"""One rank's view of the ("data", "model") mesh (``biogpt_tpu/parallel/
mesh.py``).

JAX builds one global mesh over every device and lets ``shard_map`` run
the per-shard body; here every rank is its own process holding its own
shard, and the mesh says which: the model-axis size ``tp``, this rank's
model index, the ``torch.distributed`` process group of the model axis
and the rank's device. The collectives at the Megatron joins are its
methods (``parallel/distributed.py`` runs them); on a (1, 1) mesh there is
no process group and every collective is the identity, as a one-device
JAX mesh makes the sharded path degenerate to one chip.

The data axis (slots sharded over replicas) belongs to a later slice of
the port: ``data > 1`` raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int
    model: int
    index: int                       # this rank's position on the model axis
    group: Optional[object]          # the model axis' process group
    device: torch.device

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    # the collectives of the model axis (``parallel/distributed.py``; the
    # identity at model == 1)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        from .distributed import all_reduce_sum
        return x if self.model == 1 else all_reduce_sum(x, self.group)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        from .distributed import all_reduce_max
        return x if self.model == 1 else all_reduce_max(x, self.group)

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """The shards' ``x`` concatenated along the last axis, in model
        order (the column-parallel lm_head's logits)."""
        from .distributed import all_gather
        return x if self.model == 1 else all_gather(x, self.group, dim=-1)

    def all_gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N/model, ...) local sequence rows -> the full sequence
        (sequence parallelism)."""
        from .distributed import all_gather
        return x if self.model == 1 else all_gather(x, self.group, dim=1)

    def reduce_scatter_seq(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over shards of (B, N, ...) ``x``, each shard keeping its
        own contiguous N/model rows."""
        from .distributed import reduce_scatter
        return x if self.model == 1 else reduce_scatter(x, self.group, dim=1)


def make_mesh(data: int = 1, model: Optional[int] = None, group=None,
              device="cuda") -> Mesh:
    """This rank's (data, model) mesh.

    ``model`` defaults to the size of ``group`` (the default group when
    ``torch.distributed`` is initialized, else 1). ``device`` defaults to
    the card; a bare "cuda" on a rank of several becomes ``cuda:<local
    rank>`` (``LOCAL_RANK``, else the rank on the model axis) and is made
    the current device. Raises without a card unless ``device`` is the
    CPU."""
    if data != 1:
        raise NotImplementedError(
            "the data axis (slots sharded over replicas) belongs to a later "
            "slice of the PyTorch port; use data=1")
    if model is None:
        model = dist.get_world_size(group) if dist.is_initialized() else 1
    if model < 1:
        raise ValueError(f"model axis of size {model}")
    dev = resolve_device(device)
    if model == 1:
        index, group = 0, None
    else:
        if not dist.is_initialized():
            raise RuntimeError(
                f"a model axis of {model} ranks needs torch.distributed: call "
                "parallel.distributed.initialize first")
        size = dist.get_world_size(group)
        if size != model:
            raise ValueError(f"the process group has {size} ranks, the model "
                             f"axis {model}")
        index = dist.get_rank(group)
        group = group if group is not None else dist.group.WORLD
        if dev.type == "cuda" and dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", index))
            dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return Mesh(data=1, model=model, index=index, group=group, device=dev)
