"""One rank's view of the ("data", "model") mesh (``biogpt_tpu/parallel/
mesh.py``).

JAX builds one global mesh over every device and lets ``shard_map`` or
GSPMD run the per-shard program; here every rank is its own process
holding its own shard, and the mesh says which: the axes' sizes, this
rank's place on them, the ``torch.distributed`` process groups of its two
axes and the rank's device. Ranks lie on the mesh as ``jax.make_mesh``
lays out devices: rank r at (r // model, r % model).

- The model axis (tensor parallelism) shards the weights and the KV
  cache's features; its collectives are the Megatron joins (``sum``,
  ``max``, the gathers and the reduce-scatter).
- The data axis (replicas) shards the serving slots where the batch
  divides (:meth:`Mesh.batch_rows`): a replica holds and steps only its
  own slots, and its one collective, :meth:`Mesh.gather_data`, runs once
  per serving chunk and once per refill wave (``runtime/serving.py``).
  Where the batch does not divide, every replica runs the whole batch, as
  JAX's unsharded batch spec does.

On an axis of one rank there is no process group and its collectives are
the identity, as a one-device JAX mesh makes the sharded path degenerate
to one chip.
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
    data_index: int = 0              # this rank's position on the data axis
    data_group: Optional[object] = None   # the data axis' process group

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    def batch_rows(self, batch: int) -> tuple:
        """This replica's rows [lo, hi) of a batch of ``batch`` rows: its
        own batch / data where the data axis divides the batch, else all
        of them (every replica runs the whole batch)."""
        if self.data == 1 or batch % self.data:
            return 0, batch
        n = batch // self.data
        return self.data_index * n, (self.data_index + 1) * n

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
        order (column-parallel outputs: the lm_head's logits)."""
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

    # the collective of the data axis (the identity at data == 1)

    def gather_data(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The replicas' ``x`` concatenated along ``dim`` in data order."""
        from .distributed import all_gather
        return x if self.data == 1 else all_gather(x, self.data_group, dim=dim)


def make_mesh(data: int = 1, model: Optional[int] = None, group=None,
              device="cuda") -> Mesh:
    """This rank's (data, model) mesh.

    ``model`` defaults to the ranks of ``group`` (the default group) over
    ``data`` when ``torch.distributed`` is initialized, else to 1. A mesh of
    more than one rank needs ``torch.distributed``; with ``data`` > 1 it
    spans every rank of the job (``group`` must be None) and its two axes'
    groups come from ``distributed.mesh_groups``. ``device`` defaults to
    the card; a bare "cuda" on a rank of several becomes ``cuda:<local
    rank>`` (``LOCAL_RANK``, else the global rank) and is made the current
    device. Raises without a card unless ``device`` is the CPU."""
    if data < 1:
        raise ValueError(f"data axis of size {data}")
    if model is None and dist.is_initialized():
        size = dist.get_world_size(group)
        if size % data:
            raise ValueError(f"{size} ranks do not split over data={data}")
        model = size // data
    elif model is None:
        model = 1
    if model < 1:
        raise ValueError(f"model axis of size {model}")
    dev = resolve_device(device)
    if data * model == 1:
        index, data_index, group, data_group = 0, 0, None, None
    else:
        if not dist.is_initialized():
            raise RuntimeError(
                f"a ({data}, {model}) mesh needs torch.distributed: call "
                "parallel.distributed.initialize first")
        if data == 1:
            size = dist.get_world_size(group)
            if size != model:
                raise ValueError(f"the process group has {size} ranks, the "
                                 f"model axis {model}")
            index, data_index, data_group = dist.get_rank(group), 0, None
            group = group if group is not None else dist.group.WORLD
        else:
            if group is not None:
                raise ValueError("a mesh with a data axis spans every rank "
                                 "of the job: pass no group")
            size = dist.get_world_size()
            if size != data * model:
                raise ValueError(f"the job has {size} ranks, the mesh "
                                 f"{data} x {model}")
            from .distributed import mesh_groups
            group, data_group = mesh_groups(data, model)
            rank = dist.get_rank()
            index, data_index = rank % model, rank // model
        if dev.type == "cuda" and dev.index is None:
            # never the model index: with a data axis, (0, 0) and (1, 0)
            # would share a card
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return Mesh(data=data, model=model, index=index, group=group, device=dev,
                data_index=data_index, data_group=data_group)
