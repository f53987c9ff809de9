"""Parallelism over ``torch.distributed`` (``biogpt_tpu/parallel``): the
(data, model) mesh of one rank, process-group bring-up with its
collectives, the Megatron tensor-parallel packing and forward, and the
shardings of unpacked weights and the KV cache."""

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh  # noqa: F401
from .sharding import (  # noqa: F401
    cache_pspec,
    param_pspecs,
    shard_cache,
    shard_params,
)
