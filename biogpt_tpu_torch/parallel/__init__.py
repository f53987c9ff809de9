"""Tensor parallelism over ``torch.distributed`` (``biogpt_tpu/parallel``):
the (data, model) mesh of one rank, process-group bring-up with its
collectives, and the Megatron tensor-parallel packing and forward."""

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh  # noqa: F401
