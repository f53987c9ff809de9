"""Failure detection (``biogpt_tpu/runtime/health.py``, single-stream part).

``ModelHealthError`` is raised when a generation produced non-finite logits
(the engine folds the finite check into its decode loop on the device and
reads it with the chunk's token drain). ``check_params_finite`` rejects a
loaded parameter tree with any non-finite float plane, scales and mins of
quantized weights included.
"""

from __future__ import annotations

import torch

from ..quant.layouts import QuantizedTensor


class ModelHealthError(RuntimeError):
    """Non-finite values in the parameters or the logits."""


def _float_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _float_leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, QuantizedTensor):
        yield from _float_leaves({"scales": tree.scales, "mins": tree.mins},
                                 path)
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point():
        yield path, tree


def check_params_finite(params, name: str = "params") -> None:
    """Raise ``ModelHealthError`` naming every non-finite float leaf. One
    device read on the healthy path; only a failure walks leaf by leaf."""
    leaves = list(_float_leaves(params))
    if not leaves:
        return
    ok = torch.stack([torch.isfinite(t).all() for _, t in leaves]).all()
    if bool(ok):
        return
    bad = [p for p, t in leaves if not bool(torch.isfinite(t).all())]
    raise ModelHealthError(
        f"non-finite values in {name}: {', '.join(sorted(bad))}")
