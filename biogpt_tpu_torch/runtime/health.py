"""Failure detection (``biogpt_tpu/runtime/health.py``).

``ModelHealthError`` is raised when a generation produced non-finite logits
(the engines fold the finite check into their decode loops on the device
and read it with the chunk's token drain). ``DrainStallError`` is raised by
the serving engine when launched chunks stop draining for its watchdog's
``watchdog_s`` seconds (a hung device). ``check_params_finite`` rejects a
loaded parameter tree with any non-finite float plane, scales and mins of
quantized weights included.
"""

from __future__ import annotations

import torch

from ..quant.layouts import QuantizedTensor


class ModelHealthError(RuntimeError):
    """Non-finite values in the parameters or the logits."""


class DrainStallError(RuntimeError):
    """Launched decode chunks stopped draining within the watchdog."""


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
