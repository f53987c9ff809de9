"""Quantized matmul and embedding lookup (``biogpt_tpu/ops/qmatmul.py``).

``matmul`` dispatches on the row count m exactly as the JAX package does:

  m <= 8        -> ``qmatmul``       (kernel; X' numerics)
  8 < m <= 32   -> ``qmatmul_wide``  (kernel; dequant-then-dot numerics)
  otherwise     -> plain torch ops: at m >= _DEQUANT_M_ROWS the weight
                   dequantizes in f32, rounds once to the compute dtype and
                   feeds one dense product; below it the per-block
                   partial-sum form (block-accum) runs.

The kernels run when ``allow_kernels`` is set and the weight passes their
shape gates; each kernel function itself chooses the CUDA kernel or its
plain version by the device of its tensors.
"""

from __future__ import annotations

from typing import Any

import torch

from ..quant.codecs import QK
from ..quant.layouts import QuantizedTensor, from_planes, unpack_levels
from .qmatmul_kernels import qmatmul, qmatmul_wide, supports, supports_wide

# At and above this many rows, quantized matmuls dequantize the weight and
# run one dense product instead of the block-accum form.
_DEQUANT_M_ROWS = 32


def _levels(w: QuantizedTensor) -> torch.Tensor:
    return unpack_levels(w.levels, w.qtype) if w.packed else w.levels


def dequantize(w: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """The dequantized kernel (d_in, d_out) (``quant.layouts.from_planes``)."""
    return from_planes(w, dtype)


def _as(x: torch.Tensor, dtype) -> torch.Tensor:
    """Round to ``dtype`` and widen to f32: products of such values are
    exact in f32, so an f32 product then accumulates like the reference's
    f32-accumulating dots."""
    return x.to(dtype).to(torch.float32)


def matmul(x: torch.Tensor, w: Any, *, compute_dtype=None,
           allow_kernels: bool = True) -> torch.Tensor:
    """y = x @ w for dense (d_in, d_out) or ``QuantizedTensor`` weights.
    ``x``: (..., d_in) -> (..., d_out) f32."""
    if not isinstance(w, QuantizedTensor):
        cd = compute_dtype or x.dtype
        return _as(x, cd) @ _as(w, cd)

    batch_shape = x.shape[:-1]
    m = 1
    for b in batch_shape:
        m *= b
    d_in = w.d_in
    if allow_kernels:
        if supports(w, m):
            y = qmatmul(x.reshape(m, d_in), w)
            return y.reshape(*batch_shape, y.shape[-1])
        if supports_wide(w, m):
            y = qmatmul_wide(x.reshape(m, d_in), w)
            return y.reshape(*batch_shape, y.shape[-1])

    cd = compute_dtype or torch.float32
    if m >= _DEQUANT_M_ROWS:
        wd = _as(dequantize(w, torch.float32), cd)
        return _as(x, cd) @ wd
    nb = d_in // QK
    d_out = w.d_out
    xb = _as(x, cd).reshape(*batch_shape, nb, QK)
    lv = _levels(w).to(torch.float32).reshape(nb, QK, d_out)
    partial = torch.einsum("...nk,nko->...no", xb, lv)
    out = (partial * w.scales.to(torch.float32)).sum(-2)
    if w.mins is not None:
        out = out + torch.einsum("...n,no->...o", xb.sum(-1),
                                 w.mins.to(torch.float32))
    return out


def embedding_lookup(ids: torch.Tensor, table: Any,
                     dtype=torch.float32) -> torch.Tensor:
    """Row gather from a dense or quantized (row-major planes) embedding."""
    if not isinstance(table, QuantizedTensor):
        return table[ids].to(dtype)
    lv = table.levels[ids].to(dtype)
    out = lv * table.scales[ids].to(dtype).repeat_interleave(QK, dim=-1)
    if table.mins is not None:
        out = out + table.mins[ids].to(dtype).repeat_interleave(QK, dim=-1)
    return out

