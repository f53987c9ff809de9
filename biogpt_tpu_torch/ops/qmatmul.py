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

On the card the plain products run on their rows in whole tiles of one
shape (:func:`_in_row_tiles`): ``_ROW_TILE`` rows for a dense product,
``_DEQUANT_M_ROWS`` for the block-accum form, the last tile padded with
zero rows. A library GEMM picks its algorithm, and with it the order of
each output's sums, by its shape (on the H100 cuBLAS splits K for some
row counts and not for others), so without the tiles a serving refill
row's cache rows and logits would depend on how many rows share its
group. The form itself still switches at ``_DEQUANT_M_ROWS`` rows, as in
the JAX package. ``form_rows`` sets the row count that picks the form and
the tile where the rows are a share of a larger product: a data-axis
replica's rows of a serving refill group take the whole group's form, so
each of its rows is computed as the single device computes it in the
group (the rows are not padded: a tile computes each of its rows the same
whatever the other rows hold).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..quant.codecs import QK
from ..quant.layouts import QuantizedTensor, from_planes, unpack_levels
from .qmatmul_kernels import qmatmul, qmatmul_wide, supports, supports_wide

# At and above this many rows, quantized matmuls dequantize the weight and
# run one dense product instead of the block-accum form.
_DEQUANT_M_ROWS = 32
# The rows of each dense product's tiles (:func:`_in_row_tiles`).
_ROW_TILE = 512


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


def _in_row_tiles(x: torch.Tensor, product, tile: int) -> torch.Tensor:
    """``product`` of the rows ``x`` (m, d_in) -> (m, d_out), computed on
    the card on whole tiles of ``tile`` rows (the last padded with zero
    rows), each one call of the same shape whatever m is; on the CPU in
    one call."""
    if not x.is_cuda:
        return product(x)
    m = x.shape[0]
    tiles = -(-m // tile)
    if tiles * tile != m:
        x = torch.nn.functional.pad(x, (0, 0, 0, tiles * tile - m))
    if tiles == 1:
        return product(x)[:m]
    return torch.cat([product(x[i * tile:(i + 1) * tile])
                      for i in range(tiles)])[:m]


def matmul(x: torch.Tensor, w: Any, *, compute_dtype=None,
           allow_kernels: bool = True,
           form_rows: Optional[int] = None) -> torch.Tensor:
    """y = x @ w for dense (d_in, d_out) or ``QuantizedTensor`` weights.
    ``x``: (..., d_in) -> (..., d_out) f32. ``form_rows`` (default: the
    rows of ``x``): the row count whose product's form and row tiles the
    plain products take (module docstring); the kernels' choice stays
    with the rows of ``x``."""
    batch_shape = x.shape[:-1]
    m = 1
    for b in batch_shape:
        m *= b
    form = m if form_rows is None else form_rows
    d_in = x.shape[-1]
    rows = x.reshape(m, d_in)
    if not isinstance(w, QuantizedTensor):
        cd = compute_dtype or x.dtype
        wd = _as(w, cd)
        y = _in_row_tiles(_as(rows, cd), lambda a: a @ wd,
                          _ROW_TILE if form >= _DEQUANT_M_ROWS
                          else _DEQUANT_M_ROWS)
        return y.reshape(*batch_shape, y.shape[-1])

    if allow_kernels:
        if supports(w, m):
            y = qmatmul(rows, w)
            return y.reshape(*batch_shape, y.shape[-1])
        if supports_wide(w, m):
            y = qmatmul_wide(rows, w)
            return y.reshape(*batch_shape, y.shape[-1])

    cd = compute_dtype or torch.float32
    if form >= _DEQUANT_M_ROWS:
        wd = _as(dequantize(w, torch.float32), cd)
        y = _in_row_tiles(_as(rows, cd), lambda a: a @ wd, _ROW_TILE)
        return y.reshape(*batch_shape, y.shape[-1])
    nb = d_in // QK
    lv = _levels(w).to(torch.float32).reshape(nb, QK, w.d_out)
    scales = w.scales.to(torch.float32)

    def block_accum(a):
        xb = a.reshape(a.shape[0], nb, QK)
        out = (torch.einsum("mnk,nko->mno", xb, lv) * scales).sum(-2)
        if w.mins is not None:
            out = out + torch.einsum("mn,no->mo", xb.sum(-1),
                                     w.mins.to(torch.float32))
        return out
    y = _in_row_tiles(_as(rows, cd), block_accum, _DEQUANT_M_ROWS)
    return y.reshape(*batch_shape, y.shape[-1])


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

