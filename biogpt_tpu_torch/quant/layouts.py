"""Plane layout for quantized weights (the JAX package's layout, in torch).

Each quantized 2-D weight is held as separate dense planes:

  levels : int8   (d_in, d_out)        integer levels, centered where the
                                       format has a zero-point shift
                                       (Q4_0: q-8, Q5_0: q-16, Q8_0: q)
  scales : float16 (d_in // 32, d_out) per-block scale d
  mins   : float16 (d_in // 32, d_out) per-block min m (Q4_1/Q5_1 only)

Dequantization is exactly ``levels * repeat(scales, 32, axis=0)`` for the
_0 formats and ``levels * repeat(scales) + repeat(mins)`` for the _1
formats. Weights are stored in kernel orientation (d_in, d_out) so
activations contract over the leading axis: y = x @ w. Blocks run along
d_in (row length = ne[0] = d_in).

The byte layouts (plane order, split-half nibble packing, split-eighth
fifth-bit plane) are identical to ``biogpt_tpu.quant.layouts`` so kernels
and tests match the JAX side one to one. Conversions run in numpy on the
host (loading is host work) and hand back torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import codecs
from .codecs import (
    QK,
    GGML_TYPE_Q4_0,
    GGML_TYPE_Q4_1,
    GGML_TYPE_Q5_0,
    GGML_TYPE_Q5_1,
    GGML_TYPE_Q8_0,
)

# Zero-point shift applied when centering levels per format.
LEVEL_OFFSET = {
    GGML_TYPE_Q4_0: 8,
    GGML_TYPE_Q4_1: 0,
    GGML_TYPE_Q5_0: 16,
    GGML_TYPE_Q5_1: 0,
    GGML_TYPE_Q8_0: 0,
}

FIVE_BIT = (GGML_TYPE_Q5_0, GGML_TYPE_Q5_1)


@dataclasses.dataclass
class QuantizedTensor:
    """A quantized 2-D weight (or an (L, ...) stack of them) in planes.

    When ``packed`` is True (4/5-bit formats), ``levels`` is uint8 holding
    two UNCENTERED 4-bit levels per byte in split-half order: byte row i
    carries level row i in its low nibble and level row i + d_in//2 in its
    high nibble; the 5-bit formats append a fifth-bit plane of d_in//8 rows
    (byte row j, bit p = bit 4 of level row j + p*d_in//8).
    """

    levels: torch.Tensor        # int8 (d_in, d_out) | uint8 packed rows
    scales: torch.Tensor        # float16/bfloat16 (d_in // QK, d_out)
    mins: Optional[torch.Tensor]
    qtype: int
    packed: bool = False

    @property
    def d_in(self) -> int:
        return self.scales.shape[-2] * QK

    @property
    def d_out(self) -> int:
        return self.scales.shape[-1]

    def map(self, fn) -> "QuantizedTensor":
        """Apply ``fn`` to every plane (device moves, layer slicing)."""
        return dataclasses.replace(
            self, levels=fn(self.levels), scales=fn(self.scales),
            mins=fn(self.mins) if self.mins is not None else None)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _planes_np(raw, shape_out_in: tuple[int, int], qtype: int):
    """ggml block bytes of a (d_out, d_in) weight -> numpy (levels, scales,
    mins) transposed to (d_in, d_out) / (nb, d_out)."""
    d_out, d_in = shape_out_in
    if d_in % QK != 0:
        raise ValueError(f"d_in={d_in} not a multiple of {QK}")
    bs = codecs.BLOCK_SIZES[qtype]
    buf = (np.frombuffer(raw, dtype=np.uint8)
           if isinstance(raw, (bytes, bytearray))
           else np.asarray(raw, dtype=np.uint8))
    blocks = buf.reshape(d_out, d_in // QK, bs)

    if qtype in (GGML_TYPE_Q4_0, GGML_TYPE_Q4_1, GGML_TYPE_Q5_0, GGML_TYPE_Q5_1):
        d_off, m_off, qh_off, qs_off = {
            GGML_TYPE_Q4_0: (0, None, None, 2),
            GGML_TYPE_Q4_1: (0, 2, None, 4),
            GGML_TYPE_Q5_0: (0, None, 2, 6),
            GGML_TYPE_Q5_1: (0, 2, 4, 8),
        }[qtype]
        qs = blocks[:, :, qs_off:]
        q = np.concatenate([qs & 0x0F, (qs >> 4) & 0x0F], axis=2).astype(np.uint8)
        if qh_off is not None:
            qh = np.ascontiguousarray(
                blocks[:, :, qh_off:qh_off + 4]).view("<u4")[..., 0]
            shifts = np.arange(32, dtype=np.uint32)[None, None, :]
            q = q | (((qh[..., None] >> shifts) & 1).astype(np.uint8) << 4)
        levels = (q.astype(np.int16) - LEVEL_OFFSET[qtype]).astype(np.int8)
        scales = np.ascontiguousarray(
            blocks[:, :, d_off:d_off + 2]).view(np.float16)[..., 0]
        mins = (np.ascontiguousarray(
            blocks[:, :, m_off:m_off + 2]).view(np.float16)[..., 0]
            if m_off is not None else None)
    elif qtype == GGML_TYPE_Q8_0:
        levels = np.ascontiguousarray(blocks[:, :, 2:]).view(np.int8)
        scales = np.ascontiguousarray(blocks[:, :, 0:2]).view(np.float16)[..., 0]
        mins = None
    else:
        raise ValueError(f"not a quantized type: {qtype}")
    levels_t = np.ascontiguousarray(levels.reshape(d_out, d_in).T)
    scales_t = np.ascontiguousarray(scales.T)
    mins_t = np.ascontiguousarray(mins.T) if mins is not None else None
    return levels_t, scales_t, mins_t


def _qt(levels, scales, mins, qtype, packed=False) -> QuantizedTensor:
    return QuantizedTensor(
        levels=torch.from_numpy(np.ascontiguousarray(levels)),
        scales=torch.from_numpy(np.ascontiguousarray(scales)),
        mins=(torch.from_numpy(np.ascontiguousarray(mins))
              if mins is not None else None),
        qtype=qtype, packed=packed)


def to_planes(raw, shape_out_in: tuple[int, int], qtype: int) -> QuantizedTensor:
    """ggml block bytes of a (d_out, d_in)-shaped weight -> plane layout
    (d_in, d_out) on the CPU."""
    return _qt(*_planes_np(raw, shape_out_in, qtype), qtype)


def to_lookup_planes(raw, shape_rows_cols: tuple[int, int], qtype: int) -> QuantizedTensor:
    """ggml block bytes of an embedding table -> row-major planes: levels
    keep the (n_rows, row_len) orientation for gather-style lookup, with
    scales/mins of shape (n_rows, row_len // QK)."""
    levels, scales, mins = _planes_np(raw, shape_rows_cols, qtype)
    return _qt(levels.T, scales.T, mins.T if mins is not None else None, qtype)


def pack_nibble_planes(qt: QuantizedTensor, chunks: int = 1) -> QuantizedTensor:
    """Pack a 4/5-bit-format plane tensor into one dense byte plane.

    4-bit formats pack two levels per byte in split-half order (byte row i
    holds level row i low and row i + d_in//2 high); 5-bit formats append
    the split-eighth fifth-bit plane. Levels are stored UNCENTERED
    (0..15 / 0..31). No-op for Q8_0 and for d_in whose halves would not
    stay block aligned. Works on layer-stacked (L, d_in, d_out) planes.

    ``chunks`` > 1 packs each of ``chunks`` equal d_in chunks on its own
    (nibbles, then for Q5 the fifth-bit rows, per chunk), so a contiguous
    d_in shard of the result is a packed plane by itself: the row-parallel
    weights of tensor parallelism (``parallel/tp.py``). Unpack it with the
    same ``chunks``.
    """
    if qt.packed or qt.qtype not in (GGML_TYPE_Q4_0, GGML_TYPE_Q4_1) + FIVE_BIT:
        return qt
    levels = _np(qt.levels)
    d_in = levels.shape[-2]
    if d_in % (chunks * 2 * QK) != 0:
        return qt
    u = (levels.astype(np.int16) + LEVEL_OFFSET[qt.qtype]).astype(np.uint8)
    per = d_in // chunks
    half, eighth = per // 2, per // 8
    pieces = []
    for c in range(chunks):
        uc = u[..., c * per:(c + 1) * per, :]
        lo4 = uc & 0x0F
        pieces.append(lo4[..., :half, :] | (lo4[..., half:, :] << 4))
        if qt.qtype in FIVE_BIT:
            bit4 = (uc >> 4) & 0x01
            plane = np.zeros(uc.shape[:-2] + (eighth, uc.shape[-1]), np.uint8)
            for p in range(8):
                plane |= bit4[..., p * eighth:(p + 1) * eighth, :] << p
            pieces.append(plane)
    packed = np.concatenate(pieces, axis=-2)
    return dataclasses.replace(
        qt, levels=torch.from_numpy(np.ascontiguousarray(packed)), packed=True)


def unpack_levels(levels: torch.Tensor, qtype: int) -> torch.Tensor:
    """Packed byte rows -> centered int8 levels (..., d_in, d_out), in torch
    on the tensor's own device."""
    five = qtype in FIVE_BIT
    rows = levels.shape[-2]
    d_in = rows * 8 // 5 if five else rows * 2
    nib = levels[..., :d_in // 2, :]
    lv = torch.cat([nib & 0x0F, (nib >> 4) & 0x0F], dim=-2)
    if five:
        plane = levels[..., d_in // 2:, :]
        fifth = torch.cat([(plane >> p) & 1 for p in range(8)], dim=-2)
        lv = lv | (fifth << 4)
    return (lv.to(torch.int16) - LEVEL_OFFSET[qtype]).to(torch.int8)


def unpack_nibble_planes(qt: QuantizedTensor, chunks: int = 1) -> QuantizedTensor:
    """Inverse of :func:`pack_nibble_planes` (the same ``chunks``)."""
    if not qt.packed:
        return qt
    rows = qt.levels.shape[-2] // chunks
    levels = torch.cat([unpack_levels(qt.levels[..., c * rows:(c + 1) * rows, :],
                                      qt.qtype) for c in range(chunks)], dim=-2)
    return dataclasses.replace(qt, levels=levels, packed=False)
