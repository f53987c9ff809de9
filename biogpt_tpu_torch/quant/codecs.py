"""ggml block formats: type codes, block sizes and the decoders (numpy).

The five ggml block formats of BioGPT model files (fp16-scale blocks,
QK=32, nibble packing low=j / high=j+16):

  Q4_0 (18 B/block): fp16 d;        16 B nibbles.  w = d * (q - 8)
  Q4_1 (20 B/block): fp16 d, m;     16 B nibbles.  w = d * q + m
  Q5_0 (22 B/block): fp16 d;  u32 qh; 16 B nibbles. w = d * (q - 16)
  Q5_1 (24 B/block): fp16 d, m; u32 qh; 16 B nibbles. w = d * q + m
  Q8_0 (34 B/block): fp16 d;        32 int8.       w = d * q

The decoders widen the stored fp16 scale back to f32. The encoders are
the ggml reference's five, bit-equal to the JAX package's numpy codecs
(the quantize tool, ``params_from_state_dict`` and the random model
writer use them):

  Q4_0: d = signed_absmax / -8;  q = clamp(floor(x/d + 8.5), 0, 15)
  Q4_1: d = (max-min)/15;        q = clamp(floor((x-min)/d + 0.5), 0, 15)
  Q5_0: d = signed_absmax / -16; q = clamp(floor(x/d + 16.5), 0, 31)
  Q5_1: d = (max-min)/31;        q = clamp(floor((x-min)/d + 0.5), 0, 31)
  Q8_0: d = absmax / 127;        q = roundf(x/d)   (half away from zero)

Scales and minima are stored as IEEE fp16 (round to nearest even); the
reciprocal that quantizes is taken of the f32 scale, as in ggml. Blocks
never straddle rows (row length = ne[0] = d_in).
"""

from __future__ import annotations

import numpy as np

QK = 32  # block size shared by all five formats

# ggml_type enum values (the on-disk per-tensor ttype codes).
GGML_TYPE_F32 = 0
GGML_TYPE_F16 = 1
GGML_TYPE_Q4_0 = 2
GGML_TYPE_Q4_1 = 3
GGML_TYPE_Q5_0 = 6
GGML_TYPE_Q5_1 = 7
GGML_TYPE_Q8_0 = 8

GGML_TYPE_NAMES = {
    GGML_TYPE_F32: "f32",
    GGML_TYPE_F16: "f16",
    GGML_TYPE_Q4_0: "q4_0",
    GGML_TYPE_Q4_1: "q4_1",
    GGML_TYPE_Q5_0: "q5_0",
    GGML_TYPE_Q5_1: "q5_1",
    GGML_TYPE_Q8_0: "q8_0",
}
GGML_TYPE_BY_NAME = {v: k for k, v in GGML_TYPE_NAMES.items()}

# bytes per QK-element block on disk
BLOCK_SIZES = {
    GGML_TYPE_Q4_0: 18,
    GGML_TYPE_Q4_1: 20,
    GGML_TYPE_Q5_0: 22,
    GGML_TYPE_Q5_1: 24,
    GGML_TYPE_Q8_0: 34,
}

# Number of "integer levels" bytes per block once unpacked to int8 planes.
QUANTIZED_TYPES = tuple(BLOCK_SIZES)


def ggml_type_for_ftype(ftype: int) -> int:
    """Map a file-header ftype to the ggml tensor type of the big weights.

    Mirrors ``ggml_ftype_to_ggml_type`` as used at ``biogpt.cpp:160``.
    """
    from ..config import (
        FTYPE_F32, FTYPE_F16, FTYPE_Q4_0, FTYPE_Q4_1, FTYPE_Q5_0,
        FTYPE_Q5_1, FTYPE_Q8_0,
    )
    table = {
        FTYPE_F32: GGML_TYPE_F32,
        FTYPE_F16: GGML_TYPE_F16,
        FTYPE_Q4_0: GGML_TYPE_Q4_0,
        FTYPE_Q4_1: GGML_TYPE_Q4_1,
        FTYPE_Q5_0: GGML_TYPE_Q5_0,
        FTYPE_Q5_1: GGML_TYPE_Q5_1,
        FTYPE_Q8_0: GGML_TYPE_Q8_0,
    }
    if ftype not in table:
        raise ValueError(f"unsupported ftype {ftype}")
    return table[ftype]


def _unpack_nibbles(qs: np.ndarray) -> np.ndarray:
    """(n_blocks, 16) packed bytes -> (n_blocks, 32) uint8 levels."""
    lo = qs & 0x0F
    hi = (qs >> 4) & 0x0F
    return np.concatenate([lo, hi], axis=1).astype(np.uint8)


def _unpack_qh(qh_bytes: np.ndarray) -> np.ndarray:
    """(n_blocks, 4) LE u32 bytes -> (n_blocks, 32) 5th-bit values (0/1)."""
    qh = qh_bytes.reshape(-1, 4).copy().view("<u4").reshape(-1, 1)
    shifts = np.arange(32, dtype=np.uint32)[None, :]
    return ((qh >> shifts) & 1).astype(np.uint8)


# ---------------------------------------------------------------- encoders

def _fp16_bytes(x: np.ndarray) -> np.ndarray:
    """f32 -> IEEE fp16 (RN-even, as GGML_FP32_TO_FP16) as raw bytes."""
    return x.astype(np.float16).view(np.uint8)


def _inverse(d: np.ndarray) -> np.ndarray:
    """1/d, 0 where d is 0 (an all-zero block)."""
    return np.where(d != 0.0, np.float32(1.0) / np.where(d != 0.0, d, 1.0), 0.0)


def _trunc_shift(x: np.ndarray, shift: float, hi: int) -> np.ndarray:
    """clamp((int)(x + shift), 0, hi): the reference's C cast truncates;
    the shifted values are >= 0 there, where truncation is floor."""
    return np.clip(np.floor(x + np.float32(shift)), 0, hi).astype(np.uint8)


def _pack_nibbles(q: np.ndarray) -> np.ndarray:
    """(n_blocks, 32) levels -> (n_blocks, 16) bytes: q[j] | q[j+16] << 4."""
    return ((q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)).astype(np.uint8)


def _pack_qh(q: np.ndarray) -> np.ndarray:
    """Bit 4 of each of the 32 levels -> (n_blocks, 4) LE u32 bytes (bit j
    for element j)."""
    bits = ((q >> 4) & 1).astype(np.uint32)
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32))[None, :]
    qh = (bits * weights).sum(axis=1, dtype=np.uint32)
    return qh.astype("<u4").view(np.uint8).reshape(-1, 4)


def _signed_absmax(blocks: np.ndarray) -> np.ndarray:
    """Each block's value of largest magnitude, sign kept (ggml "max"; the
    first of equal magnitudes)."""
    return blocks[np.arange(blocks.shape[0]), np.argmax(np.abs(blocks), 1)]


def _quantize_q4_0(blocks: np.ndarray) -> np.ndarray:
    d = _signed_absmax(blocks) / np.float32(-8.0)
    q = _trunc_shift(blocks * _inverse(d)[:, None], 8.5, 15)
    out = np.empty((blocks.shape[0], 18), dtype=np.uint8)
    out[:, 0:2] = _fp16_bytes(d).reshape(-1, 2)
    out[:, 2:] = _pack_nibbles(q)
    return out


def _quantize_q4_1(blocks: np.ndarray) -> np.ndarray:
    mn, mx = blocks.min(axis=1), blocks.max(axis=1)
    d = (mx - mn) / np.float32(15.0)
    q = _trunc_shift((blocks - mn[:, None]) * _inverse(d)[:, None], 0.5, 15)
    out = np.empty((blocks.shape[0], 20), dtype=np.uint8)
    out[:, 0:2] = _fp16_bytes(d).reshape(-1, 2)
    out[:, 2:4] = _fp16_bytes(mn).reshape(-1, 2)
    out[:, 4:] = _pack_nibbles(q)
    return out


def _quantize_q5_0(blocks: np.ndarray) -> np.ndarray:
    d = _signed_absmax(blocks) / np.float32(-16.0)
    q = _trunc_shift(blocks * _inverse(d)[:, None], 16.5, 31)
    out = np.empty((blocks.shape[0], 22), dtype=np.uint8)
    out[:, 0:2] = _fp16_bytes(d).reshape(-1, 2)
    out[:, 2:6] = _pack_qh(q)
    out[:, 6:] = _pack_nibbles(q)
    return out


def _quantize_q5_1(blocks: np.ndarray) -> np.ndarray:
    mn, mx = blocks.min(axis=1), blocks.max(axis=1)
    d = (mx - mn) / np.float32(31.0)
    q = _trunc_shift((blocks - mn[:, None]) * _inverse(d)[:, None], 0.5, 31)
    out = np.empty((blocks.shape[0], 24), dtype=np.uint8)
    out[:, 0:2] = _fp16_bytes(d).reshape(-1, 2)
    out[:, 2:4] = _fp16_bytes(mn).reshape(-1, 2)
    out[:, 4:8] = _pack_qh(q)
    out[:, 8:] = _pack_nibbles(q)
    return out


def _quantize_q8_0(blocks: np.ndarray) -> np.ndarray:
    d = np.abs(blocks).max(axis=1) / np.float32(127.0)
    scaled = blocks * _inverse(d)[:, None]
    # roundf: half away from zero
    q = np.trunc(scaled + np.copysign(np.float32(0.5), scaled)).astype(np.int8)
    out = np.empty((blocks.shape[0], 34), dtype=np.uint8)
    out[:, 0:2] = _fp16_bytes(d).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out


_ENCODERS = {
    GGML_TYPE_Q4_0: _quantize_q4_0,
    GGML_TYPE_Q4_1: _quantize_q4_1,
    GGML_TYPE_Q5_0: _quantize_q5_0,
    GGML_TYPE_Q5_1: _quantize_q5_1,
    GGML_TYPE_Q8_0: _quantize_q8_0,
}


def quantize_blocks(x: np.ndarray, qtype: int) -> np.ndarray:
    """float32 values (size % 32 == 0) -> raw ggml block bytes (n_blocks,
    BLOCK_SIZES[qtype])."""
    if qtype not in _ENCODERS:
        raise ValueError(f"no encoder for ggml type {qtype}")
    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.size % QK != 0:
        raise ValueError(f"element count {x.size} not a multiple of QK={QK}")
    return _ENCODERS[qtype](x.reshape(-1, QK))


def quantize_rows(x: np.ndarray, qtype: int) -> bytes:
    """A 2-D weight (n_rows, row_len) -> its ggml bytes, quantized row by
    row (the row length is the codec's, so blocks never straddle rows)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.ndim != 2:
        raise ValueError("quantize_rows expects a 2-D array")
    if x.shape[1] % QK != 0:
        raise ValueError(f"row length {x.shape[1]} not a multiple of {QK}")
    return quantize_blocks(x.reshape(-1), qtype).tobytes()


# ---------------------------------------------------------------- decoders

def _scales_f32(raw: np.ndarray) -> np.ndarray:
    return raw.copy().view(np.float16).astype(np.float32).reshape(-1)


def _dequantize_q4_0(blocks: np.ndarray) -> np.ndarray:
    d = _scales_f32(blocks[:, 0:2])
    q = _unpack_nibbles(blocks[:, 2:]).astype(np.float32)
    return (q - 8.0) * d[:, None]


def _dequantize_q4_1(blocks: np.ndarray) -> np.ndarray:
    d = _scales_f32(blocks[:, 0:2])
    m = _scales_f32(blocks[:, 2:4])
    q = _unpack_nibbles(blocks[:, 4:]).astype(np.float32)
    return q * d[:, None] + m[:, None]


def _dequantize_q5_0(blocks: np.ndarray) -> np.ndarray:
    d = _scales_f32(blocks[:, 0:2])
    hi = _unpack_qh(blocks[:, 2:6])
    q = (_unpack_nibbles(blocks[:, 6:]) | (hi << 4)).astype(np.float32)
    return (q - 16.0) * d[:, None]


def _dequantize_q5_1(blocks: np.ndarray) -> np.ndarray:
    d = _scales_f32(blocks[:, 0:2])
    m = _scales_f32(blocks[:, 2:4])
    hi = _unpack_qh(blocks[:, 4:8])
    q = (_unpack_nibbles(blocks[:, 8:]) | (hi << 4)).astype(np.float32)
    return q * d[:, None] + m[:, None]


def _dequantize_q8_0(blocks: np.ndarray) -> np.ndarray:
    d = _scales_f32(blocks[:, 0:2])
    q = blocks[:, 2:].copy().view(np.int8).astype(np.float32)
    return q * d[:, None]


_DECODERS = {
    GGML_TYPE_Q4_0: _dequantize_q4_0,
    GGML_TYPE_Q4_1: _dequantize_q4_1,
    GGML_TYPE_Q5_0: _dequantize_q5_0,
    GGML_TYPE_Q5_1: _dequantize_q5_1,
    GGML_TYPE_Q8_0: _dequantize_q8_0,
}


def dequantize_blocks(raw: np.ndarray | bytes, qtype: int) -> np.ndarray:
    """Raw ggml block bytes -> float32 values of shape (n_blocks, 32)."""
    if qtype not in _DECODERS:
        raise ValueError(f"not a quantized ggml type: {qtype}")
    bs = BLOCK_SIZES[qtype]
    buf = np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, (bytes, bytearray)) else np.asarray(raw, dtype=np.uint8)
    if buf.size % bs != 0:
        raise ValueError(f"byte count {buf.size} not a multiple of block size {bs}")
    return _DECODERS[qtype](buf.reshape(-1, bs))


def dequantize_rows(raw: bytes | np.ndarray, shape: tuple[int, int], qtype: int) -> np.ndarray:
    """ggml bytes -> float32 array of `shape` (n_rows, row_len)."""
    vals = dequantize_blocks(raw, qtype)
    return vals.reshape(shape)
