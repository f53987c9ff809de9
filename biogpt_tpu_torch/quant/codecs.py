"""ggml block formats: type codes, block sizes and the decoders (numpy).

The five ggml block formats of BioGPT model files (fp16-scale blocks,
QK=32, nibble packing low=j / high=j+16):

  Q4_0 (18 B/block): fp16 d;        16 B nibbles.  w = d * (q - 8)
  Q4_1 (20 B/block): fp16 d, m;     16 B nibbles.  w = d * q + m
  Q5_0 (22 B/block): fp16 d;  u32 qh; 16 B nibbles. w = d * (q - 16)
  Q5_1 (24 B/block): fp16 d, m; u32 qh; 16 B nibbles. w = d * q + m
  Q8_0 (34 B/block): fp16 d;        32 int8.       w = d * q

The port only reads quantized files (the encoders live with the JAX
package's quantize tool), so this module keeps the decoders: dequantization
widens the stored fp16 scale back to f32. Blocks never straddle rows
(row length = ne[0] = d_in).
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
