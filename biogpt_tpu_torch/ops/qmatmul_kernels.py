"""Quantized GEMV kernels: ``qmatmul``, ``qmatmul_wide``, ``lm_head_argmax``
and the two serving epilogues with their KV commit.

Each function takes plane-layout weights (``quant.layouts.QuantizedTensor``)
and dispatches on the device of its tensors: on the CPU it runs its plain
PyTorch version (``*_plain``), which transcribes what the TPU kernel
computes, bf16 roundings included; on a CUDA tensor it launches the
hand-written Hopper kernel (``csrc/qmatmul.cu``, ``csrc/lm_head_argmax.cu``)
or raises. There is no fallback from the card to the plain version.
``qmatmul`` runs, in one launch on the rows as they come, its own
streaming tensor-core GEMV (``csrc/qmatmul.cu``: a producer warp's TMA
boxes into a ring of stages, each consumer warp 32 columns over its
block's slice of d_in) or, at projection widths of up to 1024 rows, the
streaming GEMV below: :func:`qmm_plan` picks the route and grid from the
widths;
``qmatmul_wide`` and the tails at M <= 8 run the streaming tensor-core GEMV
(``csrc/qgemv_stream.cuh``) in one launch on the rows as they come, over
the grid :func:`stream_plan` chooses from the widths; the tails keep their
scratch in a workspace cached per (device, rows, d_in, d_out)
(:func:`tail_workspace`), so a call allocates only its outputs.

The CUDA kernels take every format as ``runtime.engine.
_pack_matmul_weights`` prepares it, with bf16 scale planes: the packed
4-bit (Q4_0, Q4_1) and 5-bit (Q5_0, Q5_1) planes and the unpacked int8
plane of Q8_0 (:func:`cuda_format`); the plain versions take all five
formats, packed or not.

Replaces (biogpt_tpu/ops/pallas_qmatmul.py):
  qmatmul          <- qmatmul_pallas         (M <= 8, X' numerics)
  qmatmul_wide     <- qmatmul_pallas_wide    (8 < M <= 32, dequant-then-dot)
  lm_head_argmax   <- lm_head_argmax_pallas  (final LN + lm_head + argmax,
                                              M <= 32)
  lm_head_argmax_commit      <- lm_head_argmax_commit_pallas
  lm_head_logits_gmax_commit <- lm_head_logits_gmax_commit_pallas
The lm_head tails switch from X' to dequant-then-dot above M = 8, as the
TPU tile does (``_ln_lmhead_tile``, pallas_qmatmul.py:320). The two
``*_commit`` functions keep the JAX call contract -- slot-major rows
(B, L, D), per-slot ``past`` (B,), caches updated -- and on the card run
their lm_head kernel and then ``decode_kernels.kv_commit`` on the same
stream; the port's caches are written in place. All are bound by the
bytes of the weight planes on an H100; see the kernel sources for what
each design does about it.
"""

from __future__ import annotations

import functools

import torch

from ..quant.codecs import (QK, GGML_TYPE_Q4_0, GGML_TYPE_Q4_1,
                            GGML_TYPE_Q5_0, GGML_TYPE_Q5_1, GGML_TYPE_Q8_0)
from ..quant.layouts import LEVEL_OFFSET, QuantizedTensor, unpack_levels
from . import cuda_lib

LANES = 128             # output-column alignment of every kernel
# d_in chunk of the TPU wide kernel's dequant loop; it has no remainder path
_WIDE_CHUNK = 1024
# (ggml type, packed) -> the CUDA kernels' level format (csrc/qgemv.cuh):
# split-half nibbles (4), the nibbles and a fifth-bit plane (5), or the
# unpacked int8 plane (8), as the engines prepare each format
CUDA_FORMATS = {(GGML_TYPE_Q4_0, True): 4, (GGML_TYPE_Q4_1, True): 4,
                (GGML_TYPE_Q5_0, True): 5, (GGML_TYPE_Q5_1, True): 5,
                (GGML_TYPE_Q8_0, False): 8}


# ------------------------------------------------------------------ gates

def supports(qt: QuantizedTensor, m: int) -> bool:
    """Shape gate of ``qmatmul`` (``pallas_qmatmul.supports``): lane-aligned
    d_out, block-aligned d_in halves, M <= 8."""
    d_out = qt.scales.shape[-1]
    d_in = qt.scales.shape[-2] * QK
    return d_out % LANES == 0 and d_in % (2 * QK) == 0 and m <= 8


def supports_wide(qt: QuantizedTensor, m: int) -> bool:
    """Shape gate of ``qmatmul_wide`` (``pallas_qmatmul.supports_wide``),
    including its refusal of a d_in tail the TPU kernel's 1024-row chunking
    would drop."""
    d_out = qt.scales.shape[-1]
    d_in = qt.scales.shape[-2] * QK
    return (d_out % LANES == 0 and d_in % (2 * QK) == 0
            and (d_in <= _WIDE_CHUNK or d_in % _WIDE_CHUNK == 0)
            and 8 < m <= 32)


def pick_tile(d_out: int) -> int:
    """The TPU kernels' lane tile (``pallas_qmatmul._pick_tile``): the argmax
    fold runs tile by tile, so its NaN rule depends on it."""
    for t in (512, 256, LANES):
        if d_out % t == 0:
            return t
    raise ValueError(f"d_out={d_out} not lane-aligned")


# --------------------------------------------------------- plain versions

def _offset(qt: QuantizedTensor) -> int:
    # packed levels are stored uncentered; unpacked ones are centered
    return LEVEL_OFFSET[qt.qtype] if qt.packed else 0


def _raw_levels(qt: QuantizedTensor) -> torch.Tensor:
    """(d_in, d_out) levels as the kernel sees them: uncentered when packed."""
    if qt.packed:
        return unpack_levels(qt.levels, qt.qtype).to(torch.int16) + _offset(qt)
    return qt.levels


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def xprime_logits(xb: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The X' formulation on already-bf16-valued rows xb (M, d_in) f32:
    per-block f32 partials of the raw levels, the offset and mins folded in
    through per-block activation sums, f32 scales -> (M, d_out) f32."""
    d_in, d_out = qt.d_in, qt.d_out
    nb = d_in // QK
    lv = _raw_levels(qt).to(torch.float32).reshape(nb, QK, d_out)
    xblk = xb.reshape(-1, nb, QK)
    partial = torch.einsum("mnk,nko->mno", xblk, lv)
    xsum = xblk.sum(-1, keepdim=True)                   # (M, nb, 1)
    off = _offset(qt)
    if off:
        partial = partial - float(off) * xsum
    acc = partial * qt.scales.to(torch.float32)
    if qt.mins is not None:
        acc = acc + xsum * qt.mins.to(torch.float32)
    return acc.sum(1)


def wide_weight(qt: QuantizedTensor) -> torch.Tensor:
    """Dequant-then-dot weight of the wide kernel: (lv - offset) * bf16(scale)
    [+ bf16(min)] in f32, rounded once to bf16 -> (d_in, d_out) f32."""
    lv = _raw_levels(qt).to(torch.float32)
    sc = _bf16(qt.scales).repeat_interleave(QK, dim=0)
    w = (lv - float(_offset(qt))) * sc
    if qt.mins is not None:
        w = w + _bf16(qt.mins).repeat_interleave(QK, dim=0)
    return _bf16(w)


def qmatmul_plain(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Plain version of ``qmatmul``: x (M, d_in) -> (M, d_out) f32."""
    return xprime_logits(_bf16(x), qt)


def qmatmul_wide_plain(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Plain version of ``qmatmul_wide``: x (M, d_in) -> (M, d_out) f32."""
    return _bf16(x) @ wide_weight(qt)


def layer_norm_bf16(x, ln_w, ln_b, eps: float) -> torch.Tensor:
    """The TPU kernels' LayerNorm (mean, then mean squared deviation), in
    f32, rounded to bf16 for the product that follows."""
    x = x.to(torch.float32)
    mean = x.mean(-1, keepdim=True)
    xc = x - mean
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return _bf16(y * ln_w.to(torch.float32) + ln_b.to(torch.float32))


def argmax_fold(logits: torch.Tensor, n_valid: int, tile: int):
    """The TPU argmax epilogue over (M, d_out) logits: pad columns become
    -1e30; per lane tile (max, lowest index >= max, clamped to n_valid-1),
    a NaN anywhere in a tile giving (NaN, n_valid-1); tiles fold from tile 0
    with a strict `>`. Returns ((M,) int32 ids, (M,) f32 max values)."""
    M, d_out = logits.shape
    col = torch.arange(d_out, device=logits.device)
    v = torch.where(col < n_valid, logits, torch.full_like(logits, -1e30))
    vt = v.reshape(M, d_out // tile, tile)
    tmax = vt.amax(-1)                                  # NaN-propagating
    coli = col.reshape(d_out // tile, tile).expand(M, -1, -1)
    big = torch.full_like(coli, 2 ** 30)
    targ = torch.where(vt >= tmax[..., None], coli, big).amin(-1)
    targ = torch.clamp(targ, max=n_valid - 1)
    bv, bi = tmax[:, 0].clone(), targ[:, 0].clone()
    for j in range(1, tmax.shape[1]):
        better = tmax[:, j] > bv
        bv = torch.where(better, tmax[:, j], bv)
        bi = torch.where(better, targ[:, j], bi)
    return bi.to(torch.int32), bv


def lm_head_logits_plain(x, ln_w, ln_b, qt: QuantizedTensor,
                         ln_eps: float = 1e-5) -> torch.Tensor:
    """The TPU tile body ``_ln_lmhead_tile``: final LN, then the lm_head
    logits (M, d_out) f32, X' at M <= 8 and dequant-then-dot above."""
    xn = layer_norm_bf16(x, ln_w, ln_b, ln_eps)
    if x.shape[0] > 8:
        return xn @ wide_weight(qt)
    return xprime_logits(xn, qt)


def lm_head_argmax_plain(x, ln_w, ln_b, qt: QuantizedTensor, n_valid: int,
                         ln_eps: float = 1e-5):
    """Plain version of ``lm_head_argmax``: ((M,) int32 ids, (M,) f32 max
    logits)."""
    return argmax_fold(lm_head_logits_plain(x, ln_w, ln_b, qt, ln_eps),
                       n_valid, pick_tile(qt.d_out))


def lm_head_logits_gmax_plain(x, ln_w, ln_b, qt: QuantizedTensor,
                              n_valid: int, ln_eps: float = 1e-5):
    """Logits (M, d_out) f32 with pad columns (>= n_valid) at -1e30, and
    their NaN-propagating maxima over 128-column groups (M, d_out/128)."""
    logits = lm_head_logits_plain(x, ln_w, ln_b, qt, ln_eps)
    col = torch.arange(qt.d_out, device=logits.device)
    logits = torch.where(col < n_valid, logits,
                         torch.full_like(logits, -1e30))
    return logits, logits.reshape(logits.shape[0], -1, LANES).amax(-1)


def lm_head_argmax_commit_plain(x, ln_w, ln_b, qt: QuantizedTensor,
                                n_valid: int, k_cache, v_cache, k_rows_t,
                                v_rows_t, past, ln_eps: float = 1e-5):
    """Plain version of ``lm_head_argmax_commit``."""
    from .decode_kernels import kv_commit_plain

    ids, mv = lm_head_argmax_plain(x, ln_w, ln_b, qt, n_valid, ln_eps)
    k_cache, v_cache = kv_commit_plain(k_cache, v_cache, k_rows_t, v_rows_t,
                                       past)
    return ids, mv, k_cache, v_cache


def lm_head_logits_gmax_commit_plain(x, ln_w, ln_b, qt: QuantizedTensor,
                                     n_valid: int, k_cache, v_cache, k_rows_t,
                                     v_rows_t, past, ln_eps: float = 1e-5):
    """Plain version of ``lm_head_logits_gmax_commit``."""
    from .decode_kernels import kv_commit_plain

    logits, gmax = lm_head_logits_gmax_plain(x, ln_w, ln_b, qt, n_valid,
                                             ln_eps)
    k_cache, v_cache = kv_commit_plain(k_cache, v_cache, k_rows_t, v_rows_t,
                                       past)
    return logits, gmax, k_cache, v_cache


# --------------------------------------------------------------- wrappers

def cuda_format(qt: QuantizedTensor, what: str) -> int:
    """The CUDA kernels' level format of ``qt`` (4, 5 or 8); raises for a
    plane the engines never hand them (a 4/5-bit format left unpacked, a
    packed Q8_0)."""
    bits = CUDA_FORMATS.get((qt.qtype, qt.packed))
    if bits is None:
        raise ValueError(
            f"{what}: the CUDA kernels take packed Q4_0/Q4_1/Q5_0/Q5_1 planes "
            f"or an unpacked Q8_0 plane, got qtype {qt.qtype} "
            f"packed={qt.packed}")
    return bits


def level_rows(d_in: int, bits: int) -> int:
    """Rows of a (d_in, d_out) level plane of format ``bits`` (qgemv.cuh's
    ``level_rows``): d_in/2 nibble rows, plus d_in/8 fifth-bit rows, or
    d_in int8 rows."""
    return d_in if bits == 8 else d_in // 2 + (d_in // 8 if bits == 5 else 0)


def check_cuda_levels(qt: QuantizedTensor, lead: tuple, what: str) -> int:
    """Check ``qt``'s planes for the CUDA kernels (``lead``: the layer-stack
    dimensions) -> its level format."""
    bits = cuda_format(qt, what)
    d_in, d_out = qt.d_in, qt.d_out
    for name, t in (("scales", qt.scales), ("mins", qt.mins)):
        if t is not None and (t.dtype != torch.bfloat16 or not t.is_contiguous()
                              or not t.is_cuda):
            raise ValueError(f"{what}: {name} must be a contiguous bf16 CUDA "
                             f"tensor, got {t.dtype} on {t.device}")
    dtype = torch.int8 if bits == 8 else torch.uint8
    shape = lead + (level_rows(d_in, bits), d_out)
    if (qt.levels.dtype != dtype or not qt.levels.is_contiguous()
            or not qt.levels.is_cuda or tuple(qt.levels.shape) != shape):
        raise ValueError(f"{what}: levels must be a contiguous {dtype} CUDA "
                         f"plane {shape}, got {qt.levels.dtype} "
                         f"{tuple(qt.levels.shape)}")
    return bits


def _cuda_x(x: torch.Tensor, d_in: int, what: str) -> torch.Tensor:
    if x.dim() != 2 or x.shape[1] != d_in:
        raise ValueError(f"{what}: x must be (M, {d_in}), got {tuple(x.shape)}")
    return x.to(torch.float32).contiguous()


# the streaming tensor-core GEMV (csrc/qgemv_stream.cuh): its column tile,
# warps a block, packed groups (64 rows of d_in) whose A fragments a warp
# holds at once, blocks of a cluster along d_in at most
_MMA_COLS = 64
STREAM_WARPS = 8
STREAM_GPW = 2
STREAM_MAX_SPLITS = 16


def stream_plan(m: int, d_in: int, d_out: int, n_sm: int) -> tuple:
    """The grid of the streaming GEMV for m rows of a (d_in, d_out) plane on
    a card of ``n_sm`` SMs -> (blocks along the 64-column tiles, blocks of
    a cluster along d_in). d_in splits until a block's slice holds at most
    two packed groups a warp (the A fragments a warp keeps for every tile),
    16 blocks at most: past 16 splits of 1024 rows a warp loads its
    fragments two groups at a time. At vocab width (a tile for every SM or
    more) persistent blocks, one an SM, walk the tiles, d_in split only as
    far as that needs; at projection widths a block per tile, d_in split
    over as many blocks as fill the card, up to one group a warp."""
    groups, tiles = d_in // (2 * QK), d_out // _MMA_COLS
    if (d_in <= 0 or d_in % (2 * QK) or d_out <= 0 or d_out % _MMA_COLS
            or n_sm <= 0 or not 0 < m <= 32):
        raise ValueError(f"stream_plan: m {m}, d_in {d_in} (of {2 * QK}), "
                         f"d_out {d_out} (of {_MMA_COLS}) unsupported")
    least = min(STREAM_MAX_SPLITS,
                -(-groups // (STREAM_WARPS * STREAM_GPW)))
    if tiles >= n_sm:
        return min(tiles, max(1, n_sm // least)), least
    splits = min(STREAM_MAX_SPLITS, max(1, n_sm // tiles),
                 -(-groups // STREAM_WARPS))
    return tiles, max(least, splits)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _plan(index: int, m: int, d_in: int, d_out: int) -> tuple:
    return stream_plan(m, d_in, d_out, _sm_count(index))


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


# qmatmul's kernel (csrc/qmatmul.cu, M <= 8): the output columns a consumer
# warp owns, consumer warps a block at most and at projection widths, the
# packed groups (64 rows of d_in) of a block's slice at most
QMM_UNIT = 32
QMM_MAX_WARPS = 16
QMM_PROJ_WARPS = 4
QMM_MAX_SLICE_GROUPS = 64
# rows of d_in up to which ``qmatmul`` takes the streaming GEMV's M <= 8 X'
# path at projection widths: on an H100 it was 0.2-2.1 us faster than
# qmatmul's kernel there at d_in 1024 (qkv, o, fc1 of the 347M model),
# 2.5-3.4 us slower at d_in 4096 (fc2) and 2.9-5.4 us slower at vocab
# width (chip_smoke.py --qmm-probe)
QMM_STREAM_MAX_D_IN = 1024


def qmm_kernel_plan(m: int, d_in: int, d_out: int, n_sm: int) -> tuple:
    """The grid of ``qmatmul``'s own kernel for m <= 8 rows of a (d_in,
    d_out) plane on a card of ``n_sm`` SMs -> (blocks along the columns,
    blocks of a cluster along d_in, consumer warps a block). Each block
    takes a contiguous run of 32-column units (runs differ by one unit at
    most), a consumer warp a unit at a time. At vocab width (a 64-column
    tile for every SM or more) one persistent block per SM with a warp for
    each of its units (16 at most: more take several passes), d_in split
    only past 64 packed groups (4096 rows); at projection widths a block of
    4 warps per 128 columns and d_in split over as many blocks of a cluster
    as fill the card, every split at least one group, 16 at most."""
    groups, units = d_in // (2 * QK), d_out // QMM_UNIT
    if (d_in <= 0 or d_in % (2 * QK) or d_out <= 0 or d_out % QMM_UNIT
            or n_sm <= 0 or not 0 < m <= 8):
        raise ValueError(f"qmm_plan: m {m}, d_in {d_in} (of {2 * QK}), "
                         f"d_out {d_out} (of {QMM_UNIT}) unsupported")
    least = -(-groups // QMM_MAX_SLICE_GROUPS)
    if least > STREAM_MAX_SPLITS:
        raise ValueError(f"qmm_plan: d_in {d_in} past "
                         f"{STREAM_MAX_SPLITS * QMM_MAX_SLICE_GROUPS * 2 * QK}")
    if d_out // _MMA_COLS >= n_sm:
        splits = least
        grid_x = min(units, max(1, n_sm // splits))
        if splits > 1:   # a split block takes its units in one pass
            grid_x = max(grid_x, -(-units // QMM_MAX_WARPS))
        warps = min(QMM_MAX_WARPS, -(-units // grid_x))
    else:
        warps = QMM_PROJ_WARPS
        grid_x = -(-units // warps)
        splits = min(STREAM_MAX_SPLITS, groups,
                     max(least, n_sm // grid_x))
    gpb = -(-groups // splits)
    return grid_x, -(-groups // gpb), warps


def qmm_plan(m: int, d_in: int, d_out: int, n_sm: int) -> tuple:
    """The route and grid of ``qmatmul`` for m <= 8 rows -> (grid_x,
    splits, warps): at projection widths (fewer 64-column tiles than SMs)
    of up to ``QMM_STREAM_MAX_D_IN`` rows the streaming GEMV's M <= 8 X'
    path on :func:`stream_plan`'s grid, with warps 0; elsewhere qmatmul's
    own kernel on :func:`qmm_kernel_plan`'s."""
    plan = qmm_kernel_plan(m, d_in, d_out, n_sm)   # checks the shape
    if (d_out // _MMA_COLS < n_sm and d_in <= QMM_STREAM_MAX_D_IN
            and d_out % _MMA_COLS == 0):
        return (*stream_plan(m, d_in, d_out, n_sm), 0)
    return plan


@functools.lru_cache(maxsize=None)
def _qmm_plan(index: int, m: int, d_in: int, d_out: int) -> tuple:
    return qmm_plan(m, d_in, d_out, _sm_count(index))


def _launch_qmatmul(x: torch.Tensor, qt: QuantizedTensor):
    """One launch on the M <= 8 rows as they come, on :func:`qmm_plan`'s
    route and grid."""
    bits = check_cuda_levels(qt, (), "qmatmul")
    d_in, d_out = qt.d_in, qt.d_out
    x = _cuda_x(x, d_in, "qmatmul")
    M = x.shape[0]
    if not supports(qt, M) or M < 1:
        raise ValueError(f"qmatmul: unsupported shape M={M} d_in={d_in} "
                         f"d_out={d_out}")
    grid_x, splits, warps = _qmm_plan(_device_index(x.device), M, d_in, d_out)
    y = torch.empty(M, d_out, dtype=torch.float32, device=x.device)
    err = cuda_lib.library("qmatmul").bgt_qmatmul(
        x.data_ptr(), qt.levels.data_ptr(), qt.scales.data_ptr(),
        cuda_lib.ptr(qt.mins), M, d_in, d_out, _offset(qt), bits, grid_x,
        splits, warps, y.data_ptr(), cuda_lib.stream_ptr(x.device))
    cuda_lib.LAUNCHES["qmatmul"] += 1
    cuda_lib.check(err, "qmatmul")
    return y


def _launch_wide(x: torch.Tensor, qt: QuantizedTensor):
    """One launch of the streaming GEMV on the M rows as they come."""
    bits = check_cuda_levels(qt, (), "qmatmul_wide")
    d_in, d_out = qt.d_in, qt.d_out
    x = _cuda_x(x, d_in, "qmatmul_wide")
    M = x.shape[0]
    if not supports_wide(qt, M):
        raise ValueError(f"qmatmul_wide: unsupported shape M={M} d_in={d_in} "
                         f"d_out={d_out}")
    grid_x, splits = _plan(_device_index(x.device), M, d_in, d_out)
    y = torch.empty(M, d_out, dtype=torch.float32, device=x.device)
    err = cuda_lib.library("qmatmul").bgt_qmatmul_wide(
        x.data_ptr(), qt.levels.data_ptr(), qt.scales.data_ptr(),
        cuda_lib.ptr(qt.mins), M, d_in, d_out, _offset(qt), bits, grid_x,
        splits, y.data_ptr(), cuda_lib.stream_ptr(x.device))
    cuda_lib.LAUNCHES["qmatmul_wide"] += 1
    cuda_lib.check(err, "qmatmul_wide")
    return y


def qmatmul(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """y = x @ dequant(qt) for M <= 8 rows -> (M, d_out) f32."""
    if x.is_cuda:
        return _launch_qmatmul(x, qt)
    return qmatmul_plain(x, qt)


def qmatmul_wide(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """y = x @ dequant(qt) for 8 < M <= 32 rows -> (M, d_out) f32."""
    if x.is_cuda:
        return _launch_wide(x, qt)
    return qmatmul_wide_plain(x, qt)


# at M = 16, 32 the tails' tensor-core GEMV (csrc/qgemv_mma.cuh): d_in at
# most 16 splits of 256 (one thread block cluster); at M <= 8 the streaming
# GEMV with every warp's A fragments held at once: 16 splits of 1024
_MMA_MAX_D_IN = 4096
_TAIL_MAX_D_IN = STREAM_MAX_SPLITS * STREAM_WARPS * STREAM_GPW * 2 * QK
# the tails' scratch, per (device, kernel rows, d_in, d_out)
_WORKSPACES: dict = {}


def tail_rows(M: int) -> int:
    """The rows a tail's kernel runs for M rows: M itself up to 8 (the
    streaming GEMV), else 16 or 32 (the M = 16, 32 GEMV; the wrapper pads
    with zero rows)."""
    return M if M <= 8 else 16 if M <= 16 else 32


def tail_workspace(dev: torch.device, Mk: int, d_in: int, d_out: int) -> dict:
    """The scratch of a tail at Mk kernel rows, made once per (device, Mk,
    d_in, d_out) and reused by every call on the stream: the per-(row,
    64-column tile) argmax triples ("bmax", "bidx", "bnan"; "bmax" is also
    the sampled tail's tile maxima) and, above 8 rows, the rows LayerNorm'd
    in bf16 ("xn")."""
    key = (dev, Mk, d_in, d_out)
    ws = _WORKSPACES.get(key)
    if ws is None:
        trip = torch.empty(3, Mk * (d_out // _MMA_COLS), dtype=torch.int32,
                           device=dev)
        ws = {"bmax": trip[0].view(torch.float32), "bidx": trip[1],
              "bnan": trip[2],
              "xn": (torch.empty(Mk, d_in, dtype=torch.bfloat16, device=dev)
                     if Mk > 8 else None)}
        _WORKSPACES[key] = ws
    return ws


def _tail_rows(x, ln_w, ln_b, qt: QuantizedTensor, n_valid: int, what: str):
    """Checked (x, ln_w, ln_b, M, level format, grid) of a tail; the grid
    is the M <= 8 GEMV's (:func:`stream_plan`), (0, 0) above."""
    bits = check_cuda_levels(qt, (), what)
    d_in, d_out = qt.d_in, qt.d_out
    x = _cuda_x(x, d_in, what)
    M = x.shape[0]
    ok = (0 < M <= 32 and d_out % LANES == 0 and 0 < n_valid <= d_out
          and d_in % (2 * QK) == 0 and d_in <= _TAIL_MAX_D_IN)
    grid = (0, 0)
    if ok and M <= 8:
        try:
            grid = _plan(_device_index(x.device), M, d_in, d_out)
        except ValueError:
            ok = False
    elif ok:
        ok = d_in <= _MMA_MAX_D_IN
    if not ok:
        raise ValueError(f"{what}: unsupported shape M={M} d_in={d_in} "
                         f"d_out={d_out} n_valid={n_valid}")
    ln_w = ln_w.to(torch.float32).contiguous()
    ln_b = ln_b.to(torch.float32).contiguous()
    return x, ln_w, ln_b, M, bits, grid


def _pad_rows(x: torch.Tensor, Mk: int) -> torch.Tensor:
    if Mk == x.shape[0]:
        return x
    return torch.cat([x, x.new_zeros(Mk - x.shape[0], x.shape[1])])


def _launch_argmax(x, ln_w, ln_b, qt, n_valid: int, ln_eps: float,
                   what: str):
    x, ln_w, ln_b, M, bits, (grid_x, splits) = _tail_rows(
        x, ln_w, ln_b, qt, n_valid, what)
    Mk = tail_rows(M)
    x = _pad_rows(x, Mk)
    dev = x.device
    ws = tail_workspace(dev, Mk, qt.d_in, qt.d_out)
    out = torch.empty(2, Mk, dtype=torch.int32, device=dev)
    ids, mv = out[0], out[1].view(torch.float32)
    lib = cuda_lib.library("lm_head_argmax")
    err = lib.bgt_lm_head_argmax(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), float(ln_eps),
        qt.levels.data_ptr(), qt.scales.data_ptr(), cuda_lib.ptr(qt.mins),
        Mk, qt.d_in, qt.d_out, _offset(qt), bits, n_valid,
        pick_tile(qt.d_out), grid_x, splits, ws["bmax"].data_ptr(),
        ws["bidx"].data_ptr(), ws["bnan"].data_ptr(), cuda_lib.ptr(ws["xn"]),
        ids.data_ptr(), mv.data_ptr(), cuda_lib.stream_ptr(dev))
    cuda_lib.LAUNCHES[what] += 1
    cuda_lib.check(err, what)
    return ids[:M], mv[:M]


def lm_head_argmax(x, ln_w, ln_b, qt: QuantizedTensor, n_valid: int,
                   ln_eps: float = 1e-5):
    """argmax(LN(x) @ dequant(qt)) over the first ``n_valid`` columns, M <=
    32 rows -> ((M,) int32 ids, (M,) f32 winning logits: the health lane's
    probe)."""
    if not x.is_cuda:
        return lm_head_argmax_plain(x, ln_w, ln_b, qt, n_valid, ln_eps)
    return _launch_argmax(x, ln_w, ln_b, qt, n_valid, ln_eps,
                          "lm_head_argmax")


def lm_head_argmax_commit(x, ln_w, ln_b, qt: QuantizedTensor, n_valid: int,
                          k_cache, v_cache, k_rows_t, v_rows_t, past,
                          ln_eps: float = 1e-5):
    """The batched greedy tail and the KV commit: ``lm_head_argmax`` of the
    B = M rows, then slot b's rows ``k_rows_t[b]`` (slot-major (B, L, D))
    committed at ``past[b]`` -> (ids, max logits, k_cache, v_cache)."""
    if not x.is_cuda:
        return lm_head_argmax_commit_plain(x, ln_w, ln_b, qt, n_valid,
                                           k_cache, v_cache, k_rows_t,
                                           v_rows_t, past, ln_eps)
    from .decode_kernels import kv_commit

    ids, mv = _launch_argmax(x, ln_w, ln_b, qt, n_valid, ln_eps,
                             "lm_head_argmax_commit")
    k_cache, v_cache = kv_commit(k_cache, v_cache, k_rows_t, v_rows_t, past)
    return ids, mv, k_cache, v_cache


def lm_head_logits_gmax_commit(x, ln_w, ln_b, qt: QuantizedTensor,
                               n_valid: int, k_cache, v_cache, k_rows_t,
                               v_rows_t, past, ln_eps: float = 1e-5):
    """The batched sampled tail and the KV commit -> (logits (M, d_out) f32
    with pad columns -1e30, their 128-column group maxima (M, d_out/128),
    k_cache, v_cache); the commit as in :func:`lm_head_argmax_commit`."""
    if not x.is_cuda:
        return lm_head_logits_gmax_commit_plain(
            x, ln_w, ln_b, qt, n_valid, k_cache, v_cache, k_rows_t, v_rows_t,
            past, ln_eps)
    from .decode_kernels import kv_commit

    what = "lm_head_logits_gmax_commit"
    x, ln_w, ln_b, M, bits, (grid_x, splits) = _tail_rows(
        x, ln_w, ln_b, qt, n_valid, what)
    Mk = tail_rows(M)   # rows are independent
    x = _pad_rows(x, Mk)
    dev = x.device
    ws = tail_workspace(dev, Mk, qt.d_in, qt.d_out)
    logits = torch.empty(Mk, qt.d_out, dtype=torch.float32, device=dev)
    gmax = torch.empty(Mk, qt.d_out // LANES, dtype=torch.float32, device=dev)
    lib = cuda_lib.library("lm_head_argmax")
    err = lib.bgt_lm_head_logits_gmax(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), float(ln_eps),
        qt.levels.data_ptr(), qt.scales.data_ptr(), cuda_lib.ptr(qt.mins),
        Mk, qt.d_in, qt.d_out, _offset(qt), bits, n_valid, grid_x, splits,
        logits.data_ptr(), gmax.data_ptr(), ws["bmax"].data_ptr(),
        cuda_lib.ptr(ws["xn"]), cuda_lib.stream_ptr(dev))
    cuda_lib.LAUNCHES[what] += 1
    cuda_lib.check(err, what)
    k_cache, v_cache = kv_commit(k_cache, v_cache, k_rows_t, v_rows_t, past)
    return logits[:M], gmax[:M], k_cache, v_cache
