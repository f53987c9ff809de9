"""The decode step through all layers, ``decode_step_fused``, and the
batched KV commits, ``kv_commit`` and ``kv_commit_quant``.

``decode_step_fused`` replaces ``biogpt_tpu/ops/pallas_decode.py::
decode_step_fused`` with a bf16 or an int8 KV cache: its B=1 path
(``_make_kernel``) and its batched lockstep path at 2 <= B <= 32
(``_make_kernel_batched``). Same contract:

    (x0 (B, D) f32, layers, k_cache, v_cache (L, B, S, D) bf16, past)
        -> (x (B, D) f32, k_rows, v_rows (L, B, D) bf16)

In the int8 mode (``k_scales``/``v_scales`` (L, B, 1, S) f32 given, the
caches int8 levels) each score column is multiplied by its row's K scale,
the V scale folds into p before p's bf16 rounding (the softmax denominator
sums raw p), the current token enters attention fake-quantized
(:func:`fake_quant_rows`), and the new rows leave in f32: the caller
quantizes them (``runtime.cache.quantize_rows``).

``layers`` are the engine-packed layer-stacked weights (fused ``qkv``,
packed 4/5-bit or unpacked Q8_0 planes, bf16 scales). ``past`` is the
host's int or a (1,) integer tensor at B=1 (on the card it is read there,
as the JAX kernel takes a traced position), and a (B,) integer tensor of
per-slot positions on the device at B >= 2. The
caller commits slot b's rows at its position; attention reads slot b's
cache rows ``< min(past[b], window)`` and the current token, never row
``past[b]`` itself. The two paths keep the TPU kernels' two numerics: X'
projections at B=1, dequant-then-dot (``_qmm_dq``) at every B >= 2.

``per_slot_kv=True`` is the paged step (``_make_kernel_paged``), at
1 <= B <= 32, bf16 or int8: each slot walks only its own live KV blocks of
:func:`kv_block_paged` rows, and every B, B=1 included, projects
dequant-then-dot. ``k_stage``/``v_stage`` (L, B, C, D) bf16 with the host
int ``step_i`` is the staged step (``_make_kernel_batched(staged=True)``,
bf16 cache, B >= 2, not paged): slot b reads its cache rows below
``min(past[b] - step_i, window)``, then the chunk's staged rows
``< step_i`` as one more block of the online softmax, then the current
token. Both take device positions at every B.

``kv_commit`` replaces ``pallas_decode.py::kv_commit_pallas``: each slot's
rows (B, L, D), slot-major, land at its own position in every layer's
cache. ``kv_commit_quant`` replaces ``kv_commit_quant_pallas``: the same
for int8 level rows and their f32 scales (B, L, 1). Both write the port's
mutable caches in place (the JAX calls donate their buffers and return new
ones) and return the same tensors.

``batched_attention`` is one layer's attention of the batched steps
alone (``csrc/attn_batched.cuh``, split by :func:`attn_plan`), with its
plain version :func:`batched_attention_plain`, which the batched steps'
plain versions call each layer.

``decode_gemv`` is one projection of the batched steps alone: their
tensor-core GEMV (``csrc/qgemv_mma.cuh``, the dequant-then-dot numerics of
``pallas_decode._qmm_dq``) with its LayerNorm prologue and its bias, GELU
or residual epilogue. ``decode_gemv_b1`` is the B=1 step's projection
alone: its M=1 GEMV (``csrc/qgemv_b1.cuh``, the X' numerics of
``pallas_decode._qmm``) with the same prologue and epilogues.

On CUDA tensors each function launches its hand-written Hopper kernels
(``csrc/decode_step.cu``, ``csrc/decode_batched.cu``,
``csrc/decode_paged.cu``, ``csrc/attn_batched.cuh``, ``csrc/kv_commit.cu``;
one host call each -- see those files for the designs and what bounds
them) or raises; on the CPU it runs its plain version, which transcribes
the TPU kernel's math, the online softmax over KV blocks and the bf16
roundings included.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..quant.codecs import QK
from ..quant.layouts import QuantizedTensor
from . import cuda_lib
from .qmatmul_kernels import (LANES, _offset, check_cuda_levels,
                              layer_norm_bf16, qmatmul_plain,
                              qmatmul_wide_plain)

# d_in chunk of the TPU kernel's matmul loops; it has no remainder path
_CHUNK = 32 * QK
# per-tensor VMEM budget that sized the TPU kernel's KV blocks
_KV_WINDOW_BYTES = 8 * 1024 * 1024
MAX_BATCH = 32     # slots of the batched step
_CUDA_HEAD_DIM = 64   # DK of csrc/decode_layers.cuh
# the paged kernel's KV block when it divides the window
# (pallas_decode._PAGED_KVB)
_PAGED_KVB = 128
_CUDA_MAX_KVB = 1024  # PG_MAX_KVB of csrc/attn_paged.cuh (the B=1 step)
# the batched steps' attention (csrc/attn_batched.cuh): the rows a CTA
# takes, and the kernel's limits
ATTN_ROWS_PER_CTA = 128
_ATTN_MAX_CLUSTER = 16
_ATTN_MAX_ROWS = 512
_ATTN_MAX_BLOCKS = 64


def supports_layers(layers: dict, cache_dtype, batch: int, n_new: int) -> bool:
    """Whether the fused step applies to these engine-packed layers
    (``pallas_decode.supports_layers``: 1 <= batch <= 32, one new token,
    fused packed planes of one format; the cache bf16, or int8 with scale
    planes, which the JAX engines let through by gating on bf16)."""
    if (not 1 <= batch <= MAX_BATCH or n_new != 1
            or cache_dtype not in (torch.bfloat16, torch.int8)):
        return False
    if "qkv" not in layers:
        return False
    qts = [layers[k]["w"] for k in ("qkv", "o", "fc1", "fc2")]
    if not all(isinstance(w, QuantizedTensor) for w in qts):
        return False
    q0 = qts[0]
    if not all(w.qtype == q0.qtype and w.packed == q0.packed for w in qts):
        return False
    if not all((w.mins is None) == (q0.mins is None) for w in qts):
        return False
    for w in qts:
        d_out, d_in = w.scales.shape[-1], w.scales.shape[-2] * QK
        if d_out % LANES != 0 or (w.packed and d_in % (2 * QK) != 0):
            return False
        if d_in > _CHUNK and d_in % _CHUNK != 0:
            return False
    return True


def kv_block(window: int, d_model: int = 1024, batch: int = 1) -> int:
    """The TPU kernel's KV block for a window (``pallas_decode._kv_block``;
    wide batches shrink it): the plain versions' online softmax walks the
    same blocks."""
    kvb = window
    while (kvb % 2 == 0 and kvb > 128
           and (kvb > 512 or batch * kvb * d_model * 2 > _KV_WINDOW_BYTES)):
        kvb //= 2
    return kvb


def kv_block_paged(window: int) -> int:
    """The paged kernel's KV block (``pallas_decode._kv_block_paged``): 128
    rows when they divide the window, else the lockstep block at B=1."""
    return _PAGED_KVB if window % _PAGED_KVB == 0 else kv_block(window)


def attn_plan(window: int, kvb: int, staged_rows: int = 0) -> tuple:
    """How the batched steps' attention (``csrc/attn_batched.cuh``) splits
    each (head, slot)'s rows -- its live cache rows of the window, then the
    ``staged_rows`` staged rows -> (cluster, rows_cap): a thread block
    cluster of ``cluster`` CTAs a (head, slot), CTA c taking the rows
    ``[c rows_cap, (c + 1) rows_cap)``. A window that one CTA's
    ``ATTN_ROWS_PER_CTA`` rows cover keeps one CTA, no cluster, while its
    staged rows fit beside it; else ``ATTN_ROWS_PER_CTA`` rows a CTA, at
    most 16, whose ranges then split the rows evenly. Each side was the
    faster for the staged step on an H100 (``chip_smoke.py::
    staged_plans``). Raises where the rows a CTA holds or the window's KV
    blocks of ``kvb`` rows (and the staged block) exceed the kernel's
    tables."""
    if window < 1 or kvb < 1 or staged_rows < 0:
        raise ValueError("attn_plan: window and kvb >= 1, staged_rows >= 0")
    rows = window + staged_rows
    if window <= ATTN_ROWS_PER_CTA and rows <= _ATTN_MAX_ROWS:
        cluster = 1
    else:
        cluster = min(-(-rows // ATTN_ROWS_PER_CTA), _ATTN_MAX_CLUSTER)
    rows_cap = -(-rows // cluster)
    if rows_cap > _ATTN_MAX_ROWS:
        raise ValueError(f"attn_plan: {rows} rows need {rows_cap} rows a "
                         f"CTA, over {_ATTN_MAX_ROWS}")
    if -(-window // kvb) + 1 > _ATTN_MAX_BLOCKS:
        raise ValueError(f"attn_plan: window {window} holds more than "
                         f"{_ATTN_MAX_BLOCKS - 1} KV blocks of {kvb} rows")
    return cluster, rows_cap


def fake_quant_rows(x: torch.Tensor) -> torch.Tensor:
    """Per-row absmax int8 quantize -> dequantize of the current token's k/v
    in the int8 mode (``pallas_decode._fake_quant_rows``). Its scale is
    ``amax * (1/127)``, where the cache's ``quantize_rows`` divides by 127:
    the two can differ by one ulp, and each is transcribed as written."""
    s = x.abs().amax(-1, keepdim=True) * (1.0 / 127.0)
    safe = torch.clamp(s, min=1e-12)
    return torch.clamp(torch.round(x / safe), -127, 127) * safe


def _scale_planes(k_cache, k_scales, v_scales):
    """Whether the caches are int8 levels with (L, B, 1, S) f32 scales."""
    if k_scales is None and v_scales is None:
        return False
    L, B, S, _ = k_cache.shape
    for t in (k_scales, v_scales):
        if t is None or tuple(t.shape) != (L, B, 1, S):
            raise ValueError("decode_step_fused: the int8 mode takes k_scales "
                             f"and v_scales of shape ({L}, {B}, 1, {S})")
    return True


def decode_step_fused_plain(x0, layers: dict, k_cache, v_cache, past: int, *,
                            n_head: int, window: int, ln_eps: float = 1e-5,
                            kv_block_size: int | None = None, k_scales=None,
                            v_scales=None):
    """Plain version of :func:`decode_step_fused` (pallas_decode.py:246-355,
    the int8 mode :288-318)."""
    L, B, S, D = k_cache.shape
    H = n_head
    Dk = D // H
    W = min(window, S)
    quant = _scale_planes(k_cache, k_scales, v_scales)
    if isinstance(past, torch.Tensor):   # a (1,) position
        past = int(past.reshape(-1)[0])
    if not 0 <= past < W:
        raise ValueError(f"past={past} outside the window {W}")
    KVB = kv_block_size or kv_block(W, D)
    if W % KVB:
        raise ValueError(f"window {W} not divisible by kv_block {KVB}")
    scale = 1.0 / math.sqrt(Dk)
    dev = x0.device
    row_dtype = torch.float32 if quant else k_cache.dtype
    x = x0.to(torch.float32).reshape(1, D)
    k_rows, v_rows = [], []
    for lyr in range(L):
        def w(name):
            return layers[name]["w"].map(lambda a: a[lyr])

        def b(name):
            return layers[name]["b"][lyr].to(torch.float32)

        h = layer_norm_bf16(x, layers["ln0"]["w"][lyr], layers["ln0"]["b"][lyr],
                            ln_eps)
        qkv = qmatmul_plain(h, w("qkv")) + b("qkv")
        q, k, v = qkv[:, :D] * scale, qkv[:, D:2 * D], qkv[:, 2 * D:]
        k_rows.append(k.to(row_dtype))
        v_rows.append(v.to(row_dtype))
        if quant:
            k, v = fake_quant_rows(k), fake_quant_rows(v)
        qh = q.to(torch.bfloat16).to(torch.float32).reshape(H, Dk)
        kh, vh = k.reshape(H, Dk), v.reshape(H, Dk)
        m = torch.full((H, 1), -1e30, device=dev)
        l = torch.zeros(H, 1, device=dev)
        acc = torch.zeros(H, Dk, device=dev)
        kc = k_cache[lyr, 0].to(torch.float32).reshape(S, H, Dk)
        vc = v_cache[lyr, 0].to(torch.float32).reshape(S, H, Dk)
        for j in range(W // KVB):
            blk = slice(j * KVB, (j + 1) * KVB)
            scores = torch.einsum("hd,shd->hs", qh, kc[blk])
            if quant:
                scores = scores * k_scales[lyr, 0, :, blk]
            valid = (torch.arange(KVB, device=dev) + j * KVB < past)[None, :]
            masked = torch.where(valid, scores, torch.full_like(scores, -1e30))
            m_new = torch.maximum(m, masked.amax(1, keepdim=True))
            p = torch.where(valid, torch.exp(scores - m_new),
                            torch.zeros_like(scores))
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(1, keepdim=True)
            if quant:
                p = p * v_scales[lyr, 0, :, blk]
            pb = p.to(torch.bfloat16).to(torch.float32)
            acc = acc * alpha + torch.einsum("hs,shd->hd", pb, vc[blk])
            m = m_new
        cur = (qh * kh).sum(1, keepdim=True)
        m_fin = torch.maximum(m, cur)
        alpha2 = torch.exp(m - m_fin)
        p_cur = torch.exp(cur - m_fin)
        ctx = ((acc * alpha2 + p_cur * vh) / (l * alpha2 + p_cur)).reshape(1, D)
        x = x + qmatmul_plain(ctx, w("o")) + b("o")
        h2 = layer_norm_bf16(x, layers["ln1"]["w"][lyr], layers["ln1"]["b"][lyr],
                             ln_eps)
        f = torch.nn.functional.gelu(qmatmul_plain(h2, w("fc1")) + b("fc1"))
        x = x + qmatmul_plain(f, w("fc2")) + b("fc2")
    return x, torch.stack(k_rows), torch.stack(v_rows)


def _softmax_block(m, l, acc, scores, valid, v, v_scale=None):
    """One KV block of the TPU kernels' online softmax over the (B, H)
    head-rows: m_new over the block's masked scores (B, H, n), raw p into
    the denominator, p (times its row's V scale) rounded to bf16 before
    p.V against ``v`` (B, n, H, Dk) -> (m, l, acc)."""
    masked = torch.where(valid, scores, torch.full_like(scores, -1e30))
    m_new = torch.maximum(m, masked.amax(-1, keepdim=True))
    p = torch.where(valid, torch.exp(scores - m_new), torch.zeros_like(scores))
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale
    pb = p.to(torch.bfloat16).to(torch.float32)
    return m_new, l, acc * alpha + torch.einsum("bhs,bshd->bhd", pb, v)


def batched_attention_plain(qkv, k_cache, v_cache, past, *, n_head: int,
                            window: int, kvb: int, k_scales=None,
                            v_scales=None, k_stage=None, v_stage=None,
                            step_i: int = 0):
    """Plain version of :func:`batched_attention`: one layer's attention of
    the batched steps (pallas_decode.py:479-497, the int8 mode :455-496,
    the staged rows :502-534). ``qkv`` (B, 3D) f32 with bias; ``k_cache``,
    ``v_cache`` this layer's (B, S, D), bf16 or int8 levels with
    ``k_scales``, ``v_scales`` (B, 1, S) f32; ``past`` (B,). The online
    softmax over KV blocks of ``kvb`` rows for all B*H head-rows at once
    over slot b's cache rows below ``min(past[b] - step_i, window)``; with
    ``k_stage`` (B, C, D) bf16, the staged rows ``< step_i`` fold in as one
    more block; then the current token (fake-quantized in the int8 mode)
    -> (ctx (B, D) f32, k_row, v_row (B, D): bf16, or f32 in the int8
    mode)."""
    B, S, D = k_cache.shape
    H = n_head
    Dk = D // H
    W = min(window, S)
    quant = k_scales is not None
    scale = 1.0 / math.sqrt(Dk)
    dev = qkv.device
    live = torch.as_tensor(past, device=dev).to(torch.int64).reshape(B) \
        - int(step_i)
    q, k, v = qkv[:, :D] * scale, qkv[:, D:2 * D], qkv[:, 2 * D:]
    row_dtype = torch.float32 if quant else k_cache.dtype
    k_row, v_row = k.to(row_dtype), v.to(row_dtype)
    if quant:
        k, v = fake_quant_rows(k), fake_quant_rows(v)
    qh = q.to(torch.bfloat16).to(torch.float32).reshape(B, H, Dk)
    kh, vh = k.reshape(B, H, Dk), v.reshape(B, H, Dk)
    m = torch.full((B, H, 1), -1e30, device=dev)
    l = torch.zeros(B, H, 1, device=dev)
    acc = torch.zeros(B, H, Dk, device=dev)
    kc = k_cache.to(torch.float32).reshape(B, S, H, Dk)
    vc = v_cache.to(torch.float32).reshape(B, S, H, Dk)
    for j in range(W // kvb):
        blk = slice(j * kvb, (j + 1) * kvb)
        scores = torch.einsum("bhd,bshd->bhs", qh, kc[:, blk])
        if quant:
            scores = scores * k_scales[:, :, blk]
        idx = torch.arange(kvb, device=dev) + j * kvb
        valid = idx[None, None, :] < live[:, None, None]
        m, l, acc = _softmax_block(m, l, acc, scores, valid, vc[:, blk],
                                   v_scales[:, :, blk] if quant else None)
    if k_stage is not None:
        C = k_stage.shape[1]
        ks_ = k_stage.to(torch.bfloat16).to(torch.float32)
        vs_ = v_stage.to(torch.bfloat16).to(torch.float32)
        scores = torch.einsum("bhd,bshd->bhs", qh, ks_.reshape(B, C, H, Dk))
        valid = (torch.arange(C, device=dev) < int(step_i))[None, None, :]
        m, l, acc = _softmax_block(m, l, acc, scores, valid,
                                   vs_.reshape(B, C, H, Dk))
    cur = (qh * kh).sum(-1, keepdim=True)
    m_fin = torch.maximum(m, cur)
    alpha2 = torch.exp(m - m_fin)
    p_cur = torch.exp(cur - m_fin)
    ctx = ((acc * alpha2 + p_cur * vh) / (l * alpha2 + p_cur)).reshape(B, D)
    return ctx, k_row, v_row


def _lockstep_plain(x0, layers: dict, k_cache, v_cache, past, *, n_head: int,
                    window: int, ln_eps: float, KVB: int, k_scales, v_scales,
                    k_stage=None, v_stage=None, step_i: int = 0):
    """The batched steps' math (pallas_decode.py:358-570, the paged kernel
    :573-751): per-slot positions ``past`` (B,), every projection
    dequant-then-dot, and each layer's attention
    (:func:`batched_attention_plain`) over KV blocks of ``KVB`` rows."""
    L, B, S, D = k_cache.shape
    W = min(window, S)
    quant = _scale_planes(k_cache, k_scales, v_scales)
    if W % KVB:
        raise ValueError(f"window {W} not divisible by kv_block {KVB}")
    dev = x0.device
    past = torch.as_tensor(past, device=dev).to(torch.int64).reshape(B)
    x = x0.to(torch.float32).reshape(B, D)
    k_rows, v_rows = [], []
    for lyr in range(L):
        def w(name):
            return layers[name]["w"].map(lambda a: a[lyr])

        def b(name):
            return layers[name]["b"][lyr].to(torch.float32)

        h = layer_norm_bf16(x, layers["ln0"]["w"][lyr], layers["ln0"]["b"][lyr],
                            ln_eps)
        qkv = qmatmul_wide_plain(h, w("qkv")) + b("qkv")
        ctx, k_row, v_row = batched_attention_plain(
            qkv, k_cache[lyr], v_cache[lyr], past, n_head=n_head,
            window=window, kvb=KVB,
            k_scales=k_scales[lyr] if quant else None,
            v_scales=v_scales[lyr] if quant else None,
            k_stage=None if k_stage is None else k_stage[lyr],
            v_stage=None if v_stage is None else v_stage[lyr], step_i=step_i)
        k_rows.append(k_row)
        v_rows.append(v_row)
        x = x + qmatmul_wide_plain(ctx, w("o")) + b("o")
        h2 = layer_norm_bf16(x, layers["ln1"]["w"][lyr], layers["ln1"]["b"][lyr],
                             ln_eps)
        f = torch.nn.functional.gelu(qmatmul_wide_plain(h2, w("fc1")) + b("fc1"))
        x = x + qmatmul_wide_plain(f, w("fc2")) + b("fc2")
    return x, torch.stack(k_rows), torch.stack(v_rows)


def decode_step_fused_batched_plain(x0, layers: dict, k_cache, v_cache, past,
                                   *, n_head: int, window: int,
                                   ln_eps: float = 1e-5,
                                   kv_block_size: int | None = None,
                                   k_scales=None, v_scales=None):
    """Plain version of the batched :func:`decode_step_fused`
    (pallas_decode.py:358-570, the int8 mode :438-439 and :455-496) over
    the TPU kernel's lockstep KV blocks. Its ``kv_groups`` only chooses
    which KV blocks it copies; the math is this."""
    _, B, S, D = k_cache.shape
    return _lockstep_plain(
        x0, layers, k_cache, v_cache, past, n_head=n_head, window=window,
        ln_eps=ln_eps, KVB=kv_block_size or kv_block(min(window, S), D, B),
        k_scales=k_scales, v_scales=v_scales)


def decode_step_fused_paged_plain(x0, layers: dict, k_cache, v_cache, past,
                                  *, n_head: int, window: int,
                                  ln_eps: float = 1e-5,
                                  kv_block_size: int | None = None,
                                  k_scales=None, v_scales=None):
    """Plain version of the paged :func:`decode_step_fused`
    (``_make_kernel_paged``, pallas_decode.py:573-751, its int8 mode
    :680-702), 1 <= B <= 32: dequant-then-dot projections at every B, and
    slot b's online softmax over its live blocks ``j < clip(ceil(past[b] /
    KVB), 1, W / KVB)`` of :func:`kv_block_paged` rows. It walks every
    block of the window: a block past a slot's live count is fully masked,
    which leaves m, l and acc unchanged bit for bit (alpha = 1, p = 0), so
    the walk equals the per-slot one."""
    return _lockstep_plain(
        x0, layers, k_cache, v_cache, past, n_head=n_head, window=window,
        ln_eps=ln_eps,
        KVB=kv_block_size or kv_block_paged(min(window, k_cache.shape[2])),
        k_scales=k_scales, v_scales=v_scales)


def decode_step_fused_staged_plain(x0, layers: dict, k_cache, v_cache, past,
                                   k_stage, v_stage, step_i, *, n_head: int,
                                   window: int, ln_eps: float = 1e-5,
                                   kv_block_size: int | None = None):
    """Plain version of the staged :func:`decode_step_fused`
    (``_make_kernel_batched(staged=True)``, pallas_decode.py:384-392,
    :472-475, :502-534): the lockstep blocks over slot b's cache rows below
    ``past[b] - step_i``, then its staged rows ``k_stage[:, b, :step_i]``
    as one block with its own running max, then the current token."""
    _, B, S, D = k_cache.shape
    return _lockstep_plain(
        x0, layers, k_cache, v_cache, past, n_head=n_head, window=window,
        ln_eps=ln_eps, KVB=kv_block_size or kv_block(min(window, S), D, B),
        k_scales=None, v_scales=None, k_stage=k_stage, v_stage=v_stage,
        step_i=step_i)


def kv_commit_plain(k_cache, v_cache, k_rows_t, v_rows_t, past):
    """Plain version of :func:`kv_commit`: slot b's rows ``k_rows_t[b]``
    (L, D) land at ``past[b]``, clamped into ``[0, S)``; in place."""
    S = k_cache.shape[2]
    pos = torch.clamp(past.to(torch.int64), 0, S - 1)
    slots = torch.arange(k_cache.shape[1], device=pos.device)
    k_cache[:, slots, pos] = k_rows_t.transpose(0, 1).to(k_cache.dtype)
    v_cache[:, slots, pos] = v_rows_t.transpose(0, 1).to(v_cache.dtype)
    return k_cache, v_cache


def kv_commit_quant_plain(k_cache, v_cache, ks, vs, kq_t, vq_t, ksc_t, vsc_t,
                          past):
    """Plain version of :func:`kv_commit_quant`: slot b's int8 rows
    ``kq_t[b]`` (L, D) and scales ``ksc_t[b]`` (L, 1) land at ``past[b]``,
    clamped into ``[0, S)``; in place."""
    S = k_cache.shape[2]
    pos = torch.clamp(past.to(torch.int64), 0, S - 1)
    slots = torch.arange(k_cache.shape[1], device=pos.device)
    k_cache[:, slots, pos] = kq_t.transpose(0, 1)
    v_cache[:, slots, pos] = vq_t.transpose(0, 1)
    ks[:, slots, 0, pos] = ksc_t[..., 0].transpose(0, 1).to(ks.dtype)
    vs[:, slots, 0, pos] = vsc_t[..., 0].transpose(0, 1).to(vs.dtype)
    return k_cache, v_cache, ks, vs


GEMV_ACTS = ("none", "gelu")


def _projection_plain(product, x, qt, bias, ln_w, ln_b, ln_eps, act,
                      residual):
    """A decode step's projection: LayerNorm (``layer_norm_bf16``) where
    ``ln_w`` is given, ``product(h, qt)``, then ``(residual + y) + bias``,
    or ``y + bias`` and exact-erf GELU."""
    h = x if ln_w is None else layer_norm_bf16(x, ln_w, ln_b, ln_eps)
    y = product(h, qt)
    b = 0.0 if bias is None else bias.to(torch.float32)
    if residual is not None:
        return (residual.to(torch.float32) + y) + b
    y = y + b
    return torch.nn.functional.gelu(y) if act == "gelu" else y


def decode_gemv_plain(x, qt: QuantizedTensor, bias=None, *, ln_w=None,
                      ln_b=None, ln_eps: float = 1e-5, act: str = "none",
                      residual=None):
    """Plain version of :func:`decode_gemv`: the batched steps' projection
    (``_lockstep_plain``) with the dequant-then-dot product
    (``qmatmul_wide_plain``)."""
    return _projection_plain(qmatmul_wide_plain, x, qt, bias, ln_w, ln_b,
                             ln_eps, act, residual)


def decode_gemv_b1_plain(x, qt: QuantizedTensor, bias=None, *, ln_w=None,
                         ln_b=None, ln_eps: float = 1e-5, act: str = "none",
                         residual=None):
    """Plain version of :func:`decode_gemv_b1`: the B=1 step's projection
    (:func:`decode_step_fused_plain`) with the X' product
    (``qmatmul_plain``)."""
    return _projection_plain(qmatmul_plain, x, qt, bias, ln_w, ln_b, ln_eps,
                             act, residual)


# --------------------------------------------------------------- wrappers

def _check_cuda_layers(layers: dict, L: int, D: int, batch: int,
                       what: str = "decode_step_fused") -> tuple:
    """Check the layer-stacked planes for the CUDA chains -> (level offset,
    level format) of their one format (``supports_layers``)."""
    if not supports_layers(layers, torch.bfloat16, batch, 1):
        raise ValueError(f"{what}: unsupported layer shapes")
    for name in ("qkv", "o", "fc1", "fc2"):
        bits = check_cuda_levels(layers[name]["w"], (L,), f"{what} {name}")
        b = layers[name]["b"]
        if (not b.is_cuda or not b.is_contiguous() or b.shape[0] != L
                or b.dtype != torch.float32):
            raise ValueError(f"{what}: {name} bias must be a contiguous f32 "
                             "layer-stacked CUDA tensor")
    qkv = layers["qkv"]["w"]
    if qkv.d_in != D:
        raise ValueError(f"{what}: qkv d_in != d_model")
    return _offset(qkv), bits


def _check_cuda_caches(k_cache, v_cache, what: str, k_scales=None,
                       v_scales=None) -> bool:
    """Check the caches for a CUDA kernel -> whether they are int8 levels
    with f32 scale planes (else bf16)."""
    quant = k_scales is not None or v_scales is not None
    dtype = torch.int8 if quant else torch.bfloat16
    if (k_cache.dtype != dtype or v_cache.dtype != dtype
            or not k_cache.is_cuda or not k_cache.is_contiguous()
            or not v_cache.is_contiguous() or v_cache.shape != k_cache.shape):
        raise ValueError(f"{what}: caches must be contiguous {dtype} CUDA "
                         "tensors (L, B, S, D) of one shape")
    if quant:
        L, B, S, _ = k_cache.shape
        for t in (k_scales, v_scales):
            if (t is None or t.dtype != torch.float32 or not t.is_cuda
                    or not t.is_contiguous() or tuple(t.shape) != (L, B, 1, S)):
                raise ValueError(f"{what}: scale planes must be contiguous "
                                 f"f32 CUDA tensors ({L}, {B}, 1, {S})")
    return quant


def _cuda_past(past, B: int, dev, what: str) -> torch.Tensor:
    """(B,) int32 per-slot positions on the card (no host read)."""
    if not isinstance(past, torch.Tensor):
        return torch.full((B,), int(past), dtype=torch.int32, device=dev)
    if (not past.is_cuda or past.numel() != B
            or past.dtype not in (torch.int32, torch.int64)):
        raise ValueError(f"{what}: past must be a ({B},) integer CUDA tensor")
    return past.reshape(B).to(torch.int32).contiguous()


def _layer_planes(layers: dict) -> list:
    out = []
    for name in ("qkv", "o", "fc1", "fc2"):
        qt = layers[name]["w"]
        out += [qt.levels.data_ptr(), qt.scales.data_ptr(),
                cuda_lib.ptr(qt.mins), layers[name]["b"].data_ptr()]
    return out


def _layer_norms(layers: dict) -> list:
    return [layers[n][k].to(torch.float32).contiguous()
            for n in ("ln0", "ln1") for k in ("w", "b")]


# output columns of a tensor-core GEMV block (MMA_COLS of csrc/qgemv_mma.cuh)
_MMA_COLS = 64
# the widest GEMV input: its d_in / 256 splits form one cluster of <= 16
_MMA_MAX_D_IN = 4096


def _kernel_rows(B: int) -> int:
    """The GEMV row count a batch runs at (8, 16 or 32); rows past B are
    zero padding."""
    return 8 if B <= 8 else 16 if B <= 16 else 32


def _check_gemv_width(layers: dict, what: str) -> None:
    """The tensor-core GEMVs (the batched chains' and the B=1 step's) take
    d_in <= 4096: their split-K blocks form one cluster of <= 16."""
    if max(layers[n]["w"].d_in for n in ("qkv", "fc2")) > _MMA_MAX_D_IN:
        raise NotImplementedError(
            f"{what}: the tensor-core GEMV takes d_in <= {_MMA_MAX_D_IN}")


def _gemv_scratch(M: int, dev) -> tuple:
    """(the LayerNorm statistics (M, 2) f32, the host int the C entry adds
    its GEMV launches to)."""
    return torch.empty(M, 2, dtype=torch.float32, device=dev), ctypes.c_int(0)


def _decode_step_b1(x0, layers, k_cache, v_cache, past, n_head: int,
                    window: int, ln_eps: float, k_scales, v_scales):
    what = "decode_step_fused_int8" if k_scales is not None else \
        "decode_step_fused"
    L, B, S, D = k_cache.shape
    if x0.shape[-1] != D or x0.numel() != D:
        raise ValueError(f"{what}: x0 must be (1, {D})")
    W = min(window, S)
    dev = x0.device
    if not isinstance(past, torch.Tensor) and not 0 <= past < W:
        raise ValueError(f"{what}: past={past} outside the window {W}")
    past = _cuda_past(past, 1, dev, what)
    offset, bits = _check_cuda_layers(layers, L, D, 1, what)
    _check_gemv_width(layers, what)
    if D != n_head * _CUDA_HEAD_DIM:
        raise NotImplementedError(
            f"{what}: the CUDA kernel is built for head width "
            f"{_CUDA_HEAD_DIM}, got {D // n_head}")
    kvb = kv_block(W, D)
    if kvb > _CUDA_MAX_KVB:
        raise ValueError(f"{what}: KV block {kvb} of window {W} exceeds "
                         f"{_CUDA_MAX_KVB} rows")
    F = layers["fc1"]["w"].d_out
    lib = cuda_lib.library("decode_step")
    f32 = dict(dtype=torch.float32, device=dev)
    x = x0.reshape(D).to(torch.float32).clone()
    row_dtype = torch.bfloat16 if k_scales is None else torch.float32
    k_rows = torch.empty(L, 1, D, dtype=row_dtype, device=dev)
    v_rows = torch.empty(L, 1, D, dtype=row_dtype, device=dev)
    qkv = torch.empty(3 * D, **f32)
    ctx = torch.empty(D, **f32)
    ff = torch.empty(F, **f32)
    n_gemv = ctypes.c_int(0)
    norms = _layer_norms(layers)
    err = lib.bgt_decode_step(
        x.data_ptr(), L, D, F, n_head, S, W, kvb, past.data_ptr(),
        float(ln_eps), offset, bits, *[t.data_ptr() for t in norms],
        *_layer_planes(layers), k_cache.data_ptr(), v_cache.data_ptr(),
        cuda_lib.ptr(k_scales), cuda_lib.ptr(v_scales), k_rows.data_ptr(),
        v_rows.data_ptr(), qkv.data_ptr(), ctx.data_ptr(), ff.data_ptr(),
        ctypes.addressof(n_gemv), cuda_lib.stream_ptr(dev))
    cuda_lib.LAUNCHES[what] += 1
    cuda_lib.LAUNCHES["decode_gemv_b1"] += n_gemv.value
    cuda_lib.check(err, what)
    return x.reshape(1, D), k_rows, v_rows


def _decode_step_batched(x0, layers, k_cache, v_cache, past, n_head: int,
                         window: int, ln_eps: float, k_scales, v_scales):
    what = "decode_step_fused_batched_int8" if k_scales is not None else \
        "decode_step_fused_batched"
    L, B, S, D = k_cache.shape
    if x0.shape != (B, D):
        raise ValueError(f"{what}: x0 must be ({B}, {D}), got "
                         f"{tuple(x0.shape)}")
    if D != n_head * _CUDA_HEAD_DIM:
        raise NotImplementedError(
            f"{what}: the CUDA kernel is built for head width "
            f"{_CUDA_HEAD_DIM}, got {D // n_head}")
    offset, bits = _check_cuda_layers(layers, L, D, B, what)
    _check_gemv_width(layers, what)
    dev = x0.device
    past = _cuda_past(past, B, dev, what)
    W = min(window, S)
    M = _kernel_rows(B)
    F = layers["fc1"]["w"].d_out
    kvb = kv_block(W, D, batch=B)
    cluster, rows_cap = attn_plan(W, kvb)
    lib = cuda_lib.library("decode_batched")
    f32 = dict(dtype=torch.float32, device=dev)
    x = torch.zeros(M, D, **f32)
    x[:B] = x0
    row_dtype = torch.bfloat16 if k_scales is None else torch.float32
    k_rows = torch.empty(L, B, D, dtype=row_dtype, device=dev)
    v_rows = torch.empty(L, B, D, dtype=row_dtype, device=dev)
    qkv = torch.empty(M, 3 * D, **f32)
    ctx = torch.zeros(M, D, **f32)
    ff = torch.empty(M, F, **f32)
    stats, n_gemv = _gemv_scratch(M, dev)
    n_attn = ctypes.c_int(0)
    norms = _layer_norms(layers)
    err = lib.bgt_decode_batched(
        x.data_ptr(), L, D, F, n_head, S, B, M, W, past.data_ptr(),
        float(ln_eps), offset, bits, *[t.data_ptr() for t in norms],
        *_layer_planes(layers),
        k_cache.data_ptr(), v_cache.data_ptr(), cuda_lib.ptr(k_scales),
        cuda_lib.ptr(v_scales), k_rows.data_ptr(), v_rows.data_ptr(),
        qkv.data_ptr(), ctx.data_ptr(), ff.data_ptr(), stats.data_ptr(), kvb,
        cluster, rows_cap, ctypes.addressof(n_gemv), ctypes.addressof(n_attn),
        cuda_lib.stream_ptr(dev))
    cuda_lib.LAUNCHES[what] += 1
    cuda_lib.LAUNCHES["decode_gemv"] += n_gemv.value
    cuda_lib.LAUNCHES["batched_attention"] += n_attn.value
    cuda_lib.check(err, what)
    return x[:B], k_rows, v_rows


def _decode_step_paged(x0, layers, k_cache, v_cache, past, n_head: int,
                       window: int, ln_eps: float, k_scales, v_scales,
                       k_stage, v_stage, step_i):
    """The paged step (bf16 or int8) or, with ``k_stage``, the staged step
    (``csrc/decode_paged.cu``): the batched chain with the batched
    attention over the paged or the staged step's KV blocks."""
    staged = k_stage is not None
    what = ("decode_step_fused_staged" if staged
            else "decode_step_fused_paged_int8" if k_scales is not None
            else "decode_step_fused_paged")
    L, B, S, D = k_cache.shape
    if x0.shape != (B, D):
        raise ValueError(f"{what}: x0 must be ({B}, {D}), got "
                         f"{tuple(x0.shape)}")
    if D != n_head * _CUDA_HEAD_DIM:
        raise NotImplementedError(
            f"{what}: the CUDA kernel is built for head width "
            f"{_CUDA_HEAD_DIM}, got {D // n_head}")
    offset, bits = _check_cuda_layers(layers, L, D, B, what)
    _check_gemv_width(layers, what)
    dev = x0.device
    past = _cuda_past(past, B, dev, what)
    W = min(window, S)
    kvb = kv_block(W, D, batch=B) if staged else kv_block_paged(W)
    C, step = 0, 0
    if staged:
        C = k_stage.shape[2]
        for t in (k_stage, v_stage):
            if (t is None or tuple(t.shape) != (L, B, C, D)
                    or t.dtype != torch.bfloat16 or not t.is_cuda
                    or not t.is_contiguous()):
                raise ValueError(f"{what}: k_stage and v_stage must be "
                                 f"contiguous bf16 CUDA tensors ({L}, {B}, C, "
                                 f"{D}) of one shape")
        if isinstance(step_i, torch.Tensor) and step_i.is_cuda:
            raise ValueError(f"{what}: step_i is the host loop's int")
        step = int(step_i)
        if not 0 <= step <= C:
            raise ValueError(f"{what}: step_i={step} outside [0, {C}]")
        attn_plan(W, kvb, C)   # the chunk's last step fits: raise at its first
    cluster, rows_cap = attn_plan(W, kvb, step)
    M = _kernel_rows(B)
    F = layers["fc1"]["w"].d_out
    lib = cuda_lib.library("decode_paged")
    f32 = dict(dtype=torch.float32, device=dev)
    x = torch.zeros(M, D, **f32)
    x[:B] = x0
    row_dtype = torch.bfloat16 if k_scales is None else torch.float32
    k_rows = torch.empty(L, B, D, dtype=row_dtype, device=dev)
    v_rows = torch.empty(L, B, D, dtype=row_dtype, device=dev)
    qkv = torch.empty(M, 3 * D, **f32)
    ctx = torch.zeros(M, D, **f32)
    ff = torch.empty(M, F, **f32)
    stats, n_gemv = _gemv_scratch(M, dev)
    n_attn = ctypes.c_int(0)
    norms = _layer_norms(layers)
    err = lib.bgt_decode_paged(
        x.data_ptr(), L, D, F, n_head, S, B, M, W, past.data_ptr(),
        float(ln_eps), offset, bits, *[t.data_ptr() for t in norms],
        *_layer_planes(layers),
        k_cache.data_ptr(), v_cache.data_ptr(), cuda_lib.ptr(k_scales),
        cuda_lib.ptr(v_scales), k_rows.data_ptr(), v_rows.data_ptr(),
        qkv.data_ptr(), ctx.data_ptr(), ff.data_ptr(), kvb, cluster,
        rows_cap, step, C, cuda_lib.ptr(k_stage), cuda_lib.ptr(v_stage),
        stats.data_ptr(), ctypes.addressof(n_gemv), ctypes.addressof(n_attn),
        cuda_lib.stream_ptr(dev))
    cuda_lib.LAUNCHES[what] += 1
    cuda_lib.LAUNCHES["decode_gemv"] += n_gemv.value
    cuda_lib.LAUNCHES["batched_attention"] += n_attn.value
    cuda_lib.check(err, what)
    return x[:B], k_rows, v_rows


def decode_step_fused(x0, layers: dict, k_cache, v_cache, past, *,
                      n_head: int, window: int, ln_eps: float = 1e-5,
                      k_scales=None, v_scales=None, per_slot_kv: bool = False,
                      k_stage=None, v_stage=None, step_i=None,
                      kv_groups: int | None = None):
    """One decode step over all layers (see the module docstring).
    ``past``: the host's int or a (1,) integer tensor at B=1, a (B,)
    integer tensor of per-slot positions at B >= 2 (and for the paged and
    staged steps at every B).
    ``window`` (a host int, >= the live positions + 1) bounds the rows
    attention reads and sizes the KV blocks. ``k_scales``/``v_scales``: the
    int8 mode's (L, B, 1, S) f32 scale planes; the rows then leave in f32.
    ``per_slot_kv``: the paged step. ``k_stage``/``v_stage``/``step_i``:
    the staged step. ``kv_groups`` changes no number (every step reads each
    slot's own live rows); it is checked as the JAX package checks it."""
    _, B, S, D = k_cache.shape
    staged = k_stage is not None
    if staged and (per_slot_kv or k_scales is not None or B == 1
                   or v_stage is None or step_i is None):
        raise ValueError("decode_step_fused: staged KV is the batched "
                         "lockstep serving path (bf16 cache, B >= 2, not "
                         "per-slot, k_stage, v_stage and step_i together)")
    W = min(window, S)
    if (kv_groups is not None and kv_groups > 1 and B > 1 and not per_slot_kv
            and W // kv_block(W, D, batch=B) > 1):
        if B % kv_groups:
            raise ValueError(f"batch {B} not divisible by kv_groups "
                             f"{kv_groups}")
        if staged:
            raise ValueError("kv_groups and staged KV do not compose")
    if not x0.is_cuda:
        if staged:
            return decode_step_fused_staged_plain(
                x0, layers, k_cache, v_cache, past, k_stage, v_stage, step_i,
                n_head=n_head, window=window, ln_eps=ln_eps)
        step = (decode_step_fused_paged_plain if per_slot_kv
                else decode_step_fused_plain if B == 1
                else decode_step_fused_batched_plain)
        return step(x0, layers, k_cache, v_cache, past, n_head=n_head,
                    window=window, ln_eps=ln_eps, k_scales=k_scales,
                    v_scales=v_scales)
    _check_cuda_caches(k_cache, v_cache, "decode_step_fused", k_scales,
                       v_scales)
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"decode_step_fused: batch {B} outside 1..{MAX_BATCH}")
    if per_slot_kv or staged:
        return _decode_step_paged(x0, layers, k_cache, v_cache, past, n_head,
                                  window, ln_eps, k_scales, v_scales, k_stage,
                                  v_stage, step_i)
    step = _decode_step_b1 if B == 1 else _decode_step_batched
    return step(x0, layers, k_cache, v_cache, past, n_head, window, ln_eps,
                k_scales, v_scales)


def batched_attention(qkv, k_cache, v_cache, past, *, n_head: int,
                      window: int, kvb: int, k_scales=None, v_scales=None,
                      k_stage=None, v_stage=None, step_i: int = 0):
    """One layer's attention of the batched steps alone, as they launch it
    (``csrc/attn_batched.cuh``, planned by :func:`attn_plan`): ``qkv`` (B,
    3D) f32 with bias, ``k_cache``, ``v_cache`` this layer's (B, S, D) bf16,
    or int8 levels with ``k_scales``, ``v_scales`` (B, 1, S) f32, ``past``
    (B,) integer positions, KV blocks of ``kvb`` rows; ``k_stage``,
    ``v_stage`` (B, C, D) bf16 with the host int ``step_i``: the staged
    rows -> (ctx (B, D) f32, k_row, v_row (B, D): bf16, or f32 in the int8
    mode). On the CPU it runs :func:`batched_attention_plain`."""
    if not qkv.is_cuda:
        return batched_attention_plain(
            qkv, k_cache, v_cache, past, n_head=n_head, window=window,
            kvb=kvb, k_scales=k_scales, v_scales=v_scales, k_stage=k_stage,
            v_stage=v_stage, step_i=step_i)
    what = "batched_attention"
    B, S, D = k_cache.shape
    quant = k_scales is not None or v_scales is not None
    _check_cuda_caches(k_cache[None], v_cache[None], what,
                       None if k_scales is None else k_scales[None],
                       None if v_scales is None else v_scales[None])
    if (qkv.shape != (B, 3 * D) or qkv.dtype != torch.float32
            or not qkv.is_contiguous()):
        raise ValueError(f"{what}: qkv must be a contiguous ({B}, {3 * D}) "
                         "f32 CUDA tensor")
    if D != n_head * _CUDA_HEAD_DIM:
        raise NotImplementedError(
            f"{what}: the CUDA kernel is built for head width "
            f"{_CUDA_HEAD_DIM}, got {D // n_head}")
    W = min(window, S)
    if W % kvb:
        raise ValueError(f"{what}: window {W} not divisible by kv_block {kvb}")
    C, step = 0, 0
    if k_stage is not None:
        C = k_stage.shape[1]
        for t in (k_stage, v_stage):
            if (t is None or tuple(t.shape) != (B, C, D) or quant
                    or t.dtype != torch.bfloat16 or not t.is_cuda
                    or not t.is_contiguous()):
                raise ValueError(f"{what}: k_stage and v_stage must be "
                                 f"contiguous bf16 CUDA tensors ({B}, C, {D}) "
                                 "beside a bf16 cache")
        step = int(step_i)
        if not 0 <= step <= C:
            raise ValueError(f"{what}: step_i={step} outside [0, {C}]")
    cluster, rows_cap = attn_plan(W, kvb, step)
    dev = qkv.device
    past = _cuda_past(past, B, dev, what)
    row_dtype = torch.float32 if quant else torch.bfloat16
    ctx = torch.empty(B, D, dtype=torch.float32, device=dev)
    k_row = torch.empty(B, D, dtype=row_dtype, device=dev)
    v_row = torch.empty(B, D, dtype=row_dtype, device=dev)
    err = cuda_lib.library("decode_paged").bgt_batched_attention(
        qkv.data_ptr(), D, n_head, B, S, W, past.data_ptr(), kvb, cluster,
        rows_cap, k_cache.data_ptr(), v_cache.data_ptr(),
        cuda_lib.ptr(k_scales), cuda_lib.ptr(v_scales), step, C,
        cuda_lib.ptr(k_stage), cuda_lib.ptr(v_stage), ctx.data_ptr(),
        k_row.data_ptr(), v_row.data_ptr(), cuda_lib.stream_ptr(dev))
    cuda_lib.LAUNCHES[what] += 1
    cuda_lib.check(err, what)
    return ctx, k_row, v_row


def kv_commit(k_cache, v_cache, k_rows_t, v_rows_t, past):
    """Commit slot b's new rows ``k_rows_t[b]``, ``v_rows_t[b]`` (slot-major
    (B, L, D)) at ``past[b]`` of every layer's cache, in place, and return
    the caches. ``past``: (B,) integer tensor; a position outside
    ``[0, S)`` is clamped into it, as dynamic_update_slice clamps."""
    if not k_cache.is_cuda:
        return kv_commit_plain(k_cache, v_cache, k_rows_t, v_rows_t, past)
    what = "kv_commit"
    _check_cuda_caches(k_cache, v_cache, what)
    L, B, S, D = k_cache.shape
    k_rows_t = k_rows_t.to(torch.bfloat16)
    v_rows_t = v_rows_t.to(torch.bfloat16)
    if (k_rows_t.shape != (B, L, D) or v_rows_t.shape != (B, L, D)
            or not k_rows_t.is_cuda or k_rows_t.stride() != v_rows_t.stride()
            or k_rows_t.stride(2) != 1):
        raise ValueError(f"{what}: rows must be ({B}, {L}, {D}) CUDA tensors "
                         "of one layout, rows contiguous")
    sb, sl = k_rows_t.stride(0), k_rows_t.stride(1)
    if (D % 8 or sb % 8 or sl % 8 or k_rows_t.data_ptr() % 16
            or v_rows_t.data_ptr() % 16):
        raise ValueError(f"{what}: rows must be 16-byte aligned (D % 8 == 0)")
    past = _cuda_past(past, B, k_cache.device, what)
    err = cuda_lib.library(what).bgt_kv_commit(
        k_cache.data_ptr(), v_cache.data_ptr(), k_rows_t.data_ptr(),
        v_rows_t.data_ptr(), sb, sl, past.data_ptr(), L, B, S, D,
        cuda_lib.stream_ptr(k_cache.device))
    cuda_lib.LAUNCHES[what] += 1
    cuda_lib.check(err, what)
    return k_cache, v_cache


def kv_commit_quant(k_cache, v_cache, ks, vs, kq_t, vq_t, ksc_t, vsc_t, past):
    """Commit slot b's int8 rows ``kq_t[b]``, ``vq_t[b]`` (slot-major
    (B, L, D)) and their scales ``ksc_t[b]``, ``vsc_t[b]`` ((B, L, 1) f32)
    at ``past[b]`` of every layer's levels and scale planes, in place, and
    return the four. A position outside ``[0, S)`` is clamped into it."""
    if not k_cache.is_cuda:
        return kv_commit_quant_plain(k_cache, v_cache, ks, vs, kq_t, vq_t,
                                     ksc_t, vsc_t, past)
    what = "kv_commit_quant"
    _check_cuda_caches(k_cache, v_cache, what, ks, vs)
    L, B, S, D = k_cache.shape
    if (kq_t.shape != (B, L, D) or vq_t.shape != (B, L, D)
            or kq_t.dtype != torch.int8 or vq_t.dtype != torch.int8
            or not kq_t.is_cuda or kq_t.stride() != vq_t.stride()
            or kq_t.stride(2) != 1):
        raise ValueError(f"{what}: level rows must be ({B}, {L}, {D}) int8 "
                         "CUDA tensors of one layout, rows contiguous")
    sb, sl = kq_t.stride(0), kq_t.stride(1)
    if (D % 16 or sb % 16 or sl % 16 or kq_t.data_ptr() % 16
            or vq_t.data_ptr() % 16):
        raise ValueError(f"{what}: rows must be 16-byte aligned (D % 16 == 0)")
    ksc_t = ksc_t.to(torch.float32)
    vsc_t = vsc_t.to(torch.float32)
    if (ksc_t.shape != (B, L, 1) or vsc_t.shape != (B, L, 1)
            or ksc_t.stride() != vsc_t.stride() or not ksc_t.is_cuda):
        raise ValueError(f"{what}: scales must be ({B}, {L}, 1) CUDA tensors "
                         "of one layout")
    past = _cuda_past(past, B, k_cache.device, what)
    err = cuda_lib.library("kv_commit").bgt_kv_commit_quant(
        k_cache.data_ptr(), v_cache.data_ptr(), ks.data_ptr(), vs.data_ptr(),
        kq_t.data_ptr(), vq_t.data_ptr(), sb, sl, ksc_t.data_ptr(),
        vsc_t.data_ptr(), ksc_t.stride(0), ksc_t.stride(1), past.data_ptr(),
        L, B, S, D, cuda_lib.stream_ptr(k_cache.device))
    cuda_lib.LAUNCHES[what] += 1
    cuda_lib.check(err, what)
    return k_cache, v_cache, ks, vs


def _check_epilogue(what: str, act: str, residual, ln_w, ln_b) -> None:
    if act not in GEMV_ACTS or (residual is not None and act != "none"):
        raise ValueError(f"{what}: act {act!r} with residual="
                         f"{residual is not None}")
    if (ln_w is None) != (ln_b is None):
        raise ValueError(f"{what}: ln_w and ln_b go together")


def _cuda_vec(t, n: int, name: str, what: str):
    """``t`` as a contiguous (n,) f32 CUDA vector, or None."""
    if t is None:
        return None
    if not t.is_cuda or t.numel() != n:
        raise ValueError(f"{what}: {name} must be a ({n},) CUDA tensor")
    return t.reshape(n).to(torch.float32).contiguous()


def _gemv_operands(what: str, qt: QuantizedTensor, bias, ln_w, ln_b) -> tuple:
    """Check a projection's planes for the tensor-core GEMVs (d_in a
    multiple of 64 up to 4096, d_out of 64) -> (level format, bias, ln_w,
    ln_b as contiguous f32 CUDA vectors or None)."""
    bits = check_cuda_levels(qt, (), what)
    d_in, d_out = qt.d_in, qt.d_out
    if d_out % _MMA_COLS or d_in % (2 * QK) or d_in > _MMA_MAX_D_IN:
        raise ValueError(f"{what}: d_in {d_in} (a multiple of 64 up to "
                         f"{_MMA_MAX_D_IN}) and d_out {d_out} (of "
                         f"{_MMA_COLS}) unsupported")
    return (bits, _cuda_vec(bias, d_out, "bias", what),
            _cuda_vec(ln_w, d_in, "ln_w", what),
            _cuda_vec(ln_b, d_in, "ln_b", what))


def decode_gemv(x, qt: QuantizedTensor, bias=None, *, ln_w=None, ln_b=None,
                ln_eps: float = 1e-5, act: str = "none", residual=None):
    """One projection of the batched decode steps alone: ``x`` (M, d_in)
    f32, 1 <= M <= 32, LayerNorm'd first where ``ln_w``/``ln_b`` are given,
    times the dequantized planes ``qt``, then ``(residual + y) + bias``
    where ``residual`` (M, d_out) is given, else ``y + bias`` and, with
    ``act="gelu"``, exact-erf GELU -> (M, d_out) f32. ``bias`` may be None.
    On CUDA tensors it launches the steps' tensor-core GEMV
    (``csrc/qgemv_mma.cuh``) at 8, 16 or 32 rows."""
    what = "decode_gemv"
    _check_epilogue(what, act, residual, ln_w, ln_b)
    if not x.is_cuda:
        return decode_gemv_plain(x, qt, bias, ln_w=ln_w, ln_b=ln_b,
                                 ln_eps=ln_eps, act=act, residual=residual)
    bits, bias, ln_w, ln_b = _gemv_operands(what, qt, bias, ln_w, ln_b)
    d_in, d_out = qt.d_in, qt.d_out
    if x.dim() != 2 or x.shape[1] != d_in or not 1 <= x.shape[0] <= MAX_BATCH:
        raise ValueError(f"{what}: x must be (M <= {MAX_BATCH}, {d_in}), got "
                         f"{tuple(x.shape)}")
    rows = x.shape[0]
    M = _kernel_rows(rows)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    xk = torch.zeros(M, d_in, **f32)
    xk[:rows] = x
    y = torch.zeros(M, d_out, **f32)
    if residual is not None:
        if tuple(residual.shape) != (rows, d_out) or not residual.is_cuda:
            raise ValueError(f"{what}: residual must be ({rows}, {d_out})")
        y[:rows] = residual
    lib = cuda_lib.library("decode_batched")
    stats, _ = _gemv_scratch(M, dev)
    err = lib.bgt_decode_gemv(
        xk.data_ptr(), M, d_in, d_out, cuda_lib.ptr(ln_w), cuda_lib.ptr(ln_b),
        float(ln_eps), qt.levels.data_ptr(), qt.scales.data_ptr(),
        cuda_lib.ptr(qt.mins), _offset(qt), bits, cuda_lib.ptr(bias),
        2 if residual is not None else GEMV_ACTS.index(act),
        y.data_ptr() if residual is not None else None, y.data_ptr(),
        stats.data_ptr(), cuda_lib.stream_ptr(dev))
    cuda_lib.LAUNCHES[what] += 1
    cuda_lib.check(err, what)
    return y[:rows]


def decode_gemv_b1(x, qt: QuantizedTensor, bias=None, *, ln_w=None,
                   ln_b=None, ln_eps: float = 1e-5, act: str = "none",
                   residual=None):
    """One projection of the B=1 decode step alone: ``x`` (1, d_in) f32,
    LayerNorm'd first where ``ln_w``/``ln_b`` are given, times the planes
    ``qt`` in the X' numerics of ``pallas_decode._qmm`` (per-block f32
    partials of the uncentered levels, then offset, scale and min), then
    ``(residual + y) + bias`` where ``residual`` (1, d_out) is given, else
    ``y + bias`` and, with ``act="gelu"``, exact-erf GELU -> (1, d_out)
    f32. ``bias`` may be None. On CUDA tensors it launches the step's M=1
    GEMV (``csrc/qgemv_b1.cuh``)."""
    what = "decode_gemv_b1"
    _check_epilogue(what, act, residual, ln_w, ln_b)
    if not x.is_cuda:
        return decode_gemv_b1_plain(x, qt, bias, ln_w=ln_w, ln_b=ln_b,
                                    ln_eps=ln_eps, act=act, residual=residual)
    bits, bias, ln_w, ln_b = _gemv_operands(what, qt, bias, ln_w, ln_b)
    d_in, d_out = qt.d_in, qt.d_out
    if x.numel() != d_in or x.shape[-1] != d_in:
        raise ValueError(f"{what}: x must be (1, {d_in}), got "
                         f"{tuple(x.shape)}")
    dev = x.device
    res = _cuda_vec(residual, d_out, "residual", what)
    xk = x.reshape(d_in).to(torch.float32).contiguous()
    y = torch.empty(d_out, dtype=torch.float32, device=dev)
    err = cuda_lib.library("decode_step").bgt_decode_gemv_b1(
        xk.data_ptr(), d_in, d_out, cuda_lib.ptr(ln_w), cuda_lib.ptr(ln_b),
        float(ln_eps), qt.levels.data_ptr(), qt.scales.data_ptr(),
        cuda_lib.ptr(qt.mins), _offset(qt), bits, cuda_lib.ptr(bias),
        2 if residual is not None else GEMV_ACTS.index(act), cuda_lib.ptr(res),
        y.data_ptr(), cuda_lib.stream_ptr(dev))
    cuda_lib.LAUNCHES[what] += 1
    cuda_lib.check(err, what)
    return y.reshape(1, d_out)
