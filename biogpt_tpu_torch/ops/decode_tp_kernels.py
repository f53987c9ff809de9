"""The tensor-parallel decode step, ``decode_step_fused_tp``, and its
per-layer kernel halves (``biogpt_tpu/ops/pallas_decode_tp.py``).

Under tensor parallelism a whole-model decode kernel cannot run: the o and
fc2 projections are row-parallel, and their partial sums meet in an
all-reduce between ranks, which no kernel can do. So each layer runs as
halves with the collectives between them, for one rank's shard of the
weights (``parallel/tp.py::pack_params_tp`` + ``shard_params_tp``: the qkv
columns (q_s | k_s | v_s), fc1's columns, o's and fc2's d_in rows of a
chunk-packed plane) and its (L, B, S, D / tp) KV shard:

  :func:`tp_attn_half`   LN0, the local qkv, attention over the H / tp
                         local heads and the local cache rows, ctx times
                         the local o rows -> a PARTIAL (B, D) f32 with no
                         bias, and the layer's local K/V rows (B, D / tp)
  sum over the shards; residual; + o bias
  :func:`tp_ffn_half`    LN1, local fc1 + bias, exact erf GELU, local fc2
                         -> a PARTIAL (B, D) f32 with no bias
  sum over the shards; residual; + fc2 bias

With an int8 KV cache the row scale is the FULL row's absmax, which needs
a max over the shards, so LN0 + qkv run first on their own
(:func:`tp_qkv_half`, (B, 3D / tp) f32 and the local absmax); the k and v
rows quantize with the all-reduced absmax (``runtime.cache.quantize_rows``,
bit-equal to the per-op path's cache) and :func:`tp_attn_half` takes q and
the dequantized k and v from the caller (``q``, ``k_cur``, ``v_cur``).

Each half keeps the TPU kernel's arithmetic: dequant-then-dot projections
(``_qmm_dq``: the weight dequantized in f32 and rounded once to bf16, x
rounded to bf16), q rounded to bf16 before the scores, the online softmax
over the lockstep KV blocks ``_kv_block(W, B, D / tp)`` (raw p into the
denominator, in int8 each score times its row's K scale and the V scale
folded into p, p rounded to bf16 before p.V), the current token last.

On CUDA tensors each half launches its hand-written Hopper kernel chain
(``csrc/decode_tp.cu``) or raises; on the CPU it runs its plain version
(``tp_*_half_plain``). :func:`decode_step_fused_tp` is one rank's step
with the mesh's collectives between the halves; :func:`decode_step_tp_shards`
runs every shard's halves in this process and sums their partials in shard
order where the all-reduce would.
"""

from __future__ import annotations

import math
from functools import reduce

import torch

from ..quant.codecs import QK
from ..quant.layouts import QuantizedTensor
from . import cuda_lib
from .decode_kernels import (MAX_BATCH, _CHUNK, _CUDA_HEAD_DIM, _CUDA_MAX_KVB,
                             _MMA_MAX_D_IN, _check_cuda_caches, _cuda_past,
                             _softmax_block, kv_block)
from .qmatmul_kernels import (LANES, _offset, check_cuda_levels,
                              layer_norm_bf16, qmatmul_wide_plain)


def supports_layers_tp(layers: dict, tp: int, batch: int) -> bool:
    """Whether the TP step applies to these TP-packed layers
    (``pallas_decode_tp.supports_layers_tp``): 1 <= batch <= 32, a fused
    qkv, every projection quantized in one format, and the LOCAL widths
    lane aligned (column-parallel qkv and fc1 shard d_out, row-parallel o
    and fc2 shard d_in). The halves' tensor-core GEMV also takes a local
    d_in of at most 4096 (its split-K blocks form one cluster of <= 16),
    which the TPU gate does not ask."""
    if not 1 <= batch <= MAX_BATCH or tp < 1:
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
    for name, w in zip(("qkv", "o", "fc1", "fc2"), qts):
        d_out, d_in = w.scales.shape[-1], w.scales.shape[-2] * QK
        if name in ("qkv", "fc1"):
            if d_out % tp:
                return False
            d_out //= tp
        else:
            if d_in % tp:
                return False
            d_in //= tp
        if d_out % LANES or (w.packed and d_in % (2 * QK)):
            return False
        if d_in > _CHUNK and d_in % _CHUNK:
            return False
        if d_in > _MMA_MAX_D_IN:
            return False
    return True


def _w(layers: dict, name: str, li: int) -> QuantizedTensor:
    return layers[name]["w"].map(lambda a: a[li])


def _b(layers: dict, name: str, li: int) -> torch.Tensor:
    return layers[name]["b"][li].to(torch.float32)


# --------------------------------------------------------------- plain

def tp_qkv_half_plain(x, layers: dict, li: int, *, ln_eps: float = 1e-5):
    """Plain version of :func:`tp_qkv_half` (``_make_qkv_kernel_tp``):
    LN0 and the local qkv of layer ``li`` -> ((B, 3Dl) f32, (B, 2) the
    absmax of each slot's local k and v rows)."""
    h = layer_norm_bf16(x, layers["ln0"]["w"][li], layers["ln0"]["b"][li],
                        ln_eps)
    qkv = qmatmul_wide_plain(h, _w(layers, "qkv", li)) + _b(layers, "qkv", li)
    Dl = qkv.shape[-1] // 3
    amax = torch.stack([qkv[:, Dl:2 * Dl].abs().amax(-1),
                        qkv[:, 2 * Dl:].abs().amax(-1)], dim=-1)
    return qkv, amax


def tp_attn_half_plain(x, layers: dict, li: int, k_cache, v_cache, past, *,
                       n_head: int, window: int, ln_eps: float = 1e-5,
                       kv_block_size: int | None = None, k_scales=None,
                       v_scales=None, q=None, k_cur=None, v_cur=None):
    """Plain version of :func:`tp_attn_half` (``_make_attn_kernel_tp``):
    ``n_head`` local heads over the (L, B, S, Dl) cache shard of layer
    ``li`` -> the partial (B, D) f32 and, on a bf16 cache, the layer's
    local K/V rows (B, Dl) in its dtype. The int8 mode (``k_scales``) takes
    ``q`` (scaled) and the dequantized ``k_cur``, ``v_cur`` (B, Dl) and
    returns the partial alone."""
    L, B, S, Dl = k_cache.shape
    H, Dk = n_head, Dl // n_head
    W = min(window, S)
    KVB = kv_block_size or kv_block(W, Dl, B)
    if W % KVB:
        raise ValueError(f"window {W} not divisible by kv_block {KVB}")
    quant = k_scales is not None
    dev = k_cache.device
    rows = None
    if quant:
        k, v = k_cur.to(torch.float32), v_cur.to(torch.float32)
    else:
        h = layer_norm_bf16(x, layers["ln0"]["w"][li], layers["ln0"]["b"][li],
                            ln_eps)
        qkv = (qmatmul_wide_plain(h, _w(layers, "qkv", li))
               + _b(layers, "qkv", li))
        q = qkv[:, :Dl] * (1.0 / math.sqrt(Dk))
        k, v = qkv[:, Dl:2 * Dl], qkv[:, 2 * Dl:]
        rows = (k.to(k_cache.dtype), v.to(v_cache.dtype))
    qh = q.to(torch.bfloat16).to(torch.float32).reshape(B, H, Dk)
    kh, vh = k.reshape(B, H, Dk), v.reshape(B, H, Dk)
    live = torch.as_tensor(past, device=dev).to(torch.int64).reshape(B)
    m = torch.full((B, H, 1), -1e30, device=dev)
    l = torch.zeros(B, H, 1, device=dev)
    acc = torch.zeros(B, H, Dk, device=dev)
    kc = k_cache[li].to(torch.float32).reshape(B, S, H, Dk)
    vc = v_cache[li].to(torch.float32).reshape(B, S, H, Dk)
    for j in range(W // KVB):
        blk = slice(j * KVB, (j + 1) * KVB)
        scores = torch.einsum("bhd,bshd->bhs", qh, kc[:, blk])
        if quant:
            scores = scores * k_scales[li, :, :, blk]
        idx = torch.arange(KVB, device=dev) + j * KVB
        valid = idx[None, None, :] < live[:, None, None]
        m, l, acc = _softmax_block(m, l, acc, scores, valid, vc[:, blk],
                                   v_scales[li, :, :, blk] if quant else None)
    cur = (qh * kh).sum(-1, keepdim=True)
    m_fin = torch.maximum(m, cur)
    alpha2 = torch.exp(m - m_fin)
    p_cur = torch.exp(cur - m_fin)
    ctx = ((acc * alpha2 + p_cur * vh) / (l * alpha2 + p_cur)).reshape(B, Dl)
    part = qmatmul_wide_plain(ctx, _w(layers, "o", li))
    return part if quant else (part, *rows)


def tp_ffn_half_plain(x, layers: dict, li: int, *, ln_eps: float = 1e-5):
    """Plain version of :func:`tp_ffn_half` (``_make_ffn_kernel_tp``): LN1,
    local fc1 + bias, exact GELU, local fc2 -> the partial (B, D) f32."""
    h2 = layer_norm_bf16(x, layers["ln1"]["w"][li], layers["ln1"]["b"][li],
                         ln_eps)
    f = torch.nn.functional.gelu(qmatmul_wide_plain(h2, _w(layers, "fc1", li))
                                 + _b(layers, "fc1", li))
    return qmatmul_wide_plain(f, _w(layers, "fc2", li))


# --------------------------------------------------------------- CUDA

def _rows(B: int) -> int:
    """The kernels' padded row count for B slots."""
    return 8 if B <= 8 else 16 if B <= 16 else 32


def _check(layers: dict, names, what: str) -> tuple:
    """The local planes of ``names`` for the CUDA chain -> (L, level offset,
    level format)."""
    L = layers["ln0"]["w"].shape[0]
    bits = {check_cuda_levels(layers[n]["w"], (L,), f"{what} {n}")
            for n in names}
    w0 = layers[names[0]]["w"]
    if len(bits) != 1 or any((layers[n]["w"].mins is None)
                             != (w0.mins is None) for n in names):
        raise ValueError(f"{what}: the projections differ in format")
    for n in names:
        b = layers[n]["b"]
        if (not b.is_cuda or not b.is_contiguous() or b.dtype != torch.float32
                or b.shape[0] != L):
            raise ValueError(f"{what}: {n} bias must be a contiguous f32 "
                             "layer-stacked CUDA tensor")
    return L, _offset(w0), bits.pop()


def _planes(qt: QuantizedTensor) -> list:
    return [qt.levels.data_ptr(), qt.scales.data_ptr(), cuda_lib.ptr(qt.mins)]


def _norm(layers: dict, name: str) -> list:
    return [layers[name][k].to(torch.float32).contiguous() for k in ("w", "b")]


def _padded(x, M: int, what: str):
    B, D = x.shape
    if not x.is_cuda:
        raise ValueError(f"{what}: x must be a CUDA tensor")
    out = torch.zeros(M, D, dtype=torch.float32, device=x.device)
    out[:B] = x
    return out


def _stats(M: int, dev) -> torch.Tensor:
    """The GEMVs' LayerNorm statistics scratch, (M, 2) f32."""
    return torch.empty(M, 2, dtype=torch.float32, device=dev)


def _li(li: int, L: int, what: str) -> int:
    li = int(li)
    if not 0 <= li < L:
        raise ValueError(f"{what}: layer {li} outside 0..{L - 1}")
    return li


def tp_qkv_half(x, layers: dict, li: int, *, ln_eps: float = 1e-5):
    """LN0 and the local qkv of layer ``li`` (bias included) -> (qkv
    (B, 3Dl) f32, (B, 2) f32 the local absmax of each slot's k and v)."""
    if not x.is_cuda:
        return tp_qkv_half_plain(x, layers, li, ln_eps=ln_eps)
    what = "tp_qkv_half"
    L, offset, bits = _check(layers, ("qkv",), what)
    li = _li(li, L, what)
    B, D = x.shape
    qw = layers["qkv"]["w"]
    Dl = qw.d_out // 3
    if not 1 <= B <= MAX_BATCH or qw.d_in != D or Dl % _CUDA_HEAD_DIM:
        raise ValueError(f"{what}: x ({B}, {D}) against qkv planes "
                         f"({qw.d_in}, {qw.d_out})")
    M = _rows(B)
    lib = cuda_lib.library("decode_tp")
    xp = _padded(x, M, what)
    f32 = dict(dtype=torch.float32, device=x.device)
    stats = _stats(M, x.device)
    qkv = torch.empty(M, 3 * Dl, **f32)
    amax = torch.empty(B, 2, **f32)
    ln = _norm(layers, "ln0")
    err = lib.bgt_tp_qkv(
        xp.data_ptr(), L, li, D, Dl, B, M, float(ln_eps), offset, bits,
        *[t.data_ptr() for t in ln], *_planes(qw),
        layers["qkv"]["b"].data_ptr(), stats.data_ptr(), qkv.data_ptr(),
        amax.data_ptr(), cuda_lib.stream_ptr(x.device))
    cuda_lib.LAUNCHES[what] += 1
    cuda_lib.check(err, what)
    return qkv[:B], amax


def tp_attn_half(x, layers: dict, li: int, k_cache, v_cache, past, *,
                 n_head: int, window: int, ln_eps: float = 1e-5,
                 kv_block_size: int | None = None, k_scales=None,
                 v_scales=None, q=None, k_cur=None, v_cur=None):
    """The attention half of layer ``li`` for this shard (see the module
    docstring): ``n_head`` local heads, ``past`` (B,) per-slot positions,
    ``window`` (>= the live positions + 1) the rows attention reads ->
    (partial (B, D) f32, k_row, v_row (B, Dl) bf16), or in the int8 mode
    (``k_scales``, ``v_scales``, with ``q``, ``k_cur``, ``v_cur``) the
    partial alone."""
    quant = k_scales is not None
    if not k_cache.is_cuda:
        return tp_attn_half_plain(
            x, layers, li, k_cache, v_cache, past, n_head=n_head,
            window=window, ln_eps=ln_eps, kv_block_size=kv_block_size,
            k_scales=k_scales, v_scales=v_scales, q=q, k_cur=k_cur,
            v_cur=v_cur)
    what = "tp_attn_half_int8" if quant else "tp_attn_half"
    _check_cuda_caches(k_cache, v_cache, what, k_scales, v_scales)
    L, offset, bits = _check(layers, ("qkv", "o"), what)
    li = _li(li, L, what)
    _, B, S, Dl = k_cache.shape
    D = layers["o"]["w"].d_out
    if Dl != n_head * _CUDA_HEAD_DIM or layers["o"]["w"].d_in != Dl:
        raise ValueError(f"{what}: {n_head} local heads of width "
                         f"{_CUDA_HEAD_DIM} against a cache row of {Dl}")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"{what}: batch {B} outside 1..{MAX_BATCH}")
    W = min(window, S)
    kvb = kv_block_size or kv_block(W, Dl, B)
    if W % kvb or kvb > _CUDA_MAX_KVB:
        raise ValueError(f"{what}: KV block {kvb} of window {W}")
    dev = k_cache.device
    M = _rows(B)
    past = _cuda_past(past, B, dev, what)
    lib = cuda_lib.library("decode_tp")
    f32 = dict(dtype=torch.float32, device=dev)
    stats = _stats(M, dev)
    ctx = torch.zeros(M, Dl, **f32)
    out = torch.empty(M, D, **f32)
    ext = [None] * 3
    k_row = v_row = xp = qkv = None
    if quant:
        ext = [t.to(torch.float32).contiguous() for t in (q, k_cur, v_cur)]
        if any(t.shape != (B, Dl) or not t.is_cuda for t in ext):
            raise ValueError(f"{what}: q, k_cur, v_cur must be ({B}, {Dl}) "
                             "CUDA tensors")
    else:
        if x.shape != (B, D):
            raise ValueError(f"{what}: x must be ({B}, {D})")
        xp = _padded(x, M, what)
        qkv = torch.empty(M, 3 * Dl, **f32)
        k_row = torch.empty(B, Dl, dtype=k_cache.dtype, device=dev)
        v_row = torch.empty(B, Dl, dtype=k_cache.dtype, device=dev)
    ln = _norm(layers, "ln0")
    qw, ow = layers["qkv"]["w"], layers["o"]["w"]
    err = lib.bgt_tp_attn(
        cuda_lib.ptr(xp), L, li, D, Dl, n_head, S, B, M, W, kvb,
        past.data_ptr(), float(ln_eps), offset, bits,
        *[t.data_ptr() for t in ln], *_planes(qw),
        layers["qkv"]["b"].data_ptr(), *_planes(ow), k_cache.data_ptr(),
        v_cache.data_ptr(), cuda_lib.ptr(k_scales), cuda_lib.ptr(v_scales),
        *[cuda_lib.ptr(t) for t in ext], cuda_lib.ptr(k_row),
        cuda_lib.ptr(v_row), stats.data_ptr(), cuda_lib.ptr(qkv),
        ctx.data_ptr(), out.data_ptr(), cuda_lib.stream_ptr(dev))
    cuda_lib.LAUNCHES[what] += 1
    cuda_lib.check(err, what)
    return out[:B] if quant else (out[:B], k_row, v_row)


def tp_ffn_half(x, layers: dict, li: int, *, ln_eps: float = 1e-5):
    """The FFN half of layer ``li`` for this shard -> the partial (B, D)
    f32 (no bias)."""
    if not x.is_cuda:
        return tp_ffn_half_plain(x, layers, li, ln_eps=ln_eps)
    what = "tp_ffn_half"
    L, offset, bits = _check(layers, ("fc1", "fc2"), what)
    li = _li(li, L, what)
    B, D = x.shape
    w1, w2 = layers["fc1"]["w"], layers["fc2"]["w"]
    Fl = w1.d_out
    if (not 1 <= B <= MAX_BATCH or w1.d_in != D or w2.d_in != Fl
            or w2.d_out != D):
        raise ValueError(f"{what}: x ({B}, {D}) against fc1 ({w1.d_in}, "
                         f"{Fl}) and fc2 ({w2.d_in}, {w2.d_out})")
    M = _rows(B)
    lib = cuda_lib.library("decode_tp")
    xp = _padded(x, M, what)
    f32 = dict(dtype=torch.float32, device=x.device)
    stats = _stats(M, x.device)
    ff = torch.empty(M, Fl, **f32)
    out = torch.empty(M, D, **f32)
    ln = _norm(layers, "ln1")
    err = lib.bgt_tp_ffn(
        xp.data_ptr(), L, li, D, Fl, M, float(ln_eps), offset, bits,
        *[t.data_ptr() for t in ln], *_planes(w1),
        layers["fc1"]["b"].data_ptr(), *_planes(w2), stats.data_ptr(),
        ff.data_ptr(), out.data_ptr(), cuda_lib.stream_ptr(x.device))
    cuda_lib.LAUNCHES[what] += 1
    cuda_lib.check(err, what)
    return out[:B]


# --------------------------------------------------------------- the step

def _tp_step(x0, shards: list, past, *, n_head: int, tp_size: int,
             window: int, ln_eps: float, kv_block: int | None, all_sum,
             all_max, plain: bool, trace: list | None, quantize=None):
    """The layer loop over this process' ``shards`` (dicts of ``layers``,
    ``k_cache``, ``v_cache`` and, int8, ``k_scales``, ``v_scales``), the
    partials combined by ``all_sum`` (a list -> their sum over every
    shard) and the int8 absmax by ``all_max``, through the halves' kernels
    or, ``plain``, their plain versions; ``trace`` collects each layer's x;
    ``quantize`` quantizes the int8 current rows (default
    ``runtime.cache.quantize_rows``) -> (x, per-shard row lists)."""
    if quantize is None:
        from ..runtime.cache import quantize_rows as quantize
    tp_qkv, tp_attn, tp_ffn = ((tp_qkv_half_plain, tp_attn_half_plain,
                                tp_ffn_half_plain) if plain
                               else (tp_qkv_half, tp_attn_half, tp_ffn_half))
    quant = shards[0].get("k_scales") is not None
    lay0 = shards[0]["layers"]
    L = lay0["ln0"]["w"].shape[0]
    Hl = n_head // tp_size
    qscale = 1.0 / math.sqrt(shards[0]["k_cache"].shape[-1] // Hl)
    x = x0.to(torch.float32)
    rows = [[[] for _ in range(4 if quant else 2)] for _ in shards]
    kw = dict(n_head=Hl, window=window, ln_eps=ln_eps, kv_block_size=kv_block)
    for li in range(L):
        parts = []
        if quant:
            outs = [tp_qkv(x, s["layers"], li, ln_eps=ln_eps) for s in shards]
            amax = all_max([a for _, a in outs])
            for s, (qkv, _), r in zip(shards, outs, rows):
                Dl = qkv.shape[-1] // 3
                kq, ksc = quantize(qkv[:, Dl:2 * Dl], amax=amax[:, 0])
                vq, vsc = quantize(qkv[:, 2 * Dl:], amax=amax[:, 1])
                parts.append(tp_attn(
                    x, s["layers"], li, s["k_cache"], s["v_cache"], past,
                    k_scales=s["k_scales"], v_scales=s["v_scales"],
                    q=qkv[:, :Dl] * qscale, k_cur=kq.float() * ksc[:, None],
                    v_cur=vq.float() * vsc[:, None], **kw))
                for acc, t in zip(r, (kq, vq, ksc, vsc)):
                    acc.append(t)
        else:
            for s, r in zip(shards, rows):
                part, k_row, v_row = tp_attn(
                    x, s["layers"], li, s["k_cache"], s["v_cache"], past, **kw)
                parts.append(part)
                r[0].append(k_row)
                r[1].append(v_row)
        x = x + all_sum(parts) + lay0["o"]["b"][li].to(torch.float32)
        fparts = [tp_ffn(x, s["layers"], li, ln_eps=ln_eps) for s in shards]
        x = x + all_sum(fparts) + lay0["fc2"]["b"][li].to(torch.float32)
        if trace is not None:
            trace.append(x)
    return x, [[torch.stack(t) for t in r] for r in rows]


def decode_step_fused_tp(x0, layers: dict, k_cache, v_cache, past, *,
                         n_head: int, tp_size: int, mesh, window: int,
                         ln_eps: float = 1e-5, kv_block: int | None = None,
                         k_scales=None, v_scales=None, plain: bool = False):
    """One rank's TP decode step (``pallas_decode_tp.decode_step_fused_tp``).

    ``x0`` (B, D) f32 the embedded input, the same on every rank;
    ``layers`` this rank's TP-packed layer shards; ``k_cache``/``v_cache``
    (L, B, S, D / tp) its KV shard; ``past`` (B,) per-slot positions;
    ``n_head`` the FULL head count; ``mesh`` the model axis
    (``parallel.mesh``), whose sum all-reduces the halves' partials.
    Returns (x (B, D) f32, the same on every rank, k_rows, v_rows
    (L, B, D / tp) bf16), or with ``k_scales``/``v_scales`` (L, B, 1, S)
    (an int8 shard) (x, kq, vq (L, B, D / tp) int8, ksc, vsc (L, B) f32):
    the caller commits slot b's rows at its position. ``plain`` runs the
    halves' plain versions (on any device: the step the kernels are held
    to)."""
    shard = {"layers": layers, "k_cache": k_cache, "v_cache": v_cache,
             "k_scales": k_scales, "v_scales": v_scales}
    x, (rows,) = _tp_step(
        x0, [shard], past, n_head=n_head, tp_size=tp_size, window=window,
        ln_eps=ln_eps, kv_block=kv_block,
        all_sum=lambda parts: mesh.sum(parts[0]),
        all_max=lambda parts: mesh.max(parts[0]), plain=plain, trace=None)
    return (x, *rows)


def decode_step_tp_shards(x0, shards: list, past, *, n_head: int,
                          window: int, ln_eps: float = 1e-5,
                          kv_block: int | None = None, plain: bool = False,
                          trace: list | None = None, quantize=None):
    """Every shard's TP step in this process: ``shards`` a list, in model
    order, of dicts with ``layers``, ``k_cache``, ``v_cache`` (and for an
    int8 cache ``k_scales``, ``v_scales``); the partials are summed in
    shard order, and the int8 absmax is their maximum, where the ranks'
    all-reduces would combine them -> (x, [each shard's rows as
    :func:`decode_step_fused_tp` returns them]). ``plain``: the halves'
    plain versions; ``trace``: a list that collects each layer's x;
    ``quantize(x, amax=)``: the int8 current rows' quantization, by
    default ``runtime.cache.quantize_rows`` (a check can replay another
    run's rows through it)."""
    return _tp_step(
        x0, shards, past, n_head=n_head, tp_size=len(shards), window=window,
        ln_eps=ln_eps, kv_block=kv_block,
        all_sum=lambda parts: reduce(torch.add, parts),
        all_max=lambda parts: reduce(torch.maximum, parts), plain=plain,
        trace=trace, quantize=quantize)
