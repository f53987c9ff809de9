"""Single-stream decode step through all layers: ``decode_step_fused``.

Replaces ``biogpt_tpu/ops/pallas_decode.py::decode_step_fused`` on its B=1
path with a bf16 KV cache (``_make_kernel``). Same contract:

    (x0 (1, D) f32, layers, k_cache, v_cache (L, 1, S, D) bf16, past)
        -> (x (1, D) f32, k_rows, v_rows (L, 1, D) bf16)

``layers`` are the engine-packed layer-stacked weights (fused ``qkv``,
packed 4-bit planes, bf16 scales). The caller commits the returned rows at
position ``past``; attention reads cache rows ``< past`` and the current
token, never row ``past`` itself.

On a CUDA tensor the step runs the hand-written chain of per-layer Hopper
kernels in ``csrc/decode_step.cu`` (one host call per token; see that file
for the design and what bounds it) or raises; on the CPU it runs
:func:`decode_step_fused_plain`, which transcribes the TPU kernel's math,
its online softmax over KV blocks and bf16 roundings included.
"""

from __future__ import annotations

import math

import torch

from ..quant.codecs import QK
from ..quant.layouts import LEVEL_OFFSET, QuantizedTensor
from . import cuda_lib
from .qmatmul_kernels import CUDA_QTYPES, LANES, layer_norm_bf16, qmatmul_plain

# d_in chunk of the TPU kernel's matmul loops; it has no remainder path
_CHUNK = 32 * QK
# per-tensor VMEM budget that sized the TPU kernel's KV blocks
_KV_WINDOW_BYTES = 8 * 1024 * 1024


def supports_layers(layers: dict, cache_dtype, batch: int, n_new: int) -> bool:
    """Whether the fused step applies to these engine-packed layers
    (``pallas_decode.supports_layers``; this slice runs batch 1)."""
    if batch != 1 or n_new != 1 or cache_dtype != torch.bfloat16:
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


def kv_block(window: int, d_model: int = 1024) -> int:
    """The TPU kernel's KV block for a B=1 window (``pallas_decode._kv_block``):
    the plain version's online softmax walks the same blocks."""
    kvb = window
    while (kvb % 2 == 0 and kvb > 128
           and (kvb > 512 or kvb * d_model * 2 > _KV_WINDOW_BYTES)):
        kvb //= 2
    return kvb


def decode_step_fused_plain(x0, layers: dict, k_cache, v_cache, past: int, *,
                            n_head: int, window: int, ln_eps: float = 1e-5,
                            kv_block_size: int | None = None):
    """Plain version of :func:`decode_step_fused` (pallas_decode.py:246-355)."""
    L, B, S, D = k_cache.shape
    H = n_head
    Dk = D // H
    W = min(window, S)
    if not 0 <= past < W:
        raise ValueError(f"past={past} outside the window {W}")
    KVB = kv_block_size or kv_block(W, D)
    if W % KVB:
        raise ValueError(f"window {W} not divisible by kv_block {KVB}")
    scale = 1.0 / math.sqrt(Dk)
    dev = x0.device
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
        k_rows.append(k.to(k_cache.dtype))
        v_rows.append(v.to(v_cache.dtype))
        qh = q.to(torch.bfloat16).to(torch.float32).reshape(H, Dk)
        kh, vh = k.reshape(H, Dk), v.reshape(H, Dk)
        m = torch.full((H, 1), -1e30, device=dev)
        l = torch.zeros(H, 1, device=dev)
        acc = torch.zeros(H, Dk, device=dev)
        kc = k_cache[lyr, 0].to(torch.float32).reshape(S, H, Dk)
        vc = v_cache[lyr, 0].to(torch.float32).reshape(S, H, Dk)
        for j in range(W // KVB):
            kb, vb = kc[j * KVB:(j + 1) * KVB], vc[j * KVB:(j + 1) * KVB]
            scores = torch.einsum("hd,shd->hs", qh, kb)
            valid = (torch.arange(KVB, device=dev) + j * KVB < past)[None, :]
            masked = torch.where(valid, scores, torch.full_like(scores, -1e30))
            m_new = torch.maximum(m, masked.amax(1, keepdim=True))
            p = torch.where(valid, torch.exp(scores - m_new),
                            torch.zeros_like(scores))
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(1, keepdim=True)
            pb = p.to(torch.bfloat16).to(torch.float32)
            acc = acc * alpha + torch.einsum("hs,shd->hd", pb, vb)
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


def _check_cuda_layers(layers: dict, L: int, D: int) -> None:
    for name in ("qkv", "o", "fc1", "fc2"):
        qt = layers[name]["w"]
        if not qt.packed or qt.qtype not in CUDA_QTYPES:
            raise NotImplementedError(
                "decode_step_fused: the CUDA kernel takes packed Q4_0/Q4_1 "
                "planes; Q5_0/Q5_1 and Q8_0 are a later slice of the port")
        for t in (qt.levels, qt.scales, qt.mins, layers[name]["b"]):
            if t is not None and (not t.is_cuda or not t.is_contiguous()
                                  or t.shape[0] != L):
                raise ValueError(f"decode_step_fused: {name} planes must be "
                                 "contiguous layer-stacked CUDA tensors")
        if (qt.scales.dtype != torch.bfloat16 or qt.levels.dtype != torch.uint8
                or layers[name]["b"].dtype != torch.float32):
            raise ValueError(f"decode_step_fused: {name} needs uint8 levels, "
                             "bf16 scales and f32 biases")
    if not supports_layers(layers, torch.bfloat16, 1, 1):
        raise ValueError("decode_step_fused: unsupported layer shapes")
    if layers["qkv"]["w"].d_in != D:
        raise ValueError("decode_step_fused: qkv d_in != d_model")


def decode_step_fused(x0, layers: dict, k_cache, v_cache, past: int, *,
                      n_head: int, window: int, ln_eps: float = 1e-5):
    """One decode step over all layers (see the module docstring).
    ``past`` is the host's Python int; ``window`` (>= past + 1) sizes the
    plain version's KV blocks and bounds ``past`` on the card."""
    if not x0.is_cuda:
        return decode_step_fused_plain(x0, layers, k_cache, v_cache, past,
                                       n_head=n_head, window=window,
                                       ln_eps=ln_eps)
    what = "decode_step_fused"
    L, B, S, D = k_cache.shape
    if B != 1 or x0.shape[-1] != D or x0.numel() != D:
        raise NotImplementedError(f"{what}: this slice runs B=1 (got B={B}); "
                                  "the batched kernel is a later slice")
    if (k_cache.dtype != torch.bfloat16 or v_cache.dtype != torch.bfloat16
            or not k_cache.is_contiguous() or not v_cache.is_contiguous()
            or v_cache.shape != k_cache.shape):
        raise ValueError(f"{what}: caches must be contiguous bf16 (L,1,S,D)")
    if not 0 <= past < min(window, S):
        raise ValueError(f"{what}: past={past} outside the window "
                         f"{min(window, S)}")
    _check_cuda_layers(layers, L, D)
    lib = cuda_lib.library("decode_step")
    DK = lib.bgt_decode_head_dim()
    if D != n_head * DK:
        raise NotImplementedError(f"{what}: the CUDA kernel is built for "
                                  f"head width {DK}, got {D // n_head}")
    F = layers["fc1"]["w"].d_out
    dev = x0.device
    x = x0.reshape(D).to(torch.float32).clone()
    k_rows = torch.empty(L, 1, D, dtype=torch.bfloat16, device=dev)
    v_rows = torch.empty(L, 1, D, dtype=torch.bfloat16, device=dev)
    ns = max(1, -(-past // 64))
    f32 = dict(dtype=torch.float32, device=dev)
    part = torch.empty(lib.bgt_decode_part_size(D, F), **f32)
    ml = torch.empty(n_head * ns * 2, **f32)
    acc = torch.empty(n_head * ns * DK, **f32)
    ctx = torch.empty(D, **f32)
    ff = torch.empty(F, **f32)

    def planes(name):
        qt = layers[name]["w"]
        return [qt.levels.data_ptr(), qt.scales.data_ptr(),
                cuda_lib.ptr(qt.mins), layers[name]["b"].data_ptr()]

    norms = [layers[n][k].to(torch.float32).contiguous()
             for n in ("ln0", "ln1") for k in ("w", "b")]
    err = lib.bgt_decode_step(
        x.data_ptr(), L, D, F, n_head, S, int(past), float(ln_eps),
        LEVEL_OFFSET[layers["qkv"]["w"].qtype],
        *[t.data_ptr() for t in norms],
        *planes("qkv"), *planes("o"), *planes("fc1"), *planes("fc2"),
        k_cache.data_ptr(), v_cache.data_ptr(), k_rows.data_ptr(),
        v_rows.data_ptr(), part.data_ptr(), ml.data_ptr(), acc.data_ptr(),
        ctx.data_ptr(), ff.data_ptr(), cuda_lib.stream_ptr(dev))
    cuda_lib.LAUNCHES[what] += 1
    cuda_lib.check(err, what)
    return x.reshape(1, D), k_rows, v_rows
