"""The fresh-cache prompt forward of the serving refills, ``prefill_fused``.

Replaces ``biogpt_tpu/ops/pallas_prefill.py::prefill_fused`` (body
``_make_prefill_kernel``). Same contract:

    (x0 (R*T, D) f32 -- R prompts padded to T tokens, embedded, layers)
        -> (x (R*T, D) f32 before the final LN,
            k_rows, v_rows (L, R*T, D) bf16)

Position t of prompt p lives at flattened row p*T + t. The cache starts
empty, so attention is causal self-attention within each prompt; rows past
a prompt's length hold causally computed padding values that no later read
reaches. Per layer, as the TPU kernel computes it: LayerNorm in f32 rounded
to bf16; the fused qkv projection dequant-then-dot (``_qmm_dq``: each
weight rounded once to bf16, f32 accumulation); q scaled by 1/sqrt(Dk);
q and k in bf16 for the scores; a full (not online) causal softmax in f32
per prompt and head, normalised before p rounds to bf16, then P.V against
bf16 V; the o projection and its residual; LayerNorm; fc1 with exact-erf
GELU; fc2 and its residual.

On CUDA tensors ``prefill_fused`` launches the hand-written Hopper kernels
of ``csrc/prefill.cu`` (one host call for all layers; see that file for the
design and what bounds it) or raises; on the CPU it runs
:func:`prefill_fused_plain`. :func:`prefill_gemm` runs one of its
projections alone through the same GEMM (the wgmma kernel with its qkv,
residual or GELU epilogue; :func:`prefill_gemm_plain` on the CPU).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_lib
from .decode_kernels import (_check_cuda_layers, _layer_norms, _layer_planes,
                             supports_layers)
from .qmatmul_kernels import (CUDA_FORMATS, _offset as _qt_offset,
                              check_cuda_levels, layer_norm_bf16,
                              qmatmul_wide_plain)

# Routing caps on the flattened rows R*T, kept from the TPU gate
# (pallas_prefill.py:59-61): there they came from VMEM, here they decide
# which refill shapes take this path and which the per-op forward, so the
# port sends the same shapes down the same numerics as the JAX package.
_MAX_RT = 512
_MAX_RT_SHORT = 1024
_SHORT_T = 128
HEAD_DIM = 64     # the head width csrc/prefill.cu is built for
MAX_T = 512       # its longest prompt: a 64-row tile's f32 scores in smem
# the GEMM's epilogues (csrc/prefill.cu's EPI_*): q (scaled), k, v in bf16;
# the residual (x + y) + bias in f32; GELU(y + bias) in bf16
GEMM_EPILOGUES = ("qkv", "resid", "gelu")
_GEMM_BLOCK_COLS = 128   # d_out in whole tiles of the GEMM's narrower width
_GEMM_STEP = 64          # its k-step: one packed group of 32 rows


def gemm_widths_ok(d_in: int, d_out: int) -> bool:
    """Whether the refill GEMM takes a (d_in, d_out) weight
    (``csrc/prefill.cu::gemm_widths_ok``): d_in in whole k-steps, d_out in
    whole 128-column tiles (256-column ones where they divide it)."""
    return (d_in > 0 and d_out > 0 and d_in % _GEMM_STEP == 0
            and d_out % _GEMM_BLOCK_COLS == 0)


def supports_prefill(layers: dict, rows: int, padded: int, *, n_head: int,
                     n_positions: int) -> bool:
    """Whether a refill group of ``rows`` prompts padded to ``padded``
    tokens takes :func:`prefill_fused`. The R*T caps are the JAX package's
    routing caps (R*T <= 512, or <= 1024 when T <= 128); the kernel itself
    needs fused planes of one format as the engines prepare them
    (``supports_layers``: packed Q4_0/Q4_1/Q5_0/Q5_1 or unpacked Q8_0, as
    the JAX gate lets packed and unpacked planes through), head width 64
    and T <= n_positions, and every projection's widths taken by the GEMM
    (``gemm_widths_ok``, which the layer gate already implies). The TPU
    gate's ``padded % 8`` and ``d_model % 128`` come from Mosaic tiling
    and are not kept (the layer gate already implies the second)."""
    rt = rows * padded
    cap = _MAX_RT_SHORT if padded <= _SHORT_T else _MAX_RT
    if rows < 1 or not 0 < padded <= n_positions or rt > cap:
        return False
    if not supports_layers(layers, torch.bfloat16, batch=1, n_new=1):
        return False
    qkv = layers["qkv"]["w"]
    return ((qkv.qtype, qkv.packed) in CUDA_FORMATS
            and qkv.d_in == n_head * HEAD_DIM
            and all(gemm_widths_ok(layers[n]["w"].d_in, layers[n]["w"].d_out)
                    for n in ("qkv", "o", "fc1", "fc2")))


def prefill_fused_plain(x0, layers: dict, *, rows: int, padded: int,
                        n_head: int, ln_eps: float = 1e-5,
                        cache_dtype=torch.bfloat16):
    """Plain version of :func:`prefill_fused` (pallas_prefill.py:74-166)."""
    R, T = rows, padded
    D = x0.shape[-1]
    H = n_head
    Dk = D // H
    L = layers["ln0"]["w"].shape[0]
    scale = 1.0 / math.sqrt(Dk)
    dev = x0.device
    causal = (torch.arange(T, device=dev)[None, :]
              <= torch.arange(T, device=dev)[:, None])          # (t, s)
    x = x0.to(torch.float32).reshape(R * T, D)
    k_rows, v_rows = [], []
    for lyr in range(L):
        def w(name):
            return layers[name]["w"].map(lambda a: a[lyr])

        def b(name):
            return layers[name]["b"][lyr].to(torch.float32)

        h = layer_norm_bf16(x, layers["ln0"]["w"][lyr], layers["ln0"]["b"][lyr],
                            ln_eps)
        qkv = qmatmul_wide_plain(h, w("qkv")) + b("qkv")
        q, k, v = qkv[:, :D] * scale, qkv[:, D:2 * D], qkv[:, 2 * D:]
        k_rows.append(k.to(cache_dtype))
        v_rows.append(v.to(cache_dtype))

        def heads(a):
            return a.to(torch.bfloat16).to(torch.float32).reshape(R, T, H, Dk)
        scores = torch.einsum("rthd,rshd->rhts", heads(q), heads(k))
        masked = torch.where(causal, scores, torch.full_like(scores, -1e30))
        m = masked.amax(-1, keepdim=True)
        p = torch.where(causal, torch.exp(scores - m), torch.zeros_like(scores))
        p = p / p.sum(-1, keepdim=True)
        pb = p.to(torch.bfloat16).to(torch.float32)
        ctx = torch.einsum("rhts,rshd->rthd", pb, heads(v)).reshape(R * T, D)
        x = x + qmatmul_wide_plain(ctx, w("o")) + b("o")
        h2 = layer_norm_bf16(x, layers["ln1"]["w"][lyr], layers["ln1"]["b"][lyr],
                             ln_eps)
        f = torch.nn.functional.gelu(qmatmul_wide_plain(h2, w("fc1")) + b("fc1"))
        x = x + qmatmul_wide_plain(f, w("fc2")) + b("fc2")
    return x, torch.stack(k_rows), torch.stack(v_rows)


def _check_gemm(a, qt, bias, epi: str, x, scale, what: str) -> None:
    """The call contract of :func:`prefill_gemm`, on every device."""
    if epi not in GEMM_EPILOGUES:
        raise ValueError(f"{what}: epi must be one of {GEMM_EPILOGUES}, got "
                         f"{epi!r}")
    M, d_in, d_out = a.shape[0], qt.d_in, qt.d_out
    if a.dim() != 2 or a.shape[1] != d_in or M < 1:
        raise ValueError(f"{what}: a must be (M, {d_in}), got "
                         f"{tuple(a.shape)}")
    if bias is None or tuple(bias.shape) != (d_out,):
        raise ValueError(f"{what}: bias must be ({d_out},)")
    if (epi == "resid") != (x is not None):
        raise ValueError(f"{what}: x (the residual) goes with epi 'resid' "
                         f"and only with it")
    if x is not None and tuple(x.shape) != (M, d_out):
        raise ValueError(f"{what}: x must be ({M}, {d_out}), got "
                         f"{tuple(x.shape)}")
    if (epi == "qkv") != (scale is not None):
        raise ValueError(f"{what}: scale (q's) goes with epi 'qkv' and only "
                         f"with it")
    if epi == "qkv" and d_out % 3 != 0:
        raise ValueError(f"{what}: the qkv epilogue splits d_out={d_out} "
                         f"into three")


def prefill_gemm_plain(a, qt, bias, *, epi: str, x=None, scale=None):
    """Plain version of :func:`prefill_gemm`: ``qmatmul_wide_plain`` (x and
    each weight rounded once to bf16, f32 products), then the epilogue as
    :func:`prefill_fused_plain` applies it."""
    _check_gemm(a, qt, bias, epi, x, scale, "prefill_gemm")
    y = qmatmul_wide_plain(a, qt)
    b = bias.to(torch.float32)
    if epi == "resid":
        return x.to(torch.float32) + y + b
    y = y + b
    if epi == "gelu":
        return torch.nn.functional.gelu(y).to(torch.bfloat16)
    D = qt.d_out // 3
    return ((y[:, :D] * scale).to(torch.bfloat16),
            y[:, D:2 * D].to(torch.bfloat16), y[:, 2 * D:].to(torch.bfloat16))


def prefill_gemm(a, qt, bias, *, epi: str, x=None, scale=None):
    """One projection of the refill kernel alone: ``a`` (M, d_in) rows
    (rounded to bf16) times the weight ``qt`` (d_in, d_out) through the
    wgmma GEMM of ``csrc/prefill.cu``, then its epilogue ``epi``:

      "qkv":   -> (q * scale, k, v), each (M, d_out/3) bf16, after + bias
      "resid": -> (x + y) + bias, (M, d_out) f32 (x the residual, f32)
      "gelu":  -> GELU(y + bias), (M, d_out) bf16 (exact erf)

    On the CPU it runs :func:`prefill_gemm_plain`."""
    what = "prefill_gemm"
    if not a.is_cuda:
        return prefill_gemm_plain(a, qt, bias, epi=epi, x=x, scale=scale)
    _check_gemm(a, qt, bias, epi, x, scale, what)
    bits = check_cuda_levels(qt, (), what)
    M, d_in, d_out = a.shape[0], qt.d_in, qt.d_out
    if not gemm_widths_ok(d_in, d_out):
        raise ValueError(f"{what}: the GEMM takes d_in % {_GEMM_STEP} == 0 "
                         f"and d_out % {_GEMM_BLOCK_COLS} == 0, got {d_in}, "
                         f"{d_out}")
    dev = a.device
    a = a.to(torch.bfloat16).contiguous()
    bias = bias.to(torch.float32).contiguous()
    bf16 = dict(dtype=torch.bfloat16, device=dev)
    outs, xo, out, k, v = (), None, None, None, None
    if epi == "qkv":
        D = d_out // 3
        out, k, v = (torch.empty(M, D, **bf16) for _ in range(3))
        outs = (out, k, v)
    elif epi == "gelu":
        out = torch.empty(M, d_out, **bf16)
        outs = out
    else:
        xo = x.to(torch.float32).contiguous().clone()
        outs = xo
    err = cuda_lib.library("prefill").bgt_prefill_gemm(
        a.data_ptr(), M, d_in, d_out, qt.levels.data_ptr(),
        qt.scales.data_ptr(), cuda_lib.ptr(qt.mins), _qt_offset(qt), bits,
        GEMM_EPILOGUES.index(epi), bias.data_ptr(), cuda_lib.ptr(xo),
        cuda_lib.ptr(out), cuda_lib.ptr(k), cuda_lib.ptr(v),
        float(scale or 0.0), cuda_lib.stream_ptr(dev))
    cuda_lib.LAUNCHES[what] += 1
    cuda_lib.check(err, what)
    return outs


def prefill_fused(x0, layers: dict, *, rows: int, padded: int, n_head: int,
                  ln_eps: float = 1e-5, cache_dtype=torch.bfloat16):
    """Whole-prompt forward of a refill group (see the module docstring)
    -> (x (R*T, D) f32, k_rows, v_rows (L, R*T, D) in ``cache_dtype``; the
    CUDA kernel emits bf16 rows)."""
    if not x0.is_cuda:
        return prefill_fused_plain(x0, layers, rows=rows, padded=padded,
                                   n_head=n_head, ln_eps=ln_eps,
                                   cache_dtype=cache_dtype)
    what = "prefill_fused"
    R, T = rows, padded
    RT, D = R * T, x0.shape[-1]
    L = layers["ln0"]["w"].shape[0]
    if x0.shape != (RT, D):
        raise ValueError(f"{what}: x0 must be ({RT}, {D}), got "
                         f"{tuple(x0.shape)}")
    if cache_dtype != torch.bfloat16:
        raise ValueError(f"{what}: the CUDA kernel emits bf16 rows")
    if D != n_head * HEAD_DIM:
        raise NotImplementedError(f"{what}: the CUDA kernel is built for head "
                                  f"width {HEAD_DIM}, got {D // n_head}")
    if T > MAX_T:
        raise ValueError(f"{what}: prompts padded to {T} > {MAX_T} tokens")
    offset, bits = _check_cuda_layers(layers, L, D, 1, what)
    F = layers["fc1"]["w"].d_out
    dev = x0.device
    bf16 = dict(dtype=torch.bfloat16, device=dev)
    x = x0.to(torch.float32).contiguous().clone()
    k_rows = torch.empty(L, RT, D, **bf16)
    v_rows = torch.empty(L, RT, D, **bf16)
    hb = torch.empty(RT, D, **bf16)     # LayerNorm'd rows
    qb = torch.empty(RT, D, **bf16)     # scaled queries
    ctx = torch.empty(RT, D, **bf16)    # attention context
    ff = torch.empty(RT, F, **bf16)     # GELU(fc1)
    norms = _layer_norms(layers)
    n_gemm = ctypes.c_int(0)
    err = cuda_lib.library("prefill").bgt_prefill(
        x.data_ptr(), R, T, L, D, F, n_head, float(ln_eps), offset, bits,
        *[t.data_ptr() for t in norms], *_layer_planes(layers),
        k_rows.data_ptr(), v_rows.data_ptr(), hb.data_ptr(), qb.data_ptr(),
        ctx.data_ptr(), ff.data_ptr(), ctypes.addressof(n_gemm),
        cuda_lib.stream_ptr(dev))
    cuda_lib.LAUNCHES[what] += 1
    cuda_lib.LAUNCHES["prefill_gemm"] += n_gemm.value
    cuda_lib.check(err, what)
    return x, k_rows, v_rows
