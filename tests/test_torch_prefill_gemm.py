"""The refill kernel's GEMM alone (``prefill_kernels.prefill_gemm``, its
plain version on the CPU) against the JAX package's dequant-then-dot
product ``pallas_decode._qmm_dq``, which ``_make_prefill_kernel`` runs for
its four projections, with that kernel's epilogues after it in jnp: q
scaled by 1/sqrt(Dk) and k, v in bf16 (qkv), the residual (x + y) + bias
(o, fc2), and bias then GELU (fc1).

The same planes (carried across byte for byte by ``params_from_numpy``)
and the same seeded numpy inputs go through both. The wgmma GEMM itself
(``csrc/prefill.cu``) is held against this plain version on the card by
``chip_smoke.py``.
"""

import ml_dtypes
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from biogpt_tpu.ops import pallas_decode
from biogpt_tpu.quant import codecs
from biogpt_tpu.quant.layouts import (LEVEL_OFFSET, pack_nibble_planes,
                                      quantize_to_planes)

from biogpt_tpu_torch.modelio.checkpoint import params_from_numpy
from biogpt_tpu_torch.ops import prefill_kernels

ALL_QTYPES = [codecs.GGML_TYPE_Q4_0, codecs.GGML_TYPE_Q4_1,
              codecs.GGML_TYPE_Q5_0, codecs.GGML_TYPE_Q5_1,
              codecs.GGML_TYPE_Q8_0]
D_IN, D_OUT = 128, 384
SCALE = 0.125   # 1/sqrt(64), the q scale of a 64-wide head
# Both round the rows and each dequantized weight to bf16 and sum exact f32
# products: they differ in the order of their f32 sums only, ~1e-5 of the
# product's magnitude. An output rounded to bf16 may then round the other
# way where its f32 value lies that close to a rounding boundary. JAX's
# GELU takes a polynomial erf (within 1.5e-7 of erf), the port the exact
# one.
SUM_ORDER_RTOL = 1e-5


def _planes(qtype, seed):
    """(JAX planes, port planes) of one random (D_IN, D_OUT) weight as the
    engines prepare it: nibble-packed where the format packs, bf16 scales."""
    rng = np.random.RandomState(seed)
    qt = pack_nibble_planes(quantize_to_planes(
        rng.randn(D_OUT, D_IN).astype(np.float32), qtype))
    qt = qt._replace(
        scales=np.asarray(qt.scales).astype(ml_dtypes.bfloat16),
        mins=(np.asarray(qt.mins).astype(ml_dtypes.bfloat16)
              if qt.mins is not None else None))
    return qt, params_from_numpy(qt, device="cpu")


def _qmm_dq(qt, a):
    """pallas_decode._qmm_dq of the bf16 rows a (M, D_IN) on one layer's
    planes ((1, rows, D_OUT) refs, as the prefill kernel's blocks give
    them), inside a Pallas kernel run in interpret mode, as the JAX
    package's own tests run its kernels on the CPU."""
    packed = bool(qt.packed)
    offset = LEVEL_OFFSET[qt.qtype] if packed else 0
    five_bit = packed and qt.qtype in (codecs.GGML_TYPE_Q5_0,
                                       codecs.GGML_TYPE_Q5_1)
    args = [jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(qt.levels)[None],
            jnp.asarray(qt.scales)[None]]
    if qt.mins is not None:
        args.append(jnp.asarray(qt.mins)[None])

    def kernel(a_ref, lv_ref, sc_ref, *rest):
        mn_ref = rest[0] if len(rest) == 2 else None
        rest[-1][...] = pallas_decode._qmm_dq(
            a_ref[...], lv_ref, sc_ref, mn_ref, offset=offset, packed=packed,
            five_bit=five_bit)
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((a.shape[0], D_OUT),
                                               jnp.float32),
        interpret=True)(*args)


def _inputs(M, seed):
    """bf16-valued rows (M, D_IN), a bias and a residual (M, D_OUT)."""
    rng = np.random.RandomState(seed)
    a = rng.randn(M, D_IN).astype(ml_dtypes.bfloat16).astype(np.float32)
    return (a, (0.1 * rng.randn(D_OUT)).astype(np.float32),
            rng.randn(M, D_OUT).astype(np.float32))


def _close(got, want, scale, bf16):
    """Within the f32 sum order of a product of magnitude ``scale`` of the
    f32 values ``want``; a bf16 output is held to ``want`` rounded to bf16
    within that, plus the gap between the two bf16 neighbours of any value
    that lies that close to a rounding boundary."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    lim = np.float32(SUM_ORDER_RTOL * scale)
    if bf16:
        def rnd(v):
            return v.astype(ml_dtypes.bfloat16).astype(np.float32)
        lim = lim + np.abs(rnd(want + lim) - rnd(want - lim))
        want = rnd(want)
    assert np.all(np.abs(got - want) <= lim)


def _f32(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("qtype", ALL_QTYPES)
@pytest.mark.parametrize("m", [8, 72])
def test_prefill_gemm_qkv_epilogue(qtype, m):
    """qkv: q * scale, k and v, each after the bias, in bf16."""
    qt_j, qt_t = _planes(qtype, seed=500 + qtype)
    a, bias, _ = _inputs(m, seed=m)
    y = np.asarray(_qmm_dq(qt_j, a) + jnp.asarray(bias))
    D = D_OUT // 3
    q, k, v = prefill_kernels.prefill_gemm(
        torch.from_numpy(a), qt_t, torch.from_numpy(bias), epi="qkv",
        scale=SCALE)
    assert q.dtype == k.dtype == v.dtype == torch.bfloat16
    assert q.shape == k.shape == v.shape == (m, D)
    scale = float(np.abs(y).max())
    _close(_f32(q), y[:, :D] * SCALE, scale * SCALE, True)
    _close(_f32(k), y[:, D:2 * D], scale, True)
    _close(_f32(v), y[:, 2 * D:], scale, True)


@pytest.mark.parametrize("qtype", ALL_QTYPES)
@pytest.mark.parametrize("m", [8, 72])
def test_prefill_gemm_residual_epilogue(qtype, m):
    """o's and fc2's epilogue: (x + y) + bias in f32, the TPU kernel's
    order."""
    qt_j, qt_t = _planes(qtype, seed=600 + qtype)
    a, bias, res = _inputs(m, seed=m + 1)
    y = _qmm_dq(qt_j, a)
    want = np.asarray(jnp.asarray(res) + y + jnp.asarray(bias))
    got = prefill_kernels.prefill_gemm(
        torch.from_numpy(a), qt_t, torch.from_numpy(bias), epi="resid",
        x=torch.from_numpy(res))
    assert got.dtype == torch.float32 and got.shape == (m, D_OUT)
    _close(got.numpy(), want, float(np.abs(np.asarray(y)).max()), False)


@pytest.mark.parametrize("qtype", ALL_QTYPES)
@pytest.mark.parametrize("m", [8, 72])
def test_prefill_gemm_gelu_epilogue(qtype, m):
    """fc1's epilogue: bias, then GELU, in bf16."""
    qt_j, qt_t = _planes(qtype, seed=700 + qtype)
    a, bias, _ = _inputs(m, seed=m + 2)
    y = _qmm_dq(qt_j, a) + jnp.asarray(bias)
    want = np.asarray(pallas_decode._gelu_erf(y))
    got = prefill_kernels.prefill_gemm(
        torch.from_numpy(a), qt_t, torch.from_numpy(bias), epi="gelu")
    assert got.dtype == torch.bfloat16 and got.shape == (m, D_OUT)
    _close(_f32(got), want, float(np.abs(np.asarray(y)).max()), True)


def test_prefill_gemm_refusals():
    """The call contract, checked on every device: a known epilogue, the
    residual with 'resid' and only there, q's scale with 'qkv' and only
    there, row and bias widths."""
    _, qt_t = _planes(codecs.GGML_TYPE_Q4_0, seed=1)
    a = torch.zeros(8, D_IN)
    bias = torch.zeros(D_OUT)
    x = torch.zeros(8, D_OUT)
    gemm = prefill_kernels.prefill_gemm
    for bad in (dict(epi="relu"), dict(epi="resid"),
                dict(epi="gelu", x=x), dict(epi="qkv"),
                dict(epi="gelu", scale=SCALE),
                dict(epi="resid", x=torch.zeros(8, D_OUT + 1))):
        with pytest.raises(ValueError):
            gemm(a, qt_t, bias, **bad)
    with pytest.raises(ValueError):
        gemm(torch.zeros(8, D_IN + 64), qt_t, bias, epi="gelu")
    with pytest.raises(ValueError):
        gemm(a, qt_t, torch.zeros(D_OUT - 1), epi="gelu")
    with pytest.raises(ValueError):
        gemm(a, qt_t, None, epi="gelu")


def _zero_layers(d_model, d_ff):
    """One layer of zero Q4_0 planes (packed, as the engines prepare them)
    at these widths, with LayerNorm parameters and biases."""
    from biogpt_tpu_torch.quant import codecs as tcodecs
    from biogpt_tpu_torch.quant.layouts import QuantizedTensor

    def planes(d_in, d_out):
        return QuantizedTensor(
            levels=torch.zeros(1, d_in // 2, d_out, dtype=torch.uint8),
            scales=torch.zeros(1, d_in // 32, d_out, dtype=torch.bfloat16),
            mins=None, qtype=tcodecs.GGML_TYPE_Q4_0, packed=True)
    layers = {n: {"w": torch.ones(1, d_model), "b": torch.zeros(1, d_model)}
              for n in ("ln0", "ln1")}
    for name, d_in, d_out in (("qkv", d_model, 3 * d_model),
                              ("o", d_model, d_model),
                              ("fc1", d_model, d_ff), ("fc2", d_ff, d_model)):
        layers[name] = {"w": planes(d_in, d_out), "b": torch.zeros(1, d_out)}
    return layers


@pytest.mark.parametrize("d_model,d_ff,routed", [
    (128, 512, True), (384, 2048, True), (640, 2048, True),
    (896, 3072, True), (1024, 4096, True), (384, 1536, False),
    (192, 768, False), (1024, 4000, False)])
def test_gate_routes_only_widths_the_gemm_takes(d_model, d_ff, routed):
    """Every model the refill gate sends ``prefill_fused`` has four
    projections the GEMM takes (``gemm_widths_ok``), among them those
    whose qkv width 256 does not divide (d_model 384, 640, 896: 128-column
    tiles); the layer gate refuses d_in past 1024 off whole 1024-row chunks
    (d_ff 1536) and any width off the 128-column grid."""
    layers = _zero_layers(d_model, d_ff)
    gate = prefill_kernels.supports_prefill(
        layers, 4, 32, n_head=d_model // 64, n_positions=1024)
    widths = all(prefill_kernels.gemm_widths_ok(layers[n]["w"].d_in,
                                                layers[n]["w"].d_out)
                 for n in ("qkv", "o", "fc1", "fc2"))
    assert gate == routed
    assert widths or not gate
    assert widths == (d_model % 128 == 0 and d_ff % 128 == 0)
