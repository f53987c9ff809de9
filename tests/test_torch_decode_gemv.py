"""The batched decode steps' projection alone (``decode_kernels.
decode_gemv``, its plain version on the CPU) against the JAX package's
dequant-then-dot product ``pallas_decode._qmm_dq``, with the TPU kernels'
LayerNorm (``_ln``) before it and their bias, GELU (``_gelu_erf``) or
residual after it, as ``_make_kernel_batched`` chains them.

The same planes (carried across byte for byte by ``params_from_numpy``)
and the same seeded numpy inputs go through both. The tensor-core GEMV
itself (``csrc/qgemv_mma.cuh``) is held against this plain version on the
card by ``chip_smoke.py``.
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
from biogpt_tpu_torch.ops import decode_kernels
from biogpt_tpu_torch.ops.qmatmul_kernels import layer_norm_bf16

ALL_QTYPES = [codecs.GGML_TYPE_Q4_0, codecs.GGML_TYPE_Q4_1,
              codecs.GGML_TYPE_Q5_0, codecs.GGML_TYPE_Q5_1,
              codecs.GGML_TYPE_Q8_0]
D_IN, D_OUT = 256, 384
EPS = 1e-5
# Both round x and each dequantized weight to bf16 and sum exact f32
# products: they differ in the order of their f32 sums only, ~1e-5 of the
# output's magnitude. JAX's GELU takes a polynomial erf (Abramowitz and
# Stegun 7.1.26, within 1.5e-7 of erf), the port the exact one: well
# inside the same limit.
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


def _qmm_dq(qt, h):
    """pallas_decode._qmm_dq of the rows h (M, D_IN) on one layer's planes
    ((1, rows, D_OUT) refs, as the batched kernel's blocks give them),
    inside a Pallas kernel run in interpret mode, as the JAX package's own
    tests run its kernels on the CPU."""
    packed = bool(qt.packed)
    offset = LEVEL_OFFSET[qt.qtype] if packed else 0
    five_bit = packed and qt.qtype in (codecs.GGML_TYPE_Q5_0,
                                       codecs.GGML_TYPE_Q5_1)
    args = [jnp.asarray(h).astype(jnp.bfloat16), jnp.asarray(qt.levels)[None],
            jnp.asarray(qt.scales)[None]]
    if qt.mins is not None:
        args.append(jnp.asarray(qt.mins)[None])

    def kernel(h_ref, lv_ref, sc_ref, *rest):
        mn_ref = rest[0] if len(rest) == 2 else None
        rest[-1][...] = pallas_decode._qmm_dq(
            h_ref[...], lv_ref, sc_ref, mn_ref, offset=offset, packed=packed,
            five_bit=five_bit)
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((h.shape[0], D_OUT),
                                               jnp.float32),
        interpret=True)(*args)


def _inputs(M, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(M, D_IN).astype(np.float32),
            (0.1 * rng.randn(D_OUT)).astype(np.float32))


def _rel_close(got, want, rtol=SUM_ORDER_RTOL):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("qtype", ALL_QTYPES)
@pytest.mark.parametrize("m", [8, 16, 32])
def test_decode_gemv_matches_qmm_dq(qtype, m):
    """The product and its bias at every row count the kernel runs at."""
    qt_j, qt_t = _planes(qtype, seed=100 + qtype)
    x, bias = _inputs(m, seed=m)
    want = np.asarray(_qmm_dq(qt_j, x) + jnp.asarray(bias))
    got = decode_kernels.decode_gemv(torch.from_numpy(x), qt_t,
                                     torch.from_numpy(bias)).numpy()
    assert got.shape == (m, D_OUT)
    _rel_close(got, want)


@pytest.mark.parametrize("qtype", ALL_QTYPES)
def test_decode_gemv_layernorm_prologue(qtype):
    """qkv's and fc1's LayerNorm before the product. The two frameworks sum
    the statistics in other orders, so an element next to a bf16 rounding
    boundary may round the other way: the LayerNorm'd rows are held to one
    bf16 step of JAX's ``_ln``, and the product to ``_qmm_dq`` of the
    port's own rows."""
    qt_j, qt_t = _planes(qtype, seed=200 + qtype)
    x, bias = _inputs(32, seed=7)
    rng = np.random.RandomState(8)
    lnw = (1 + 0.1 * rng.randn(D_IN)).astype(np.float32)
    lnb = (0.1 * rng.randn(D_IN)).astype(np.float32)
    h_j = np.asarray(pallas_decode._ln(jnp.asarray(x), jnp.asarray(lnw),
                                       jnp.asarray(lnb), EPS)
                     .astype(jnp.bfloat16)).astype(np.float32)
    h_t = layer_norm_bf16(torch.from_numpy(x), torch.from_numpy(lnw),
                          torch.from_numpy(lnb), EPS).numpy()
    step = np.abs(h_j) * 2.0 ** -7
    assert np.all(np.abs(h_t - h_j) <= step)
    got = decode_kernels.decode_gemv(
        torch.from_numpy(x), qt_t, torch.from_numpy(bias),
        ln_w=torch.from_numpy(lnw), ln_b=torch.from_numpy(lnb),
        ln_eps=EPS).numpy()
    _rel_close(got, np.asarray(_qmm_dq(qt_j, h_t) + jnp.asarray(bias)))


@pytest.mark.parametrize("qtype", ALL_QTYPES)
def test_decode_gemv_gelu_epilogue(qtype):
    """fc1's epilogue: bias, then GELU."""
    qt_j, qt_t = _planes(qtype, seed=300 + qtype)
    x, bias = _inputs(16, seed=9)
    want = np.asarray(pallas_decode._gelu_erf(_qmm_dq(qt_j, x)
                                              + jnp.asarray(bias)))
    got = decode_kernels.decode_gemv(torch.from_numpy(x), qt_t,
                                     torch.from_numpy(bias),
                                     act="gelu").numpy()
    _rel_close(got, want)


@pytest.mark.parametrize("qtype", ALL_QTYPES)
def test_decode_gemv_residual_epilogue(qtype):
    """o's and fc2's epilogue: (x + y) + bias, the TPU kernel's order."""
    qt_j, qt_t = _planes(qtype, seed=400 + qtype)
    x, bias = _inputs(8, seed=10)
    res = np.random.RandomState(11).randn(8, D_OUT).astype(np.float32)
    want = np.asarray(jnp.asarray(res) + _qmm_dq(qt_j, x) + jnp.asarray(bias))
    got = decode_kernels.decode_gemv(torch.from_numpy(x), qt_t,
                                     torch.from_numpy(bias),
                                     residual=torch.from_numpy(res)).numpy()
    _rel_close(got, want)


def test_decode_gemv_refuses_mixed_epilogues():
    _, qt_t = _planes(codecs.GGML_TYPE_Q4_0, seed=1)
    x = torch.zeros(8, D_IN)
    with pytest.raises(ValueError):
        decode_kernels.decode_gemv(x, qt_t, act="relu")
    with pytest.raises(ValueError):
        decode_kernels.decode_gemv(x, qt_t, act="gelu",
                                   residual=torch.zeros(8, D_OUT))
    with pytest.raises(ValueError):
        decode_kernels.decode_gemv(x, qt_t, ln_w=torch.ones(D_IN))
