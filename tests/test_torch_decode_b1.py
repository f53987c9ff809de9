"""The single-stream (B=1) decode step's projection alone (``decode_kernels.
decode_gemv_b1``, its plain version on the CPU) against the JAX package's
X' product -- ``pallas_qmatmul.qmatmul_pallas`` run in interpret mode, the
numerics of ``pallas_decode._qmm`` that the TPU's B=1 kernel uses -- with
the TPU kernel's LayerNorm (``_ln``) before it and its bias, GELU
(``_gelu_erf``) or residual after it, as ``_make_kernel`` chains them; and
the B=1 step with its position as a (1,) tensor, token-identical to the
host's int.

The same planes (carried across byte for byte by ``params_from_numpy``)
and the same seeded numpy inputs go through both. The M=1 GEMV itself
(``csrc/qgemv_b1.cuh``) and the step's CUDA chain are held against these
plain versions on the card by ``chip_smoke.py``.
"""

import ml_dtypes
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from biogpt_tpu.config import BioGptConfig
from biogpt_tpu.modelio.checkpoint import params_from_state_dict
from biogpt_tpu.modelio.synthetic import make_state_dict
from biogpt_tpu.ops import pallas_decode, pallas_qmatmul
from biogpt_tpu.quant import codecs
from biogpt_tpu.quant.layouts import pack_nibble_planes, quantize_to_planes
from biogpt_tpu.runtime.engine import _pack_matmul_weights

from biogpt_tpu_torch.modelio.checkpoint import params_from_numpy
from biogpt_tpu_torch.ops import decode_kernels
from biogpt_tpu_torch.ops.qmatmul_kernels import layer_norm_bf16

ALL_QTYPES = [codecs.GGML_TYPE_Q4_0, codecs.GGML_TYPE_Q4_1,
              codecs.GGML_TYPE_Q5_0, codecs.GGML_TYPE_Q5_1,
              codecs.GGML_TYPE_Q8_0]
D_IN = 256
EPS = 1e-5
# Both round x to bf16, take f32 per-block partials of the uncentered
# levels and apply offset, scale and min per block in f32: they differ in
# the order of their f32 sums only, ~1e-5 of the output's magnitude. JAX's
# GELU takes a polynomial erf (within 1.5e-7 of erf), the port the exact
# one: well inside the same limit.
SUM_ORDER_RTOL = 1e-5
CFG = BioGptConfig.tiny(d_model=128, d_ff=256, n_head=2, n_layer=2,
                        n_vocab=256, n_positions=64)


def _planes(qtype, d_out, seed):
    """(JAX planes, port planes) of one random (D_IN, d_out) weight as the
    engines prepare it: nibble-packed where the format packs, bf16 scales."""
    rng = np.random.RandomState(seed)
    qt = pack_nibble_planes(quantize_to_planes(
        rng.randn(d_out, D_IN).astype(np.float32), qtype))
    qt = qt._replace(
        scales=np.asarray(qt.scales).astype(ml_dtypes.bfloat16),
        mins=(np.asarray(qt.mins).astype(ml_dtypes.bfloat16)
              if qt.mins is not None else None))
    return qt, params_from_numpy(qt, device="cpu")


def _rel_close(got, want, rtol=SUM_ORDER_RTOL):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("qtype", ALL_QTYPES)
@pytest.mark.parametrize("epilogue,d_out", [("bias", 128), ("ln", 384),
                                            ("gelu", 256), ("resid", 128)])
def test_decode_gemv_b1_matches_qmm(qtype, epilogue, d_out):
    """The product with each prologue and epilogue the B=1 step chains:
    qkv's LayerNorm and bias, fc1's bias and GELU, o's and fc2's (x + y) +
    bias. With the LayerNorm, the two frameworks sum the statistics in
    other orders, so an element next to a bf16 rounding boundary may round
    the other way: the LayerNorm'd row is held to one bf16 step of JAX's
    ``_ln``, and the product to the X' product of the port's own row."""
    qt_j, qt_t = _planes(qtype, d_out, seed=10 * qtype + d_out)
    rng = np.random.RandomState(d_out)
    x = rng.randn(1, D_IN).astype(np.float32)
    bias = (0.1 * rng.randn(d_out)).astype(np.float32)
    kw, h = {}, x
    if epilogue == "ln":
        lnw = (1 + 0.1 * rng.randn(D_IN)).astype(np.float32)
        lnb = (0.1 * rng.randn(D_IN)).astype(np.float32)
        h_j = np.asarray(pallas_decode._ln(jnp.asarray(x), jnp.asarray(lnw),
                                           jnp.asarray(lnb), EPS)
                         .astype(jnp.bfloat16)).astype(np.float32)
        h = layer_norm_bf16(torch.from_numpy(x), torch.from_numpy(lnw),
                            torch.from_numpy(lnb), EPS).numpy()
        assert np.all(np.abs(h - h_j) <= np.abs(h_j) * 2.0 ** -7)
        kw = dict(ln_w=torch.from_numpy(lnw), ln_b=torch.from_numpy(lnb),
                  ln_eps=EPS)
    y = pallas_qmatmul.qmatmul_pallas(jnp.asarray(h), qt_j, interpret=True)
    if epilogue == "resid":
        res = rng.randn(1, d_out).astype(np.float32)
        want = jnp.asarray(res) + y + jnp.asarray(bias)
        kw = dict(residual=torch.from_numpy(res))
    elif epilogue == "gelu":
        want = pallas_decode._gelu_erf(y + jnp.asarray(bias))
        kw = dict(act="gelu")
    else:
        want = y + jnp.asarray(bias)
    got = decode_kernels.decode_gemv_b1(torch.from_numpy(x), qt_t,
                                        torch.from_numpy(bias), **kw).numpy()
    assert got.shape == (1, d_out)
    _rel_close(got, np.asarray(want))


def test_decode_gemv_b1_refuses_mixed_epilogues():
    _, qt_t = _planes(codecs.GGML_TYPE_Q4_0, 128, seed=1)
    x = torch.zeros(1, D_IN)
    with pytest.raises(ValueError):
        decode_kernels.decode_gemv_b1(x, qt_t, act="relu")
    with pytest.raises(ValueError):
        decode_kernels.decode_gemv_b1(x, qt_t, act="gelu",
                                      residual=torch.zeros(1, 128))
    with pytest.raises(ValueError):
        decode_kernels.decode_gemv_b1(x, qt_t, ln_w=torch.ones(D_IN))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_decode_step_b1_takes_a_device_position(kv):
    """The B=1 step with ``past`` as a (1,) integer tensor, as the JAX
    kernel takes a traced position: the same hidden state and K/V rows,
    bit for bit, as with the host's int."""
    params = _pack_matmul_weights(params_from_state_dict(
        make_state_dict(CFG, seed=3), CFG, qtype=codecs.GGML_TYPE_Q4_0))
    layers = params_from_numpy(params["layers"], "cpu")
    L, S, D = CFG.n_layer, CFG.n_positions, CFG.d_model
    rng = np.random.RandomState(5)
    x0 = torch.from_numpy(rng.randn(1, D).astype(np.float32))
    kw = {}
    if kv == "int8":
        k = torch.from_numpy(rng.randint(-127, 128, (L, 1, S, D)).astype(np.int8))
        v = torch.from_numpy(rng.randint(-127, 128, (L, 1, S, D)).astype(np.int8))
        kw = dict(k_scales=torch.from_numpy(
                      (0.01 * rng.rand(L, 1, 1, S)).astype(np.float32)),
                  v_scales=torch.from_numpy(
                      (0.01 * rng.rand(L, 1, 1, S)).astype(np.float32)))
    else:
        k = torch.from_numpy(rng.randn(L, 1, S, D).astype(np.float32)
                             ).to(torch.bfloat16)
        v = torch.from_numpy(rng.randn(L, 1, S, D).astype(np.float32)
                             ).to(torch.bfloat16)
    past = 21
    host = decode_kernels.decode_step_fused(
        x0, layers, k, v, past, n_head=CFG.n_head, window=32, **kw)
    for dtype in (torch.int32, torch.int64):
        dev = decode_kernels.decode_step_fused(
            x0, layers, k, v, torch.tensor([past], dtype=dtype),
            n_head=CFG.n_head, window=32, **kw)
        for a, b in zip(host, dev):
            assert torch.equal(a, b)
