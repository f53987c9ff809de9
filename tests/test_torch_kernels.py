"""The port's kernel functions (their plain versions, on the CPU) against
the JAX package's Pallas kernels in interpret mode.

Same planes (carried across byte for byte by ``params_from_numpy``) and
the same seeded numpy inputs go through both. The CUDA kernels themselves
are held against these plain versions on the card by ``chip_smoke.py``.
"""

import functools

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
from biogpt_tpu_torch.ops import decode_kernels, qmatmul_kernels

ALL_QTYPES = [codecs.GGML_TYPE_Q4_0, codecs.GGML_TYPE_Q4_1,
              codecs.GGML_TYPE_Q5_0, codecs.GGML_TYPE_Q5_1,
              codecs.GGML_TYPE_Q8_0]
CFG = BioGptConfig.tiny(d_model=128, d_ff=256, n_head=2, n_layer=3,
                        n_vocab=256, n_positions=64)


def _qt_pair(qtype, d_out, d_in, seed, bf16_scales=False):
    """(JAX planes, port planes) of one random weight, nibble-packed where
    the format packs; optionally with the engine's bf16 scale planes."""
    rng = np.random.RandomState(seed)
    qt = pack_nibble_planes(quantize_to_planes(
        rng.randn(d_out, d_in).astype(np.float32), qtype))
    if bf16_scales:
        import ml_dtypes
        qt = qt._replace(
            scales=np.asarray(qt.scales).astype(ml_dtypes.bfloat16),
            mins=(np.asarray(qt.mins).astype(ml_dtypes.bfloat16)
                  if qt.mins is not None else None))
    return qt, params_from_numpy(qt, device="cpu")


def _rel_close(got, want, rtol):
    """|got - want| <= rtol * max|want| elementwise."""
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


# The plain versions transcribe the TPU kernels' arithmetic (bf16 rounding
# of x, f32 per-block partials, f32 scales); the two differ only in the
# order of their f32 sums, so they agree to ~1e-5 of the output's scale.
SUM_ORDER_RTOL = 1e-5


@pytest.mark.parametrize("qtype", ALL_QTYPES)
@pytest.mark.parametrize("m", [1, 3, 8])
def test_qmatmul_matches_pallas(qtype, m):
    qt_j, qt_t = _qt_pair(qtype, d_out=256, d_in=128, seed=qtype)
    x = np.random.RandomState(m).randn(m, 128).astype(np.float32)
    want = np.asarray(pallas_qmatmul.qmatmul_pallas(
        jnp.asarray(x), qt_j, interpret=True))
    got = qmatmul_kernels.qmatmul(torch.from_numpy(x), qt_t).numpy()
    assert qmatmul_kernels.supports(qt_t, m) == pallas_qmatmul.supports(qt_j, m)
    _rel_close(got, want, SUM_ORDER_RTOL)


@pytest.mark.parametrize("qtype", ALL_QTYPES)
@pytest.mark.parametrize("m", [16, 32])
def test_qmatmul_wide_matches_pallas(qtype, m):
    qt_j, qt_t = _qt_pair(qtype, d_out=256, d_in=256, seed=10 + qtype)
    x = np.random.RandomState(m).randn(m, 256).astype(np.float32)
    want = np.asarray(pallas_qmatmul.qmatmul_pallas_wide(
        jnp.asarray(x), qt_j, interpret=True))
    got = qmatmul_kernels.qmatmul_wide(torch.from_numpy(x), qt_t).numpy()
    _rel_close(got, want, SUM_ORDER_RTOL)
    for mm in (8, 12, 33):
        assert (qmatmul_kernels.supports_wide(qt_t, mm)
                == pallas_qmatmul.supports_wide(qt_j, mm))


def test_qmatmul_wide_gate_refuses_chunk_tail():
    """d_in = 1536 is not a multiple of the TPU kernel's 1024-row chunk."""
    qt_j, qt_t = _qt_pair(codecs.GGML_TYPE_Q4_0, d_out=128, d_in=1536, seed=3)
    assert not pallas_qmatmul.supports_wide(qt_j, 16)
    assert not qmatmul_kernels.supports_wide(qt_t, 16)


@pytest.mark.parametrize("qtype", ALL_QTYPES)
@pytest.mark.parametrize("m", [1, 4])
def test_lm_head_argmax_matches_pallas(qtype, m):
    """ids exactly, winning logits to summation order; n_valid < d_out
    exercises the pad-column mask, d_out = 1024 gives two 512-column tiles."""
    qt_j, qt_t = _qt_pair(qtype, d_out=1024, d_in=128, seed=20 + qtype,
                          bf16_scales=True)
    rng = np.random.RandomState(30 + m)
    x = rng.randn(m, 128).astype(np.float32)
    lnw = rng.randn(128).astype(np.float32)
    lnb = (rng.randn(128) * 0.1).astype(np.float32)
    n_valid = 1024 - 37
    ids_j, mv_j = pallas_qmatmul.lm_head_argmax_pallas(
        jnp.asarray(x), jnp.asarray(lnw), jnp.asarray(lnb), qt_j,
        n_valid=n_valid, interpret=True, with_max=True)
    ids_t, mv_t = qmatmul_kernels.lm_head_argmax(
        torch.from_numpy(x), torch.from_numpy(lnw), torch.from_numpy(lnb),
        qt_t, n_valid)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    _rel_close(mv_t.numpy(), np.asarray(mv_j), SUM_ORDER_RTOL)


def _tie_planes():
    """A Q4_0 lm_head with dominant columns: 100 and its copy 700 (a tie
    across two 512-column tiles) win for x = [+1]*64 + [-1]*64; 3 and its
    copy 5 (a tie inside one tile) win for the reversed x."""
    qt_j, _ = _qt_pair(codecs.GGML_TYPE_Q4_0, d_out=1024, d_in=128, seed=41,
                       bf16_scales=True)
    lv = np.array(qt_j.levels)          # packed: byte row i = rows i, i + 64
    sc = np.array(qt_j.scales)
    for col, byte in ((100, 0x1F), (700, 0x1F), (3, 0xF1), (5, 0xF1)):
        lv[:, col] = byte               # levels 15 / 1 -> +7 / -7 centered
        sc[:, col] = 0.5
    qt_j = qt_j._replace(levels=lv, scales=sc)
    return qt_j, params_from_numpy(qt_j, device="cpu")


def test_lm_head_argmax_tie_and_nan_rows_match_pallas():
    qt_j, qt_t = _tie_planes()
    lnw, lnb = np.ones(128, np.float32), np.zeros(128, np.float32)
    half = np.concatenate([np.ones(64), -np.ones(64)]).astype(np.float32)
    x = np.stack([half, -half, np.full(128, np.nan, np.float32)])
    ids_j, mv_j = pallas_qmatmul.lm_head_argmax_pallas(
        jnp.asarray(x), jnp.asarray(lnw), jnp.asarray(lnb), qt_j,
        n_valid=1000, interpret=True, with_max=True)
    ids_t, mv_t = qmatmul_kernels.lm_head_argmax(
        torch.from_numpy(x), torch.from_numpy(lnw), torch.from_numpy(lnb),
        qt_t, 1000)
    ids_j, mv_j = np.asarray(ids_j), np.asarray(mv_j)
    assert ids_j[0] == 100 and ids_j[1] == 3      # the ties really won
    assert ids_j[2] == 999 and np.isnan(mv_j[2])  # all-NaN row: clamped id
    np.testing.assert_array_equal(ids_t.numpy(), ids_j)
    assert np.isnan(mv_t.numpy()[2])
    _rel_close(mv_t.numpy()[:2], mv_j[:2], SUM_ORDER_RTOL)


# ------------------------------------------------------------- decode step

def _packed_layers(qtype, seed):
    params = _pack_matmul_weights(params_from_state_dict(
        make_state_dict(CFG, seed=seed), CFG, qtype=qtype))
    return params["layers"], params_from_numpy(params["layers"], "cpu")


@pytest.mark.parametrize("qtype,window,kv_block,past", [
    (codecs.GGML_TYPE_Q4_0, 16, None, 0),
    (codecs.GGML_TYPE_Q4_0, 16, None, 9),
    (codecs.GGML_TYPE_Q4_0, 32, 8, 17),
    (codecs.GGML_TYPE_Q4_1, 64, 16, 40),
    (codecs.GGML_TYPE_Q5_0, 32, 8, 30),
    (codecs.GGML_TYPE_Q5_1, 32, 8, 25),
    (codecs.GGML_TYPE_Q8_0, 16, None, 12),
])
def test_decode_step_fused_matches_pallas(qtype, window, kv_block, past):
    """B=1, bf16 KV, several windows and KV blocks (one and several online
    softmax blocks). Both sides run the same bf16-path arithmetic; they
    differ in f32 summation order and the GELU's erf (the TPU kernel's
    polynomial is within 1.5e-7), which can flip a bf16 rounding of an
    activation. Tolerance: 1e-3 of the hidden state's magnitude, and one
    bf16 ulp (2^-7 relative) of the rows' largest magnitude."""
    layers_j, layers_t = _packed_layers(qtype, seed=qtype)
    L, S, D = CFG.n_layer, CFG.n_positions, CFG.d_model
    rng = np.random.RandomState(past)
    x0 = rng.randn(1, D).astype(np.float32)
    k = (rng.randn(L, 1, S, D) * 0.5).astype(np.float32)
    v = (rng.randn(L, 1, S, D) * 0.5).astype(np.float32)
    kj, vj = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    x_j, kr_j, vr_j = pallas_decode.decode_step_fused(
        jnp.asarray(x0), layers_j, kj, vj, jnp.int32(past), n_head=CFG.n_head,
        window=window, interpret=True, kv_block=kv_block)
    kt = torch.from_numpy(k).to(torch.bfloat16)
    vt = torch.from_numpy(v).to(torch.bfloat16)
    # an explicit KV block is the plain version's option; the wrapper walks
    # the TPU kernel's default blocks on the CPU
    step = (decode_kernels.decode_step_fused if kv_block is None else
            functools.partial(decode_kernels.decode_step_fused_plain,
                              kv_block_size=kv_block))
    x_t, kr_t, vr_t = step(
        torch.from_numpy(x0), layers_t, kt, vt, past, n_head=CFG.n_head,
        window=window)
    _rel_close(x_t.numpy(), np.asarray(x_j), 1e-3)
    for got, want in ((kr_t, kr_j), (vr_t, vr_j)):
        _rel_close(got.float().numpy(), np.asarray(want, np.float32), 2 ** -7)


@pytest.mark.parametrize("qtype", ALL_QTYPES)
def test_engine_weight_preparation_matches_jax(qtype):
    """The engines prepare each format's matmul planes as the JAX engine
    does: 4/5-bit levels packed (uint8), Q8_0 left unpacked as int8 levels
    with ``packed=False``; scale (and min) planes bf16; the lm_head
    lane-padded. The CUDA kernels take exactly these planes."""
    from biogpt_tpu_torch.runtime.engine import (
        _pack_matmul_weights as port_pack)

    pj = _pack_matmul_weights(params_from_state_dict(
        make_state_dict(CFG, seed=2), CFG, qtype=qtype))
    pt = port_pack(params_from_numpy(params_from_state_dict(
        make_state_dict(CFG, seed=2), CFG, qtype=qtype), "cpu"))
    packed = qtype != codecs.GGML_TYPE_Q8_0
    for wj, wt in [(pj["lm_head"], pt["lm_head"])] + [
            (pj["layers"][n]["w"], pt["layers"][n]["w"])
            for n in ("qkv", "o", "fc1", "fc2")]:
        assert wt.packed == wj.packed == packed
        assert wt.levels.dtype == (torch.uint8 if packed else torch.int8)
        np.testing.assert_array_equal(wt.levels.numpy(), np.asarray(wj.levels))
        assert wt.scales.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            wt.scales.float().numpy(), np.asarray(wj.scales, np.float32))
        assert (wt.mins is None) == (wj.mins is None)
        if wt.mins is not None:
            assert wt.mins.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                wt.mins.float().numpy(), np.asarray(wj.mins, np.float32))
        bits = qmatmul_kernels.CUDA_FORMATS[(wt.qtype, wt.packed)]
        assert wt.levels.shape[-2] == qmatmul_kernels.level_rows(wt.d_in, bits)
    assert pt["lm_head"].d_out % qmatmul_kernels.LANES == 0


def test_supports_layers_matches_pallas():
    layers_j, layers_t = _packed_layers(codecs.GGML_TYPE_Q4_0, seed=0)
    assert pallas_decode.supports_layers(layers_j, jnp.bfloat16, 1, 1)
    assert decode_kernels.supports_layers(layers_t, torch.bfloat16, 1, 1)
    assert not decode_kernels.supports_layers(layers_t, torch.float16, 1, 1)
    assert not decode_kernels.supports_layers(layers_t, torch.bfloat16, 1, 4)
    raw = params_from_numpy(params_from_state_dict(
        make_state_dict(CFG, seed=0), CFG, qtype=codecs.GGML_TYPE_Q4_0),
        "cpu")
    assert not decode_kernels.supports_layers(raw["layers"], torch.bfloat16,
                                              1, 1)


def test_kv_block_matches_pallas():
    for w in (16, 24, 128, 256, 512, 1024):
        assert decode_kernels.kv_block(w, 1024) == pallas_decode._kv_block(
            w, 1, 1024)
