"""The port's batched-serving kernels (their plain versions, on the CPU)
against the JAX package's Pallas kernels in interpret mode: the batched
decode step, the KV commit and the two fused lm_head + commit epilogues.

Same planes (carried across byte for byte by ``params_from_numpy``) and
the same seeded numpy inputs go through both. The CUDA kernels are held
against these plain versions on the card by ``chip_smoke.py``.
"""

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

CFG = BioGptConfig.tiny(d_model=128, d_ff=256, n_head=2, n_layer=3,
                        n_vocab=256, n_positions=64)
# f32 summation order only (see tests/test_torch_kernels.py)
SUM_ORDER_RTOL = 1e-5


def _rel_close(got, want, rtol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _packed_layers(qtype, seed):
    params = _pack_matmul_weights(params_from_state_dict(
        make_state_dict(CFG, seed=seed), CFG, qtype=qtype))
    return params["layers"], params_from_numpy(params["layers"], "cpu")


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


@pytest.mark.parametrize("qtype,past,kv_block,kv_groups", [
    (codecs.GGML_TYPE_Q4_0, [0, 5, 17, 40], None, None),
    (codecs.GGML_TYPE_Q4_0, [0, 5, 17, 40], 8, 2),
    (codecs.GGML_TYPE_Q4_1, [3, 0, 9, 31, 12, 0, 1, 22, 30, 7, 16, 25], 8,
     None),
    (codecs.GGML_TYPE_Q4_1, [3, 0, 9, 31, 12, 0, 1, 22, 30, 7, 16, 25], 8, 2),
    (codecs.GGML_TYPE_Q5_0, [0, 5, 17, 40], None, None),
    (codecs.GGML_TYPE_Q5_1, [3, 0, 9, 31, 12, 0, 1, 22, 30, 7, 16, 25], 8,
     None),
    (codecs.GGML_TYPE_Q8_0, [0, 5, 17, 40], 8, None),
])
def test_batched_decode_step_matches_pallas(qtype, past, kv_block, kv_groups):
    """B = 4 and 12, ragged per-slot positions (dead slots at 0, one slot
    past the window of 32), one and several KV blocks, with and without the
    TPU kernel's grouped KV streaming (which changes no number). Both sides
    run the bf16-path arithmetic with dequant-then-dot projections; they
    differ in f32 summation order and the GELU's erf (the TPU polynomial is
    within 1.5e-7), which can flip a bf16 rounding. Tolerance: 1e-3 of the
    hidden state's magnitude, one bf16 ulp (2^-7) of the rows' largest."""
    layers_j, layers_t = _packed_layers(qtype, seed=qtype + len(past))
    L, S, D = CFG.n_layer, CFG.n_positions, CFG.d_model
    B, window = len(past), 32
    rng = np.random.RandomState(len(past))
    x0 = rng.randn(B, D).astype(np.float32)
    k = (rng.randn(L, B, S, D) * 0.5).astype(np.float32)
    v = (rng.randn(L, B, S, D) * 0.5).astype(np.float32)
    pj = jnp.asarray(past, jnp.int32)
    x_j, kr_j, vr_j = pallas_decode.decode_step_fused(
        jnp.asarray(x0), layers_j, jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), pj, n_head=CFG.n_head, window=window,
        interpret=True, kv_block=kv_block, kv_groups=kv_groups)
    pt = torch.tensor(past, dtype=torch.int32)
    if kv_block is None:   # the wrapper walks the TPU kernel's own blocks
        x_t, kr_t, vr_t = decode_kernels.decode_step_fused(
            torch.from_numpy(x0), layers_t, _bf16(k), _bf16(v), pt,
            n_head=CFG.n_head, window=window)
    else:
        x_t, kr_t, vr_t = decode_kernels.decode_step_fused_batched_plain(
            torch.from_numpy(x0), layers_t, _bf16(k), _bf16(v), pt,
            n_head=CFG.n_head, window=window, kv_block_size=kv_block)
    _rel_close(x_t.numpy(), np.asarray(x_j), 1e-3)
    for got, want in ((kr_t, kr_j), (vr_t, vr_j)):
        _rel_close(got.float().numpy(), np.asarray(want, np.float32), 2 ** -7)


def test_batched_gates_match_pallas():
    layers_j, layers_t = _packed_layers(codecs.GGML_TYPE_Q4_0, seed=0)
    for b in (1, 2, 12, 32, 33):
        assert (decode_kernels.supports_layers(layers_t, torch.bfloat16, b, 1)
                == pallas_decode.supports_layers(layers_j, jnp.bfloat16, b, 1))
    for w in (16, 128, 256, 512, 1024):
        for b in (2, 8, 32):
            assert (decode_kernels.kv_block(w, 1024, batch=b)
                    == pallas_decode._kv_block(w, b, 1024))


def _cache_pair(B, S, seed):
    rng = np.random.RandomState(seed)
    L, D = CFG.n_layer, CFG.d_model
    kc = rng.randn(L, B, S, D).astype(np.float32)
    vc = rng.randn(L, B, S, D).astype(np.float32)
    krt = rng.randn(B, L, D).astype(np.float32)
    vrt = rng.randn(B, L, D).astype(np.float32)
    past = rng.randint(0, S, size=B).astype(np.int32)
    return kc, vc, krt, vrt, past


def _bits(t):
    return t.view(torch.int16).numpy()


def _jbits(a):
    return np.asarray(a).view(np.int16)


def test_kv_commit_matches_pallas_exactly():
    kc, vc, krt, vrt, past = _cache_pair(B=5, S=24, seed=1)
    kj, vj = pallas_decode.kv_commit_pallas(
        jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16),
        jnp.asarray(krt, jnp.bfloat16), jnp.asarray(vrt, jnp.bfloat16),
        jnp.asarray(past), interpret=True)
    kt, vt = _bf16(kc), _bf16(vc)
    out = decode_kernels.kv_commit(kt, vt, _bf16(krt), _bf16(vrt),
                                   torch.from_numpy(past))
    assert out[0] is kt and out[1] is vt          # in place
    np.testing.assert_array_equal(_bits(kt), _jbits(kj))
    np.testing.assert_array_equal(_bits(vt), _jbits(vj))


def test_kv_commit_clamps_like_dynamic_update_slice():
    """A position past the cache lands on its last row, as the per-slot
    dynamic_update_slice of the JAX serving path writes it."""
    from jax import lax

    kc, vc, krt, vrt, _ = _cache_pair(B=2, S=8, seed=2)
    past = np.array([8, 11], np.int32)
    kt, vt = _bf16(kc), _bf16(vc)
    decode_kernels.kv_commit(kt, vt, _bf16(krt), _bf16(vrt),
                             torch.from_numpy(past))
    want = jnp.asarray(kc, jnp.bfloat16)
    rows = jnp.asarray(krt, jnp.bfloat16)
    for b in range(2):
        want = lax.dynamic_update_slice(
            want, rows[b][:, None, None, :], (0, b, int(past[b]), 0))
    np.testing.assert_array_equal(_bits(kt), _jbits(want))


def _lm_head_pair(seed, tie=False):
    """(JAX planes, port planes) of a Q4_0 lm_head, 1024 columns (two
    512-column tiles). ``tie``: columns 100 and 700 (across tiles), 3 and 5
    (inside one) made identical and dominant for +-[1]*64 halves of x."""
    import ml_dtypes

    rng = np.random.RandomState(seed)
    qt = pack_nibble_planes(quantize_to_planes(
        rng.randn(1024, 128).astype(np.float32), codecs.GGML_TYPE_Q4_0))
    lv = np.array(qt.levels)
    sc = np.asarray(qt.scales).astype(ml_dtypes.bfloat16)
    if tie:
        for col, byte in ((100, 0x1F), (700, 0x1F), (3, 0xF1), (5, 0xF1)):
            lv[:, col] = byte
            sc[:, col] = 0.5
    qt = qt._replace(levels=lv, scales=sc)
    return qt, params_from_numpy(qt, device="cpu")


def _epilogue_inputs(M, seed, tie=False):
    rng = np.random.RandomState(seed)
    if tie:
        half = np.concatenate([np.ones(64), -np.ones(64)]).astype(np.float32)
        rows = [half, -half, np.full(128, np.nan, np.float32)]
        x = np.stack([rows[i % 3] for i in range(M)])
        lnw, lnb = np.ones(128, np.float32), np.zeros(128, np.float32)
    else:
        x = rng.randn(M, 128).astype(np.float32)
        x[M // 2] = np.nan                       # one poisoned row
        lnw = rng.randn(128).astype(np.float32)
        lnb = (rng.randn(128) * 0.1).astype(np.float32)
    kc, vc, krt, vrt, past = _cache_pair(B=M, S=16, seed=seed + 1)
    return x, lnw, lnb, kc, vc, krt, vrt, past


def _port_args(x, lnw, lnb, kc, vc, krt, vrt, past):
    return (torch.from_numpy(x), torch.from_numpy(lnw), torch.from_numpy(lnb),
            _bf16(kc), _bf16(vc), _bf16(krt), _bf16(vrt),
            torch.from_numpy(past))


@pytest.mark.parametrize("M", [4, 12])
@pytest.mark.parametrize("tie", [False, True])
def test_lm_head_argmax_commit_matches_pallas(M, tie):
    """X' rows at M = 4, dequant-then-dot at M = 12: ids equal (ties to the
    lowest index, an all-NaN row to (NaN, n_valid - 1)), winning logits to
    summation order, caches bit-equal."""
    qt_j, qt_t = _lm_head_pair(seed=M, tie=tie)
    x, lnw, lnb, kc, vc, krt, vrt, past = _epilogue_inputs(M, seed=M, tie=tie)
    n_valid = 1000
    ids_j, mv_j, kj, vj = pallas_qmatmul.lm_head_argmax_commit_pallas(
        jnp.asarray(x), jnp.asarray(lnw), jnp.asarray(lnb), qt_j, n_valid,
        jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16),
        jnp.asarray(krt, jnp.bfloat16), jnp.asarray(vrt, jnp.bfloat16),
        jnp.asarray(past), interpret=True)
    xt, lw, lb, kt, vt, krt_t, vrt_t, pt = _port_args(x, lnw, lnb, kc, vc,
                                                      krt, vrt, past)
    ids_t, mv_t, kt, vt = qmatmul_kernels.lm_head_argmax_commit(
        xt, lw, lb, qt_t, n_valid, kt, vt, krt_t, vrt_t, pt)
    ids_j, mv_j = np.asarray(ids_j), np.asarray(mv_j)
    if tie:
        assert list(ids_j[:3]) == [100, 3, n_valid - 1]
    np.testing.assert_array_equal(ids_t.numpy(), ids_j)
    nan = np.isnan(mv_j)
    assert nan.any() and (np.isnan(mv_t.numpy()) == nan).all()
    _rel_close(mv_t.numpy()[~nan], mv_j[~nan], SUM_ORDER_RTOL)
    np.testing.assert_array_equal(_bits(kt), _jbits(kj))
    np.testing.assert_array_equal(_bits(vt), _jbits(vj))


@pytest.mark.parametrize("M", [4, 12])
def test_lm_head_logits_gmax_commit_matches_pallas(M):
    """Logits to summation order with pad columns at -1e30, the group
    maxima likewise (a NaN row NaNs its groups), caches bit-equal."""
    qt_j, qt_t = _lm_head_pair(seed=20 + M)
    x, lnw, lnb, kc, vc, krt, vrt, past = _epilogue_inputs(M, seed=20 + M)
    n_valid = 1000
    lo_j, gm_j, kj, vj = pallas_qmatmul.lm_head_logits_gmax_commit_pallas(
        jnp.asarray(x), jnp.asarray(lnw), jnp.asarray(lnb), qt_j, n_valid,
        jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16),
        jnp.asarray(krt, jnp.bfloat16), jnp.asarray(vrt, jnp.bfloat16),
        jnp.asarray(past), interpret=True)
    xt, lw, lb, kt, vt, krt_t, vrt_t, pt = _port_args(x, lnw, lnb, kc, vc,
                                                      krt, vrt, past)
    lo_t, gm_t, kt, vt = qmatmul_kernels.lm_head_logits_gmax_commit(
        xt, lw, lb, qt_t, n_valid, kt, vt, krt_t, vrt_t, pt)
    lo_j, gm_j = np.asarray(lo_j), np.asarray(gm_j)
    assert lo_t.shape == lo_j.shape == (M, 1024)
    assert gm_t.shape == gm_j.shape == (M, 8)
    good = np.arange(M) != M // 2
    assert np.isnan(gm_t.numpy()[M // 2]).all() and np.isnan(gm_j[M // 2]).all()
    _rel_close(lo_t.numpy()[good], lo_j[good], SUM_ORDER_RTOL)
    _rel_close(gm_t.numpy()[good], gm_j[good], SUM_ORDER_RTOL)
    assert (lo_t.numpy()[:, n_valid:] == -1e30).all()
    np.testing.assert_array_equal(_bits(kt), _jbits(kj))
    np.testing.assert_array_equal(_bits(vt), _jbits(vj))
