"""The port's refill prefill path (``ops/prefill_kernels.py``,
``forward_prefill_fused``, the serving refills) against the JAX package's
``pallas_prefill.prefill_fused`` in interpret mode, on the CPU at a small
configuration. Same planes (carried across byte for byte by
``params_from_numpy``) and the same seeded numpy inputs go through both.
The CUDA kernel is held against the plain version on the card by
``chip_smoke.py``."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from biogpt_tpu.config import BioGptConfig, GenerationParams as JaxGen
from biogpt_tpu.modelio.checkpoint import params_from_state_dict
from biogpt_tpu.modelio.synthetic import make_state_dict
from biogpt_tpu.models.biogpt import (
    forward_prefill_fused as jax_forward_prefill_fused)
from biogpt_tpu.ops import pallas_prefill
from biogpt_tpu.ops.qmatmul import set_pallas_mode
from biogpt_tpu.quant import codecs
from biogpt_tpu.runtime.engine import _pack_matmul_weights
from biogpt_tpu.runtime.serving import BatchedEngine as JaxBatchedEngine
from biogpt_tpu.runtime.serving import Request as JaxRequest

from biogpt_tpu_torch.config import BioGptConfig as TorchConfig
from biogpt_tpu_torch.config import GenerationParams
from biogpt_tpu_torch.modelio.checkpoint import params_from_numpy
from biogpt_tpu_torch.models.biogpt import forward_prefill_fused
from biogpt_tpu_torch.ops import prefill_kernels
from biogpt_tpu_torch.runtime import serving
from biogpt_tpu_torch.runtime.cache import QuantKVCache
from biogpt_tpu_torch.runtime.serving import BatchedEngine, Request

CFG_KW = dict(d_model=128, d_ff=256, n_head=2, n_layer=3, n_vocab=256,
              n_positions=64)
CFG = BioGptConfig.tiny(**CFG_KW)
TCFG = TorchConfig.tiny(**CFG_KW)


def _rel_close(got, want, rtol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _packed(qtype, seed):
    """(JAX engine-packed params, the port's with the same bytes)."""
    p = _pack_matmul_weights(params_from_state_dict(
        make_state_dict(CFG, seed=seed), CFG, qtype=qtype))
    return p, params_from_numpy(p, device="cpu")


def _prompts(lens, padded, seed):
    rng = np.random.RandomState(seed)
    ids = np.zeros((len(lens), padded), np.int32)
    for r, n in enumerate(lens):
        ids[r, :n] = rng.randint(3, CFG.n_vocab, size=n)
    return ids, np.asarray([n - 1 for n in lens], np.int32)


@pytest.mark.parametrize("qtype,lens,padded", [
    (codecs.GGML_TYPE_Q4_0, [5], 8),                      # 1-row refill
    (codecs.GGML_TYPE_Q4_0, [3, 8, 6, 2], 8),             # a full small wave
    (codecs.GGML_TYPE_Q4_0, [13, 4], 16),                 # ragged in a bucket
    (codecs.GGML_TYPE_Q4_0, [30], 32),                    # one longer prompt
    (codecs.GGML_TYPE_Q4_0, [3, 8, 6, 2, 5, 7, 4, 1], 8),  # 8-row wave
    (codecs.GGML_TYPE_Q4_1, [7, 3], 8),
    (codecs.GGML_TYPE_Q4_1, [13, 4], 16),
    (codecs.GGML_TYPE_Q5_0, [3, 8, 6, 2], 8),
    (codecs.GGML_TYPE_Q5_1, [13, 4], 16),
    (codecs.GGML_TYPE_Q8_0, [7, 3], 8),
    (codecs.GGML_TYPE_Q8_0, [13, 4], 16),
])
def test_prefill_plain_matches_pallas(qtype, lens, padded):
    """``prefill_fused_plain`` against ``prefill_fused(interpret=True)`` on
    the shapes of tests/test_pallas_prefill.py: the hidden state of every
    row and each layer's K/V rows, padding rows included. Both sides run
    the TPU kernel's arithmetic; they differ in f32 summation order and
    the GELU's erf (the TPU polynomial is within 1.5e-7), which can flip a
    bf16 rounding. Tolerance: 1e-3 of the hidden state's magnitude, one
    bf16 ulp (2^-7) of the rows' largest."""
    pj, pt = _packed(qtype, seed=len(lens) + padded)
    R, T = len(lens), padded
    x0 = np.random.RandomState(R * T).randn(R * T, CFG.d_model).astype(
        np.float32)
    x_j, kr_j, vr_j = pallas_prefill.prefill_fused(
        jnp.asarray(x0), pj["layers"], rows=R, padded=T, n_head=CFG.n_head,
        interpret=True)
    x_t, kr_t, vr_t = prefill_kernels.prefill_fused(
        torch.from_numpy(x0), pt["layers"], rows=R, padded=T,
        n_head=CFG.n_head)
    assert kr_t.dtype == torch.bfloat16 and kr_t.shape == kr_j.shape
    _rel_close(x_t.numpy(), np.asarray(x_j), 1e-3)
    for got, want in ((kr_t, kr_j), (vr_t, vr_j)):
        _rel_close(got.float().numpy(), np.asarray(want, np.float32), 2 ** -7)


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_forward_prefill_fused_matches_jax(cache_dtype):
    """The whole refill forward (embedding, the kernel, the last rows' LN
    and lm_head at R rows, the small cache): logit argmax equal; the small
    cache's bf16 rows to one ulp; int8 levels differ by at most one, and
    only where the kernel's bf16 row differs or lies on a rounding
    boundary, with scales within 1e-6 relative."""
    pj, pt = _packed(codecs.GGML_TYPE_Q4_0, seed=3)
    ids, last = _prompts([5, 8, 2, 7], 8, seed=4)
    jd = jnp.int8 if cache_dtype == "int8" else jnp.bfloat16
    td = torch.int8 if cache_dtype == "int8" else torch.bfloat16
    try:
        set_pallas_mode(True)
        lj, sj = jax_forward_prefill_fused(pj, jnp.asarray(ids), CFG,
                                           jnp.asarray(last), cache_dtype=jd,
                                           interpret=True)
    finally:
        set_pallas_mode("auto")
    lt, st = forward_prefill_fused(pt, torch.from_numpy(ids).long(), TCFG,
                                   torch.from_numpy(last).long(),
                                   cache_dtype=td)
    lj = np.asarray(lj, np.float32)
    np.testing.assert_array_equal(lt.numpy().argmax(-1), lj.argmax(-1))
    _rel_close(lt.numpy(), lj, 1e-3)
    if cache_dtype == "bf16":
        for got, want in ((st.k, sj.k), (st.v, sj.v)):
            _rel_close(got.float().numpy(), np.asarray(want, np.float32),
                       2 ** -7)
        return
    assert isinstance(st, QuantKVCache) and st.ks.shape == sj.ks.shape
    _, sb = forward_prefill_fused(pt, torch.from_numpy(ids).long(), TCFG,
                                  torch.from_numpy(last).long())
    for lv_t, sc_t, lv_j, sc_j, rows in ((st.k, st.ks, sj.k, sj.ks, sb.k),
                                         (st.v, st.vs, sj.v, sj.vs, sb.v)):
        sc_t, sc_j = sc_t.numpy(), np.asarray(sc_j)
        np.testing.assert_allclose(sc_t, sc_j, rtol=1e-6, atol=0)
        diff = lv_t.numpy().astype(np.int32) - np.asarray(lv_j, np.int32)
        assert np.abs(diff).max() <= 1
        # where a level moved, the rounding was a tie within the rows' own
        # rounding: x / scale within a bf16 ulp of a half level
        ratio = rows.float().numpy() / np.swapaxes(sc_t, 2, 3)
        off = np.abs(np.abs(ratio - np.trunc(ratio)) - 0.5)
        assert (off[diff != 0] <= 2 ** -7 * np.abs(ratio)[diff != 0]).all()


def test_supports_prefill_gate():
    """The R*T routing caps equal the JAX gate's; the port drops the
    Mosaic tiling conditions and states its own: head width 64 and
    T <= n_positions."""
    pj, pt = _packed(codecs.GGML_TYPE_Q4_0, seed=0)
    for rows in (1, 2, 4, 8, 16, 32):
        for padded in (8, 16, 32, 64, 128, 256, 512):
            want = pallas_prefill.supports_prefill(pj["layers"], rows, padded,
                                                   1024)
            got = prefill_kernels.supports_prefill(
                pt["layers"], rows, padded, n_head=16, n_positions=1024)
            # (tiny layers, 347M's head count: head width 8 fails)
            assert not got
            assert prefill_kernels.supports_prefill(
                pt["layers"], rows, padded, n_head=CFG.n_head,
                n_positions=1024) == want, (rows, padded)
    assert not prefill_kernels.supports_prefill(
        pt["layers"], 1, 128, n_head=CFG.n_head, n_positions=64)
    # a padded % 8 shape the TPU gate refuses for Mosaic tiling
    assert prefill_kernels.supports_prefill(pt["layers"], 2, 12,
                                            n_head=CFG.n_head, n_positions=64)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_serving_refills_through_prefill_kernel_match_jax(kv_quant,
                                                          monkeypatch):
    """bf16 compute, packed Q4_0, the refill kernel switched on for both
    engines (``_prefill_fused``, as tests/test_pallas_prefill.py does on
    the JAX side): every greedy id equals the JAX engine's under
    ``set_pallas_mode(True)``, over refill waves of mixed lengths, with a
    bf16 and an int8 cache; the port's refills all take the kernel."""
    pj = params_from_state_dict(make_state_dict(CFG, seed=11), CFG,
                                qtype=codecs.GGML_TYPE_Q4_0)
    pt = params_from_numpy(pj, device="cpu")
    prompts = [[2, 41, 7], [2, 19, 3, 8, 30, 11, 4, 9, 60], [2, 5],
               [2, 13, 17, 40, 22], [2, 90, 91]]
    kw = dict(max_batch=4, chunk=2, max_seq=32, kv_quant=kv_quant)
    gen = dict(temp=0.0, stop_at_eos=False)
    je = JaxBatchedEngine(CFG, pj, compute_dtype=jnp.bfloat16, **kw)
    je._prefill_fused = True
    try:
        set_pallas_mode(True)
        want = je.serve([JaxRequest(prompt_ids=p, n_predict=4, request_id=i)
                         for i, p in enumerate(prompts)], JaxGen(**gen))
    finally:
        set_pallas_mode("auto")
    te = BatchedEngine(TCFG, pt, compute_dtype=torch.bfloat16, device="cpu",
                       **kw)
    assert not te._prefill_fused                 # off on the CPU by default
    assert te._fused_sampled == (not kv_quant)
    te._prefill_fused = True
    calls = []
    real = serving.forward_prefill_fused
    monkeypatch.setattr(serving, "forward_prefill_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = te.serve([Request(prompt_ids=p, n_predict=4, request_id=i)
                    for i, p in enumerate(prompts)], GenerationParams(**gen))
    assert len(calls) == te.metrics.snapshot()["refill_programs"] >= 2
    assert {k: v.ids for k, v in got.items()} == {k: v.ids
                                                  for k, v in want.items()}
