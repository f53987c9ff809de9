"""The port's model, engine, sampler and CLI against the JAX package, on
the CPU at a small configuration (the kernels run as their plain
versions, the JAX kernels in interpret mode)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from biogpt_tpu.config import BioGptConfig, GenerationParams
from biogpt_tpu.modelio.checkpoint import params_from_state_dict
from biogpt_tpu.modelio.synthetic import make_state_dict
from biogpt_tpu.models.biogpt import forward as jax_forward
from biogpt_tpu.ops.qmatmul import set_pallas_mode
from biogpt_tpu.quant import codecs
from biogpt_tpu.runtime.cache import init_cache as jax_init_cache
from biogpt_tpu.runtime.engine import Engine as JaxEngine
from biogpt_tpu.runtime.sampling import top_k_top_p_probs as jax_probs

from biogpt_tpu_torch.config import BioGptConfig as TorchConfig
from biogpt_tpu_torch.modelio.checkpoint import params_from_numpy
from biogpt_tpu_torch.models.biogpt import forward
from biogpt_tpu_torch.runtime.cache import init_cache
from biogpt_tpu_torch.runtime.engine import Engine
from biogpt_tpu_torch.runtime.sampling import (sample_top_k_top_p,
                                               top_k_top_p_probs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_KW = dict(d_model=128, d_ff=256, n_head=2, n_layer=3, n_vocab=256,
              n_positions=64)
CFG = BioGptConfig.tiny(**CFG_KW)
TCFG = TorchConfig.tiny(**CFG_KW)


def _params(qtype, seed):
    """(JAX params, the port's params with the same bytes)."""
    p = params_from_state_dict(make_state_dict(CFG, seed=seed), CFG,
                               qtype=qtype)
    return p, params_from_numpy(p, device="cpu")


@pytest.mark.parametrize("qtype", [None, codecs.GGML_TYPE_Q4_0,
                                   codecs.GGML_TYPE_Q5_1])
@pytest.mark.parametrize("mode,n", [("last", 5), ("all", 12), ("last", 40)])
def test_forward_f32_matches_jax(qtype, mode, n):
    """f32 compute, no kernels (the JAX XLA paths): block-accum below 32
    rows, dequant-then-dot at 40. Same math, f32 summation order only:
    1e-4 of the logits' magnitude."""
    pj, pt = _params(qtype, seed=3)
    ids = np.random.RandomState(n).randint(3, CFG.n_vocab, size=(1, n))
    cj = jax_init_cache(CFG, batch=1, max_len=CFG.n_positions,
                        dtype=jnp.float32)
    want, _ = jax_forward(pj, jnp.asarray(ids, jnp.int32), cj, jnp.int32(0),
                          CFG, compute_dtype=jnp.float32, logits_mode=mode,
                          allow_pallas=False)
    ct = init_cache(TCFG, batch=1, max_len=CFG.n_positions,
                    dtype=torch.float32)
    got, ct = forward(pt, torch.from_numpy(ids), ct, 0, TCFG,
                      compute_dtype=torch.float32, logits_mode=mode,
                      allow_kernels=False)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert int(ct.k[:, :, n:].abs().sum()) == 0   # rows past n untouched


def test_forward_noncausal_compat_mode_matches_jax():
    pj, pt = _params(codecs.GGML_TYPE_Q4_1, seed=4)
    ids = np.random.RandomState(9).randint(3, CFG.n_vocab, size=(1, 8))
    cj = jax_init_cache(CFG, batch=1, max_len=16, dtype=jnp.float32)
    want, _ = jax_forward(pj, jnp.asarray(ids, jnp.int32), cj, jnp.int32(0),
                          CFG, compute_dtype=jnp.float32, causal=False,
                          logits_mode="all", allow_pallas=False,
                          last_index=jnp.int32(5))
    ct = init_cache(TCFG, batch=1, max_len=16, dtype=torch.float32)
    got, _ = forward(pt, torch.from_numpy(ids), ct, 0, TCFG,
                     compute_dtype=torch.float32, causal=False,
                     logits_mode="all", allow_kernels=False, last_index=5)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("qtype,prompt_len", [
    (codecs.GGML_TYPE_Q4_0, 6),     # prefill bucket 8: qmatmul (m = 8)
    (codecs.GGML_TYPE_Q4_0, 19),    # bucket 32: qmatmul_wide
    (codecs.GGML_TYPE_Q4_1, 12),    # bucket 16: qmatmul_wide, Q4_1 mins
    (codecs.GGML_TYPE_Q5_0, 6),     # bucket 8, the fifth-bit plane
    (codecs.GGML_TYPE_Q5_1, 12),    # bucket 16, Q5_1 mins
    (codecs.GGML_TYPE_Q8_0, 19),    # bucket 32, the unpacked lm_head tail
])
def test_engine_greedy_ids_match_jax_fused(qtype, prompt_len):
    """The main path end to end: engine-prepared planes, kernel prefill,
    fused decode and the greedy tail -- the fused LN + lm_head + argmax
    kernel for a packed lm_head, the lm_head GEMV and an argmax for Q8_0's
    unpacked one, as in the JAX engine; 24 new tokens must equal the JAX
    engine's (megakernel and Pallas GEMVs in interpret mode)."""
    pj, pt = _params(qtype, seed=7 + prompt_len)
    prompt = [2] + np.random.RandomState(prompt_len).randint(
        3, CFG.n_vocab, size=prompt_len - 1).tolist()
    gen = GenerationParams(n_predict=24, temp=0.0, seed=0, stop_at_eos=False)
    ej = JaxEngine(CFG, pj, compute_dtype=jnp.bfloat16)
    packed = qtype != codecs.GGML_TYPE_Q8_0
    assert ej._fused_decode and ej._fused_greedy == packed
    try:
        set_pallas_mode(True)
        want = ej.generate(prompt, gen, stream_cb=lambda _: None).ids
    finally:
        set_pallas_mode("auto")
    et = Engine(TCFG, pt, device="cpu")
    assert et._fused_decode and et._fused_greedy == packed
    assert et.cache_dtype == torch.bfloat16
    got = et.generate(prompt, GenerationParams(**vars(gen))).ids
    assert len(got) == prompt_len + 24
    assert got == want


def test_engine_sampled_and_streamed_paths_run():
    _, pt = _params(codecs.GGML_TYPE_Q4_0, seed=5)
    et = Engine(TCFG, pt, device="cpu")
    gen = GenerationParams(n_predict=6, temp=0.8, top_k=8, seed=3,
                           stop_at_eos=False)
    a = et.generate([2, 40, 41], gen).ids
    b = et.generate([2, 40, 41], gen).ids          # same seed, same ids
    assert a == b and len(a) == 9
    toks = []
    greedy = GenerationParams(n_predict=5, temp=0.0, stop_at_eos=False)
    c = et.generate([2, 40, 41], greedy, stream_cb=toks.append).ids
    assert toks == c[3:] == et.generate([2, 40, 41], greedy).ids[3:]


def test_top_k_top_p_probs_match_jax():
    rng = np.random.RandomState(0)
    logits = (rng.randn(3, 500) * 3).astype(np.float32)
    for top_k, top_p, temp in ((40, 0.9, 0.9), (10, 1.0, 0.5), (5, 0.3, 2.0)):
        pj, ij = jax_probs(jnp.asarray(logits), top_k, top_p, temp)
        pt, it = top_k_top_p_probs(torch.from_numpy(logits), top_k, top_p,
                                   temp)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)
    g = torch.Generator().manual_seed(1)
    ids = sample_top_k_top_p(torch.from_numpy(logits), g, top_k=5, top_p=0.3,
                             temp=2.0)
    _, it = top_k_top_p_probs(torch.from_numpy(logits), 5, 0.3, 2.0)
    kept = (top_k_top_p_probs(torch.from_numpy(logits), 5, 0.3, 2.0)[0] > 0)
    for b in range(3):
        assert int(ids[b]) in it[b][kept[b]].tolist()


def test_engine_without_card_raises():
    _, pt = _params(codecs.GGML_TYPE_Q4_0, seed=1)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")   # decided at run time
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(TCFG, pt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(TCFG, pt, kv_quant=True)
    # the int8 KV cache serves on the CPU when asked for it
    et = Engine(TCFG, pt, kv_quant=True, device="cpu")
    assert et.cache_dtype == torch.int8 and et._fused_greedy
    ids = et.generate([2, 40, 41], GenerationParams(n_predict=4, temp=0.0,
                                                    stop_at_eos=False)).ids
    assert len(ids) == 7


def test_cli_runs_on_cpu(tmp_path):
    """``python -m biogpt_tpu_torch.cli --device cpu`` on a synthetic
    Q4_0 file written by the port."""
    from biogpt_tpu_torch.modelio.synthetic import write_random_quantized_model

    path = tmp_path / "m.bin"
    write_random_quantized_model(path, TCFG, seed=2)
    env = dict(os.environ, PYTHONPATH=REPO)
    for extra in (["--temp", "0"], ["--temp", "0.9", "-s", "1", "--stream"]):
        r = subprocess.run(
            [sys.executable, "-m", "biogpt_tpu_torch.cli", "-m", str(path),
             "-p", "the cells", "-n", "6", "--device", "cpu", *extra],
            capture_output=True, text=True, timeout=300, env=env)
        assert r.returncode == 0, r.stderr
        assert "the cells" in r.stdout and "predict time" in r.stderr


def test_engine_score_matches_jax():
    """Full-sequence logits of the packed engine (kernels' plain versions
    in the f32 compute mode) against the JAX engine's in interpret mode."""
    pj, pt = _params(codecs.GGML_TYPE_Q4_0, seed=11)
    ids = np.array([[2, 5, 9, 12, 40, 41]])
    try:
        set_pallas_mode(True)
        want = JaxEngine(CFG, pj, compute_dtype=jnp.float32).score(ids)
    finally:
        set_pallas_mode("auto")
    got = Engine(TCFG, pt, compute_dtype=torch.float32, device="cpu").score(ids)
    assert got.shape == want.shape == (1, 6, CFG.n_vocab)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_health_lane_catches_non_finite_values():
    from biogpt_tpu_torch.runtime.health import (ModelHealthError,
                                                 check_params_finite)

    _, pt = _params(codecs.GGML_TYPE_Q4_0, seed=12)
    check_params_finite(pt)
    pt["final_ln"]["w"][3] = float("nan")
    with pytest.raises(ModelHealthError, match="final_ln"):
        check_params_finite(pt)
    # the poisoned final LN NaNs every logit; the fused greedy tail's max
    # value carries it to the drain, which withholds the tokens
    et = Engine(TCFG, pt, device="cpu")
    with pytest.raises(ModelHealthError, match="non-finite logits"):
        et.generate([2, 40, 41], GenerationParams(n_predict=4, temp=0.0))
