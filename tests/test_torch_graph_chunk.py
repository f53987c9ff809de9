"""The engines' decode chunks (``runtime/graphs.py``, ``Engine.generate``,
``BatchedEngine._run_chunk``) on the CPU at a small configuration, against
the JAX engines (``Engine.decode_scan``, ``BatchedEngine.step_scan``) run
in the same process with their kernels in interpret mode.

On the CPU a chunk body runs directly, through the kernels' plain
versions; on the card the same body is a CUDA graph's replay
(``chip_smoke.py``'s graph phase holds the two equal there). Here:

- the B=1 route, whose position is a (1,) tensor end to end, against the
  host-int route (the same steps with the host's position, committed by
  ``commit_rows``): equal ids and bit-equal caches, bf16 and int8; greedy
  ids equal to the JAX engine's; sampled ids equal to the eager loop's
  (the host-int steps and the same sampler and seed) bit for bit;
- a generation that crosses the window-128 bucket with a budget that is
  not a multiple of 64, chunk by chunk (64 steps at window 128, then
  4 + 1 at 256), against the JAX engine;
- the binary decomposition of a budget, and the runner's order (a key's
  eager runs, then its capture and replays) with its launch counts (a CPU
  stand-in for the CUDA graph: the capture records each stand-in
  kernel's device work, a replay runs it without the host's wrappers);
- the engines' reused caches: a long then a short generation on one
  ``Engine``, and two serves on one ``BatchedEngine``, against fresh
  engines and the JAX engines.

Greedy ids are required equal; caches are compared bit for bit (the same
plain versions on the same inputs).
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from biogpt_tpu.config import BioGptConfig, GenerationParams as JaxGen
from biogpt_tpu.modelio.checkpoint import params_from_state_dict
from biogpt_tpu.modelio.synthetic import make_state_dict
from biogpt_tpu.ops.qmatmul import set_pallas_mode
from biogpt_tpu.quant import codecs
from biogpt_tpu.runtime.engine import Engine as JaxEngine
from biogpt_tpu.runtime.serving import BatchedEngine as JaxBatchedEngine
from biogpt_tpu.runtime.serving import Request as JaxRequest

from biogpt_tpu_torch.config import BioGptConfig as TorchConfig
from biogpt_tpu_torch.config import GenerationParams
from biogpt_tpu_torch.modelio.checkpoint import params_from_numpy
from biogpt_tpu_torch.models.biogpt import forward_fused_decode_greedy
from biogpt_tpu_torch.ops import cuda_lib
from biogpt_tpu_torch.runtime import graphs
from biogpt_tpu_torch.runtime.engine import Engine
from biogpt_tpu_torch.runtime.sampling import greedy, sample_top_k_top_p
from biogpt_tpu_torch.runtime.serving import BatchedEngine, Request

# the fused step's and the argmax tail's widths; 256 positions hold a
# window of 256
CFG_KW = dict(d_model=128, d_ff=256, n_head=2, n_layer=2, n_vocab=256,
              n_positions=256)
CFG = BioGptConfig.tiny(**CFG_KW)
TCFG = TorchConfig.tiny(**CFG_KW)
SHORT = [2, 10, 25, 48, 7, 91]                                # 6 tokens
LONG = [2] + np.random.RandomState(9).randint(3, 256, size=59).tolist()  # 60


@pytest.fixture(scope="module")
def pair():
    pj = params_from_state_dict(make_state_dict(CFG, seed=13), CFG,
                                qtype=codecs.GGML_TYPE_Q4_0)
    return pj, params_from_numpy(pj, device="cpu")


@contextlib.contextmanager
def _interpret():
    try:
        set_pallas_mode(True)
        yield
    finally:
        set_pallas_mode("auto")


@pytest.fixture(scope="module")
def jax_greedy(pair):
    """The JAX engine's greedy ids: the long prompt past the window-128
    bucket (bf16), the short prompt (bf16, int8)."""
    pj, _ = pair
    out = {}
    for kv_quant, runs in ((False, (("long", LONG, 70), ("short", SHORT, 12))),
                           (True, (("short", SHORT, 12),))):
        eng = JaxEngine(CFG, pj, compute_dtype=jnp.bfloat16,
                        kv_quant=kv_quant)
        with _interpret():
            for name, prompt, n in runs:
                out[(name, kv_quant)] = eng.generate(prompt, JaxGen(
                    n_predict=n, temp=0.0, stop_at_eos=False)).ids
    return out


def _host_int_loop(eng, prompt, n, gen):
    """The host-int route on a fresh cache: each step at the host's
    position (``commit_rows``), greedy through the fused tail or sampled
    with host floats from a generator seeded like ``eng``'s -> (ids,
    cache)."""
    g = torch.Generator().manual_seed(gen.seed)
    cache = eng.new_cache()
    logits, cache, past = eng.prefill(cache, prompt)

    def pick(lg):
        if gen.temp <= 0:
            return greedy(lg)
        return sample_top_k_top_p(lg, g, top_k=gen.top_k, top_p=gen.top_p,
                                  temp=gen.temp)
    tok, ids = pick(logits), list(prompt)
    ids.append(int(tok[0]))
    for i in range(n - 1):
        window = eng._window(past + 1 + eng.SCAN_LEN * (1 + i // 64))
        if gen.temp <= 0:
            tok, _, cache = forward_fused_decode_greedy(
                eng.params, tok.reshape(1, 1).long(), cache, past + i,
                eng.config, kv_window=window)
        else:
            logits, cache = eng.decode_step(cache, tok, past + i, window)
            tok = pick(logits)
        ids.append(int(tok[0]))
    return ids, cache


def _planes(cache):
    return [t for t in (cache.k, cache.v, getattr(cache, "ks", None),
                        getattr(cache, "vs", None)) if t is not None]


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_b1_device_position_matches_host_int_and_jax(pair, jax_greedy,
                                                     kv_quant):
    _, pt = pair
    gen = GenerationParams(n_predict=12, temp=0.0, stop_at_eos=False)
    eng = Engine(TCFG, pt, kv_quant=kv_quant, device="cpu")
    assert eng._fused_greedy and not eng.graphs.capture
    got = eng.generate(SHORT, gen).ids
    want, cache = _host_int_loop(eng, SHORT, 12, gen)
    assert got == want == jax_greedy[("short", kv_quant)]
    for a, b in zip(_planes(eng._cache), _planes(cache)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_b1_sampled_matches_the_eager_loop(pair, kv_quant):
    _, pt = pair
    gen = GenerationParams(n_predict=12, temp=0.9, top_k=12, top_p=0.9,
                           seed=3, stop_at_eos=False)
    eng = Engine(TCFG, pt, kv_quant=kv_quant, device="cpu")
    got = eng.generate(SHORT, gen).ids
    want, cache = _host_int_loop(eng, SHORT, 12, gen)
    assert got == want
    assert got != eng.generate(SHORT, dataclasses.replace(gen, seed=4)).ids
    assert eng.generate(SHORT, gen).ids == got      # reseeded per call
    for a, b in zip(_planes(eng._cache), _planes(cache)):
        assert torch.equal(a, b)


def test_generation_crosses_the_window_128_bucket(pair, jax_greedy,
                                                  monkeypatch):
    """69 steps from a 60-token prompt: a 64-step chunk at window 128,
    then 5 = 4 + 1 steps at window 256."""
    _, pt = pair
    eng = Engine(TCFG, pt, device="cpu")
    runs = []
    real = eng._run_steps
    monkeypatch.setattr(eng, "_run_steps", lambda cache, st, n, window, *a:
                        (runs.append((n, window)),
                         real(cache, st, n, window, *a)))
    got = eng.generate(LONG, GenerationParams(n_predict=70, temp=0.0,
                                              stop_at_eos=False))
    assert runs == [(64, 128), (4, 256), (1, 256)]
    assert got.ids == jax_greedy[("long", False)]


@pytest.mark.parametrize("n", [1, 5, 63, 64, 65, 100, 127, 200])
def test_binary_chunks(n):
    parts = graphs.binary_chunks(n, 64)
    assert sum(parts) == n and parts == sorted(parts, reverse=True)
    assert all(p <= 64 and p & (p - 1) == 0 for p in parts)
    tail = [p for p in parts if p < 64]
    assert len(tail) == len(set(tail)) == bin(n % 64).count("1")


# ------------------------------------------------ a CUDA graph stand-in

class _Graph:
    """Stand-in for ``torch.cuda.CUDAGraph``: a capture records each
    stand-in kernel's device work; a replay runs it, and no wrapper."""
    capturing = None

    def __init__(self):
        self.ops, self.generators = [], []

    def register_generator_state(self, g):
        self.generators.append(g)

    def replay(self):
        for op in self.ops:
            op()


class _Capture:
    def __init__(self, graph, pool=None, capture_error_mode="global"):
        self.graph = graph

    def __enter__(self):
        _Graph.capturing = self.graph

    def __exit__(self, *exc):
        _Graph.capturing = None


def _launch(name: str, op) -> None:
    """A kernel wrapper's stand-in: the host counts the launch, and the
    device runs ``op`` now, or at each replay of the graph under capture."""
    cuda_lib.LAUNCHES[name] += 1
    if _Graph.capturing is not None:
        _Graph.capturing.ops.append(op)
    else:
        op()


def test_eager_runs_then_capture_and_replays_count_launches(monkeypatch):
    """A key's first ``EAGER_RUNS`` runs call the body, the next captures
    it (moving nothing) and replays it, and later runs replay: after every
    run the state and the generator's draws are the eager runner's, and
    the launch counts are the eager runs' plus the replays'."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", _Capture)
    runs, eager_runs = 5, graphs.ChunkGraphs.EAGER_RUNS

    def make():
        gen = torch.Generator().manual_seed(7)
        pos, ring = torch.zeros(1), torch.zeros(4)
        draws = torch.zeros(4)

        def body():   # 4 steps: two kernels a step, one drawing
            for i in range(4):
                _launch("decode_step_fused",
                        lambda i=i: (ring[i:i + 1].copy_(pos), pos.add_(1)))
                _launch("qmatmul", lambda i=i: draws[i:i + 1].copy_(
                    torch.rand(1, generator=gen)))
        return gen, (pos, ring, draws), body

    cuda_lib.reset_launch_counts()
    gen, state, body = make()
    eager = graphs.ChunkGraphs("cpu", gen, capture=False)
    outs = []
    for _ in range(runs):
        eager.run("k", body, sampled=True)
        outs.append([t.clone() for t in state])
    assert eager.captures == eager.replays == 0
    assert cuda_lib.LAUNCHES["decode_step_fused"] == 4 * runs

    cuda_lib.reset_launch_counts()
    gen, state, body = make()
    runner = graphs.ChunkGraphs("cpu", gen, capture=False)
    runner.capture = True   # the card's path, on the stand-ins
    for r in range(runs):
        runner.run("k", body, sampled=True)
        assert runner.captures == (r >= eager_runs)
        assert runner.replays == max(0, r + 1 - eager_runs)
        for got, want in zip(state, outs[r]):
            assert torch.equal(got, want)
    assert runner.runs == {"k": eager_runs}
    assert runner.graphs["k"][0].generators == [gen]
    assert runner.launches("k") == {"decode_step_fused": 4, "qmatmul": 4}
    # the eager runs' launches and the replays': the capture launches none
    assert cuda_lib.LAUNCHES["decode_step_fused"] == 4 * runs
    assert cuda_lib.LAUNCHES["qmatmul"] == 4 * runs
    cuda_lib.reset_launch_counts()


# ----------------------------------------------------- reused caches

def test_engine_long_then_short_matches_fresh_and_jax(pair, jax_greedy):
    _, pt = pair
    gen = GenerationParams(temp=0.0, stop_at_eos=False)
    eng = Engine(TCFG, pt, device="cpu")
    long_ids = eng.generate(LONG, dataclasses.replace(gen, n_predict=70)).ids
    short_ids = eng.generate(SHORT, dataclasses.replace(gen,
                                                        n_predict=12)).ids
    assert long_ids == jax_greedy[("long", False)]
    assert short_ids == jax_greedy[("short", False)]
    fresh = Engine(TCFG, pt, device="cpu")
    assert fresh.generate(SHORT, dataclasses.replace(gen,
                                                     n_predict=12)).ids \
        == short_ids


@pytest.mark.parametrize("flags", [
    {}, dict(staged_kv=True), dict(kv_quant=True), dict(paged_kv=True)],
    ids=["lockstep", "staged", "int8", "paged"])
def test_batched_engine_two_serves_match_fresh_and_jax(pair, flags):
    """A serve of long requests, then one of short ones, on one engine
    (its pool cache and slot state reused) against a fresh engine and the
    JAX engine with the same route (B=2, chunks of 3: refills into slots
    the first serve filled past the second's prompts)."""
    pj, pt = pair
    kw = dict(max_batch=2, chunk=3, max_seq=64, **flags)
    waves = ([LONG[:30], LONG[30:52], LONG[:41]], [SHORT, SHORT[:3]])
    n_new = (8, 5)
    gen = dict(temp=0.0, stop_at_eos=False)

    def reqs(cls, w):
        return [cls(prompt_ids=list(p), n_predict=n_new[w], request_id=i)
                for i, p in enumerate(waves[w])]
    te = BatchedEngine(TCFG, pt, device="cpu", **kw)
    assert te._fused_decode and te._fused_greedy
    te.serve(reqs(Request, 0), GenerationParams(**gen))
    got = te.serve(reqs(Request, 1), GenerationParams(**gen))
    fresh = BatchedEngine(TCFG, pt, device="cpu", **kw).serve(
        reqs(Request, 1), GenerationParams(**gen))
    for i in range(len(waves[1])):
        assert got[i].ids == fresh[i].ids, i
    je = JaxBatchedEngine(CFG, pj, compute_dtype=jnp.bfloat16, **kw)
    with _interpret():
        want = je.serve(reqs(JaxRequest, 1), JaxGen(**gen))
    for i in range(len(waves[1])):
        assert got[i].ids == want[i].ids, i
