"""The serving refill and ``Engine.prefill`` as bodies on static tensors
(``runtime/serving.py::BatchedEngine._prefill_group``,
``runtime/engine.py::Engine.prefill``, ``runtime/graphs.py``) on the CPU at
a tiny configuration, against the JAX engines (``BatchedEngine
._prefill_group`` and its ``_refill_jit``) run in the same process.

On the CPU a body runs directly, through the kernels' plain versions; on
the card the same body is a CUDA graph's replay (``chip_smoke.py``'s graph
phase holds the two equal there). Here:

- the static-shape refill body against the per-slot refill it replaces
  (transcribed below as :func:`_per_slot_refill`): the pool cache, the first
  tokens, the slot vectors and the generator's state bit for bit, with the
  refill kernel's plain version and with the per-op forward; and against
  the JAX engine's refill: slot vectors exactly, greedy first tokens
  equal, the pool rows to a stated tolerance and every row it must not
  write untouched;
- a slot's refill results in a group of 16 rows and of 32: bit-equal on
  the refill kernel's route; on the per-op route the cache rows are, and
  the first tokens' logits too once both groups take one form of the
  last-token lm_head (the JAX package's own rule switches it at 32 rows);
  a data-axis replica's share of a group takes the group's forms
  (``forward(group_rows=)``);
- ``Engine.prefill``'s body against the forward it ran before (the host's
  last index, a fresh cache): logits and cache bit-equal;
- the runner's order on a CPU stand-in for ``torch.cuda.CUDAGraph`` whose
  capture launches nothing (the state the body moves is put back) and
  whose replay runs the body: refill keys of every shape, prefill keys
  and scoring keys (``Engine.logits``) run eagerly twice, are captured,
  then replay, with results equal to an eager engine's (the scores also
  to the eager forward's, JAX ``Engine.score``'s and, through
  ``perplexity_of_ids``, an eager engine's perplexity); a mesh engine
  never captures.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from biogpt_tpu.config import BioGptConfig, GenerationParams as JaxGen
from biogpt_tpu.modelio.checkpoint import params_from_state_dict
from biogpt_tpu.modelio.synthetic import make_state_dict
from biogpt_tpu.ops.qmatmul import set_pallas_mode
from biogpt_tpu.quant import codecs
from biogpt_tpu.runtime import cache as jax_cache
from biogpt_tpu.runtime.serving import BatchedEngine as JaxBatchedEngine
from biogpt_tpu.runtime.serving import Request as JaxRequest

from biogpt_tpu_torch.config import BioGptConfig as TorchConfig
from biogpt_tpu_torch.config import GenerationParams
from biogpt_tpu_torch.modelio.checkpoint import params_from_numpy
from biogpt_tpu_torch.models.biogpt import forward, forward_prefill_fused
from biogpt_tpu_torch.ops import qmatmul as ops_qmatmul
from biogpt_tpu_torch.runtime import graphs, serving
from biogpt_tpu_torch.runtime.cache import init_cache, merge_rows
from biogpt_tpu_torch.runtime.engine import Engine
from biogpt_tpu_torch.runtime.sampling import sample_per_request
from biogpt_tpu_torch.runtime.serving import BatchedEngine, Request

CFG_KW = dict(d_model=128, d_ff=256, n_head=2, n_layer=2, n_vocab=256,
              n_positions=64)
CFG = BioGptConfig.tiny(**CFG_KW)
TCFG = TorchConfig.tiny(**CFG_KW)
B, MAX_SEQ = 32, 64
SLOTS = [3, 17, 0, 30, 9]             # five rows: a group of 8, 3 padding
LENS = [9, 13, 16, 11, 10]            # one bucket of 16 tokens
SAMPLED = dict(temp=0.9, top_k=8, top_p=0.9)
GEN = dict(temp=0.0, top_k=40, top_p=0.95, stop_at_eos=False)
KV = [False, True]
KV_IDS = ["bf16", "int8"]


@pytest.fixture(scope="module")
def pair():
    pj = params_from_state_dict(make_state_dict(CFG, seed=21), CFG,
                                qtype=codecs.GGML_TYPE_Q4_0)
    return pj, params_from_numpy(pj, device="cpu")


@contextlib.contextmanager
def _interpret():
    try:
        set_pallas_mode(True)
        yield
    finally:
        set_pallas_mode("auto")


def _prompts(lens, seed):
    rng = np.random.RandomState(seed)
    return [[2] + rng.randint(3, CFG.n_vocab, size=n - 1).tolist()
            for n in lens]


def _row_kw(mode: str, i: int) -> dict:
    """Every row greedy, or every other row sampled with its own
    parameters (the rest greedy through temp 0)."""
    if mode == "sampled" and i % 2 == 0:
        return dict(SAMPLED)
    return dict(temp=0.0)


def _pairs(cls, slots, lens, mode, seed=4):
    return [(s, cls(prompt_ids=p, n_predict=4, request_id=i,
                    **_row_kw(mode, i)))
            for i, (s, p) in enumerate(zip(slots, _prompts(lens, seed)))]


def _garbage(cache, seed: int):
    """Fill every plane of a pool cache with seeded values: the rows a
    refill must not write keep them."""
    g = torch.Generator().manual_seed(seed)
    for name in ("k", "v", "ks", "vs"):
        t = getattr(cache, name, None)
        if t is None:
            continue
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g))
        else:
            t.copy_(torch.rand(t.shape, generator=g) * 4 - 2)


def _planes(cache):
    return [t for t in (cache.k, cache.v, getattr(cache, "ks", None),
                        getattr(cache, "vs", None)) if t is not None]


def _vectors(st):
    return [st.toks, st.first_buf, st.lengths, st.temps, st.top_ps,
            st.top_ks]


def _per_slot_refill(eng, pairs, cache, generator, gen, st):
    """The refill as the port ran it before its body took static shapes
    (one device): the group's forward, the first ``n`` rows sampled from
    the group's draw, the rows merged and the vectors written through an
    (n,)-long slot index."""
    lens = [len(req.prompt_ids) for _, req in pairs]
    padded = min(serving._bucket(max(lens)), eng.max_seq)
    n = len(pairs)
    nr = min(serving._bucket(n, floor=1), eng.B)
    ids = np.zeros((nr, padded), dtype=np.int64)
    last = np.zeros((nr,), dtype=np.int64)
    for i, (_, req) in enumerate(pairs):
        ids[i, :lens[i]] = req.prompt_ids
        last[i] = lens[i] - 1
    params = [eng._req_params(req, gen) for _, req in pairs]
    temps = torch.tensor([p[0] for p in params], dtype=torch.float32)
    top_ps = torch.tensor([p[1] for p in params], dtype=torch.float32)
    top_ks = torch.tensor([p[2] for p in params], dtype=torch.int32)
    ids, last = torch.from_numpy(ids), torch.from_numpy(last)
    cfg = eng.config
    if eng._prefill_fused:
        logits, small = forward_prefill_fused(
            eng.params, ids, cfg, last, compute_dtype=eng.compute_dtype,
            cache_dtype=eng.cache_dtype)
    else:
        small = init_cache(cfg, batch=nr, max_len=padded,
                           dtype=eng.cache_dtype)
        logits, small = forward(eng.params, ids, small, 0, cfg,
                                compute_dtype=eng.compute_dtype,
                                allow_kernels=False, logits_mode="last",
                                last_index=last)
    firsts = sample_per_request(logits[:n], generator, top_ks, top_ps, temps,
                                max_top_k=eng.MAX_TOP_K,
                                rows=(nr, slice(0, n)))
    slots = torch.tensor([s for s, _ in pairs])
    merge_rows(cache, small, slots, torch.arange(n))
    st.toks[slots] = firsts
    st.first_buf[slots] = firsts
    st.lengths[slots] = torch.tensor(lens, dtype=torch.int32)
    st.temps[slots] = temps
    st.top_ps[slots] = top_ps
    st.top_ks[slots] = top_ks


def _engine(pt, kv_quant, fused, max_batch=B, **kw):
    eng = BatchedEngine(TCFG, pt, max_batch=max_batch, chunk=4,
                        max_seq=MAX_SEQ, kv_quant=kv_quant, device="cpu", **kw)
    eng._prefill_fused = fused
    return eng


def _refill(eng, pairs, gen, seed=5, per_slot=False):
    """One refill group on a fresh serve's state over a seeded pool ->
    the generator's state after it."""
    st, cache = eng._slots(), eng._pool_cache()
    _garbage(cache, 1)
    eng.generator.manual_seed(seed)
    if per_slot:
        _per_slot_refill(eng, pairs, cache, eng.generator, gen, st)
    else:
        eng._prefill_group(pairs, cache, eng.generator, gen, st)
    return eng.generator.get_state()


@pytest.fixture(scope="module")
def jax_engines(pair):
    """The JAX engines by (int8 cache, refill kernel), made once: the
    greedy and sampled cases share one compiled refill program."""
    made = {}

    def get(kv_quant, fused):
        if (kv_quant, fused) not in made:
            je = JaxBatchedEngine(CFG, pair[0], compute_dtype=jnp.bfloat16,
                                  max_batch=B, chunk=4, max_seq=MAX_SEQ,
                                  kv_quant=kv_quant)
            je._prefill_fused = fused
            made[(kv_quant, fused)] = je
        return made[(kv_quant, fused)]
    return get


@pytest.mark.parametrize("fused", [False, True], ids=["per_op", "fused"])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("kv_quant", KV, ids=KV_IDS)
def test_refill_body_matches_per_slot_refill_and_jax(pair, jax_engines,
                                                     kv_quant, mode, fused):
    """Five requests into scattered slots of 32 (a group of 8 rows: three
    padding rows): the body's pool cache, slot vectors and generator state
    equal the per-slot refill's bit for bit. Against the JAX engine's
    refill (``_refill_jit``, the refill kernel in interpret mode where
    ``fused``): lengths, temps, top_ps and top_ks exactly; greedy rows'
    first tokens equal; every sampled token a valid id; the refilled rows
    [0, padded) of bf16 K and V within one bf16 ulp of the rows' largest
    (both sides round f32 sums of another order), int8 levels within one
    and scales within 2^-7 relative (the per-op rows' amax is such a sum);
    every other row of the pool (other
    slots, positions past the bucket) bit-equal to what it held."""
    pj, pt = pair
    gen = GenerationParams(**GEN)
    got, want = (_engine(pt, kv_quant, fused) for _ in range(2))
    pairs = _pairs(Request, SLOTS, LENS, mode)
    g_got = _refill(got, pairs, gen)
    g_want = _refill(want, pairs, gen, per_slot=True)
    assert torch.equal(g_got, g_want)
    for a, b in zip(_planes(got._cache) + _vectors(got._st),
                    _planes(want._cache) + _vectors(want._st)):
        assert torch.equal(a, b)

    je = jax_engines(kv_quant, fused)
    garbage = init_cache(TCFG, batch=B, max_len=MAX_SEQ,
                         dtype=torch.int8 if kv_quant else torch.bfloat16)
    _garbage(garbage, 1)
    planes = [jnp.asarray(t.float().numpy()).astype(
        jnp.int8 if t.dtype == torch.int8
        else jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        for t in _planes(garbage)]
    cache_j = (jax_cache.QuantKVCache(*planes) if kv_quant
               else jax_cache.KVCache(*planes))
    i32 = dict(dtype=jnp.int32)
    slot_state = (jnp.zeros((B, 1), **i32), jnp.zeros((B,), **i32),
                  jnp.zeros((B,), **i32), jnp.zeros((B,), jnp.float32),
                  jnp.ones((B,), jnp.float32), jnp.ones((B,), **i32))
    with _interpret():
        cache_j, vec_j, lens_j, _ = je._prefill_group(
            _pairs(JaxRequest, SLOTS, LENS, mode), cache_j,
            jax.random.PRNGKey(0), JaxGen(**GEN), slot_state)
    assert lens_j == LENS
    toks_j, lengths_j, first_j, temps_j, tps_j, tks_j = (
        np.asarray(v) for v in vec_j)
    st = got._st
    np.testing.assert_array_equal(st.lengths.numpy(), lengths_j)
    np.testing.assert_array_equal(st.temps.numpy(), temps_j)
    np.testing.assert_array_equal(st.top_ps.numpy(), tps_j)
    np.testing.assert_array_equal(st.top_ks.numpy(), tks_j)
    greedy = [s for i, s in enumerate(SLOTS) if _row_kw(mode, i)["temp"] <= 0]
    still = [s for s in range(B) if s not in SLOTS]
    for rows in (greedy, still):
        np.testing.assert_array_equal(st.toks.numpy()[rows],
                                      toks_j[rows, 0])
        np.testing.assert_array_equal(st.first_buf.numpy()[rows],
                                      first_j[rows])
    assert ((st.toks.numpy()[SLOTS] >= 0)
            & (st.toks.numpy()[SLOTS] < CFG.n_vocab)).all()
    padded = 16
    for t, j, g in zip(_planes(got._cache), _planes_j(cache_j),
                       _planes(garbage)):
        t = t.float().numpy()
        j, g = np.asarray(j, np.float32), g.float().numpy()
        axis = 3 if t.shape[2] == 1 else 2          # the scales' positions
        keep = np.ones(t.shape, bool)
        idx = [slice(None)] * 4
        idx[1], idx[axis] = np.asarray(SLOTS)[:, None], np.arange(padded)
        keep[tuple(idx)] = False
        np.testing.assert_array_equal(t[keep], g[keep])
        np.testing.assert_array_equal(j[keep], g[keep])
        got_rows, want_rows = t[~keep], j[~keep]
        if kv_quant and axis == 2:
            assert np.abs(got_rows - want_rows).max() <= 1
        elif kv_quant:
            np.testing.assert_allclose(got_rows, want_rows, rtol=2 ** -7,
                                       atol=0)
        else:
            scale = float(np.abs(want_rows).max())
            np.testing.assert_allclose(got_rows, want_rows, rtol=0,
                                       atol=2 ** -7 * scale)


def _planes_j(cache):
    return [t for t in (cache.k, cache.v, getattr(cache, "ks", None),
                        getattr(cache, "vs", None)) if t is not None]


@pytest.mark.parametrize("fused", [False, True], ids=["per_op", "fused"])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("kv_quant", KV, ids=KV_IDS)
def test_slot_refill_independent_of_group_rows(pair, kv_quant, mode, fused,
                                               monkeypatch):
    """32 requests refilled into slots 0..31 as one group of 32 rows, and
    their first 16 as a group of 16: the first 16 slots' cache rows, slot
    vectors and first tokens bit-equal (the CPU generator's draw of 16 rows
    is the first 16 rows of its draw of 32). On the per-op route the cache
    rows and vectors are bit-equal as shipped; the last-token lm_head
    takes the block-accumulated form below ``_DEQUANT_M_ROWS`` (32) rows
    and dequantize-then-dot at it, the JAX package's rule, so the first
    tokens are held with both groups in one form."""
    _, pt = pair
    gen = GenerationParams(**GEN)
    lens = [int(n) for n in np.random.RandomState(8).randint(4, 17, size=B)]
    pairs = _pairs(Request, list(range(B)), lens, mode, seed=9)
    runs = {}
    for n in (32, 16):
        eng = _engine(pt, kv_quant, fused)
        g = _refill(eng, pairs[:n], gen)
        runs[n] = (eng, g)
    (e32, _), (e16, _) = runs[32], runs[16]
    for a, b in zip(_planes(e32._cache), _planes(e16._cache)):
        assert torch.equal(a[:, :16], b[:, :16])
    lengths = [e32._st.lengths, e32._st.temps, e32._st.top_ps,
               e32._st.top_ks]
    for a, b in zip(lengths, [e16._st.lengths, e16._st.temps,
                              e16._st.top_ps, e16._st.top_ks]):
        assert torch.equal(a[:16], b[:16])
    if not fused:
        monkeypatch.setattr(ops_qmatmul, "_DEQUANT_M_ROWS", 16)
        for n in (32, 16):
            _refill(runs[n][0], pairs[:n], gen)
    assert torch.equal(e32._st.toks[:16], e16._st.toks[:16])
    assert torch.equal(e32._st.first_buf[:16], e16._st.first_buf[:16])


@pytest.mark.parametrize("kv_quant", KV, ids=KV_IDS)
def test_replica_share_of_a_group_takes_the_groups_lm_head_form(pair,
                                                                kv_quant):
    """A data-axis replica's 16 rows of a 32-row refill group
    (``forward(group_rows=32)``, as ``_refill_body`` runs a replica's
    per-op refill: every product in the group's form) against the whole
    group's forward: the logits and the cache rows bit-equal, where a
    group of 16 alone takes the lm_head's other form below
    ``_DEQUANT_M_ROWS`` rows."""
    _, pt = pair
    lens = [int(n) for n in np.random.RandomState(2).randint(4, 17, size=B)]
    ids = torch.zeros(B, 16, dtype=torch.long)
    for b, p in enumerate(_prompts(lens, 6)):
        ids[b, :len(p)] = torch.tensor(p)
    last = torch.tensor([n - 1 for n in lens])
    dtype = torch.int8 if kv_quant else torch.bfloat16
    runs = {}
    for n, rows in ((32, None), (16, 32), (16, None)):
        small = init_cache(TCFG, batch=n, max_len=16, dtype=dtype)
        runs[(n, rows)] = forward(pt, ids[:n], small, 0, TCFG,
                                  compute_dtype=torch.bfloat16,
                                  allow_kernels=False, last_index=last[:n],
                                  group_rows=rows)
    (l32, c32), (l16, c16) = runs[(32, None)], runs[(16, 32)]
    assert l16.shape == (16, CFG.n_vocab)
    assert torch.equal(l16, l32[:16])
    for a, b in zip(_planes(c16), _planes(c32)):
        assert torch.equal(a, b[:, :16])
    assert not torch.equal(runs[(16, None)][0], l32[:16])


@pytest.mark.parametrize("n", [5, 13, 40])
@pytest.mark.parametrize("kv_quant", KV, ids=KV_IDS)
def test_engine_prefill_body_matches_the_eager_forward(pair, kv_quant, n):
    """``Engine.prefill`` (its prompt and last position on the device, the
    forward one body) against the forward it ran before: the prompt
    padded to its bucket (8, 16, 64: the M <= 8 GEMV, the 9-32-row GEMV,
    one dense product) with the host's last index, on a fresh cache: the
    logits and the cache bit-equal; then a greedy and a sampled generation
    through the same prefill equal a fresh engine's."""
    _, pt = pair
    eng = Engine(TCFG, pt, kv_quant=kv_quant, device="cpu")
    prompt = _prompts([n], 3)[0]
    logits, cache, past = eng.prefill(eng._gen_cache(), prompt)
    assert past == n and cache is eng._cache
    padded = serving._bucket(n)
    ids = torch.zeros(1, padded, dtype=torch.long)
    ids[0, :n] = torch.tensor(prompt)
    want_cache = eng.new_cache()
    want, _ = forward(eng.params, ids, want_cache, 0, TCFG,
                      compute_dtype=eng.compute_dtype, allow_kernels=True,
                      logits_mode="last", kv_window=eng._window(padded),
                      last_index=n - 1)
    assert torch.equal(logits, want)
    for a, b in zip(_planes(cache), _planes(want_cache)):
        assert torch.equal(a[:, :, :padded], b[:, :, :padded])
    for temp in (0.0, 0.9):
        gen = GenerationParams(n_predict=6, temp=temp, seed=2,
                               stop_at_eos=False)
        fresh = Engine(TCFG, pt, kv_quant=kv_quant, device="cpu")
        assert eng.generate(prompt, gen).ids == fresh.generate(prompt,
                                                               gen).ids


# ------------------------------------------------ a CUDA graph stand-in

class _Graph:
    """Stand-in for ``torch.cuda.CUDAGraph``: a replay runs the body the
    runner captured (:func:`_stand_in`)."""

    def __init__(self):
        self.body, self.generators = None, []

    def register_generator_state(self, g):
        self.generators.append(g)

    def replay(self):
        self.body()


@contextlib.contextmanager
def _no_capture_context(graph, pool=None, capture_error_mode="global"):
    yield


def _stand_in(monkeypatch, state):
    """Capture on the CPU: the runner's capture runs the body (as the
    card's capture records it), then the tensors of ``state()`` and the
    generators are put back (a capture launches nothing), and the graph
    keeps the body for its replays."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", _no_capture_context)
    real = graphs.ChunkGraphs._capture

    def capture(self, body, sampled):
        saved = [t.clone() for t in state()]
        gen = self.generator.get_state()
        graph, counted = real(self, body, sampled)
        for t, s in zip(state(), saved):
            t.copy_(s)
        self.generator.set_state(gen)
        graph.body = body
        return graph, counted
    monkeypatch.setattr(graphs.ChunkGraphs, "_capture", capture)


def _serving_state(eng):
    def state():
        st = eng._st
        return _planes(eng._cache) + _vectors(st) + [st.live, st.ring,
                                                     st.health]
    return state


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("kv_quant", KV, ids=KV_IDS)
def test_refill_keys_run_eagerly_then_capture_and_replay(pair, kv_quant,
                                                         mode, monkeypatch):
    """Five serves of the same requests on one engine whose runner
    captures (the stand-in): each refill key runs eagerly twice, is
    captured on its third run and replays after; every serve's ids and the
    pool cache equal an eager engine's serve by serve."""
    _, pt = pair
    gen = GenerationParams(**{**GEN, "seed": 6})
    reqs = lambda: [Request(prompt_ids=p, n_predict=5, request_id=i,  # noqa
                            **_row_kw(mode, i))
                    for i, p in enumerate(_prompts([9, 13, 16], 4))]
    live, eager = (_engine(pt, kv_quant, True, max_batch=4)
                   for _ in range(2))
    _stand_in(monkeypatch, _serving_state(live))
    live.graphs.capture = True
    key = ("refill", "fused", live.cache_dtype, 4, 16)
    for r in range(5):
        got = live.serve(reqs(), gen)
        want = eager.serve(reqs(), gen)
        assert {i: x.ids for i, x in got.items()} == \
            {i: x.ids for i, x in want.items()}
        for a, b in zip(_planes(live._cache), _planes(eager._cache)):
            assert torch.equal(a, b)
        assert live.graphs.runs[key] == min(r + 1, 2)
        assert (key in live.graphs.graphs) == (r >= 2)
    assert eager.graphs.captures == 0
    assert live.graphs.graphs[key][0].generators == [live.generator]


@pytest.mark.parametrize("kv_quant", KV, ids=KV_IDS)
def test_prefill_keys_run_eagerly_then_capture_and_replay(pair, kv_quant,
                                                          monkeypatch):
    """Four greedy generations on one engine whose runner captures (the
    stand-in): the prefill key runs eagerly twice, is captured on its third
    run and replays on the fourth; each generation's ids and the cache
    equal an eager engine's. ``warmup()`` captures its own prefill key and
    no other."""
    _, pt = pair
    live, eager = (Engine(TCFG, pt, kv_quant=kv_quant, device="cpu")
                   for _ in range(2))

    def state():
        st = live._decode_state()
        bufs = [b.logits for b in live._prefill_bufs.values()]
        return _planes(live._gen_cache()) + bufs + [
            st.tok, st.pos, st.done, st.health, st.ring]
    _stand_in(monkeypatch, state)
    live.graphs.capture = True
    prompt = _prompts([11], 5)[0]
    gen = GenerationParams(n_predict=3, temp=0.0, stop_at_eos=False)
    key = ("prefill", live.cache_dtype, 16, live._window(16))
    for r in range(4):
        assert live.generate(prompt, gen).ids == eager.generate(prompt,
                                                                gen).ids
        for a, b in zip(_planes(live._cache), _planes(eager._cache)):
            assert torch.equal(a, b)
        assert live.graphs.runs[key] == min(r + 1, 2)
        assert (key in live.graphs.graphs) == (r >= 2)
    warm = Engine(TCFG, pt, kv_quant=kv_quant, device="cpu")
    warm.graphs.capture = True
    live = warm
    # its decode chunks are held by tests/test_torch_graph_chunk.py
    monkeypatch.setattr(warm, "_run_steps", lambda *a, **k: None)
    warm.warmup(prompt_len=8, n_tokens=2, sampled=False)
    assert [k for k in warm.graphs.graphs if k[0] == "prefill"] == [
        ("prefill", warm.cache_dtype, 8, warm._window(8))]


@pytest.mark.parametrize("kv_quant", KV, ids=KV_IDS)
def test_large_groups_and_mesh_engines_never_capture(pair, kv_quant,
                                                     monkeypatch):
    """Its name dates from when groups above 1024 rows x tokens ran
    eagerly; they are captured now, and only mesh engines never capture.

    A refill key of any shape is captured: a group of 32 rows of a
    64-token bucket (2,048 rows x tokens, the per-op forward) on a
    capturing runner (the stand-in) runs eagerly twice, is captured on its
    third run and replays on the fourth, its pool cache, slot vectors and
    generator after each run bit-equal to an eager engine's (each run
    refills the same seeded pool with the same seed), as JAX
    compiles ``refill_commit`` for every shape. An engine on a mesh builds
    its runner with capture off (its collectives are gloo's), a
    single-device one, per-op route included, with capture on."""
    from biogpt_tpu_torch.parallel.mesh import Mesh

    _, pt = pair
    live, eager = (_engine(pt, kv_quant, False) for _ in range(2))
    _stand_in(monkeypatch, _serving_state(live))
    live.graphs.capture = True
    lens = [33 + i % 31 for i in range(B)]
    pairs = _pairs(Request, list(range(B)), lens, "sampled")
    gen = GenerationParams(**GEN)
    key = ("refill", "per_op", live.cache_dtype, 32, 64)
    # every run starts from the same seeded pool and generator
    g_eager = _refill(eager, pairs, gen)
    for r in range(4):
        assert torch.equal(_refill(live, pairs, gen), g_eager)
        for a, b in zip(_planes(live._cache) + _vectors(live._st),
                        _planes(eager._cache) + _vectors(eager._st)):
            assert torch.equal(a, b)
        assert live.graphs.runs[key] == min(r + 1, 2)
        assert (key in live.graphs.graphs) == (r >= 2)
    assert live.graphs.replayed[key] == 2 and eager.graphs.captures == 0

    wanted = []
    real = graphs.ChunkGraphs.__init__

    def init(self, device, generator=None, capture=True):
        wanted.append(capture)
        real(self, device, generator, capture)
    monkeypatch.setattr(graphs.ChunkGraphs, "__init__", init)
    mesh = Mesh(1, 1, 0, None, torch.device("cpu"))
    BatchedEngine(TCFG, pt, max_batch=4, max_seq=MAX_SEQ, device="cpu",
                  mesh=mesh)
    Engine(TCFG, pt, device="cpu", mesh=mesh)
    BatchedEngine(TCFG, pt, max_batch=4, max_seq=MAX_SEQ, device="cpu",
                  compute_dtype=torch.float32)
    Engine(TCFG, pt, device="cpu", cache_dtype=torch.float16)
    assert wanted == [False, False, True, True]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_score_keys_run_eagerly_then_capture_and_replay(pair, causal,
                                                        monkeypatch):
    """``Engine.logits`` of two 12-token rows, four times on one f32
    engine of unpacked weights (no kernel on either side, as JAX's CPU
    engine runs none) whose runner captures (the stand-in): the scoring key (cache
    dtype, causal, rows, length) runs eagerly twice, is captured on its
    third call and replays on the fourth; every call's logits are
    bit-equal to the forward it ran before (a fresh cache on the host's
    ids) and to an eager engine's, and a returned tensor keeps its values
    through the next call. Its scores against JAX ``Engine.score`` at
    ``tests/test_torch_tools.py``'s rtol/atol 1e-5; ``perplexity_of_ids``
    (windows of 16, stride 8: one key replayed, the last window's own)
    bit-equal to an eager engine's."""
    from biogpt_tpu.runtime.engine import Engine as JaxEngine
    from biogpt_tpu_torch.tools.perplexity import perplexity_of_ids

    pj, pt = pair
    kw = dict(compute_dtype=torch.float32, cache_dtype=torch.float32,
              causal=causal, pack_q4=False, device="cpu")
    live, eager = Engine(TCFG, pt, **kw), Engine(TCFG, pt, **kw)
    # the body's one output, its logits, is written whole by every run
    _stand_in(monkeypatch, lambda: [])
    live.graphs.capture = True
    ids = np.asarray(_prompts([12, 12], 7))
    small = init_cache(TCFG, batch=2, max_len=12, dtype=torch.float32)
    want, _ = forward(live.params, torch.from_numpy(ids), small, 0, TCFG,
                      compute_dtype=torch.float32, causal=causal,
                      allow_kernels=live.allow_kernels, logits_mode="all")
    key = ("score", torch.float32, causal, 2, 12)
    kept = []
    for r in range(4):
        got = live.logits(ids)
        kept.append(got)
        assert torch.equal(got, want) and torch.equal(eager.logits(ids), want)
        assert live.graphs.runs[key] == min(r + 1, 2)
        assert (key in live.graphs.graphs) == (r >= 2)
    assert live.graphs.replayed[key] == 2 and eager.graphs.captures == 0
    assert list(live._score_bufs) == [key] and not eager._score_bufs
    assert all(torch.equal(k, want) for k in kept)
    assert kept[0].data_ptr() != kept[1].data_ptr()

    jax_eng = JaxEngine(CFG, pj, compute_dtype=jnp.float32,
                        cache_dtype=jnp.float32, causal=causal, pack_q4=False)
    np.testing.assert_allclose(live.score(ids), jax_eng.score(ids),
                               rtol=1e-5, atol=1e-5)
    text = [2] + np.random.RandomState(3).randint(
        4, CFG.n_vocab - 10, size=43).tolist()
    got = perplexity_of_ids(live, text, window=16, stride=8)
    assert got == perplexity_of_ids(eager, text, window=16, stride=8)
    assert live.graphs.replayed[("score", torch.float32, causal, 1, 16)] >= 2
