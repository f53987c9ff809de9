"""The port's batched serving path (sampler, ``BatchedEngine``,
``ServingScheduler``, HTTP server) against the JAX package's, on the CPU
at small configurations. Weights reach the port through
``params_from_numpy`` (the same bytes); the JAX kernels run in interpret
mode, the port's as their plain versions."""

import json
import threading
import urllib.request

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
from biogpt_tpu.runtime import sampling as jax_sampling
from biogpt_tpu.runtime.serving import BatchedEngine as JaxBatchedEngine
from biogpt_tpu.runtime.serving import Request as JaxRequest

from biogpt_tpu_torch.config import BioGptConfig as TorchConfig
from biogpt_tpu_torch.config import GenerationParams
from biogpt_tpu_torch.modelio.checkpoint import params_from_numpy
from biogpt_tpu_torch.runtime import sampling
from biogpt_tpu_torch.runtime.serving import (BatchedEngine, Request,
                                              ServingScheduler)
from biogpt_tpu_torch.server import BioGptServer

TINY_KW = {}                                           # tests/test_serving.py
WIDE_KW = dict(d_model=128, d_ff=256, n_head=2, n_layer=3, n_vocab=256,
               n_positions=64)                         # the fused kernels' shapes


def _pair(kw, seed, qtype=None):
    """(JAX config, port config, JAX params, port params with their bytes)."""
    cj, ct = BioGptConfig.tiny(**kw), TorchConfig.tiny(**kw)
    pj = params_from_state_dict(make_state_dict(cj, seed=seed), cj,
                                qtype=qtype)
    return cj, ct, pj, params_from_numpy(pj, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    return _pair(TINY_KW, seed=21)


def _serve_both(pair, prompts, n_predict, gen_kw, engine_kw, req_kw=None,
                pallas=None):
    """Serve the same requests through both engines -> ({id: ids} JAX,
    {id: ids} port)."""
    cj, ct, pj, pt = pair
    req_kw = req_kw or (lambda i: {})

    def reqs(cls):
        return [cls(prompt_ids=list(p), n_predict=n_predict, request_id=i,
                    **req_kw(i)) for i, p in enumerate(prompts)]

    dtype = engine_kw.pop("dtype", "f32")
    je = JaxBatchedEngine(cj, pj, compute_dtype=(
        jnp.float32 if dtype == "f32" else jnp.bfloat16), **engine_kw)
    try:
        if pallas is not None:
            set_pallas_mode(pallas)
        want = je.serve(reqs(JaxRequest), JaxGen(**gen_kw))
    finally:
        set_pallas_mode("auto")
    te = BatchedEngine(ct, pt, compute_dtype=(
        torch.float32 if dtype == "f32" else torch.bfloat16), device="cpu",
        **engine_kw)
    got = te.serve(reqs(Request), GenerationParams(**gen_kw))
    return ({k: v.ids for k, v in want.items()},
            {k: v.ids for k, v in got.items()}, te)


# ------------------------------------------------------------- the sampler

def test_topk_index_stable_matches_jax():
    """Forced ties (logits drawn from {0, 1, 2, 3}): among equal values the
    lowest index comes first, as ``lax.top_k`` gives, in the probabilities'
    ids, the gather top-k (with and without precomputed group maxima) and
    the temp <= 0 rows of the per-request sampler."""
    rng = np.random.RandomState(0)
    V = 42384                                          # BioGPT's vocabulary
    logits = rng.randint(0, 4, size=(6, V)).astype(np.float32)
    lt, lj = torch.from_numpy(logits), jnp.asarray(logits)

    pt, it = sampling.top_k_top_p_probs(lt, 40, 0.9, 0.9)
    pj, ij = jax_sampling.top_k_top_p_probs(lj, 40, 0.9, 0.9)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)

    padded = np.pad(logits, ((0, 0), (0, -V % 128)), constant_values=-np.inf)
    gmax = padded.reshape(6, -1, 128).max(-1)           # (6, 332)
    for gm in (None, gmax):
        vt, xt = sampling.topk_gather(
            lt, 64, None if gm is None else torch.from_numpy(gm))
        vj, xj = jax_sampling.topk_gather(
            lj, 64, None if gm is None else jnp.asarray(gm))
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))

    temps = np.array([0.0, 0.9, -1.0, 0.0, 1.5, 0.0], np.float32)
    top_ks = np.array([1, 40, 64, 8, 12, 64], np.int32)
    top_ps = np.array([0.9, 0.9, 1.0, 0.5, 0.95, 0.9], np.float32)
    got = sampling.sample_per_request(
        lt, torch.Generator().manual_seed(0), torch.from_numpy(top_ks),
        torch.from_numpy(top_ps), torch.from_numpy(temps))
    want = jax_sampling.sample_per_request(
        jax.random.PRNGKey(0), lj, jnp.asarray(top_ks), jnp.asarray(top_ps),
        jnp.asarray(temps))
    greedy_rows = temps <= 0
    np.testing.assert_array_equal(got.numpy()[greedy_rows],
                                  np.asarray(want)[greedy_rows])
    assert (got.numpy()[greedy_rows] == np.argmax(logits, -1)[greedy_rows]).all()
    # a sampled row draws among its own top-k candidates
    _, cand = sampling.topk_stable(lt, 64)
    for b in np.flatnonzero(~greedy_rows):
        assert int(got[b]) in cand[b, :top_ks[b]].tolist()


# ------------------------------------------ serve() against the JAX engine

CASES = {
    # name: (prompts, n_predict, GenerationParams, BatchedEngine kwargs)
    "slots_refill": ([[2, 5, 9], [2, 11, 30, 41, 8], [2, 7]], 6,
                     dict(temp=0.0, stop_at_eos=False),
                     dict(max_batch=4, chunk=4)),
    "more_requests_than_slots": ([[2, i + 3, i + 11] for i in range(5)], 4,
                                 dict(temp=0.0, stop_at_eos=False),
                                 dict(max_batch=2, chunk=3)),
    "refill_wave_mixed_lengths": (
        [[2, 5], [2, 6, 7, 8, 9, 10, 11], [2, 3, 4], [2, 9, 1, 2],
         [2] + list(range(3, 30)), [2, 8]], 5,
        dict(temp=0.0, stop_at_eos=False), dict(max_batch=4, chunk=4)),
    "eos": ([[2, 5], [2, 9, 4], [2, 31, 7, 7]], 8,
            dict(temp=0.0, stop_at_eos=True, eos_token_id=None),
            dict(max_batch=2, chunk=4)),
    "capacity_truncation": ([[2, 5, 9], [2, 7]], 40,
                            dict(temp=0.0, stop_at_eos=False),
                            dict(max_batch=1, chunk=4, max_seq=16)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_serve_f32_matches_jax(tiny, case):
    """f32 compute (the per-op step): every request's ids equal the JAX
    engine's, over refill waves, more requests than slots, EOS (the eos id
    is the first token the model emits for the first prompt) and a request
    the KV capacity truncates."""
    prompts, n_predict, gen_kw, engine_kw = CASES[case]
    gen_kw = dict(gen_kw)
    if "eos_token_id" in gen_kw:
        probe, _, _ = _serve_both(tiny, prompts[:1], 1,
                                  dict(temp=0.0, stop_at_eos=False),
                                  dict(max_batch=2, chunk=4))
        gen_kw["eos_token_id"] = probe[0][-1]
    want, got, _ = _serve_both(tiny, prompts, n_predict, gen_kw,
                               dict(engine_kw))
    assert got == want
    if case == "eos":
        assert got[0][-1] == gen_kw["eos_token_id"]
        assert len(got[0]) < len(prompts[0]) + n_predict
    if case == "capacity_truncation":
        assert len(prompts[0]) < len(got[0]) < len(prompts[0]) + n_predict
        assert len(got[1]) > len(prompts[1])   # served in the freed slot


def test_serve_f32_greedy_rows_of_sampled_batch_match_jax(tiny):
    """Per-request sampling in one batch: the greedy rows (temp 0 against a
    sampled default) equal the JAX engine's; the sampled rows are valid."""
    prompts = [[2, 5, 9], [2, 7, 11], [2, 13], [2, 40, 41, 42]]

    def req_kw(i):
        return (dict(temp=0.0) if i % 2 == 0
                else dict(temp=1.5, top_k=50, top_p=0.95))
    want, got, _ = _serve_both(tiny, prompts, 6,
                               dict(temp=0.9, seed=3, stop_at_eos=False),
                               dict(max_batch=2, chunk=3), req_kw=req_kw)
    for i in (0, 2):
        assert got[i] == want[i], i
    for i in (1, 3):
        assert len(got[i]) == len(prompts[i]) + 6
        assert all(0 <= t < 256 for t in got[i])


@pytest.mark.parametrize("sampled,qtype", [
    pytest.param(False, codecs.GGML_TYPE_Q4_0, id="False"),
    pytest.param(True, codecs.GGML_TYPE_Q4_0, id="True"),
    pytest.param(False, codecs.GGML_TYPE_Q5_1, id="q5_1-greedy"),
    pytest.param(False, codecs.GGML_TYPE_Q8_0, id="q8_0-greedy"),
])
def test_serve_bf16_fused_matches_jax_pallas(sampled, qtype):
    """bf16 and engine-prepared planes: the port's fused batched step with
    its greedy (argmax + commit) or sampled (logits + group maxima +
    commit) tail against the JAX engine's megakernel and epilogues in
    interpret mode, across a refill wave; packed Q4_0 and Q5_1, and Q8_0,
    whose unpacked lm_head takes the lm_head GEMV and an argmax instead of
    the fused tails on both sides. Greedy rows are token-identical; sampled
    rows draw from other random bits and are only checked for range."""
    pair = _pair(WIDE_KW, seed=11, qtype=qtype)
    prompts = [[2, 41, 7], [2, 19, 3, 8], [2, 5]]
    gen_kw = dict(temp=0.8 if sampled else 0.0, top_k=12, top_p=0.9,
                  stop_at_eos=False, seed=5)

    def req_kw(i):
        return dict(temp=0.0) if i != 1 else {}
    want, got, te = _serve_both(
        pair, prompts, 4, gen_kw,
        dict(max_batch=2, chunk=2, max_seq=32, dtype="bf16"),
        req_kw=req_kw if sampled else None, pallas=True)
    packed = qtype != codecs.GGML_TYPE_Q8_0
    assert te._fused_decode
    assert te._fused_greedy == te._fused_sampled == packed
    for i in range(len(prompts)):
        if sampled and i == 1:
            assert len(got[i]) == len(prompts[i]) + 4
            assert all(0 <= t < 256 for t in got[i])
        else:
            assert got[i] == want[i], i


# ------------------------------------------------ scheduler, server, gates

def test_abort_frees_slot_and_resolves_partial(tiny):
    """Aborting a running request frees its one slot for the queued one,
    which then matches the JAX engine; the aborted future resolves with the
    tokens drained so far."""
    import time

    _, ct, _, pt = tiny
    sched = ServingScheduler(
        BatchedEngine(ct, pt, max_batch=1, chunk=4,
                      compute_dtype=torch.float32, device="cpu"),
        GenerationParams(temp=0.0, stop_at_eos=False))
    toks = []
    f1 = sched.submit([2, 5, 9], n_predict=50, on_token=toks.append)
    f2 = sched.submit([2, 7], n_predict=4)
    deadline = time.monotonic() + 60
    while not toks and time.monotonic() < deadline:
        time.sleep(0.005)
    assert toks, "no tokens drained within 60 s"
    sched.abort(f1.request_id)
    r1, r2 = f1.result(timeout=120), f2.result(timeout=120)
    sched.close()
    assert 0 < len(r1.new_ids) < 50
    want, _, _ = _serve_both(tiny, [[2, 7]], 4,
                             dict(temp=0.0, stop_at_eos=False),
                             dict(max_batch=2, chunk=4))
    assert r2.ids == want[0]
    assert sched.engine.metrics.snapshot()["requests_aborted"] == 1


def test_scheduler_http_round_trip(tiny):
    """``BioGptServer`` over a ``ServingScheduler`` on the CPU: concurrent
    /generate calls, one SSE stream, /healthz and /stats."""
    _, ct, _, pt = tiny
    sched = ServingScheduler(
        BatchedEngine(ct, pt, max_batch=2, chunk=4,
                      compute_dtype=torch.float32, device="cpu"),
        GenerationParams(temp=0.0, stop_at_eos=False), poll_s=0.01)
    srv = BioGptServer(sched, tokenizer=None)
    srv.start()
    base = f"http://{srv.host}:{srv.port}"

    def post(body):
        return urllib.request.urlopen(urllib.request.Request(
            f"{base}/generate", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}), timeout=120)

    try:
        prompts = [[2, 5, 9], [2, 11, 30, 41, 8], [2, 7]]
        out = [None] * 3

        def run(i):
            out[i] = json.loads(post({"prompt_ids": prompts[i],
                                      "n_predict": 5}).read())
        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        resp = post({"prompt_ids": [2, 5, 9], "n_predict": 5, "stream": True})
        events = [json.loads(line[len(b"data: "):])
                  for line in resp.read().splitlines()
                  if line.startswith(b"data: ")]
        health = json.loads(urllib.request.urlopen(f"{base}/healthz").read())
        stats = json.loads(urllib.request.urlopen(f"{base}/stats").read())
        with pytest.raises(urllib.error.HTTPError, match="400"):
            post({"n_predict": 3})
    finally:
        srv.shutdown()
    want, _, _ = _serve_both(tiny, prompts, 5,
                             dict(temp=0.0, stop_at_eos=False),
                             dict(max_batch=2, chunk=4))
    assert [o["ids"] for o in out] == [want[i] for i in range(3)]
    streamed = [e["token_id"] for e in events if "token_id" in e]
    assert events[-1]["done"] and events[-1]["ids"] == want[0]
    assert streamed == events[-1]["new_ids"] == want[0][3:]
    assert health == {"ok": True}
    assert stats["batch_slots"] == 2 and stats["requests_completed"] == 4
    assert stats["tokens_emitted"] == 20


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_profile_decode_slots_step(tiny, greedy):
    """``tools/profile_decode.py``'s batched profile builds the slot state
    itself (``step_slots``, no gathered first tokens) and drives
    ``BatchedEngine._step`` on it: one step gives each slot a token."""
    from biogpt_tpu_torch.tools.profile_decode import step_slots

    _, ct, _, pt = tiny
    eng = BatchedEngine(ct, pt, device="cpu", max_batch=3, max_seq=32,
                        chunk=2)
    st = step_slots(eng, past=5)
    assert st.firsts is st.first_buf
    gen = torch.Generator()
    gen.manual_seed(0)
    nxt, ok, cache = eng._step(st, eng.new_cache(),
                               torch.ones(3, dtype=torch.bool), 32, greedy,
                               gen)
    assert nxt.shape == (3,) and bool(ok)
    assert ((0 <= nxt) & (nxt < ct.n_vocab)).all()


def test_batched_engine_gates(tiny, tmp_path):
    """The card by default (raises without one, decided at run time); a
    data axis without ``torch.distributed`` raises the RuntimeError of a
    mesh of several ranks; a (1, 1) mesh with unpacked Q4_0 weights (the
    JAX package's GSPMD route) serves the ids of the single-device
    ``pack_q4=False`` engine, without kernels; ``kv_quant``, ``paged_kv``,
    ``staged_kv`` and the tensor-parallel options on a (1, 1) mesh serve
    (the TP step's bf16 cache by default)."""
    from biogpt_tpu_torch.parallel import make_mesh

    _, ct, _, pt = tiny
    mesh = make_mesh(1, 1, device="cpu")
    with pytest.raises(RuntimeError, match="needs torch.distributed"):
        make_mesh(data=2, device="cpu")
    _, cq, _, pq = _pair(TINY_KW, seed=21, qtype=codecs.GGML_TYPE_Q4_0)
    greedy = GenerationParams(temp=0.0, stop_at_eos=False)
    served = []
    for kw in (dict(mesh=mesh), {}):
        be = BatchedEngine(cq, pq, device="cpu", max_batch=2, chunk=2,
                           pack_q4=False, compute_dtype=torch.float32, **kw)
        assert not be.allow_kernels and not be._tp_fused
        res = be.serve([Request(prompt_ids=p, n_predict=4, request_id=i)
                        for i, p in enumerate(([2, 5, 9], [2, 7], [2, 3]))],
                       greedy)
        served.append({i: r.ids for i, r in res.items()})
    assert served[0] == served[1] and len(served[0]) == 3
    for kw in (dict(kv_quant=True), dict(paged_kv=True),
               dict(staged_kv=True), dict(mesh=mesh, tp_fused_decode=True)):
        be = BatchedEngine(ct, pt, device="cpu", max_batch=2, chunk=2, **kw)
        assert be.cache_dtype == (torch.int8 if "kv_quant" in kw
                                  else torch.bfloat16 if "mesh" in kw
                                  else torch.float16)
        res = be.serve([Request(prompt_ids=[2, 5, 9], n_predict=3)],
                       GenerationParams(temp=0.0, stop_at_eos=False))
        assert len(res[0].new_ids) == 3
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedEngine(ct, pt)
    from biogpt_tpu_torch.modelio.synthetic import write_random_quantized_model
    from biogpt_tpu_torch.server import main

    path = tmp_path / "m.bin"
    write_random_quantized_model(path, ct, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-m", str(path)])
