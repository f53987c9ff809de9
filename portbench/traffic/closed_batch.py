"""Closed offline batches through ``BatchedEngine.serve``: calls of
``call_requests`` requests each, run back to back; the window closes at
the end of the call in which ``--seconds`` passed.

Workload parameters: ``call_requests``, ``requests`` (the mix,
``traffic.draw_pool``).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

from . import (FIRST_ID, Req, Window, draw_pool, make_requests, pow2_buckets,
               stream_rng)

WARM_PASSES = 3   # the most traffic passes of the warm-up


def build(run):
    from biogpt_tpu_torch.runtime.serving import BatchedEngine

    c = run.cfg["engine"]
    eng = BatchedEngine(run.pcfg, run.params, max_batch=c["max_batch"],
                        chunk=c["chunk"], max_seq=c["max_seq"],
                        device=run.device)
    p = run.wl["params"]
    pool = draw_pool(p["requests"], p["call_requests"])
    return SimpleNamespace(eng=eng, pool=pool)


def serve_call(eng, reqs, live_intake: bool = False) -> tuple:
    """One ``serve`` of ``reqs`` -> (start, end) host seconds; each
    request's tokens, first and last delivery times land in it."""
    from biogpt_tpu_torch.config import GenerationParams
    from biogpt_tpu_torch.runtime.serving import Request

    def on_token(rid, tid):
        r = reqs[rid]
        now = time.perf_counter()
        if r.t_first is None:
            r.t_first = now
        r.t_last = now

    batch = [Request(prompt_ids=r.prompt, n_predict=r.n_predict,
                     request_id=i, temp=r.temp, top_k=r.top_k, top_p=r.top_p)
             for i, r in enumerate(reqs)]
    gen = GenerationParams(temp=0.0, stop_at_eos=False,
                           seed=reqs[0].sample_seed if reqs else 0)
    t = time.perf_counter()
    for r in reqs:
        r.t_due = t
    out = eng.serve(batch, gen, on_token=on_token,
                    more=(lambda: []) if live_intake else None)
    t_end = time.perf_counter()
    for i, r in enumerate(reqs):
        res = out.get(i)
        r.new_ids = list(res.new_ids) if res is not None else None
    return t, t_end


def warm_grid(eng, buckets, n_max: int, greedy: bool, live_intake: bool,
              max_rows: int, vocab: int) -> None:
    """Bring every refill group shape and KV window that the traffic can
    form to its CUDA graph: ``rows`` requests of each length bucket, for
    every power of two ``rows`` up to ``max_rows``, and one request of the
    longest prompt to the longest ``n_max``; each a key's eager runs and
    its capture (three serves)."""
    from biogpt_tpu_torch.runtime.graphs import ChunkGraphs

    def reqs(n, plen, n_predict):
        return [Req(prompt=[FIRST_ID + (i + j) % (vocab - FIRST_ID)
                            for j in range(plen)],
                    n_predict=n_predict, greedy=greedy,
                    temp=0.0 if greedy else 0.8,
                    top_k=1 if greedy else 40, top_p=1.0 if greedy else 0.9)
                for i in range(n)]

    rows = 1
    while rows <= max_rows:
        for plen in buckets:
            for _ in range(ChunkGraphs.EAGER_RUNS + 1):
                serve_call(eng, reqs(rows, plen, 1), live_intake)
        rows *= 2
    for _ in range(ChunkGraphs.EAGER_RUNS + 1):
        serve_call(eng, reqs(1, buckets[-1], n_max), live_intake)


def n_predict_max(spec: dict) -> int:
    n = spec["n_predict"]
    return int(n.get("value") or max(n.get("choices") or n["uniform"]))


def warm(run, s) -> None:
    """:func:`warm_grid` on the mix's shapes, then calls of the traffic
    from another seed until one captures nothing."""
    eng, p = s.eng, run.wl["params"]
    spec = p["requests"]
    lo = min(c[1] for c in spec["prompt_len"])
    hi = max(c[2] for c in spec["prompt_len"])
    greedy = all(r["greedy"] for r in s.pool)
    warm_grid(eng, pow2_buckets(lo, hi), n_predict_max(spec), greedy, False,
              min(eng.B, p["call_requests"]), run.pcfg.n_vocab)
    for k in range(WARM_PASSES):
        before = eng.graphs.stats()["captures"]
        serve_call(eng, make_requests(s.pool, stream_rng(run.seed, 2, k),
                                      run.pcfg.n_vocab))
        if eng.graphs.stats()["captures"] == before:
            break


def window(run, s, dtrace=None) -> Window:
    eng = s.eng
    w = Window(counters0=eng.metrics.snapshot(), graphs0=eng.graphs.stats())
    w.t0 = time.perf_counter()
    call = 0
    while True:
        reqs = make_requests(s.pool, stream_rng(run.seed, 1, call),
                             run.pcfg.n_vocab)
        t, t_end = serve_call(eng, reqs)
        w.calls.append((t, t_end))
        w.requests += reqs
        call += 1
        if t_end - w.t0 >= run.seconds:
            break
    w.t1 = w.calls[-1][1]
    w.counters1, w.graphs1 = eng.metrics.snapshot(), eng.graphs.stats()
    return w


def tail(run, s, dtrace) -> None:
    """One more call of the traffic while the device trace runs."""
    serve_call(s.eng, make_requests(s.pool, stream_rng(run.seed, 3, 0),
                                    run.pcfg.n_vocab))
    dtrace.stop()


def engine(s):
    return s.eng


def close(s) -> None:
    s.eng = None
