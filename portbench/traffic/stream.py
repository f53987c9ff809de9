"""The CLI's single stream: ``Engine.generate`` calls run back to back,
each with its own sampling seed; the window closes at the end of the
call in which ``--seconds`` passed.

Workload parameters: ``pool_size`` (the requests of one cycle; the
stream runs cycle after cycle, each in an order of its own),
``requests`` (the mix, ``traffic.draw_pool``).
"""

from __future__ import annotations

import itertools
import time
from types import SimpleNamespace

from . import (FIRST_ID, Req, Window, draw_pool, make_requests, pow2_buckets,
               stream_rng)

WARM_PASSES = 3


def build(run):
    from biogpt_tpu_torch.runtime.engine import Engine

    eng = Engine(run.pcfg, run.params, max_seq=run.cfg["engine"]["max_seq"],
                 device=run.device)
    p = run.wl["params"]
    pool = draw_pool(p["requests"], p["pool_size"])
    return SimpleNamespace(eng=eng, pool=pool)


def generate(eng, r) -> tuple:
    """One ``generate`` of request ``r`` -> (start, end) host seconds."""
    from biogpt_tpu_torch.config import GenerationParams

    gen = GenerationParams(n_predict=r.n_predict, temp=r.temp, top_k=r.top_k,
                           top_p=r.top_p, seed=r.sample_seed,
                           stop_at_eos=False)
    t = time.perf_counter()
    res = eng.generate(r.prompt, gen)
    t_end = time.perf_counter()
    r.t_due, r.t_last = t, t_end
    r.new_ids = list(res.new_ids)
    return t, t_end


def requests(run, s, stream: int):
    """The stream's requests, cycle after cycle of the pool."""
    for c in itertools.count():
        yield from make_requests(s.pool, stream_rng(run.seed, stream, c),
                                 run.pcfg.n_vocab, spread=True)


def warm(run, s) -> None:
    """Three generations (a graph key's eager runs and its capture) of
    each prompt-length bucket the mix reaches, greedy and sampled as the
    mix has them, at the mix's own lengths; then passes of the traffic
    until one captures nothing."""
    from biogpt_tpu_torch.runtime.graphs import ChunkGraphs

    eng, spec = s.eng, run.wl["params"]["requests"]
    lo = min(c[1] for c in spec["prompt_len"])
    hi = max(c[2] for c in spec["prompt_len"])
    shapes = {}
    for p in s.pool:
        shapes.setdefault((p["greedy"], p["top_k"], p["n_predict"]), p)
    for plen in pow2_buckets(lo, hi):
        for p in shapes.values():
            r = Req(prompt=[FIRST_ID + j for j in range(plen)],
                    n_predict=p["n_predict"], greedy=p["greedy"],
                    temp=p["temp"], top_k=p["top_k"], top_p=p["top_p"])
            for _ in range(ChunkGraphs.EAGER_RUNS + 1):
                generate(eng, r)
    for k in range(WARM_PASSES):
        before = eng.graphs.stats()["captures"]
        for r in itertools.islice(requests(run, s, 2 + 10 * k), 8):
            generate(eng, r)
        if eng.graphs.stats()["captures"] == before:
            break


def window(run, s, dtrace=None) -> Window:
    eng = s.eng
    w = Window(graphs0=eng.graphs.stats())
    w.t0 = time.perf_counter()
    for r in requests(run, s, 1):
        w.calls.append(generate(eng, r))
        w.requests.append(r)
        if w.calls[-1][1] - w.t0 >= run.seconds:
            break
    w.t1 = w.calls[-1][1]
    w.graphs1 = eng.graphs.stats()
    return w


def tail(run, s, dtrace) -> None:
    """More of the stream while the device trace runs (at most 30 s)."""
    if not dtrace.enabled:
        return
    t_end = time.perf_counter() + 30.0
    for r in requests(run, s, 3):
        dtrace.tick()
        generate(s.eng, r)
        if dtrace.done or time.perf_counter() > t_end:
            break
    dtrace.stop()


def engine(s):
    return s.eng


def close(s) -> None:
    s.eng = None
