"""An open loop of Poisson arrivals into ``ServingScheduler.submit`` (the
HTTP server's engine front, without HTTP) at a fixed rate.

The window's requests arrive in ``[0, --seconds)``: round(rate x seconds)
of them, at gaps drawn from ``traffic.SIZES_SEED`` and scaled to the
window (``traffic.arrival_gaps``); sizes and gaps keep the same order for
every seed, which gives the prompt ids. Arrivals go on for ``tail_s``
seconds after the window at the same rate, so its last requests finish
under load; every request due in the window is then waited for, at most
``wait_s`` seconds past the close. Each request is timed from when it was
due, and the submitter's lateness is kept. The backlog is counted on the
benchmark's side: requests submitted less those whose result has come
back, sampled every 10 ms through the window.

Workload parameters: ``rate`` (requests a second), ``requests`` (the mix,
``traffic.draw_pool``), ``tail_s``, ``wait_s``.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout
from types import SimpleNamespace

from . import (Window, arrival_gaps, draw_pool, make_requests, pow2_buckets,
               stream_rng)
from .closed_batch import n_predict_max, warm_grid

BACKLOG_EVERY_S = 0.01
WARM_PASSES = 3
WARM_PASS_S = 2.0


def build(run):
    from biogpt_tpu_torch.runtime.serving import BatchedEngine

    c = run.cfg["engine"]
    eng = BatchedEngine(run.pcfg, run.params, max_batch=c["max_batch"],
                        chunk=c["chunk"], max_seq=c["max_seq"],
                        device=run.device)
    return SimpleNamespace(eng=eng, sched=None)


def _scheduler(run, eng):
    from biogpt_tpu_torch.config import GenerationParams
    from biogpt_tpu_torch.runtime.serving import ServingScheduler

    gen = GenerationParams(temp=0.0, stop_at_eos=False,
                           seed=int(stream_rng(run.seed, 5).integers(1 << 62)))
    return ServingScheduler(eng, gen)


def _on_token(r):
    def cb(tid):
        now = time.perf_counter()
        if r.t_first is None:
            r.t_first = now
        r.t_last = now
    return cb


def _drive(sched, reqs, gaps, t0, backlog=None, t_stop=None):
    """Submit ``reqs`` from ``t0`` on, each ``gaps`` after the one before
    (the first at ``t0``); sample the backlog (submitted less finished)
    into ``backlog`` until ``t_stop`` from a thread of its own ->
    [(request, future)] and the latest lateness s."""
    done = threading.Event()
    out, finished = [], []

    def sample():
        while not done.is_set() and time.perf_counter() < t_stop:
            backlog.append(len(out) - len(finished))
            time.sleep(BACKLOG_EVERY_S)

    sampler = None
    if backlog is not None:
        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
    late, due = 0.0, t0
    try:
        for r, g in zip(reqs, gaps):
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            r.t_due = due
            late = max(late, time.perf_counter() - due)
            fut = sched.submit(r.prompt, r.n_predict, temp=r.temp,
                               top_k=r.top_k, top_p=r.top_p,
                               on_token=_on_token(r))
            out.append((r, fut))
            fut.add_done_callback(finished.append)
            due += g
    finally:
        done.set()
        if sampler is not None:
            sampler.join()
    return out, late


def _collect(pairs, deadline) -> None:
    for r, fut in pairs:
        try:
            res = fut.result(timeout=max(0.0, deadline - time.perf_counter()))
            r.new_ids = list(res.new_ids)
        except FutureTimeout:
            r.error = "not finished by the wait's end"
        except Exception as e:   # the request failed in the program
            r.error = f"{type(e).__name__}: {e}"


def _traffic(run, stream: int, seconds: float, part: int):
    """The requests due in ``seconds`` and their gaps: sizes and gaps of
    ``part`` (0 the window's, 1 the tail's, 2 the warm-up's), prompt ids
    of the seed's ``stream``."""
    p = run.wl["params"]
    n = max(1, round(p["rate"] * seconds))
    pool = draw_pool(p["requests"], n, part)
    return (make_requests(pool, stream_rng(run.seed, stream),
                          run.pcfg.n_vocab, permute=False),
            arrival_gaps(p["rate"], n, seconds, part))


def warm(run, s) -> None:
    """Every refill group shape and KV window the mix can form brought to
    its graph (``closed_batch.warm_grid``, live intake as the scheduler
    serves), then passes of the traffic through the scheduler until one
    captures nothing."""
    eng, spec = s.eng, run.wl["params"]["requests"]
    buckets = sorted({b for _, lo, hi in spec["prompt_len"]
                      for b in pow2_buckets(lo, hi)})
    warm_grid(eng, buckets, n_predict_max(spec), False, True, eng.B,
              run.pcfg.n_vocab)
    s.sched = _scheduler(run, eng)
    for k in range(WARM_PASSES):
        before = eng.graphs.stats()["captures"]
        reqs, gaps = _traffic(run, 20 + k, WARM_PASS_S, 2)
        pairs, _ = _drive(s.sched, reqs, gaps, time.perf_counter())
        _collect(pairs, time.perf_counter() + 120.0)
        if eng.graphs.stats()["captures"] == before:
            break


def window(run, s, dtrace=None) -> Window:
    p, eng = run.wl["params"], s.eng
    reqs, gaps = _traffic(run, 1, run.seconds, 0)
    more, more_gaps = _traffic(run, 2, p["tail_s"], 1)
    w = Window(counters0=eng.metrics.snapshot(), graphs0=eng.graphs.stats())
    w.extra["backlog"] = []
    w.t0 = time.perf_counter()
    if dtrace is not None:   # traced runs: during the arrivals after it
        dtrace.start_s = w.t0 + run.seconds + 0.2
    pairs, late = _drive(s.sched, reqs, gaps, w.t0, w.extra["backlog"],
                         w.t0 + run.seconds)
    w.t1 = w.t0 + run.seconds
    tail_pairs, late_tail = _drive(s.sched, more, more_gaps, w.t1)
    _collect(pairs, w.t1 + p["wait_s"])
    w.counters1, w.graphs1 = eng.metrics.snapshot(), eng.graphs.stats()
    _collect(tail_pairs, time.perf_counter() + p["wait_s"])
    w.requests, w.tail = reqs, more
    w.extra.update(submit_late_s=late, tail_submit_late_s=late_tail,
                   tail_requests=len(more))
    return w


def tail(run, s, dtrace) -> None:
    """The device trace ran during the arrivals after the window."""
    dtrace.stop()


def engine(s):
    return s.eng


def close(s) -> None:
    if s.sched is not None:
        s.sched.close(timeout=120.0)
    s.sched = s.eng = None
