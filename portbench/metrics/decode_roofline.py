"""decode_roofline.<cell kind>: the decode steps' share of their roofline, %: the least time of the window's decode
steps (``bounds.decode_cost``: the weights once a step, each live
slot's KV rows below its position read once, its new KV rows written
once) over the device time inside the decode spans (the batched chunks,
or the single stream's step runs). It counts the work the requests
needed, not the launches, so it reads the same whatever kernels do it.

Spans (CUDA events around the engine's private methods, until the
program has spans of its own): ``BatchedEngine._run_chunk`` and
``Engine._run_steps`` (whose third argument is its step count)."""

from portbench.bounds import bound_s, decode_cost
from portbench.stats import decode_positions, spans_in

SPANS = {
    "BatchedEngine": {"chunk": ("_run_chunk", None)},
    "Engine": {"decode": ("_run_steps", lambda a, k: a[2])},
}


def read(run, name):
    w = run.window
    if run.cfg["engine"]["class"] == "Engine":   # the single stream
        spans = spans_in(run, "decode")
        steps = sum(n for _, n in spans)
    else:
        spans = spans_in(run, "chunk")
        chunks = (w.counters1["chunks_launched"]
                  - w.counters0["chunks_launched"])
        steps = chunks * run.cfg["engine"]["chunk"]
    device_s = sum(ms for ms, _ in spans) / 1e3
    positions = decode_positions(r for r in w.requests if r.done)
    if device_s <= 0 or not positions:
        return None
    return 100.0 * bound_s(*decode_cost(run.model, run.fmt, steps,
                                        positions)) / device_s
