"""decode_device_ms_per_step.<cell kind>: the device ms inside the
window's decode-chunk spans over the decode steps launched
(``chunks_launched`` x chunk): the batched step's own time, the rest of
the serve left out.

Span: CUDA events around ``BatchedEngine._run_chunk`` (until the program
has spans of its own)."""

from portbench.stats import spans_in

SPANS = {"BatchedEngine": {"chunk": ("_run_chunk", None)}}


def read(run, name):
    w = run.window
    steps = ((w.counters1["chunks_launched"] - w.counters0["chunks_launched"])
             * run.cfg["engine"]["chunk"])
    ms = sum(m for m, _ in spans_in(run, "chunk"))
    return ms / steps if steps and ms > 0 else None
