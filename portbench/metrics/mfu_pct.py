"""mfu_pct.<cell kind>: the model's operations for the requests served
(every prompt row and every generated token, ``bounds.request_flops``)
over the seconds they took times the card's published bf16 peak: the
whole step's share of the peak, which bounds every kernel's roofline
share.

The batch and stream windows keep the card busy, and their seconds are
their calls' wall time. The serving window is an open loop, whose wall
time is set by the arrivals, so there the seconds are the device time
inside the serving engine's refill-group and decode-chunk spans from the
window's start on, and the requests those spans served: the window's and
the tail's that arrived after it (spans as ``refill_device_share_pct``
binds them)."""

from portbench.bounds import PEAKS, request_flops

SPANS = {"BatchedEngine": {
    "refill": ("_prefill_group",
               lambda a, k: [len(req.prompt_ids) for _, req in a[0]]),
    "chunk": ("_run_chunk", None),
}}


def _flops(run, reqs):
    return sum(request_flops(run.model, len(r.prompt), len(r.new_ids))
               for r in reqs)


def read(run, name):
    w = run.window
    reqs = [r for r in w.requests if r.done]
    if not reqs:
        return None
    if w.calls:
        wall = sum(t1 - t0 for t0, t1 in w.calls)
        return 100.0 * _flops(run, reqs) / (wall * PEAKS["bf16_flops"])
    if not all(r.done for r in w.requests + w.tail):
        return None
    device_s = sum(ms for kind in ("refill", "chunk")
                   for ms, _, t in run.span_ms.get(kind, [])
                   if t >= w.t0) / 1e3
    if device_s <= 0:
        return None
    return (100.0 * _flops(run, w.requests + w.tail)
            / (device_s * PEAKS["bf16_flops"]))
