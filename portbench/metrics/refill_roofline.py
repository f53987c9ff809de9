"""refill_roofline.<cell kind>: the refill groups' share of their roofline, %: the least time of the window's refill
groups (``bounds.refill_cost`` of each group's real prompt lengths: the
weights once a group, 2 x params a prompt token, causal attention over
each prompt, its KV rows written once) over the device time inside the
refill-group spans.

Span: CUDA events around ``BatchedEngine._prefill_group``, keeping its
group's prompt lengths (until the program has spans of its own)."""

from portbench.bounds import bound_s, refill_cost
from portbench.stats import spans_in

SPANS = {"BatchedEngine": {
    "refill": ("_prefill_group",
               lambda a, k: [len(req.prompt_ids) for _, req in a[0]]),
}}


def read(run, name):
    spans = spans_in(run, "refill")
    device_s = sum(ms for ms, _ in spans) / 1e3
    if device_s <= 0:
        return None
    least = sum(bound_s(*refill_cost(run.model, run.fmt, lens))
                for _, lens in spans)
    return 100.0 * least / device_s
