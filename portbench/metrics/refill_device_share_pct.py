"""refill_device_share_pct.<cell kind>: the refill groups' share of the
serving engine's device time in the window: refill-group span ms over
refill plus decode-chunk span ms (spans as ``refill_roofline`` and
``decode_roofline`` bind them)."""

from portbench.stats import spans_in

SPANS = {"BatchedEngine": {
    "refill": ("_prefill_group",
               lambda a, k: [len(req.prompt_ids) for _, req in a[0]]),
    "chunk": ("_run_chunk", None),
}}


def read(run, name):
    refill = sum(ms for ms, _ in spans_in(run, "refill"))
    chunk = sum(ms for ms, _ in spans_in(run, "chunk"))
    if refill + chunk <= 0:
        return None
    return 100.0 * refill / (refill + chunk)
