"""ttft_p95_ms: the 95th percentile, over every request due in the
window, of the time from its scheduled arrival to the delivery of its
first token; a request that never finished counts as a miss."""

import math

from portbench.stats import p95


def read(run, name):
    return p95((r.t_first - r.t_due) * 1e3
               if r.done and r.t_first is not None else math.inf
               for r in run.window.requests)
