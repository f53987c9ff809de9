"""tpot_p95_ms: the 95th percentile, over every request due in the
window, of (last token delivered - first token delivered) / (new tokens
- 1): the streaming user's cadence (tokens arrive a chunk at a time); a
request that never finished counts as a miss."""

import math

from portbench.stats import p95


def _tpot(r):
    if not r.done or r.t_first is None:
        return math.inf
    return (r.t_last - r.t_first) * 1e3 / (len(r.new_ids) - 1)


def read(run, name):
    return p95(_tpot(r) for r in run.window.requests if r.n_predict > 1)
