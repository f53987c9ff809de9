"""Arithmetic the metrics' readers share: a tail over all requests, and
the work of a window's requests."""

from __future__ import annotations

import math
from typing import Iterable, List, Optional


def p95(values: Iterable[float]) -> Optional[float]:
    """The 95th percentile by nearest rank (the value at rank
    ceil(0.95 n)); a miss counts as +inf. None for no values, or where
    the rank falls on a miss."""
    xs = sorted(values)
    if not xs:
        return None
    v = xs[max(0, math.ceil(0.95 * len(xs)) - 1)]
    return v if math.isfinite(v) else None


def decode_positions(reqs) -> List[int]:
    """The position of every decode step's token: a request of P prompt
    tokens and n new ones takes its first from the prompt's last row and
    one step at each of P, P + 1, ..., P + n - 2."""
    out = []
    for r in reqs:
        P, n = len(r.prompt), len(r.new_ids or [])
        out.extend(range(P, P + n - 1))
    return out


def spans_in(run, kind: str) -> list:
    """[(device ms, meta)] of the spans of ``kind`` whose call began in the
    window."""
    w = run.window
    return [(ms, meta) for ms, meta, t in run.span_ms.get(kind, [])
            if w.t0 <= t < w.t1]
