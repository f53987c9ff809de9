"""Wall-clock phase timer for the CLI's run report, and the length of the
device spin that keeps a CUDA-event window on the card's own time."""

from __future__ import annotations

import contextlib
import math
import time
from collections import defaultdict
from typing import Dict, Iterator


class Timer:
    """Accumulates wall-clock time per named phase."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0

    def ms(self, name: str) -> float:
        return self.totals[name] * 1e3


# The device spin before a timed call (:func:`spin_cycles`): this many
# times the call's host enqueue time, at least SPIN_FLOOR_MS, at most
# SPIN_CAP_MS.
SPIN_FACTOR = 4.0
SPIN_FLOOR_MS = 0.5
SPIN_CAP_MS = 100.0


def spin_cycles(host_ms: float, cycles_per_ms: float) -> int:
    """Clock cycles of the device spin (``torch.cuda._sleep``) to queue
    before a timed call: while the card spins, the host enqueues the call's
    launches, so the window's start event fires when the spin ends and the
    window holds device time alone. ``SPIN_FACTOR`` times the call's host
    enqueue time ``host_ms``, at least ``SPIN_FLOOR_MS``, at most
    ``SPIN_CAP_MS``; ``cycles_per_ms`` is the spin's measured rate on the
    card."""
    if host_ms < 0 or cycles_per_ms <= 0:
        raise ValueError("spin_cycles: host_ms >= 0 and cycles_per_ms > 0")
    ms = min(max(SPIN_FACTOR * host_ms, SPIN_FLOOR_MS), SPIN_CAP_MS)
    return int(math.ceil(ms * cycles_per_ms))
