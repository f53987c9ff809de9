"""Profiling and timing utilities (``biogpt_tpu/utils/profiling.py``).

  Timer               -- named wall-clock phase accumulator with call counts
                         (the CLI's run report)
  trace(dir)          -- a ``torch.profiler`` trace of the card (and host)
                         around a block, exported as a Chrome trace (the
                         one profiler wrapper: ``chip_smoke.py``'s kernel
                         traces run on it)
  device_memory_stats -- live device memory per CUDA device
  spin_cycles         -- the length of the device spin that keeps a
                         CUDA-event window on the card's own time
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


class Timer:
    """Accumulates wall-clock time and calls per named phase."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def ms(self, name: str) -> float:
        return self.totals[name] * 1e3

    def report(self) -> str:
        """One line a phase, by name: its total ms, and its ms a call where
        it ran more than once."""
        lines = []
        for name, total in sorted(self.totals.items()):
            n = self.counts[name]
            lines.append(f"{name:>12s}: {total * 1e3:9.2f} ms"
                         + (f" ({total / n * 1e3:.2f} ms/call over {n})"
                            if n > 1 else ""))
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None,
          host: bool = True) -> Iterator[torch.profiler.profile]:
    """A ``torch.profiler`` trace of the block (the host where ``host``,
    and the card where there is one), written under ``log_dir``, where
    given, as ``trace.json`` (Chrome's trace format, readable in Perfetto)
    when the block ends, also on an error. Yields the profiler
    (``events()`` for its records, ``key_averages()`` for sums by
    kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        if log_dir is not None:
            prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats() -> Dict[str, dict]:
    """Live memory of each CUDA device (``torch.cuda.memory_stats``): bytes
    in use, the limit (the card's total memory) and the peak in use, by
    device name ``cuda:<i>``; empty without a card."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
        }
    return stats


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
