"""The device layer's reading: a ``torch.profiler`` trace of the card's
own activity (kernels, copies, sets) over a short steady sub-window of a
traced run, after the pattern of ``biogpt_tpu_torch/utils/profiling.py``
(``trace``) and ``tools/profile_decode.py`` (its idle share), with busy
time taken as the union of the device's intervals rather than their sum.

The profiler records the card alone (no host operators), so it can be
started and stopped from whichever thread drives the engine; the host
side of each idle gap is named from the benchmark's own spans
(``spans.SpanLog``), whose ``time.time_ns`` stamps share the profiler's
time base. Off the card nothing is traced and nothing is read.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import torch


NAME_CHARS = 160   # a kernel's name in the breakdown, cut after this
SETTLE_S = 0.25    # the trace's first seconds, left out of its sub-window


class DeviceTrace:
    """Trace the card from ``start_s`` (host perf_counter) for ``length_s``
    seconds: :meth:`tick` starts and stops it when its time comes, from
    whichever thread calls it; :meth:`stop` ends it early. The sub-window
    read begins ``SETTLE_S`` after the profiler's start, so that what
    turning it on costs stays out of it."""

    def __init__(self, start_s: float, length_s: float, enabled: bool):
        self.start_s, self.length_s = start_s, length_s
        self.enabled = enabled and torch.cuda.is_available()
        self.prof = None
        self.ns = (0, 0)
        self.done = False
        self._lock = threading.Lock()

    def tick(self) -> None:
        if not self.enabled or self.done:
            return
        now = time.perf_counter()
        with self._lock:
            if self.prof is None and now >= self.start_s:
                self.prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                self.prof.start()
                self._t0 = time.perf_counter() + SETTLE_S
                self._ns0 = time.time_ns() + int(SETTLE_S * 1e9)
            elif (self.prof is not None
                  and now >= self._t0 + self.length_s):
                self._stop()

    def stop(self) -> None:
        with self._lock:
            if self.prof is not None and not self.done:
                self._stop()

    def _stop(self) -> None:
        torch.cuda.synchronize()
        self.ns = (self._ns0, time.time_ns())
        self.prof.stop()
        self.done = True

    def summary(self, host_intervals: list) -> Optional[dict]:
        """:func:`reduce` of the traced sub-window, or None where nothing
        was traced."""
        if self.prof is None or not self.done:
            return None
        events = [(ev.name(), ev.start_ns(), ev.end_ns())
                  for ev in self.prof.profiler.kineto_results.events()
                  if ev.device_type() == torch.autograd.DeviceType.CUDA]
        return reduce(events, *self.ns, host_intervals)


def reduce(events: list, lo: int, hi: int,
           host_intervals: list) -> Optional[dict]:
    """The device's (name, ns start, ns end) activity in [lo, hi) -> {busy_s
    (the union of its intervals), window_s, device_ops (the ten names that
    took most time), idle_gaps (the ten longest gaps, each named by the
    innermost host span, (kind, ns start, ns end), around its middle)}, or
    None where there is no device activity in the window. A gap's name
    ends with where it began, in seconds from the window's start."""
    ivs, by_name = [], {}
    for name, s, e in events:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        ivs.append((s, e))
        by_name[name] = by_name.get(name, 0) + (e - s)
    if not ivs:
        return None
    ivs.sort()
    busy, gaps = 0, []
    cur_s = cur_e = lo
    for s, e in ivs:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if hi > cur_e:
        gaps.append((cur_e, hi))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    named = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (g0 + g1) // 2
        inside = [iv for iv in host_intervals if iv[1] <= mid <= iv[2]]
        label = (max(inside, key=lambda iv: iv[1])[0] if inside
                 else "host outside the program's spans")
        named.append([f"{label} at +{(g0 - lo) / 1e9:.3f} s",
                      (g1 - g0) / 1e9])
    return {"busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9,
            "device_ops": [[n if len(n) <= NAME_CHARS
                            else n[:NAME_CHARS] + "...", t / 1e9]
                           for n, t in ops],
            "idle_gaps": named}
