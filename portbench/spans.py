"""Spans the benchmark's own files put around calls of the program's
methods: a CUDA event before and after each call on the card, and the
host's clock (``time.time_ns``, the profiler's time base) around it.

Copied from ``chip_smoke.py::span_meter`` (instance attributes that wrap
the engine's methods; removing them restores the methods), generalised:
which method a span kind wraps, and what it keeps of the call's
arguments, comes from the per-layer metrics' own files (their ``SPANS``),
so that spans inside the program can replace these later.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

# kind -> (method name, meta(args, kwargs) -> what the span keeps, or None)
Bindings = Dict[str, Tuple[str, Optional[Callable]]]


class SpanLog:
    """The spans of one run: (kind, host start s, host ns start, host ns
    end, start event, end event, meta) in call order. ``on_call`` runs
    before each wrapped call (the device trace's gate)."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self.records = []
        self.on_call: Optional[Callable[[], None]] = None
        self._lock = threading.Lock()

    def install(self, obj, bindings: Bindings) -> None:
        for kind, (name, meta) in bindings.items():
            self._wrap(obj, kind, name, meta)

    @staticmethod
    def uninstall(obj, bindings: Bindings) -> None:
        for name, _ in bindings.values():
            if name in vars(obj):
                delattr(obj, name)

    def _wrap(self, obj, kind: str, name: str, meta) -> None:
        real = getattr(obj, name)

        def timed_call(*a, **k):
            if self.on_call is not None:
                self.on_call()
            t = time.perf_counter()
            ns0 = time.time_ns()
            s = e = None
            if self.cuda:
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
            out = real(*a, **k)
            if self.cuda:
                e.record()
            m = meta(a, k) if meta is not None else None
            with self._lock:
                self.records.append((kind, t, ns0, time.time_ns(), s, e, m))
            return out
        setattr(obj, name, timed_call)

    def device_ms(self) -> Dict[str, list]:
        """{kind: [(device ms, meta, host perf_counter s at the call), ...]}
        of every span; waits for their events. Empty off the card: a CPU
        run has no device time."""
        out: Dict[str, list] = {}
        if not self.cuda:
            return out
        for kind, t, _, _, s, e, m in self.records:
            e.synchronize()
            out.setdefault(kind, []).append((s.elapsed_time(e), m, t))
        return out

    def host_intervals(self) -> list:
        """[(kind, ns start, ns end)] of every span."""
        return [(r[0], r[2], r[3]) for r in self.records]
