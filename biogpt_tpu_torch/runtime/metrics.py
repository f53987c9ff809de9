"""Serving observability counters (``biogpt_tpu/runtime/metrics.py``, copied).

A long-lived serving process needs live counters: one
:class:`ServingMetrics` instance hangs off each
:class:`~.serving.BatchedEngine` and is updated from the scheduling thread
and the drain threads; ``snapshot()`` is what the HTTP front-end's
``GET /stats`` returns.
"""

from __future__ import annotations

import threading
import time


class ServingMetrics:
    """Thread-safe monotonic counters for one serving engine."""

    _COUNTERS = (
        "requests_accepted",    # taken off the queue (slotted, or aborted pre-slot)
        "requests_completed",   # final token drained (on_complete point)
        "requests_aborted",     # caller-aborted (client disconnect etc.)
        "tokens_emitted",       # generated tokens delivered to results
        "chunks_launched",      # decode scans dispatched
        "drains_landed",        # chunk fetches completed by the pool
        "refill_programs",      # batched prefill+commit programs run
        "serve_calls",          # serve() invocations completed
        "health_failures",      # ModelHealthError raised
    )

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._c = {k: 0 for k in self._COUNTERS}
        self._serve_wall_s = 0.0
        self._last_serve = {}   # wall_s / tokens / tok_s of the last serve()
        self._lat = {}          # kind -> [count, sum_s, max_s]
        self._started = time.time()

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] += n

    # ---- per-request latency (accept -> first token / final token).
    # Aggregated as count/sum/max so the stats endpoint stays O(1) — a
    # full histogram would grow with traffic on a long-lived server.

    def observe_latency(self, kind: str, seconds: float) -> None:
        """kind: "ttft" (accept -> first generated token drained) or
        "e2e" (accept -> final token drained)."""
        with self._lock:
            agg = self._lat.setdefault(kind, [0, 0.0, 0.0])
            agg[0] += 1
            agg[1] += seconds
            agg[2] = max(agg[2], seconds)

    def serve_finished(self, wall_s: float, tokens: int) -> None:
        with self._lock:
            self._c["serve_calls"] += 1
            self._serve_wall_s += wall_s
            self._last_serve = {
                "wall_s": round(wall_s, 4), "tokens": tokens,
                "tokens_per_sec": round(tokens / wall_s, 2) if wall_s else 0.0,
            }

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._c)
            out["serve_wall_s"] = round(self._serve_wall_s, 4)
            out["uptime_s"] = round(time.time() - self._started, 2)
            if self._last_serve:
                out["last_serve"] = dict(self._last_serve)
            for kind, (n, total, mx) in self._lat.items():
                out[f"{kind}_mean_s"] = round(total / n, 4) if n else 0.0
                out[f"{kind}_max_s"] = round(mx, 4)
        return out
