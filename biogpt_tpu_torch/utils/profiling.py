"""Wall-clock phase timer for the CLI's run report."""

from __future__ import annotations

import contextlib
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
