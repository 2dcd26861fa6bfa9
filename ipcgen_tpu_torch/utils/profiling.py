"""Lightweight profiling helpers (port of ``ipcgen_tpu/utils/profiling.py``).

Named wall-clock spans, a throughput counter (rays/s, rooms/h) and an
optional ``torch.profiler`` range.  A span around work queued on the card
measures the enqueue unless it ends in ``utils.device.sync``.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


class Timer:
    """Context-manager wall-clock timer with named accumulation."""

    def __init__(self) -> None:
        self.spans: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def total(self) -> float:
        return sum(self.spans.values())


@dataclass
class RateCounter:
    """Throughput counter: accumulate work units against elapsed seconds."""

    unit: str = "items"
    count: float = 0.0
    seconds: float = 0.0
    _t0: Optional[float] = field(default=None, repr=False)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, n: float) -> None:
        if self._t0 is None:
            raise RuntimeError("RateCounter.stop() called before start().")
        self.seconds += time.perf_counter() - self._t0
        self.count += n
        self._t0 = None

    @property
    def rate(self) -> float:
        return self.count / self.seconds if self.seconds > 0 else 0.0

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"RateCounter({self.rate:,.0f} {self.unit}/s over {self.seconds:.3f}s)"


@contextlib.contextmanager
def trace(name: str, enabled: bool = False):
    """With ``enabled``, name the block in a ``torch.profiler`` trace
    (``record_function``); otherwise a no-op."""
    if not enabled:
        yield
        return
    from torch.profiler import record_function

    with record_function(name):
        yield
