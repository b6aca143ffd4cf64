"""Phase timing and counters (port of ``tiresias_tpu.utils.tracing``).

Each phase is a named host timer and, when a CUDA device is present, an
NVTX range, so device traces line up with host phases.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict, deque

import torch


class Metrics:
    """Process-wide counters and latency records (thread-safe)."""

    # per-phase sample cap: a sliding window keeps memory bounded and the
    # percentiles recent
    MAX_SAMPLES = 4096

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: dict[str, float] = defaultdict(float)
        self.timings: dict[str, deque] = defaultdict(
            lambda: deque(maxlen=self.MAX_SAMPLES)
        )

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    def record_time(self, name: str, seconds: float) -> None:
        with self._lock:
            self.timings[name].append(seconds)

    def clear(self, name: str) -> None:
        """Drop a phase's latency records (a run that reads its own)."""
        with self._lock:
            self.timings.pop(name, None)

    def percentile(self, name: str, pct: float) -> float | None:
        with self._lock:
            vals = sorted(self.timings.get(name, ()))
        if not vals:
            return None
        idx = min(len(vals) - 1, int(round(pct / 100.0 * (len(vals) - 1))))
        return vals[idx]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "timings": {k: list(v) for k, v in self.timings.items()},
            }


metrics = Metrics()


@contextlib.contextmanager
def phase(name: str, record: bool = True):
    """Time a phase; mark it as an NVTX range when CUDA is available. The
    host time covers enqueueing only unless the phase ends in a readback."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    start = time.perf_counter()
    try:
        yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
        # record failures too: tail percentiles must include the slow and
        # raising requests they exist to expose
        if record:
            metrics.record_time(name, time.perf_counter() - start)
