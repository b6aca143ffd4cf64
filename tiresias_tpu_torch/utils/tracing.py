"""Spans, counters and named timings (port of ``tiresias_tpu.utils.tracing``).

A span marks one layer's part of a request on the host clock
(``time.perf_counter_ns``): its name, start and end, the span that
enclosed it on the same thread (its parent) and the root span of its
request (its call id). Spans nest through a per-thread stack, since the
serve layer searches on several threads. Recording is off by default:
:func:`start` turns it on, :func:`stop` turns it off and returns the
spans kept, at most ``CAPACITY`` of the newest. With recording off a
:func:`span` is one flag test and a shared object that does nothing.

:func:`phase` is a span whose duration is also kept as a named timing,
recording on or off, for the timings that have a reader: ``search.match``
(the server's ``stats`` op, ``tools/soak.py``), ``engine.warmup.maps`` and
``serve.batch_search`` (``chip_smoke.py``).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict, deque
from typing import NamedTuple


class Metrics:
    """Process-wide counters and latency records (thread-safe)."""

    # per-phase sample cap: a sliding window keeps memory bounded and the
    # records recent
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

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "timings": {k: list(v) for k, v in self.timings.items()},
            }


metrics = Metrics()


class Span(NamedTuple):
    """One recorded span; times in ``time.perf_counter_ns`` units."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None  # the enclosing span on its thread; None for a root
    root: int  # the id of its request's root span (its own for a root)


CAPACITY = 1 << 16  # spans kept by default: ~6,000 calls of ~11 spans

_on = False  # the one flag an unrecorded span tests
_spans: deque = deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()  # its ``stack``: the thread's open spans
_now = time.perf_counter_ns


class _Open:
    """A span being timed. One opened while recording is on takes a place
    on its thread's stack and is recorded when it closes, if recording is
    still on; a ``timed`` one keeps its duration under its name either
    way."""

    __slots__ = ("name", "timed", "start", "stack", "id", "parent", "root")

    def __init__(self, name: str, timed: bool) -> None:
        self.name, self.timed, self.stack = name, timed, None

    def __enter__(self) -> _Open:
        # the clock first and last: the recorder's own work stays inside
        # the span, so a parent's self time is its own
        self.start = _now()
        if _on:
            try:
                stack = _local.stack
            except AttributeError:
                stack = _local.stack = []
            self.stack = stack
            if stack:
                up = stack[-1]
                self.parent, self.root = up.id, up.root
                self.id = next(_ids)
            else:
                self.parent, self.id = None, next(_ids)
                self.root = self.id
            stack.append(self)
        return self

    def __exit__(self, kind, err, tb) -> bool:
        if self.stack is not None:
            self.stack.pop()
            end = _now()
            if _on:
                _spans.append((self.name, self.start, end, self.id,
                               self.parent, self.root))
        else:
            end = _now()
        if self.timed:
            # failures count too: tail percentiles must include the slow
            # and raising requests they exist to expose
            metrics.record_time(self.name, (end - self.start) / 1e9)
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self) -> _NoSpan:
        return self

    def __exit__(self, kind, err, tb) -> bool:
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """A span over a ``with`` block; with recording off, nothing at all.
    Its host time covers enqueueing only unless the block reads back."""
    if not _on:
        return _NO_SPAN
    return _Open(name, False)


def phase(name: str) -> _Open:
    """A :func:`span` whose duration is also kept as the named timing
    ``name`` (``metrics.snapshot()["timings"]``), recording on or off."""
    return _Open(name, True)


def start() -> None:
    """Record spans from here on, keeping the newest ``CAPACITY``. Spans
    already open stay unrecorded, so their children record as roots."""
    global _on, _spans
    _spans = deque(maxlen=CAPACITY)
    _on = True


def stop() -> list[Span]:
    """Stop recording; the spans kept since :func:`start`, in the order they
    closed (a child before its parent)."""
    global _on, _spans
    _on = False
    out, _spans = _spans, deque(maxlen=CAPACITY)
    return [Span(*s) for s in out]


def self_ns(spans: list[Span]) -> dict[int, int]:
    """Each span's self time by its id: its duration less the part of it
    that its children cover."""
    kids: dict = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            kids[s.parent].append((s.start_ns, s.end_ns))
    out = {}
    for s in spans:
        covered, edge = 0, s.start_ns
        for a, b in sorted(kids.get(s.id, ())):
            a, b = max(a, edge), min(b, s.end_ns)
            if b > a:
                covered += b - a
                edge = b
        out[s.id] = s.end_ns - s.start_ns - covered
    return out
