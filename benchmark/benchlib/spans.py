"""The program's spans on the device trace's clock.

With recording on (``tiresias_tpu_torch.utils.tracing.start``), the engine
keeps a span at each layer boundary of a call: its name, start and end on
the host's ``perf_counter_ns``, its parent and its call's root. The
profile of a traced window holds each device operation together with the
host's CUDA call that launched it (one correlation id), both on the
profile's own clock. A host call with no device work, ``CALIBRATION``,
made between two readings of the host's clock once a call, ties the two
clocks: the offset is the middle of the interval that every such bracket
allows, the residual half its width (negative where none fits them all).

On that clock, each device operation is named by the span whose launch it
was, and each stretch of the window in which the device ran nothing by the
innermost span open on the host ("outside search" between calls). The
profile's device times drift against its host times by some microseconds
over a window, so each call's device times are shifted by the call's least
lead of an operation's start over its launch, less the window's median
one.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

from benchlib.stats import percentile
from benchlib.trace import SPIN

ROOT = "search.match"
READBACK = "search.readback"
# the spans that launch device work; the engine's host work of building
# and enqueueing it is the self time of all but the upload and readback
LAUNCHERS = ("search.upload", "search.fingerprint", "search.votes",
             "search.prefilter", "search.rank", READBACK)
LAUNCH = ("search.fingerprint", "search.votes", "search.prefilter",
          "search.rank")
OUTSIDE = "outside search"
CALIBRATION = "cudaStreamQuery"
# ops/match_kernels.py::route_counts' slots
ROUTES = ("K4 index route items", "K4 dense route items",
          "K5 index route items", "K5 wide items handed on",
          "K5 bit-sliced kernel items", "bit-sliced frame tests on bitsets",
          "bit-sliced frame tests entry by entry")


@dataclasses.dataclass
class Records:
    ops: list  # (name, start ns, end ns, correlation id), by start
    launches: dict  # correlation id -> start ns of the host call behind it
    base_ns: int  # the profile time that trace.device_records calls 0
    calibrations: list  # (start ns, end ns) of each CALIBRATION call


def profile_records(prof) -> Records:
    """Every device record of a torch.profiler profile, the CUDA call
    (``cuda*`` or ``cu*``) that launched it, and the CALIBRATION calls."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops, host, cal = [], {}, []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        if e.device_type() == cuda:
            ops.append((e.name(), s, s + e.duration_ns(), e.correlation_id()))
        elif e.name() == CALIBRATION:
            cal.append((s, s + e.duration_ns()))
        elif e.name().startswith("cu") and e.correlation_id():
            host.setdefault(e.correlation_id(), s)
    ops.sort(key=lambda o: o[1])
    mine = {o[3] for o in ops}
    return Records(ops, {c: h for c, h in host.items() if c in mine},
                   min((o[1] for o in ops), default=0), sorted(cal))


@dataclasses.dataclass
class Clock:
    offset_ns: float  # profile ns = host ns + offset
    residual_us: float
    calls: int  # the CALIBRATION calls that bound the offset


def clock(brackets: list, calls: list) -> Clock | None:
    """The offset from the host's clock to the profile's. ``brackets``: the
    host clock's readings (before, after) around each CALIBRATION call, in
    order; ``calls``: the profile's records of them. None where they do not
    pair one to one."""
    if not brackets or len(brackets) != len(calls):
        return None
    pairs = list(zip(brackets, calls))
    lo = max(e - after for (_, after), (_, e) in pairs)
    hi = min(s - before for (before, _), (s, _) in pairs)
    return Clock((lo + hi) / 2, (hi - lo) / 2e3, len(pairs))


def _segments(root, kids: dict) -> list:
    """``(start ns, end ns, span)`` of a call's host time, each piece
    named by the innermost span open in it."""
    out = []

    def walk(s):
        cur = s.start_ns
        for c in kids.get(s.id, ()):
            if c.start_ns > cur:
                out.append((cur, c.start_ns, s))
            walk(c)
            cur = max(cur, c.end_ns)
        if s.end_ns > cur:
            out.append((cur, s.end_ns, s))

    walk(root)
    return out


@dataclasses.dataclass
class SpanReading:
    clock: Clock
    calls: list  # per call: {span name: self ms summed over its spans}
    idle_s: dict  # innermost open span (or OUTSIDE) -> idle device s
    window_s: float
    checked: int  # calls with device ops in the window
    launch_ok: int  # of them, those whose every op starts after its launch
    # span opened, that span one of LAUNCHERS
    readback_ok: int  # of them, those whose last op ends before the
    # search.readback span does
    unplaced: int  # device ops launched outside every root span
    misplaced: dict  # span name -> ops that fail the launch check there
    drift_us: float  # the spread of the calls' device-time shifts

    def median_ms(self, *names) -> float | None:
        if not self.calls:
            return None
        return percentile([sum(c.get(n, 0.0) for n in names)
                           for c in self.calls], 50)

    def idle_pct(self) -> float | None:
        """Share of the window in which the device ran nothing while a
        root span was open."""
        if self.window_s <= 0:
            return None
        inside = sum(v for k, v in self.idle_s.items() if k != OUTSIDE)
        return 100.0 * inside / self.window_s

    def idle_by_span(self, top: int = 10) -> list:
        return sorted(([k, v] for k, v in self.idle_s.items()),
                      key=lambda x: -x[1])[:top]


def read(spans: list, rec: Records, trace,
         brackets: list) -> SpanReading | None:
    """``spans``: the window's spans (``tracing.stop()``); ``trace``: the
    window's ``benchlib.trace.Trace`` (its first marker and length bound
    the window); ``brackets``: as :func:`clock`'s."""
    from tiresias_tpu_torch.utils.tracing import self_ns

    roots = sorted((s for s in spans if s.parent is None and s.name == ROOT),
                   key=lambda s: s.start_ns)
    if not roots or trace is None or not trace.calls:
        return None
    kids: dict = defaultdict(list)
    by_root: dict = defaultdict(list)
    readbacks = {}
    for s in sorted(spans, key=lambda s: s.start_ns):
        by_root[s.root].append(s)
        if s.parent is not None:
            kids[s.parent].append(s)
        if s.name == READBACK:
            readbacks[s.root] = s
    clk = clock(brackets, rec.calibrations)
    if clk is None:
        return None
    own = self_ns(spans)
    calls = []
    for r in roots:
        per: dict = defaultdict(float)
        for s in by_root[r.id]:
            per[s.name] += own[s.id] / 1e6
        calls.append(dict(per))

    # host pieces on the profile's clock, by start
    off = clk.offset_ns
    segs = sorted(((a + off, b + off, s) for r in roots
                   for a, b, s in _segments(r, kids)), key=lambda x: x[0])
    seg_starts = [a for a, _, _ in segs]

    def where(t: float):
        i = bisect.bisect_right(seg_starts, t) - 1
        return segs[i][2] if i >= 0 and t < segs[i][1] else None

    # each device op by the span that launched it
    w0 = rec.base_ns + trace.calls[0].start_us * 1e3
    w1 = w0 + trace.window_s * 1e9
    placed, busy, unplaced = [], [], 0
    for name, s, e, corr in rec.ops:
        if SPIN in name or not w0 <= s < w1:
            continue
        launch = rec.launches.get(corr)
        span = where(launch) if launch is not None else None
        if span is None:
            unplaced += 1
            busy.append((s, e))
        else:
            placed.append((span, s, e, launch))
    # the profile's device times drift against its host times by some us
    # over a window: per call, shift them so that the call's least lead of
    # an op's start over its launch is the window's median one
    lead: dict = {}
    for span, s, _, launch in placed:
        lead[span.root] = min(lead.get(span.root, s - launch), s - launch)
    floor = percentile(lead.values(), 50) if lead else 0.0
    shift = {r: v - floor for r, v in lead.items()}
    bad_launch, last_end = set(), {}
    misplaced: dict = defaultdict(int)
    for span, s, e, _ in placed:
        s, e = s - shift[span.root], e - shift[span.root]
        busy.append((s, e))
        if span.name not in LAUNCHERS or s < span.start_ns + off:
            bad_launch.add(span.root)
            misplaced[span.name] += 1
        last_end[span.root] = max(last_end.get(span.root, e), e)
    timed = [r for r in roots if r.id in last_end]
    readback_ok = sum(1 for r in timed if r.id in readbacks and
                      last_end[r.id] <= readbacks[r.id].end_ns + off)
    if timed:
        w0 -= shift[timed[0].id]
        w1 -= shift[timed[-1].id]

    # the window's idle stretches by the innermost open span
    idle, cur = [], w0
    for s, e in _merged(busy):
        if s > cur:
            idle.append((cur, s))
        cur = max(cur, e)
    if w1 > cur:
        idle.append((cur, w1))
    by: dict = defaultdict(float)
    j = 0
    for a, b in idle:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k, t = j, a
        while t < b:
            if k < len(segs) and segs[k][0] <= t:
                end = min(b, segs[k][1])
                by[segs[k][2].name] += (end - t) / 1e9
                t = end
                k += 1
            else:
                end = min(b, segs[k][0]) if k < len(segs) else b
                by[OUTSIDE] += (end - t) / 1e9
                t = end
    drift = (max(shift.values()) - min(shift.values())) / 1e3 if shift \
        else 0.0
    return SpanReading(clk, calls, dict(by), trace.window_s, len(timed),
                       len(timed) - len(bad_launch), readback_ok, unplaced,
                       dict(misplaced), drift)


def _merged(intervals):
    """Overlapping intervals merged, by start."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out
