"""Device timing on a CUDA card: CUDA events, torch.profiler device sums,
and back-to-back launches on one stream.

``python3 chip_smoke.py`` and ``tiresias_tpu_torch/bench.py`` time with
these. Every helper that times takes a callable that launches the work on
the current stream and needs a card; :data:`CLOCKS` records which clock
each :func:`device_ms` call used, so a figure can carry its clock.
:func:`profile_reading` and :func:`launches_per_call` are the arithmetic of
a profile's reading, and need none.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tiresias_tpu_torch.utils import build


def call_ms(fn, reps: int = 20) -> float:
    """Median wall time of one call on the stream (CUDA events around each
    call after two warm-ups): device time plus whatever launch overhead the
    host adds before the work reaches the card."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


_FLUSH = {}
# the clock of each device_ms call, in order: "profiler" (every kernel
# recorded a whole number of times a call), "profiler-scaled" (some kernel
# lost records: read from the records that arrived, see profile_reading), or
# "events" where torch.profiler recorded no device time at all and the call
# timed with CUDA events
CLOCKS: list = []
# the spin-kernel records (lead_in's LEAD_IN + 1 and the end's edge_spin)
# each device_ms profile lost, in order
LEAD_LOST: list = []


def clocks_since(n0: int) -> str:
    """The clocks the device_ms calls since ``CLOCKS[n0]`` timed with, in
    sorted order joined by "+" ("profiler", "profiler-scaled", "events")."""
    return "+".join(sorted(set(CLOCKS[n0:]))) or "none"


def flush_buffer():
    """A 128 MB int32 buffer (2.6 times the 50 MB L2) whose
    ``bitwise_not_`` flushes the L2 cache."""
    dev = torch.cuda.current_device()
    if dev not in _FLUSH:
        _FLUSH[dev] = torch.zeros(32 * 2**20, dtype=torch.int32, device=dev)
    return _FLUSH[dev]


def events_ms(fn, reps: int = 20, flush: bool = False) -> float:
    """Device time per call from CUDA events around each call, with the host
    ahead of the card: a ~2 ms spin kernel before each call keeps the card
    busy while the host queues the call's launches, so the events see the
    call's kernels and the gaps between them, not the launch overhead (a
    call whose host work takes longer shows that too). With ``flush``, the
    L2 cache is flushed before each call."""
    buf = flush_buffer() if flush else None
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if buf is not None:
            buf.bitwise_not_()
        torch.cuda._sleep(4_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


# the spin kernel of torch.cuda._sleep, which edge_spin and lead_in launch
SPIN = "spin_kernel"
# spin kernels of ~1 us at the start of every device_ms profile
LEAD_IN = 64


def edge_spin() -> None:
    """A ~0.5 ms spin kernel for each end of a profile window. Profiles
    leave ``SPIN`` out of their sums."""
    torch.cuda._sleep(1_000_000)


def lead_in() -> None:
    """``LEAD_IN`` spin kernels of ~1 us and one of ~0.5 ms at the start of
    a profile window. In a process that has run for minutes, CUPTI loses
    the first device records of some profiles (H100, chip_smoke.py); these
    come first, so a loss of fewer than ``LEAD_IN + 1`` records misses the
    timed calls, and the spins' own count says how many were lost."""
    for _ in range(LEAD_IN):
        torch.cuda._sleep(2_000)
    edge_spin()


def launches_per_call(kernels, before: dict, after: dict, reps: int) -> dict:
    """Launches a call of each kernel name in ``kernels`` that a counted
    wrapper runs (``build.KERNEL_NAMES``): the launches of every counter
    that names it, between the snapshots ``before`` and ``after`` of
    ``build.LAUNCHES``, over ``reps`` calls, where that is a whole
    number."""
    out = {}
    for name in kernels:
        moved = sum(after[c] - before[c]
                    for c, parts in build.KERNEL_NAMES.items()
                    if any(p in name for p in parts))
        n, rest = divmod(moved, reps)
        if n > 0 and not rest:
            out[name] = n
    return out


def profile_reading(records, reps: int, per_call: dict | None = None,
                    names: tuple | None = None):
    """Device ms per call from one profile of ``reps`` calls, given its
    device records ``(kernel name, us)``: each kernel's recorded time over
    ``reps``. A kernel recorded a number of times that is no multiple of
    ``reps`` lost records; it reads as its mean record time times its
    launches a call: ``per_call[name]`` (the launch counters',
    :func:`launches_per_call`), else the fewest whole launches a call its
    records allow. Returns (ms by each of ``names`` that a kernel's name
    contains, or under "" the total; the kernel names read from lost
    records)."""
    totals: dict = {}
    for name, us in records:
        t = totals.setdefault(name, [0, 0.0])
        t[0] += 1
        t[1] += us
    per = dict.fromkeys(names or ("",), 0.0)
    scaled = []
    for name, (count, us) in totals.items():
        if count % reps:
            n = (per_call or {}).get(name) or -(-count // reps)
            ms = us / count * n / 1e3
            scaled.append(name)
        else:
            ms = us / reps / 1e3
        for key in per:
            if key in name:
                per[key] += ms
    return per, scaled


def device_ms(fn, reps: int = 20, flush: bool = False,
              names: tuple | None = None):
    """Device time per call: the CUDA kernel and memory-op time
    torch.profiler records over ``reps`` calls, divided by ``reps``
    (:func:`profile_reading`; a kernel that lost records reads from those
    that arrived and the launch counters). With ``names``, a dict of each
    kernel name that contains one of them (the share of each launch of a
    pair). With ``flush``, the L2 cache is flushed before each call, and
    the flush is left out of the sum; so are the spin kernels of the
    window's lead-in and end (:func:`lead_in`, :func:`edge_spin`). A
    profile that records no device time at all (CUPTI occasionally
    delivers none) times with CUDA events instead (:func:`events_ms`), and
    a split by ``names`` is unknown (None). The clock used is appended to
    ``CLOCKS``."""
    buf = flush_buffer() if flush else None
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    before = dict(build.LAUNCHES)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # per-cycle
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lead_in()
            for _ in range(reps):
                if buf is not None:
                    buf.bitwise_not_()
                fn()
            edge_spin()
            torch.cuda.synchronize()
    after = dict(build.LAUNCHES)
    records, spins = [], 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if SPIN in e.name:
            spins += 1
        elif buf is None or "bitwise_not" not in e.name:
            records.append((e.name, e.self_device_time_total))
    LEAD_LOST.append(max(0, LEAD_IN + 2 - spins))
    if records:
        per_call = launches_per_call({n for n, _ in records}, before, after,
                                     reps)
        per, scaled = profile_reading(records, reps, per_call, names)
        if sum(per.values()) > 0:
            CLOCKS.append("profiler-scaled" if scaled else "profiler")
            return per if names else per[""]
    print(f"[profiler] no CUDA device time recorded over {reps} calls: "
          f"this call times with CUDA events (events_ms)", flush=True)
    CLOCKS.append("events")
    if names:
        return dict.fromkeys(names)
    return events_ms(fn, reps, flush)


def stream_ms(fn, reps: int = 10) -> float:
    """Time per call of ``reps`` back-to-back calls on the stream, from CUDA
    events around them (after two warm-ups): device time plus whatever gaps
    the host leaves between launches. A yardstick beside ``device_ms`` that
    needs no profiler."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps

