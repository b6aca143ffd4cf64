"""Device timing on a CUDA card: CUDA events, torch.profiler device sums,
and back-to-back launches on one stream.

``python3 chip_smoke.py`` and ``tiresias_tpu_torch/bench.py`` time with
these. Every helper takes a callable that launches the work on the current
stream and needs a card; :data:`CLOCKS` records which clock each
:func:`device_ms` call used, so a figure can carry its clock.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


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
# the clock of each device_ms call, in order: "profiler", or "events" where
# torch.profiler recorded no device time and the call timed with CUDA events
CLOCKS: list = []


def clocks_since(n0: int) -> str:
    """The clocks the device_ms calls since ``CLOCKS[n0]`` timed with:
    "profiler", "events", or "events+profiler" where they differed."""
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


# the spin kernel of torch.cuda._sleep, which edge_spin launches
SPIN = "spin_kernel"


def edge_spin() -> None:
    """A ~0.5 ms spin kernel for each end of a profile window, meant to
    take records CUPTI might lose at a window's edges. In a long process a
    profile of ``reps`` calls still records some kernels ``reps - 1`` times
    with the spins in place (H100, chip_smoke.py): the loss is not at the
    edges, and :func:`device_ms` retakes such a profile. Profiles leave
    ``SPIN`` out of their sums."""
    torch.cuda._sleep(1_000_000)


def device_ms(fn, reps: int = 20, attempts: int = 3, flush: bool = False,
              names: tuple | None = None):
    """Device time per call: the CUDA kernel and memory-op time
    torch.profiler records over ``reps`` calls, divided by ``reps``. With
    ``names``, a dict of each kernel name that contains one of them (the
    share of each launch of a pair). With ``flush``, the L2 cache is
    flushed before each call, and the flush is left out of the sum; so are
    the spin kernels at the window's edges (:func:`edge_spin`). A
    profile that records none of the summed time, or records a kernel a
    number of times that is no multiple of ``reps`` (CUPTI occasionally
    delivers none, or drops records, for a short window; every call
    launches the same kernels), is taken again, up to ``attempts``
    profiles (one while the previous call's profiles were all empty); then
    this call times with CUDA events instead (:func:`events_ms`), and a split
    by ``names`` is unknown (None). The clock used is appended to
    ``CLOCKS``."""
    if CLOCKS and CLOCKS[-1] == "events":
        attempts = 1
    buf = flush_buffer() if flush else None
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # per-cycle
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                edge_spin()
                for _ in range(reps):
                    if buf is not None:
                        buf.bitwise_not_()
                    fn()
                edge_spin()
                torch.cuda.synchronize()
        per = {n: 0.0 for n in names or ("",)}
        short = []
        for e in prof.key_averages():
            if SPIN in e.key or (buf is not None and "bitwise_not" in e.key):
                continue
            us = getattr(e, "self_device_time_total", 0)
            if us > 0 and e.count % reps:
                short.append(f"{e.key[:48]} x{e.count}")
            for n in per:
                if n in e.key:
                    per[n] += us / 1e3 / reps
        if short:
            print(f"[profiler] device records are no whole number a call "
                  f"over {reps} calls ({'; '.join(short)})", flush=True)
        elif sum(per.values()) > 0:
            CLOCKS.append("profiler")
            return per if names else per[""]
        else:
            print(f"[profiler] no CUDA device time recorded over {reps} "
                  f"calls", flush=True)
    print(f"[profiler] no whole profile in {attempts} attempt(s) in a row: "
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

