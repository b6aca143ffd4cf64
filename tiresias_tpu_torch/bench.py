"""Benchmark harness of the PyTorch port — the counterpart of ``bench.py``.

    python -m tiresias_tpu_torch.bench                  # every section
    python -m tiresias_tpu_torch.bench --section NAME   # one, in-process
    python -m tiresias_tpu_torch.cli bench [--section NAME]

Runs on ``cuda`` and raises without a card; ``--device cpu`` runs the
kernels' plain twins (tests only: a CPU run measures no device metric).

The orchestrator builds the kernel library once, then runs every section in
a subprocess of its own under a hard watchdog deadline (``SECONDARY``),
headline first. A killed section's partial output is salvaged. Each section
prints ``[bench]`` lines on stderr, each with the section's peak device
memory and the card's name and power limit as ``nvidia-smi`` prints them,
and ``{"_summary": ...}`` control lines on stdout, merged per section. The
last two stdout lines are a compact ``{"sections": ...}`` line (at most
1,700 characters; the largest payloads are dropped whole) and the headline
``{"metric": "fingerprint_throughput", ...}``. A section that fails or is
killed is named in the ``sections`` line, and the run then exits 1; so does
a run whose headline was not measured.

Timing on the card: K back-to-back launches on one stream between two CUDA
events and one synchronize give per-iteration device ms (``dev_ms``; the
stream's time, launch gaps included) beside the host's wall ms. ``rtt_ms``
is the card's launch-and-sync floor: one trivial kernel and
``torch.cuda.synchronize()``, warm, p50. The link floors come from measured
host-to-device copies of 32 MiB, pageable and pinned.

``TIRESIAS_BENCH_BUDGET_S`` is a soft wall-clock budget: the orchestrator
skips what no longer fits, and a section skips a configuration past 85% of
its deadline, each with an explicit marker.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from tiresias_tpu_torch.api import Tiresias
from tiresias_tpu_torch.config import (
    NOISE20_COEF_WEIGHTS,
    ContextConfig,
    DspConfig,
    TiresiasConfig,
)
from tiresias_tpu_torch.ops import match_kernels
from tiresias_tpu_torch.ops import match_lattice as ml
from tiresias_tpu_torch.ops.match import prepare_query, top1
from tiresias_tpu_torch.ops.match_index import build_match_index
from tiresias_tpu_torch.ops.mfcc import (
    PAD_VALUE,
    fingerprint_padded_batch,
    pad_frames_bucket,
)
from tiresias_tpu_torch.utils import build
from tiresias_tpu_torch.utils.audio import (
    float_to_i16,
    synth_chirp,
    synth_tone,
    write_wav,
)
from tiresias_tpu_torch.utils.device import resolve_device
from tiresias_tpu_torch.utils.g711 import encode
from tiresias_tpu_torch.utils.timing import CLOCKS, device_ms
from tiresias_tpu_torch.utils.tracing import metrics

_START = time.monotonic()
SR = 8000
# the package's parent: children run ``python -m tiresias_tpu_torch.bench``
# from here
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t() -> float:
    return time.monotonic() - _START


def mark(msg: str) -> None:
    """Timestamped stderr progress marker: a killed run's tail shows where
    it died."""
    print(f"[bench] t=+{_t():.0f}s {msg}", file=sys.stderr, flush=True)


def _budget_s() -> float:
    """Soft wall-clock budget: of the whole run in the orchestrator, of the
    section in a child (85% of its deadline, set by the orchestrator)."""
    return float(os.environ.get("TIRESIAS_BENCH_BUDGET_S", "1400"))


def summary(section: str, **kw) -> None:
    """A section's key numbers as a stdout control line; the orchestrator
    merges repeated lines of one section (partial results survive a later
    watchdog kill) into its final ``sections`` line."""

    def _r(v):
        return round(v, 2) if isinstance(v, float) else v

    print(
        json.dumps(
            {"_summary": 1, "section": section,
             **{k: _r(v) for k, v in kw.items()}},
            separators=(",", ":"),
        ),
        flush=True,
    )


def over_budget(label: str) -> bool:
    """True (and a skip marker) when the soft budget is spent: the caller
    skips the labelled section or configuration."""
    spent = time.monotonic() - _START
    if spent <= _budget_s():
        return False
    print(
        f"[bench] {label} skipped: {spent:.0f}s spent exceeds the "
        f"{_budget_s():.0f}s soft budget (set TIRESIAS_BENCH_BUDGET_S to "
        "raise)",
        file=sys.stderr,
    )
    return True


# ---- the card, its clocks and its memory -------------------------------- #

_CARD: dict = {}


def card(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (once per process), or
    ``cpu`` for a CPU run."""
    if device.type != "cuda":
        return "cpu (plain twins; no device metric)"
    if "line" not in _CARD:
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60,
            )
            _CARD["line"] = (smi.stdout.strip().splitlines() or ["?"])[0] \
                if smi.returncode == 0 else f"nvidia-smi rc={smi.returncode}"
        except (OSError, subprocess.TimeoutExpired) as exc:
            _CARD["line"] = f"nvidia-smi failed: {exc}"
    return _CARD["line"]


def peak_bytes(device: torch.device) -> int | None:
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


def say(device: torch.device, msg: str) -> None:
    """One ``[bench]`` result line: ``msg``, the section's peak device
    memory so far, and the card."""
    peak = peak_bytes(device)
    mem = "n/a" if peak is None else f"{peak / 2**30:.3f} GiB"
    print(f"[bench] {msg}; peak memory {mem}; {card(device)}",
          file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def seq_ms(fns, device: torch.device) -> tuple[float, float]:
    """(device ms, wall ms) per call of ``fns`` run back to back once each
    on the stream: CUDA events before the first and after the last, one
    synchronize, the host's clock around it all. On the CPU both are the
    host's clock."""
    _sync(device)
    t0 = time.perf_counter()
    if device.type != "cuda":
        for fn in fns:
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / len(fns)
        return ms, ms
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for fn in fns:
        fn()
    b.record()
    b.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return a.elapsed_time(b) / len(fns), wall / len(fns)


def launch_floor_ms(device: torch.device, n: int = 15) -> float:
    """p50 ms of one trivial kernel plus ``torch.cuda.synchronize()``, warm:
    the least a blocking search pays beyond its work (the host's own clock
    on the CPU)."""
    x = torch.zeros(1, device=device)
    x.add_(1)
    _sync(device)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        x.add_(1)
        _sync(device)
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(ts, 50))


def link_mibs(device: torch.device, pinned: bool, n: int = 5) -> float:
    """Host-to-device MiB/s of a 32 MiB int16 copy (incompressible), median
    of ``n``: from pageable memory, or from pinned memory. On the CPU, a
    host copy."""
    probe = torch.from_numpy(np.random.default_rng(0).integers(
        -1000, 1000, (16, 2**20), dtype=np.int16))
    if pinned and device.type == "cuda":
        probe = probe.pin_memory()
    dst = torch.empty_like(probe, device=device)
    dst.copy_(probe)
    _sync(device)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        dst.copy_(probe, non_blocking=pinned)
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return 32.0 / float(np.median(ts))


# the kernels of one prefiltered search, by a substring of their names:
# K-a the bound scan, K-b the selection (csrc/select.cu: one kb_select launch),
# the dialplan rescore, K-c the candidate forms and their work list
# kernel groups by a part of the profiler's kernel names (the work list's
# three kernels by their namespace's "::", or K5's grouped vote kernels
# would count twice)
SPLIT = (("K1", "mfcc"), ("K-a", "bound_scan"), ("K-b", "kb_select"),
         ("rescore", "rescore_rows"), ("K-c", "match_votes"),
         ("K-c work list", "::group_"))


def kernel_split(fn, device: torch.device, reps: int = 16) -> str:
    """Device ms per call of ``fn`` by kernel group (:data:`SPLIT`), from
    torch.profiler's kernel sums; the rest is plain torch (the rescore,
    the scatter, top-1). "not measured" on the CPU, or where the profiler
    recorded no kernel and timed with CUDA events."""
    if device.type != "cuda":
        return "kernel split not measured (no card)"
    per = device_ms(fn, reps, names=("",) + tuple(n for _, n in SPLIT))
    if per[""] is None:
        return f"kernel split not measured ({CLOCKS[-1]} clock)"
    parts = [f"{label} {per[n]:.4f}" for label, n in SPLIT if per[n]]
    rest = per[""] - sum(per[n] for _, n in SPLIT)
    return (f"kernel split per search ({CLOCKS[-1]}): total "
            f"{per['']:.4f} ms = {', '.join(parts)}, plain torch "
            f"{rest:.4f}")


def _fallbacks() -> int:
    return int(metrics.snapshot()["counters"].get(
        "search.prefilter_fallbacks", 0))


def _engine(device, prefix: str, dsp: DspConfig | None = None,
            contexts=()) -> Tiresias:
    cfg = TiresiasConfig(dsp=dsp or DspConfig(), contexts=tuple(contexts),
                         data_dir=tempfile.mkdtemp(prefix=prefix))
    return Tiresias(cfg, restore=False, device=device)


def _inject_uniform(eng: Tiresias, device, n_tracks: int, seed: int,
                    tag: str) -> None:
    """``n_tracks`` uniform [-30, 25) fingerprints of 128 frames into
    context "c" (as the JAX sections inject them), the loop timed on a line
    of its own."""
    eng.create_context("c")
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for i in range(n_tracks):
        fp = rng.uniform(-30, 25, size=(128, 2)).astype(np.float32)
        eng.store.add_audio(f"t{i}", "c", fp, f"{tag}{i:08d}")
    say(device, f"injected {n_tracks} tracks through store.add_audio in "
        f"{time.perf_counter() - t0:.3f}s (host loop)")


# ---- 1. the headline: fingerprint throughput --------------------------- #


def bench_fingerprint_throughput(
    device="cuda", batch: int = 256, clip_s: float = 60.0, k_scan: int = 16,
    rounds: int = 5,
) -> float:
    """Audio-hours fingerprinted per wall-clock hour: ``k_scan`` launches of
    the K2 path over ``[batch, clip_s * 8000]`` PCM generated on the card,
    back to back on one stream and one synchronize, median of ``rounds``."""
    dev = resolve_device(device)
    dsp = DspConfig()
    n = int(SR * clip_s)
    n -= n % dsp.hop_size
    gen = torch.Generator(device=dev).manual_seed(0)
    pcm = 0.3 * torch.randn((batch, n), generator=gen, device=dev)

    def fp():
        return fingerprint_padded_batch(pcm, SR, dsp, device=dev)

    fp()
    _sync(dev)
    devs, walls = [], []
    for _ in range(rounds):
        d, w = seq_ms([fp] * k_scan, dev)
        devs.append(d)
        walls.append(w * k_scan / 1e3)
    elapsed = float(np.median(walls))
    audio_s = k_scan * batch * clip_s
    throughput = audio_s / elapsed
    frames = k_scan * batch * (n // dsp.hop_size)
    ns_frame = elapsed * 1e9 / frames
    say(dev, f"fingerprint: {k_scan} back-to-back launches x {batch} x "
        f"{clip_s:.0f}s, median-of-{rounds} {elapsed:.4f}s -> "
        f"{throughput:.1f} audio-hrs/hr ({ns_frame:.2f} ns/frame wall; "
        f"device {float(np.median(devs)):.4f} ms per launch from CUDA "
        f"events; spread {min(walls):.4f}-{max(walls):.4f}s)")
    summary("fingerprint", hrs_hr=round(throughput),
            ns_frame=ns_frame,
            dev_ms=float(np.median(devs)))
    return throughput


# ---- 7. host feed ------------------------------------------------------- #


def bench_fingerprint_hostfeed(
    device="cuda", batch: int = 256, clip_s: float = 30.0, n_bufs: int = 4,
    iters: int = 4,
) -> None:
    """Fingerprint throughput with the PCM shipped from host memory: pinned
    staging buffers, each batch's copy on a second stream overlapping the
    previous batch's fingerprints. Two wires: int16 and G.711 µ-law (half
    the bytes, expanded on the card). Both link floors, pageable and pinned,
    are measured first; the pipeline copies from pinned memory."""
    dev = resolve_device(device)
    dsp = DspConfig()
    n = int(SR * clip_s)
    n -= n % dsp.hop_size
    rng = np.random.default_rng(11)
    bufs = [
        np.clip(np.round(0.3 * rng.standard_normal((batch, n)) * 32768.0),
                -32768, 32767).astype(np.int16)
        for _ in range(n_bufs)
    ]
    pageable = link_mibs(dev, pinned=False)
    pinned = link_mibs(dev, pinned=True)
    say(dev, f"hostfeed: link floors (32 MiB copies) pageable "
        f"{pageable:.1f} MiB/s, pinned {pinned:.1f} MiB/s; the pipeline "
        "copies from pinned staging buffers")
    audio_s = iters * batch * clip_s

    def run_wire(wire, label, law=None):
        host = [torch.from_numpy(b) for b in wire]
        if dev.type == "cuda":
            host = [h.pin_memory() for h in host]
        n_valid = np.full((batch,), n, np.int32) if law else None
        slots = [torch.empty_like(host[0], device=dev) for _ in range(2)]

        def fp(x):
            return fingerprint_padded_batch(x, SR, dsp, law=law,
                                            n_valid=n_valid, device=dev)

        fp(slots[0].copy_(host[0]))  # first use: tables, allocator
        _sync(dev)
        start = time.perf_counter()
        outs = []
        if dev.type == "cuda":
            comp = torch.cuda.current_stream(dev)
            copy = torch.cuda.Stream(dev)
            ready = [torch.cuda.Event() for _ in slots]
            free = [None, None]
            for i in range(iters):
                s = i % 2
                with torch.cuda.stream(copy):
                    if free[s] is not None:
                        copy.wait_event(free[s])
                    slots[s].copy_(host[i % n_bufs], non_blocking=True)
                    ready[s].record(copy)
                comp.wait_event(ready[s])
                outs.append(fp(slots[s]))
                free[s] = torch.cuda.Event()
                free[s].record(comp)
        else:
            for i in range(iters):
                outs.append(fp(slots[i % 2].copy_(host[i % n_bufs])))
        _ = sum(float(o[0, 0, 0]) for o in outs)
        elapsed = time.perf_counter() - start
        itemsize = wire[0].dtype.itemsize
        mib = iters * batch * n * itemsize / 2**20
        mib_per_hr = 3600 * SR * itemsize / 2**20
        floor = pinned * 3600 / mib_per_hr
        thr = audio_s / elapsed
        say(dev, f"fingerprint HOST-FEED {label}: {iters} x {batch} x "
            f"{clip_s:.0f}s ({mib:.0f} MiB H2D) in {elapsed:.4f}s -> "
            f"{thr:.1f} audio-hrs/hr incl. H2D ({mib / elapsed:.1f} MiB/s "
            f"sustained; {mib_per_hr:.1f} MiB/audio-hr on this wire -> "
            f"pinned link floor {floor:.0f} hrs/hr, pageable "
            f"{pageable * 3600 / mib_per_hr:.0f}; pipeline at "
            f"{100 * thr / floor:.1f}% of the pinned floor)")
        return thr, mib / elapsed

    thr, link = run_wire(bufs, "int16")
    # db_build's floor uses the pinned link of this run
    print(json.dumps({"_ctrl": 1, "key": "TIRESIAS_BENCH_LINK_MBS",
                      "value": round(pinned, 1)}), flush=True)
    summary("hostfeed", hrs_hr=round(thr), link_mbs=round(link, 1),
            pinned_mbs=round(pinned, 1), pageable_mbs=round(pageable, 1))
    if over_budget("hostfeed ulaw wire"):
        return
    ulaw = [encode(b.reshape(-1), "ulaw").reshape(batch, n) for b in bufs]
    thr_u, _ = run_wire(ulaw, "G.711 ulaw wire", law="ulaw")
    summary("hostfeed", ulaw_hrs_hr=round(thr_u))


# ---- 2 and 4. the dialplan ops path ------------------------------------- #


def bench_search_latency(
    device="cuda", n_tracks: int = 10_000, n_rounds: int = 20,
    batches: tuple = (1, 64), time_build: bool = False,
    track_frames: int = 1024, k_seq: int = 32, section: str = "search",
    prefix: str = "",
) -> float:
    """p50 ms per query of a 3 s recognition against ``n_tracks`` uniform
    tracks on the dialplan ops path: fingerprint (K1) → lattice votes (K3′)
    → top-1, ending in a readback; and the batch-1 device time of
    ``k_seq`` recognitions back to back on one stream."""
    dev = resolve_device(device)
    dsp = DspConfig()
    rng = np.random.default_rng(1)
    t = track_frames
    db = rng.uniform(-30, 25, size=(n_tracks, t)).astype(np.float32)
    n_frames = rng.integers(t // 2, t, size=n_tracks)
    mask = np.arange(t)[None, :] < n_frames[:, None]
    db = np.where(mask, db, PAD_VALUE).astype(np.float32)

    _sync(dev)
    t_build0 = time.perf_counter()
    vm = ml.build_value_map(torch.from_numpy(db).to(dev),
                            torch.from_numpy(mask).to(dev))
    _sync(dev)
    build_s = time.perf_counter() - t_build0
    del db, mask
    if time_build:
        say(dev, f"lattice build @ {n_tracks} tracks: {build_s:.3f}s for a "
            f"{vm.numel() * 4 / 2**20:.0f} MiB distance map (incl. the "
            "H2D copy of the tracks)")

    def recognize(pcm):
        qfp = fingerprint_padded_batch(pcm, SR, dsp, device=dev)
        active = torch.ones(qfp.shape[:2], dtype=torch.bool, device=dev)
        votes = ml.lattice_votes(vm, qfp[..., 0].contiguous(), active, 0.5,
                                 float("-inf"), float("inf"))
        return top1(votes)

    n = 3 * SR - (3 * SR) % dsp.hop_size
    results = {}
    for batch in batches:
        pcm = torch.from_numpy(
            (0.3 * rng.standard_normal((batch, n))).astype(np.float32)
        ).to(dev)
        int(recognize(pcm)[0][0])
        times = []
        for _ in range(n_rounds):
            t0 = time.perf_counter()
            int(recognize(pcm)[0][0])
            times.append((time.perf_counter() - t0) * 1e3 / batch)
        results[batch] = float(np.percentile(times, 50))
        say(dev, f"search @ {n_tracks} tracks, batch {batch}: "
            f"p50={results[batch]:.4f} ms/query (call p90="
            f"{np.percentile(times, 90) * batch:.3f} ms)")

    pcm_seq = torch.from_numpy(
        (0.3 * rng.standard_normal((k_seq, n))).astype(np.float32)).to(dev)
    calls = [lambda i=i: recognize(pcm_seq[i : i + 1]) for i in range(k_seq)]
    seq_ms(calls, dev)  # warm
    runs = [seq_ms(calls, dev) for _ in range(n_rounds)]
    per_query = float(np.percentile([r[0] for r in runs], 50))
    wall = float(np.percentile([r[1] for r in runs], 50))
    results["device"] = per_query
    say(dev, f"search @ {n_tracks} tracks, batch 1 DEVICE-TIME: "
        f"p50={per_query:.4f} ms/query ({k_seq} batch-1 recognitions back "
        f"to back on one stream, CUDA events; wall {wall:.4f} ms/query)")
    kw = {f"{prefix}dev_ms": per_query}
    for b in (1, 64):
        if b in results:
            kw[f"{prefix}b{b}_ms"] = results[b]
    if time_build:
        kw[f"{prefix}build_s"] = build_s
    summary(section, **kw)
    return results.get(64, per_query)


def bench_search_scale(
    device="cuda",
    configs=(("100k_", 100_000, 1024), ("1m_", 1_000_000, 128)),
) -> None:
    """``search`` past the BASELINE size: 100,000 tracks of 1,024 frames
    and 1,000,000 of 128 (~4 s prompts), the map build timed."""
    for prefix, n_tracks, t in configs:
        if over_budget(f"search scale @{n_tracks}"):
            continue
        bench_search_latency(device, n_tracks=n_tracks, n_rounds=10,
                             batches=(), time_build=True, track_frames=t,
                             section="search_scale", prefix=prefix)
        if resolve_device(device).type == "cuda":
            torch.cuda.empty_cache()


# ---- 10. the certified dialplan prefilter ------------------------------- #


def _clustered_db(dev, n_tracks: int, t: int, shape: tuple, mu_lo: float,
                  mu_hi: float, sigma: float, seed: int = 7):
    """``(db, mask)`` on the card: per-audio means uniform in [mu_lo,
    mu_hi) plus ``sigma`` normal noise, ``n_frames`` uniform in [t/2, t),
    PAD_VALUE past each audio's end."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    mu = mu_lo + (mu_hi - mu_lo) * torch.rand(
        (n_tracks, 1) + shape, generator=gen, device=dev)
    db = mu + sigma * torch.randn((n_tracks, t) + shape, generator=gen,
                                  device=dev)
    del mu
    nf = torch.randint(t // 2, t, (n_tracks,), generator=gen, device=dev)
    mask = torch.arange(t, device=dev)[None, :] < nf[:, None]
    m = mask.reshape(mask.shape + (1,) * len(shape))
    return db.masked_fill_(~m, PAD_VALUE), mask


def bench_lattice_prefiltered(
    device="cuda", n_tracks: int = 1_000_000, t: int = 128, k_seq: int = 32,
    rounds: int = 8,
) -> None:
    """The certified dialplan prefilter against the full scan at
    ``n_tracks``: uint8 bound scan (K-a) → top-256 (K-b,
    ``select_candidates``) → exact rescore (``rescore_rows``), batch-1
    device time of ``k_seq`` searches back to back. The corpus has wide
    per-frame dynamics (σ = 6 dB around a per-audio mean); queries are
    excerpts of stored audios. Where a query certifies, its
    prefiltered top-1 must equal the full scan's."""
    dev = resolve_device(device)
    db, mask = _clustered_db(dev, n_tracks, t, (), -40.0, 10.0, 6.0)
    _sync(dev)
    t0 = time.perf_counter()
    vm = ml.build_value_map(db, mask)
    vmq = ml.quantize_value_map(vm)
    _sync(dev)
    build_s = time.perf_counter() - t0
    del mask
    qf = min(56, t // 2 - 8)
    rows = [(i * 131 + 5) % n_tracks for i in range(8)]
    qs = torch.stack([db[r, 4 : 4 + qf] for r in rows] * (k_seq // 8))
    targets = rows * (k_seq // 8)
    del db
    ones1 = torch.ones((1, qf), dtype=torch.bool, device=dev)
    neg, pos = float("-inf"), float("inf")
    tol = 0.1

    def full(i):
        return ml.lattice_votes(vm, qs[i : i + 1], ones1, tol, neg, pos)

    def pre(i):
        return ml.lattice_prefiltered_votes(vm, vmq, qs[i : i + 1], ones1,
                                            tol, neg, pos)

    results = {}
    for name, fn in (("full", full), ("prefiltered", pre)):
        calls = [lambda i=i: fn(i) for i in range(k_seq)]
        seq_ms(calls, dev)
        results[name] = float(np.median(
            [seq_ms(calls, dev)[0] for _ in range(rounds)]))
    certs, wins = 0, 0
    for i in range(k_seq):
        votes, cert = pre(i)
        fb, fc = top1(full(i))
        pb, pc = top1(votes)
        wins += int(fb[0]) == targets[i]
        if bool(cert[0]):
            certs += 1
            if (int(pb[0]), int(pc[0])) != (int(fb[0]), int(fc[0])):
                raise AssertionError(
                    f"query {i}: certified prefiltered top-1 "
                    f"{int(pb[0])}/{int(pc[0])} != full scan "
                    f"{int(fb[0])}/{int(fc[0])}")
    speedup = results["full"] / max(results["prefiltered"], 1e-9)
    say(dev, f"dialplan PREFILTERED @ {n_tracks} tracks, query 0: "
        f"{kernel_split(lambda: pre(0), dev)}")
    say(dev, f"dialplan PREFILTERED @ {n_tracks} tracks (T={t}), batch 1 "
        f"DEVICE-TIME: p50={results['prefiltered']:.4f} ms/query vs "
        f"{results['full']:.4f} full scan ({speedup:.2f}x; {k_seq} searches "
        f"back to back; certificates {certs}/{k_seq}, each equal to the full "
        f"scan's top-1; the stored excerpt's audio wins the full scan "
        f"{wins}/{k_seq}; maps built in {build_s:.3f}s)")
    summary("lattice_prefiltered", pf_ms=results["prefiltered"],
            full_ms=results["full"], speedup=speedup,
            certs=f"{certs}/{k_seq}")


# ---- 11. aligned + 8 coefficients at scale ------------------------------ #

_ALIGNED_Q_IDS = (5, 71, 901, 4242, 17, 333, 2024, 6001,
                  9, 123, 777, 3141, 42, 271, 828, 1618)


def bench_aligned_scale(
    device="cuda", n_coefs: int = 8,
    configs=(("100k", 100_000, 1024, True, True),
             ("1m", 1_000_000, 128, False, True),
             ("long", 128, 131_072, True, False)),
    k_seq: int = 4, k_seq_pref: int = 16, rounds: int = 5,
) -> None:
    """Aligned votes over ``n_coefs`` coefficients at tol 0.1 (the
    recommended accuracy mode) at scale, batch-1 device time: the full K5
    scan and the certified prefilter (K-a bound → K-b selection → K-c
    rescore), on a clustered corpus (σ = 1.5 around per-audio means) with
    noisy stored excerpts as queries. Every query's own audio must win the
    full scan, and every certified prefiltered search."""
    dev = resolve_device(device)
    f = 3 * SR // DspConfig().hop_size
    for apfx, n_tracks, t, full_scan, prefilter in configs:
        if over_budget(f"aligned@{n_coefs}coefs {n_tracks}x{t} config"):
            continue
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        db, mask = _clustered_db(dev, n_tracks, t, (n_coefs,), -25.0, 20.0,
                                 1.5)
        _sync(dev)
        t0 = time.perf_counter()
        index = build_match_index(db)
        _sync(dev)
        index_s = time.perf_counter() - t0
        qf = min(f, t // 2 - 8)
        noise = np.random.default_rng(9).normal(0, 0.01, (qf, n_coefs))
        targets = [i % n_tracks for i in _ALIGNED_Q_IDS]
        qs = [prepare_query(
            (db[r, 8 : 8 + qf] + torch.from_numpy(noise).float().to(dev)
             )[None], None, trunc_coef1=False) for r in targets]

        def check(label, best, i):
            if int(best[0]) != targets[i]:
                raise AssertionError(
                    f"aligned {label} @ {n_tracks}: query {i} found row "
                    f"{int(best[0])}, not its own {targets[i]}")

        per_query = None
        if full_scan:
            def full(i):
                q, active, use2 = qs[i]
                return top1(match_kernels.match_votes_fused_aligned(
                    db, q, active, use2, 0.1, coefs=n_coefs, index=index))

            calls = [lambda i=i: full(i) for i in range(k_seq)]
            seq_ms(calls, dev)
            per_query = float(np.median(
                [seq_ms(calls, dev)[0] for _ in range(rounds)]))
            for i in range(k_seq):
                check("full scan", full(i)[0], i)
            say(dev, f"aligned@{n_coefs}coefs search @ {n_tracks} tracks "
                f"(T={t}), batch 1 DEVICE-TIME: p50={per_query:.4f} "
                f"ms/query ({k_seq} full K5 scans back to back; every "
                f"query's own audio wins; index built in {index_s:.3f}s)")
            summary("aligned_scale", **{f"{apfx}_full_ms": per_query})
        if not prefilter:
            del db, mask, index
            continue
        t0 = time.perf_counter()
        specs, maps = ml.build_bound_maps(db, mask, n_coefs)
        _sync(dev)
        maps_s = time.perf_counter() - t0

        def pref(i, ctx_ids=None, ctx_id=None):
            q, active, use2 = qs[i]
            votes, cert = match_kernels.aligned_prefiltered_votes(
                db, maps, q, active, use2, 0.1, specs=specs, coefs=n_coefs,
                ctx_ids=ctx_ids, ctx_id=ctx_id, index=index)
            return top1(votes)[0], cert

        def timed_pref(ctx_of):
            calls = [lambda i=i: pref(i, **ctx_of(i))
                     for i in range(k_seq_pref)]
            seq_ms(calls, dev)
            ms = float(np.median([seq_ms(calls, dev)[0]
                                  for _ in range(rounds)]))
            certs = 0
            for i in range(k_seq_pref):
                best, cert = pref(i, **ctx_of(i))
                if bool(cert[0]):
                    certs += 1
                    check("prefiltered", best, i)
            return ms, certs

        per_query_p, certs = timed_pref(lambda i: {})
        say(dev, f"aligned@{n_coefs}coefs PREFILTERED @ {n_tracks} tracks, "
            f"query 0: {kernel_split(lambda: pref(0), dev)}")
        speed = (f"{per_query / max(per_query_p, 1e-9):.2f}x vs full scan; "
                 if per_query is not None else "")
        say(dev, f"aligned@{n_coefs}coefs PREFILTERED @ {n_tracks} tracks "
            f"(T={t}), batch 1 DEVICE-TIME: p50={per_query_p:.4f} ms/query "
            f"({speed}{k_seq_pref} searches back to back; certificates "
            f"{certs}/{k_seq_pref}, each won by the query's own audio; "
            f"bound maps built in {maps_s:.3f}s)")
        summary("aligned_scale", **{f"{apfx}_pf_ms": per_query_p,
                                    f"{apfx}_certs": f"{certs}/{k_seq_pref}"})
        if apfx == configs[0][0]:
            # the reference's per-context mode: 16 round-robin contexts,
            # each query filtered to its own audio's context
            ctx = torch.arange(n_tracks, dtype=torch.int32, device=dev) % 16
            per_query_c, certs_c = timed_pref(
                lambda i: {"ctx_ids": ctx, "ctx_id": targets[i] % 16})
            say(dev, f"aligned@{n_coefs}coefs PREFILTERED CTX-FILTERED @ "
                f"{n_tracks} tracks (16 contexts), batch 1 DEVICE-TIME: "
                f"p50={per_query_c:.4f} ms/query (certificates "
                f"{certs_c}/{k_seq_pref}; in-context winners all correct)")
            summary("aligned_scale", ctx_ms=per_query_c, ctx_ok=True)
        del db, mask, index, maps


# ---- 3. the engine's dialplan search ------------------------------------ #


def bench_engine_search(device="cuda", n_tracks: int = 10_000,
                        reps: int = 20) -> None:
    """Full-stack search: ``Tiresias.search_pcm_batch`` at batch 1 and 64
    against ``n_tracks`` injected tracks (host batching, the engine's
    dispatch, one readback, the TIR* results)."""
    dev = resolve_device(device)
    eng = _engine(dev, "tir_bench_eng")
    _inject_uniform(eng, dev, n_tracks, 3, "h")
    q = synth_tone(440, 3.0, SR)
    eng.search_pcm("c", q, SR)  # views, maps, tables
    rtt = launch_floor_ms(dev)
    kw_sum: dict = {"rtt_ms": rtt}
    for batch in (1, 64):
        qs = [q] * batch
        eng.search_pcm_batch("c", qs, SR)
        fb0, q0 = _fallbacks(), metrics.counters["search.queries"]
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            eng.search_pcm_batch("c", qs, SR)
            times.append((time.perf_counter() - t0) * 1e3 / batch)
        p50 = float(np.percentile(times, 50))
        ovh = p50 - rtt / batch
        kw_sum[f"b{batch}_ms"] = p50
        kw_sum[f"b{batch}_ovh_ms"] = ovh
        say(dev, f"engine search @ {n_tracks} tracks, batch {batch}: "
            f"p50={p50:.4f} ms/query full-stack = launch+sync floor "
            f"{rtt / batch:.4f} + host and device {ovh:.4f} ms (rtt_ms is "
            f"the card's launch-and-sync floor, {rtt:.4f} ms; "
            f"{_fallbacks() - fb0} certificate fallbacks over "
            f"{reps} searches of "
            f"{int(metrics.counters['search.queries'] - q0) // reps} "
            "queries)")
    summary("engine_search", **kw_sum)
    eng.close()


# ---- 5. the strict configuration at 100,000 tracks ---------------------- #


def bench_device_rank(device="cuda", n_tracks: int = 100_000,
                      reps: int = 20, k_seq: int = 16) -> None:
    """The strict configuration (coefs=2, no truncation, tol 0.01, bag
    votes) at ``n_tracks`` clustered tracks plus a stored speech-like
    target: the engine's one strict route (certified bag prefilter — K-a,
    K-b, K-c — and the K4 full scan on a miss), batch-1 p50
    and device time, and the gates-closed full scan. The target must
    win."""
    dev = resolve_device(device)
    eng = _engine(dev, "tir_bench_rank")
    eng.create_context("c")
    rng = np.random.default_rng(5)
    mu = rng.uniform(-25, 20, (n_tracks, 1, 2)).astype(np.float32)
    fps = (mu + 0.5 * rng.standard_normal((n_tracks, 128, 2))).astype(
        np.float32)
    t0 = time.perf_counter()
    for i in range(n_tracks):
        eng.store.add_audio(f"t{i}", "c", fps[i], f"r{i:08d}")
    say(dev, f"device-rank: injected {n_tracks} clustered tracks through "
        f"store.add_audio in {time.perf_counter() - t0:.3f}s (host loop)")
    del fps, mu
    q = _speechlike_batch(rng, 1, 3.0, SR)[0]
    eng.add_audio_pcm("c", "target", q, SR)
    kw = dict(coefs=2, tolerance=0.01, trunc_coef1=False)
    rtt = launch_floor_ms(dev)
    kw_sum: dict = {"rtt_ms": rtt}

    def p50(label, key):
        r = eng.search_pcm("c", q, SR, **kw)
        if not (r.found and r.name == "target"):
            raise AssertionError(f"device-rank {label}: {r.status} {r.name}")
        fb0 = _fallbacks()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            r = eng.search_pcm("c", q, SR, **kw)
            times.append((time.perf_counter() - t0) * 1e3)
            if r.name != "target":
                raise AssertionError(f"device-rank {label}: {r.name}")
        p = float(np.percentile(times, 50))
        kw_sum[key] = p
        say(dev, f"device-rank strict@2 @ {n_tracks} tracks, {label}: "
            f"p50={p:.4f} ms/query full-stack = launch+sync floor "
            f"{rtt:.4f} + host and device {p - rtt:.4f} ms "
            f"({_fallbacks() - fb0}/{reps} certificate fallbacks; the "
            "target wins every search)")
        return p

    p50("the engine's strict route (certified bag prefilter, full scan "
        "on a miss)", "fused_ms")
    kw_sum["fused_ovh_ms"] = kw_sum["fused_ms"] - rtt

    # device time of the prefiltered chain, k_seq searches back to back
    store = eng.store
    view = max(store.search_views(), key=lambda v: v.n_audios)
    specs, maps = store.bound_maps_for(view, 2)
    index = store.match_index_for(view)
    dsp = eng.config.dsp
    padded, n_frames = pad_frames_bucket([q], dsp.hop_size)
    pcm = torch.from_numpy(padded).to(dev)

    def search():
        qfp = fingerprint_padded_batch(pcm, SR, dsp, device=dev)
        qq, active, use2 = prepare_query(qfp, n_frames, trunc_coef1=False)
        votes, cert = match_kernels.aligned_prefiltered_votes(
            view.db, maps, qq, active, use2, 0.01, specs=specs, coefs=2,
            aligned=False, index=index)
        return top1(votes)[0], cert

    outs = [search() for _ in range(k_seq)]
    certs = sum(int(c[0]) for _, c in outs)
    dev_ms, wall_ms = seq_ms([search] * k_seq, dev)
    say(dev, f"device-rank strict@2 @ {n_tracks} tracks: "
        f"{kernel_split(search, dev)}")
    kw_sum["dev_ms"] = dev_ms
    say(dev, f"device-rank strict@2 @ {n_tracks} tracks, batch 1 "
        f"DEVICE-TIME: p50={dev_ms:.4f} ms/query ({k_seq} prefiltered "
        f"searches back to back: fingerprint, bound, top-k, candidate "
        f"rescore; certificates {certs}/{k_seq}; wall {wall_ms:.4f} "
        "ms/query)")
    # the full scan with every gate closed
    saved = eng._pf_allowed
    eng._pf_allowed = lambda view, mode: False
    try:
        p50("gates closed (K4 full scan)", "full_ms")
    finally:
        eng._pf_allowed = saved
    summary("device_rank", **kw_sum)
    eng.close()


# ---- 8. the TCP server -------------------------------------------------- #


def bench_server_latency(device="cuda", n_tracks: int = 10_000,
                         n_clients: int = 64, rounds: int = 8) -> None:
    """Concurrent batch-1 recognitions through the TCP protocol: each of
    ``n_clients`` client threads (in the server's process, as the JAX
    section runs them) opens a channel, sends one 3 s window and waits for
    its result, ``rounds`` times; a burst, then paced at ~2 requests/s per
    client."""
    import asyncio

    from tiresias_tpu_torch.serve.server import (
        RecognitionServer,
        warmup_batch_sizes,
    )

    dev = resolve_device(device)
    eng = _engine(dev, "tir_bench_srv")
    _inject_uniform(eng, dev, n_tracks, 5, "h")
    rng = np.random.default_rng(5)
    for b in warmup_batch_sizes(n_clients):
        eng.warmup(samplerate=SR, batch_sizes=(b,))
    holder: dict = {}
    started = threading.Event()

    def runner():
        async def amain():
            srv = RecognitionServer(eng, port=0, samplerate=SR)
            await srv.start()
            holder["server"] = srv
            holder["loop"] = asyncio.get_running_loop()
            started.set()
            try:
                await srv.serve_forever()
            except asyncio.CancelledError:
                pass

        asyncio.run(amain())

    threading.Thread(target=runner, daemon=True).start()
    if not started.wait(60):
        raise RuntimeError("the server did not start within 60 s")
    port = holder["server"].port
    rtt_dev = launch_floor_ms(dev)
    with socket.create_connection(("127.0.0.1", port), timeout=30) as es:
        ef = es.makefile("rw", encoding="utf-8", newline="\n")
        tcp_ts = []
        for _ in range(20):
            t0 = time.perf_counter()
            ef.write(json.dumps({"op": "echo"}) + "\n")
            ef.flush()
            ef.readline()
            tcp_ts.append((time.perf_counter() - t0) * 1e3)
    rtt_tcp = float(np.percentile(tcp_ts, 50))
    say(dev, f"server latency floors (same run): launch+sync p50="
        f"{rtt_dev:.4f} ms, TCP loopback echo p50={rtt_tcp:.4f} ms")
    window = np.clip(np.round(0.3 * rng.standard_normal(3 * SR) * 32768.0),
                     -32768, 32767).astype("<i2")
    payload = base64.b64encode(window.tobytes()).decode()
    lat_lock = threading.Lock()
    latencies: list[float] = []
    errors: list[str] = []

    def client(ci: int, pace_s: float = 0.0):
        pace_rng = np.random.default_rng(1000 + ci)
        try:
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=120) as s:
                f = s.makefile("rw", encoding="utf-8", newline="\n")
                if pace_s:
                    time.sleep(float(pace_rng.uniform(0, pace_s)))
                for r in range(rounds):
                    ch = f"c{ci}r{r}"
                    f.write(json.dumps({"op": "open", "channel": ch,
                                        "context": "c",
                                        "duration_ms": 3000}) + "\n")
                    f.flush()
                    if not json.loads(f.readline()).get("opened"):
                        raise RuntimeError(f"{ch} did not open")
                    f.write(json.dumps({"op": "pcm", "channel": ch,
                                        "pcm": payload}) + "\n")
                    f.flush()
                    t0 = time.perf_counter()
                    reply = json.loads(f.readline())
                    dt = (time.perf_counter() - t0) * 1e3
                    if "result" not in reply:
                        raise RuntimeError(f"{ch}: {reply}")
                    with lat_lock:
                        latencies.append(dt)
                    if pace_s:
                        time.sleep(float(pace_rng.uniform(0.5, 1.5)) * pace_s)
        except Exception as exc:  # noqa: BLE001 - reported after the join
            with lat_lock:
                errors.append(f"client {ci}: {exc!r}")

    def run_phase(pace_s: float):
        latencies.clear()
        threads = [threading.Thread(target=client, args=(i, pace_s),
                                    daemon=True) for i in range(n_clients)]
        t_all0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        busy = time.perf_counter() - t_all0
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"server clients failed: {errors[:3]}")
        return busy, list(latencies)

    try:
        busy, lats = run_phase(0.0)
        total = n_clients * rounds
        say(dev, f"server batch-1 @ {n_tracks} tracks: {total} recognitions "
            f"over {n_clients} concurrent TCP clients (burst; client threads "
            f"in the server's process); completion p50="
            f"{np.percentile(lats, 50):.3f} ms p90="
            f"{np.percentile(lats, 90):.3f} ms; steady-state "
            f"{busy / total * 1e3:.4f} ms/query ({total / busy:.1f} qps)")
        summary("server", rtt_ms=rtt_dev, tcp_ms=rtt_tcp,
                burst_p50_ms=float(np.percentile(lats, 50)),
                ss_ms=busy / total * 1e3, qps=round(total / busy))
        busy, lats = run_phase(0.5)
        paced = float(np.percentile(lats, 50))
        say(dev, f"server batch-1 @ {n_tracks} tracks PACED (~{2 * n_clients}"
            f" rps offered): completion p50={paced:.3f} ms p90="
            f"{np.percentile(lats, 90):.3f} ms = launch+sync floor "
            f"{rtt_dev:.4f} + residual {paced - rtt_dev:.3f} ms (scorer "
            f"tick, batching, attribution, {rtt_tcp:.4f} ms TCP loopback)")
        summary("server", paced_p50_ms=paced,
                resid_ms=paced - rtt_dev)
    finally:
        asyncio.run_coroutine_threadsafe(
            holder["server"].stop(), holder["loop"]).result(timeout=30)
        eng.close()


# ---- 6. catalog build from files ---------------------------------------- #


def bench_db_build(device="cuda", n_clips: int = 1000, n_warm: int = 512,
                   trials: int = 5) -> None:
    """BASELINE config #2: wall time of a cold ``Tiresias.sync()`` over
    ``n_clips`` 3 s WAVs (decode, hash, fingerprint, store, checkpoint),
    median of ``trials`` fresh engines, after a warm sync of ``n_warm``
    clips of the same length; the floor of the PCM's host-to-device bytes
    at the pinned link rate (from ``hostfeed``, else probed here)."""
    dev = resolve_device(device)
    link = float(os.environ.get("TIRESIAS_BENCH_LINK_MBS", "0") or 0)
    if not link:
        link = link_mibs(dev, pinned=True)
        mark(f"db build: pinned link probe {link:.1f} MiB/s")
    directory = tempfile.mkdtemp(prefix="tir_bench_corpus")
    dirs = [directory]
    try:
        rng = np.random.default_rng(2)
        for i in range(n_clips):
            pcm = synth_chirp(
                150 + (i % 211) * 9.7, 800 + (i % 113) * 21.3, 3.0, SR
            ) + 0.01 * rng.standard_normal(3 * SR).astype(np.float32)
            write_wav(f"{directory}/clip{i:05d}.wav", pcm, SR)
        warm_dir = tempfile.mkdtemp(prefix="tir_bench_warm")
        dirs.append(warm_dir)
        for i in range(n_warm):
            write_wav(f"{warm_dir}/w{i:03d}.wav",
                      synth_chirp(100 + 3.1 * i, 500 + 7.3 * i, 3.0, SR), SR)
        warm = _engine(dev, "tir_bench_warmdata",
                       contexts=(ContextConfig("warm", warm_dir),))
        dirs.append(warm.config.data_dir)
        warm.sync()
        warm.close()
        trials_out = []
        for _ in range(trials):
            e = _engine(dev, "tir_bench_data",
                        contexts=(ContextConfig("bench", directory),))
            dirs.append(e.config.data_dir)
            t0 = time.perf_counter()
            rep = e.sync()
            _sync(dev)
            trials_out.append((time.perf_counter() - t0, rep))
            e.close()
        timed = sorted(trials_out, key=lambda x: x[0])
        elapsed, report = timed[len(timed) // 2]
        best, best_report = timed[0]
        if report.created != n_clips:
            raise AssertionError(f"db build created {report.created} of "
                                 f"{n_clips} clips")
        h2d_mib = report.created * 3.0 * SR * 2 / 2**20
        floor_s = h2d_mib / link
        say(dev, f"db build: {report.created} clips x 3 s ingested in "
            f"{elapsed:.4f}s -> {report.created / elapsed:.1f} clips/s "
            f"({report.created * 3.0 / elapsed:.1f} audio-hrs/hr end-to-end "
            f"incl. host decode + hash; median of {trials} cold syncs after "
            f"a warm one; best {best:.4f}s = "
            f"{best_report.created * 3.0 / best:.1f} audio-hrs/hr; spread "
            f"{timed[0][0]:.4f}-{timed[-1][0]:.4f}s; {h2d_mib:.1f} MiB of "
            f"PCM over the {link:.1f} MiB/s pinned link: floor "
            f"{floor_s:.4f}s, best trial at {100 * floor_s / best:.2f}% of "
            "link speed)")
        summary("db_build", hrs_hr=round(report.created * 3.0 / elapsed),
                best_hrs_hr=round(best_report.created * 3.0 / best),
                link_pct=100 * floor_s / best,
                link_mbs=round(link, 1))
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)


# ---- 9. the streaming scorer -------------------------------------------- #


def bench_streams(device="cuda", n_streams: int = 128,
                  scale_streams: int = 1024, n_tones: int = 64) -> None:
    """BASELINE configs #3/#5: concurrent 8 kHz channels through
    ``StreamingRecognizer`` (int16 wire, then G.711 µ-law at the scale
    width), pushed in 20 ms frames as fast as the scorer takes them: the
    aggregate real-time factor, and how many channels found their own
    tone."""
    from tiresias_tpu_torch.serve import StreamingRecognizer

    dev = resolve_device(device)
    eng = _engine(dev, "tir_bench_streams",
                  contexts=(ContextConfig("s", "/nonexistent"),))
    for i in range(n_tones):
        eng.add_audio_pcm("s", f"tone{i}", synth_tone(200 + 30 * i, 3.0, SR),
                          SR)

    def run(n: int, law: str | None = None) -> tuple[int, float]:
        rec = StreamingRecognizer(eng, samplerate=SR)
        streams = [float_to_i16(synth_tone(200 + 30 * (i % n_tones), 3.2, SR))
                   for i in range(n)]
        if law is not None:
            streams = [encode(p, law) for p in streams]
        for i in range(n):
            rec.open(f"warm{i}", context="s", duration_ms=3000, law=law)
            rec.push(f"warm{i}", streams[i][: 3 * SR])
        rec.process_ready()
        for i in range(n):
            rec.open(f"ch{i}", context="s", duration_ms=3000, law=law)
        frame = SR // 50
        results: dict = {}
        t0 = time.perf_counter()
        offset = 0
        while offset < int(3.2 * SR) and len(results) < n:
            for i in range(n):
                rec.push(f"ch{i}", streams[i][offset : offset + frame])
            offset += frame
            results.update(rec.process_ready())
        elapsed = time.perf_counter() - t0
        own = sum(r.name == f"tone{int(c[2:]) % n_tones}"
                  for c, r in results.items())
        return len(results), elapsed, own

    done, elapsed, own = run(n_streams)
    audio_s = n_streams * 3.0
    say(dev, f"streams: {done}/{n_streams} channels x 3 s (int16 wire) "
        f"scored in {elapsed:.4f}s -> {audio_s / elapsed:.1f}x real-time "
        f"aggregate ({audio_s / elapsed / n_streams:.2f}x per channel; "
        f"{own} found their own tone in the dialplan parity mode, which "
        "rarely self-matches: PARITY.md section 5)")
    summary("streams", x128=round(audio_s / elapsed, 1),
            x128_per_ch=audio_s / elapsed / n_streams)
    if scale_streams > n_streams:
        audio_s = scale_streams * 3.0
        for law, key in ((None, "x1024"), ("ulaw", "x1024_ulaw")):
            if law and over_budget("streams SCALE ulaw"):
                return
            done, elapsed, own = run(scale_streams, law)
            say(dev, f"streams SCALE{' ' + law if law else ''}: "
                f"{done}/{scale_streams} channels x 3 s "
                f"({'G.711 wire, uint8 H2D' if law else 'int16 wire'}) in "
                f"{elapsed:.4f}s -> {audio_s / elapsed:.1f}x real-time "
                f"aggregate ({audio_s / elapsed / scale_streams:.2f}x per "
                f"channel; {own} found their own tone)")
            summary("streams", **{key: round(audio_s / elapsed, 1)})
    eng.close()


# ---- 12-13. accuracy at scale ------------------------------------------- #


def _speechlike_batch(rng: np.random.Generator, n_clips: int, seconds: float,
                      sr: int = SR) -> np.ndarray:
    """``[n_clips, n]`` individually identifiable harmonic-stack clips
    (``tools/accuracy_study.py``'s ``speechlike`` across the clip axis)."""
    n = int(seconds * sr)
    n -= n % 256
    t = np.arange(n, dtype=np.float32)[None, :] / sr
    f0 = rng.uniform(90, 220, (n_clips, 1)).astype(np.float32)
    vib = 1.0 + 0.03 * np.sin(
        2 * np.pi * rng.uniform(3, 7, (n_clips, 1)).astype(np.float32) * t)
    out = np.zeros((n_clips, n), np.float32)
    for h in range(1, 9):
        amp = (rng.uniform(0.2, 1.0, (n_clips, 1)) / h).astype(np.float32)
        mod = 1.0 + 0.5 * np.sin(
            2 * np.pi * rng.uniform(0.5, 3.0, (n_clips, 1)).astype(np.float32)
            * t + rng.uniform(0, 6.28, (n_clips, 1)).astype(np.float32))
        out += amp * mod * np.sin(2 * np.pi * f0 * h * vib * t)
    out += 0.02 * rng.standard_normal((n_clips, n)).astype(np.float32)
    out *= 0.3 / np.maximum(1e-9, np.abs(out).max(axis=1, keepdims=True))
    return out.astype(np.float32)


def _corpus_noise(batch_no: int, shape: tuple, device) -> torch.Tensor:
    """The corpus batch's unit normal noise, from a generator seeded per
    batch on the card."""
    gen = torch.Generator(device=device).manual_seed(1000 + batch_no)
    return torch.randn(shape, generator=gen, device=device)


def _build_synth_corpus(
    eng, dsp, n_tracks: int, n_queries: int, rng, sr: int = SR,
    clip_s: float = 2.0, tag: str = "acc", budget_label: str | None = None,
):
    """Speech-like harmonic-stack clips synthesized and fingerprinted on
    the card in [512, n] batches and injected into context "c"; the query
    targets' PCM is read back. Returns ``(n_tracks built, targets,
    kept {index: pcm})``; with ``budget_label`` the build stops early past
    the soft budget."""
    dev = eng.device
    bs = 512
    n_clip = int(clip_s * sr)
    n_clip -= n_clip % 256
    t = torch.arange(n_clip, dtype=torch.float32, device=dev)[None, None] / sr
    h = torch.arange(1, 9, dtype=torch.float32, device=dev)[None, :, None]

    def synth_batch(params, batch_no):
        f0, vibf, amp, modf, phase = params
        vib = 1.0 + 0.03 * torch.sin(2 * np.pi * vibf[:, None, :] * t)
        mod = 1.0 + 0.5 * torch.sin(2 * np.pi * modf * t + phase)
        out = (amp * mod * torch.sin(2 * np.pi * f0[:, None, :] * h * vib
                                     * t)).sum(dim=1)
        out += 0.02 * _corpus_noise(batch_no, tuple(out.shape), dev)
        out *= 0.3 / torch.clamp(out.abs().amax(dim=1, keepdim=True),
                                 min=1e-9)
        i16 = torch.clamp(torch.round(out * 32768.0), -32768, 32767).to(
            torch.int16)
        return i16, fingerprint_padded_batch(i16, sr, dsp, device=dev)

    def draw_params(nb):
        def f32(x):
            return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

        return (
            f32(rng.uniform(90, 220, (nb, 1))),
            f32(rng.uniform(3, 7, (nb, 1))),
            f32(rng.uniform(0.2, 1.0, (nb, 8, 1))
                / np.arange(1, 9)[None, :, None]),
            f32(rng.uniform(0.5, 3.0, (nb, 8, 1))),
            f32(rng.uniform(0, 6.28, (nb, 8, 1))),
        )

    kept: dict[int, np.ndarray] = {}
    targets = list(range(0, n_tracks, max(1, n_tracks // n_queries)))
    targets = targets[:n_queries]
    tset = set(targets)
    done = 0
    batch_no = 0
    while done < n_tracks:
        if budget_label and over_budget(budget_label):
            mark(f"{budget_label}: stopping corpus at {done} tracks")
            n_tracks = done
            targets = [i for i in targets if i < done]
            break
        nb = min(bs, n_tracks - done)
        i16, fps = synth_batch(draw_params(nb), batch_no)
        batch_no += 1
        fps = fps.cpu().numpy()
        rows = [j for j in range(nb) if done + j in tset]
        if rows:
            pcm_rows = i16[torch.tensor(rows, device=dev)].cpu().numpy()
            for j, pr in zip(rows, pcm_rows):
                kept[done + j] = pr.astype(np.float32) / 32768.0
        for j in range(nb):
            eng.store.add_audio(f"clip{done + j}", "c", fps[j],
                                f"{tag}{done + j:08d}")
        done += nb
    return n_tracks, targets, kept


def _corpus_queries(kept, targets, rng, sr=SR, clip_s=2.0, query_s=1.5):
    """Frame-aligned excerpt queries and their truth names."""
    qn = int(query_s * sr)
    qn -= qn % 256
    excerpts, truth = [], []
    for i in targets:
        off = int(rng.integers(0, int((clip_s - query_s) * sr)))
        off -= off % 256
        excerpts.append(kept[i][off : off + qn])
        truth.append(f"clip{i}")
    return excerpts, truth


def _noise_at(rng, pcm, snr_db):
    sig = float((pcm**2).mean())
    noise = rng.standard_normal(len(pcm)).astype(np.float32)
    noise *= np.sqrt(sig / (10 ** (snr_db / 10)) / float((noise**2).mean()))
    return (pcm + noise).astype(np.float32)


def bench_accuracy(device="cuda", n_tracks: int = 10_240,
                   n_queries: int = 100, n_impostors: int = 50) -> None:
    """Top-1 and false accepts against ``n_tracks`` distractors for the
    dialplan semantics and for aligned + 8 coefficients at tol 0.1, with the
    prefilters on; clean, 20 dB SNR and G.711 µ-law queries, and impostor
    clips that are not stored (a false accept is an impostor FOUND at
    confidence > 0.5). The prefilter on and off must give the same result
    for every clean query."""
    dev = resolve_device(device)
    clip_s, query_s = 2.0, 1.5
    rng = np.random.default_rng(99)
    dsp = DspConfig(n_coefs=8)  # store 8; dialplan searches coef 1
    eng = _engine(dev, "tir_acc", dsp=dsp)
    eng.create_context("c")
    mark(f"accuracy: synthesizing + fingerprinting {n_tracks} tracks")
    n_tracks, targets, kept = _build_synth_corpus(
        eng, dsp, n_tracks, n_queries, rng, SR, clip_s, tag="acc")
    excerpts, truth = _corpus_queries(kept, targets, rng, SR, clip_s,
                                      query_s)
    noisy = [_noise_at(rng, q, 20.0) for q in excerpts]
    impostors = list(_speechlike_batch(rng, n_impostors, query_s, SR))
    wire = [encode(float_to_i16(q), "ulaw") for q in excerpts]
    fb0 = _fallbacks()

    def run(queries, expect, wire_law=None, pf=True, **kw):
        if not pf:  # every gate closed: the engine full-scans
            saved = eng._pf_allowed
            eng._pf_allowed = lambda view, mode: False
        try:
            res = eng.search_pcm_batch("c", queries, SR, wire_law=wire_law,
                                       **kw)
        finally:
            if not pf:
                eng._pf_allowed = saved
        if expect is None:
            hits = (sum(r.found and r.confidence > 0.5 for r in res),
                    sum(r.found and r.confidence > 0.9 for r in res))
        else:
            hits = sum(r.found and r.name == want
                       for r, want in zip(res, expect))
        return hits, [(r.name, r.match_count) for r in res]

    for label, pre, kw in (
        ("dialplan parity semantics (coefs=1, trunc, tol 0.001)", "dp", {}),
        ("aligned@8 tol 0.1 (recommended)", "al8",
         dict(coefs=8, tolerance=0.1, trunc_coef1=False, aligned=True)),
    ):
        ex, ex_det = run(excerpts, truth, **kw)
        nz, _ = run(noisy, truth, **kw)
        g7, _ = run(wire, truth, wire_law="ulaw", **kw)
        fa, _ = run(impostors, None, **kw)
        _, ex_det_off = run(excerpts, truth, pf=False, **kw)
        same = ex_det == ex_det_off
        say(dev, f"accuracy @ {n_tracks} distractors, {label}: top-1 clean "
            f"{ex}/{len(excerpts)}, noisy20dB {nz}/{len(noisy)}, G.711 wire "
            f"{g7}/{len(wire)}; false-accepts {fa[0]}/{n_impostors} "
            f"@conf>0.5 ({fa[1]} @conf>0.9); prefilter ON==OFF "
            f"{'yes' if same else 'NO — MISMATCH'}")
        summary("accuracy", n=n_tracks,
                **{f"{pre}_clean": f"{ex}/{len(excerpts)}",
                   f"{pre}_noisy": f"{nz}/{len(noisy)}",
                   f"{pre}_g711": f"{g7}/{len(wire)}",
                   f"{pre}_fa": f"{fa[0]}/{n_impostors}",
                   f"{pre}_pf_eq": bool(same)})
        if not same:
            raise AssertionError(f"accuracy {label}: prefilter ON != OFF")
    if not over_budget("accuracy tol-0.3 noise point"):
        kw3 = dict(coefs=8, tolerance=0.3, trunc_coef1=False, aligned=True)
        nz3, _ = run(noisy, truth, **kw3)
        fa3, _ = run(impostors, None, **kw3)
        say(dev, f"accuracy @ {n_tracks} distractors, aligned@8 tol 0.3 "
            f"(noise operating point): noisy20dB {nz3}/{len(noisy)}; "
            f"false-accepts {fa3[0]}/{n_impostors} @conf>0.5 ({fa3[1]} "
            "@conf>0.9)")
        summary("accuracy", tol03_noisy=f"{nz3}/{len(noisy)}",
                tol03_fa=f"{fa3[0]}/{n_impostors}")
    fallbacks = _fallbacks() - fb0
    say(dev, f"accuracy: prefilter certificate fallbacks this section: "
        f"{fallbacks} (0 = every prefiltered query certified exact)")
    summary("accuracy", pf_fallbacks=fallbacks)
    eng.close()


def bench_accuracy_scale(device="cuda", n_tracks: int = 102_400,
                         n_queries: int = 100, n_impostors: int = 50) -> None:
    """The noise operating point at ``n_tracks`` distractors: fingerprints
    in the noise-weighted space (``NOISE20_COEF_WEIGHTS``), aligned + 8
    coefficients at tol 0.2 with ``min_margin`` 0.1; noisy 20 dB and clean
    recall, and impostors that pass the margin gate."""
    dev = resolve_device(device)
    clip_s, query_s = 2.0, 1.5
    rng = np.random.default_rng(99)
    dsp = DspConfig(n_coefs=8, coef_weights=NOISE20_COEF_WEIGHTS)
    eng = _engine(dev, "tir_as", dsp=dsp)
    eng.create_context("c")
    mark(f"accuracy-scale: synthesizing + fingerprinting {n_tracks} tracks")
    t0 = time.perf_counter()
    n_tracks, targets, kept = _build_synth_corpus(
        eng, dsp, n_tracks, n_queries, rng, SR, clip_s, tag="as",
        budget_label="accuracy-scale corpus build")
    build_s = time.perf_counter() - t0
    excerpts, truth = _corpus_queries(kept, targets, rng, SR, clip_s,
                                      query_s)
    noisy = [_noise_at(rng, q, 20.0) for q in excerpts]
    impostors = list(_speechlike_batch(rng, n_impostors, query_s, SR))
    kw = dict(coefs=8, tolerance=0.2, trunc_coef1=False, aligned=True,
              min_margin=0.1)
    res_n = eng.search_pcm_batch("c", noisy, SR, **kw)
    rec_n = sum(r.found and r.name == w for r, w in zip(res_n, truth))
    res_i = eng.search_pcm_batch("c", impostors, SR, **kw)
    fa = sum(r.found for r in res_i)
    res_c = eng.search_pcm_batch("c", excerpts, SR, **kw)
    rec_c = sum(r.found and r.name == w for r, w in zip(res_c, truth))
    say(dev, f"accuracy-scale @ {n_tracks} distractors, NOISE OPERATING "
        f"POINT (coef_weights=noise20, aligned@8 tol 0.2, min_margin 0.1): "
        f"noisy20dB {rec_n}/{len(noisy)}, clean {rec_c}/{len(excerpts)}, "
        f"margin-passed false-accepts {fa}/{n_impostors} (corpus "
        f"synthesized, fingerprinted and injected in {build_s:.3f}s)")
    summary("accuracy_scale", n=n_tracks, noisy=f"{rec_n}/{len(noisy)}",
            clean=f"{rec_c}/{len(excerpts)}", fa=f"{fa}/{n_impostors}")
    eng.close()


# ---- 14. the prefilter's worst case ------------------------------------- #


def _fallback_base(device, t: int) -> tuple[np.ndarray, np.ndarray]:
    """(raw, coef-0-truncated) ``[t, 2]``: the 440 Hz query tone's own
    fingerprint tiled to ``t`` frames."""
    q = synth_tone(440, 3.0, SR)
    qn = len(q) - len(q) % 256
    qfp = fingerprint_padded_batch(q[None, :qn], SR, DspConfig(),
                                   device=device)[0].cpu().numpy()
    reps = int(np.ceil(t / qfp.shape[0]))
    raw = np.tile(qfp, (reps, 1))[:t].astype(np.float32)
    trunc = raw.copy()
    trunc[:, 0] = np.trunc(trunc[:, 0])
    return raw, trunc


def bench_prefilter_fallback(device="cuda", n_tracks: int = 100_000,
                             t: int = 128, n_timed: int = 12) -> None:
    """The prefilter's worst case: every track is the query's own
    fingerprint plus noise far below the tolerance, so every track ties
    and no certificate can hold. Per-query latency while the certificate
    misses (bound scan, miss, full scan), the adaptive gate closing after 8
    misses, then the gated steady state (full scan only); dialplan, then
    aligned@2 tol 0.1."""
    dev = resolve_device(device)
    rng = np.random.default_rng(13)
    q = synth_tone(440, 3.0, SR)
    base_raw, base_trunc = _fallback_base(dev, t)
    noise = rng.uniform(-1e-5, 1e-5, (n_tracks, t, 2)).astype(np.float32)
    for label, pre, base, kw in (
        ("dialplan", "dp", base_trunc, {}),
        ("aligned@2 tol 0.1", "al2", base_raw,
         dict(coefs=2, tolerance=0.1, trunc_coef1=False, aligned=True)),
    ):
        eng = _engine(dev, "tir_tie")
        eng.create_context("c")
        t0 = time.perf_counter()
        for i in range(n_tracks):
            eng.store.add_audio(f"t{i}", "c", base + noise[i], f"tie{i:08d}")
        mark(f"prefilter fallback: {n_tracks} near-duplicate tracks "
             f"({label}) injected in {time.perf_counter() - t0:.3f}s")
        eng.search_pcm("c", q, SR, **kw)  # views, maps, first miss
        # a mutation gives a new view gen, which re-arms the gate
        eng.store.add_audio("rearm", "c", base, "rearm000")
        eng.search_pcm("c", q, SR, **kw)
        times, fbs = [], []
        fb0 = _fallbacks()
        for _ in range(n_timed):
            t0 = time.perf_counter()
            r = eng.search_pcm("c", q, SR, **kw)
            times.append((time.perf_counter() - t0) * 1e3)
            fbs.append(_fallbacks() - fb0)
        if not r.found:
            raise AssertionError("tie corpus must match (every track votes)")
        if not max(fbs):
            say(dev, f"prefilter fallback-regime @ {n_tracks} tie-heavy "
                f"tracks, {label}: prefilter not exercised (0 certificate "
                f"misses recorded); plain search "
                f"p50={np.percentile(times, 50):.4f} ms/query")
            summary("fallback_regime",
                    **{f"{pre}_ms": float(np.percentile(times, 50)),
                       f"{pre}_note": "pf_not_exercised"})
            eng.close()
            continue
        close_i = fbs.index(max(fbs))
        miss = times[: close_i + 1] or times[:1]
        gated = times[close_i + 1 :] or times[-1:]
        say(dev, f"prefilter fallback-regime @ {n_tracks} tie-heavy tracks, "
            f"{label}: miss-phase p50={np.percentile(miss, 50):.4f} ms/query "
            f"(bound scan + certificate miss + full-scan fallback; "
            f"{fbs[-1]} misses -> adaptive gate closed after query "
            f"{close_i + 1}), gated steady-state "
            f"p50={np.percentile(gated, 50):.4f} ms/query (full scan only; "
            "a store mutation re-arms)")
        summary("fallback_regime",
                **{f"{pre}_miss_ms": float(np.percentile(miss, 50)),
                   f"{pre}_gated_ms": float(np.percentile(gated, 50))})
        eng.close()


# ---- 15. cold start ----------------------------------------------------- #

_COLD_CODE = (
    "import sys, tempfile, time, numpy as np\n"
    "from tiresias_tpu_torch.api import Tiresias\n"
    "from tiresias_tpu_torch.config import TiresiasConfig\n"
    "from tiresias_tpu_torch.serve.server import warmup_batch_sizes\n"
    "t0 = time.perf_counter()\n"
    "eng = Tiresias(TiresiasConfig(data_dir=tempfile.mkdtemp()),"
    " restore=False, device=sys.argv[1])\n"
    "eng.create_context('c')\n"
    "rng = np.random.default_rng(7)\n"
    "for i in range(int(sys.argv[2])):\n"
    "    eng.store.add_audio(f't{i}', 'c',"
    " rng.uniform(-30, 25, (128, 2)).astype(np.float32), f'c{i:08d}')\n"
    "t0 = time.perf_counter()\n"
    "t = eng.warmup_async(samplerate=8000,"
    " batch_sizes=warmup_batch_sizes(int(sys.argv[3])), laws=('ulaw',))\n"
    "print(f'COLD_READY_S={time.perf_counter() - t0:.3f}', flush=True)\n"
    "t.join()\n"
    "print(f'COLD_WARMUP_S={time.perf_counter() - t0:.3f}', flush=True)\n"
    "eng.close()\n"
)


def bench_coldstart(device="cuda", n_tracks: int = 256,
                    channels: int = 128) -> None:
    """Serving start-up: a 128-channel serving config's readiness-tiered
    warm-up (kernel library, maps and the int16 search, then float32 and
    G.711 in the background) with the kernel build directory present; then
    the same warm-up in a fresh process whose ``TIRESIAS_KERNEL_DIR`` is an
    empty directory, so it pays the ``nvcc`` build (a first deployment)."""
    from tiresias_tpu_torch.serve.server import warmup_batch_sizes

    dev = resolve_device(device)
    eng = _engine(dev, "tir_bench_cold")
    eng.create_context("c")
    rng = np.random.default_rng(7)
    for i in range(n_tracks):
        eng.store.add_audio(f"t{i}", "c", rng.uniform(
            -30, 25, (128, 2)).astype(np.float32), f"c{i:08d}")
    sizes = warmup_batch_sizes(channels)
    t0 = time.perf_counter()
    th = eng.warmup_async(samplerate=SR, batch_sizes=sizes, laws=("ulaw",))
    ready_s = time.perf_counter() - t0
    th.join()
    full_s = time.perf_counter() - t0
    say(dev, f"coldstart: serving config ({channels} channels -> batch "
        f"sizes {sizes} x [int16, f32, ulaw] silent searches + maps): READY "
        f"in {ready_s:.4f}s (kernel library, maps, int16 searches), fully "
        f"warm in {full_s:.4f}s; the kernel build directory present")
    summary("coldstart", ready_s=ready_s, warm_s=full_s)
    eng.close()
    if over_budget("coldstart cold-build run"):
        return
    kdir = tempfile.mkdtemp(prefix="tir_cold_kernels")
    env = dict(os.environ, TIRESIAS_KERNEL_DIR=kdir,
               PYTHONPATH=os.pathsep.join(
                   [_ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    deadline = max(30.0, _budget_s() - _t())
    mark(f"coldstart: empty kernel directory subprocess (deadline "
         f"{deadline:.0f}s)")
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _COLD_CODE, str(dev), str(n_tracks),
             str(channels)], env=env, timeout=deadline, cwd=_ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
    except subprocess.TimeoutExpired:
        say(dev, f"coldstart COLD BUILD: did not finish within "
            f"{deadline:.0f}s")
        raise
    finally:
        shutil.rmtree(kdir, ignore_errors=True)
    vals = dict(ln.split("=", 1) for ln in proc.stdout.splitlines()
                if ln.startswith("COLD_"))
    if proc.returncode != 0 or "COLD_WARMUP_S" not in vals:
        raise RuntimeError(f"coldstart cold run rc={proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    cold_s, cold_ready = float(vals["COLD_WARMUP_S"]), float(
        vals["COLD_READY_S"])
    say(dev, f"coldstart COLD BUILD: the same warm-up from an empty kernel "
        f"directory: READY at {cold_ready:.4f}s, fully warm in "
        f"{cold_s:.4f}s (vs {full_s:.4f}s with the library built) — the "
        "first deployment's nvcc build")
    summary("coldstart", cold_s=cold_s, cold_ready_s=cold_ready)


# ---- the orchestrator ---------------------------------------------------- #


def _emit_headline(throughput: float | None) -> None:
    baseline = 1000.0  # audio-hours per hour (BASELINE.md)
    line = {
        "metric": "fingerprint_throughput",
        "value": None if throughput is None else round(throughput, 1),
        "unit": "audio_hours_per_hour_per_chip",
        "vs_baseline": (None if throughput is None
                        else round(throughput / baseline, 3)),
    }
    if throughput is None:
        line["note"] = "headline_not_measured"
    print(json.dumps(line), flush=True)


# Every entry runs in its own watchdogged subprocess (``--section NAME``)
# and takes the device name.
SECTIONS = {
    "fingerprint": lambda device: _emit_headline(
        bench_fingerprint_throughput(device)),
    "search": bench_search_latency,
    "accuracy": bench_accuracy,
    "accuracy_scale": bench_accuracy_scale,
    "server": bench_server_latency,
    "lattice_prefiltered": bench_lattice_prefiltered,
    "aligned_scale": bench_aligned_scale,
    "streams": bench_streams,
    "fallback_regime": bench_prefilter_fallback,
    "hostfeed": bench_fingerprint_hostfeed,
    "db_build": bench_db_build,
    "engine_search": bench_engine_search,
    "device_rank": bench_device_rank,
    "search_scale": bench_search_scale,
    "coldstart": bench_coldstart,
    # stub sections the orchestrator's tests drive (no device work)
    "_test_sleep": lambda device: time.sleep(600),
    "_test_headline": lambda device: _emit_headline(1234.5),
    "_test_headline_then_hang": lambda device: (
        _emit_headline(777.0), time.sleep(600)),
    "_test_summary": lambda device: (
        summary("alpha", a_ms=1.5), summary("alpha", b=2),
        summary("beta", ok=True)),
    "_test_ctrl": lambda device: print(
        json.dumps({"_ctrl": 1, "key": "TIRESIAS_BENCH_LINK_MBS",
                    "value": 42.5}), flush=True),
    "_test_fail": lambda device: (summary("_test_fail", partial=1), 1 / 0),
}

HEADLINE = ("fingerprint", 300)
# a deadline below this skips the section: a child needs seconds to start
MIN_DEADLINE_S = 25
# (name, nominal watchdog deadline s), in the JAX bench's order
SECONDARY = (
    ("search", 300),
    ("engine_search", 240),
    ("accuracy", 420),
    ("accuracy_scale", 420),
    ("device_rank", 300),
    ("hostfeed", 300),
    ("coldstart", 300),
    ("lattice_prefiltered", 240),
    ("aligned_scale", 420),
    ("server", 300),
    ("streams", 330),
    ("db_build", 300),
    ("fallback_regime", 330),
    ("search_scale", 330),
)


def _consume_control_lines(out: str | None, state: dict,
                           summaries: dict | None,
                           launches: dict | None = None) -> None:
    """Parse a section's stdout: ``{"_ctrl": ...}`` lines feed ``state``
    (passed to later sections as environment variables), ``{"_summary":
    ...}`` lines merge into ``summaries[section]``, ``{"_launches": ...}``
    lines into ``launches[section]``."""
    for ln in (out or "").splitlines():
        try:
            if ln.startswith('{"_ctrl"'):
                d = json.loads(ln)
                state[d["key"]] = d["value"]
            elif ln.startswith('{"_summary"') and summaries is not None:
                d = json.loads(ln)
                sec = d.pop("section")
                d.pop("_summary", None)
                summaries.setdefault(sec, {}).update(d)
            elif ln.startswith('{"_launches"') and launches is not None:
                d = json.loads(ln)
                launches[d["section"]] = d["counts"]
        except (ValueError, KeyError):
            pass


def _child_env(state: dict, deadline: float) -> dict:
    env = os.environ.copy()
    env["TIRESIAS_BENCH_BUDGET_S"] = f"{max(20.0, deadline * 0.85):.0f}"
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    env.update({k: str(v) for k, v in state.items()})
    return env


def _run_child(name: str, deadline: float, state: dict,
               summaries: dict | None = None, device: str = "cuda",
               launches: dict | None = None) -> str | None:
    """Run one section in a subprocess under a hard watchdog deadline.

    The child's stderr is inherited; its stdout is captured and parsed
    (:func:`_consume_control_lines`). Returns the captured stdout, or None
    when the section was skipped or was killed with nothing printed. A
    failed, killed or skipped section is named in ``summaries`` under the
    key ``failed`` (``rc=N``, ``killed after Ns``) or ``skipped``."""
    def note(key, why):
        if summaries is not None:
            summaries.setdefault(name, {})[key] = why

    if deadline < MIN_DEADLINE_S:
        mark(f"section {name}: skipped ({deadline:.0f}s left is too little)")
        note("skipped", f"{deadline:.0f}s left")
        return None
    mark(f"section {name}: start (watchdog {deadline:.0f}s)")
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tiresias_tpu_torch.bench", "--section", name,
         "--device", device],
        stdout=subprocess.PIPE, text=True, start_new_session=True,
        cwd=_ROOT, env=_child_env(state, deadline),
    )
    try:
        out, _ = proc.communicate(timeout=deadline)
    except subprocess.TimeoutExpired as exc:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            proc.kill()
        try:  # salvage what the child printed before it stalled
            rest, _ = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            rest = ""

        def _s(x):  # TimeoutExpired carries bytes even with text=True
            return x.decode(errors="replace") if isinstance(x, bytes) \
                else (x or "")

        out = _s(exc.stdout) + _s(rest)
        mark(f"section {name}: KILLED by watchdog after {deadline:.0f}s"
             f"{'; partial output salvaged' if out else ''}")
        _consume_control_lines(out, state, summaries, launches)
        note("failed", f"killed after {deadline:.0f}s")
        return out or None
    dt = time.monotonic() - t0
    _consume_control_lines(out, state, summaries, launches)
    if proc.returncode != 0:
        mark(f"section {name}: FAILED rc={proc.returncode} after {dt:.0f}s")
        note("failed", f"rc={proc.returncode}")
    else:
        mark(f"section {name}: done in {dt:.0f}s")
    return out


def _extract_headline(out: str | None) -> str | None:
    for ln in (out or "").splitlines():
        if ln.startswith('{"metric"') and '"value": null' not in ln:
            return ln
    return None


def _orchestrate(device: str = "cuda", sections=SECONDARY,
                 headline_section=HEADLINE) -> int:
    """Build the kernels once, run the headline section, then ``sections``,
    each in a watchdogged subprocess; print the final two lines. Returns 1
    when a section failed or was killed or the headline is missing."""
    dev = resolve_device(device)
    budget = _budget_s()
    mark(f"orchestrator start on {dev}: per-section watchdog subprocesses, "
         f"total budget {budget:.0f}s (TIRESIAS_BENCH_BUDGET_S); "
         f"{card(dev)}")
    if dev.type == "cuda":
        build.kernel_library()
        mark(f"kernel library built and loaded in "
             f"{build.build_seconds():.3f}s into {build.build_dir()}")
    state: dict = {}
    summaries: dict = {}
    launches: dict = {}
    name, dl = headline_section
    headline = _extract_headline(_run_child(
        name, min(dl, budget - _t()), state, summaries, device, launches))
    for name, nominal in sections:
        remaining = budget - _t()
        if remaining < 45:
            mark(f"section {name}: skipped ({remaining:.0f}s left of the "
                 f"{budget:.0f}s budget)")
            summaries.setdefault(name, {})["skipped"] = "budget"
            continue
        _run_child(name, min(nominal, remaining), state, summaries, device,
                   launches)
        _print_final(headline, summaries)
    failed = sorted(s for s, d in summaries.items()
                    if isinstance(d, dict) and "failed" in d)
    mark(f"launches {json.dumps(launches, separators=(',', ':'))}")
    rc = 1 if failed or headline is None else 0
    mark(f"bench complete (rc={rc}; failed: {failed or 'none'}; headline "
         f"{'measured' if headline else 'MISSING'})")
    _print_final(headline, summaries)
    return rc


def _print_final(headline: str | None, summaries: dict) -> None:
    """The last stdout lines: the compact all-sections line (at most 1,700
    characters: the largest payloads are dropped whole), then the
    headline."""
    if summaries:
        keep = dict(summaries)
        line = json.dumps({"sections": keep}, separators=(",", ":"))
        while len(line) > 1700:
            big = max(keep, key=lambda s: len(json.dumps(keep[s])))
            if keep[big] == "dropped_for_size":
                break
            keep[big] = "dropped_for_size"
            line = json.dumps({"sections": keep}, separators=(",", ":"))
        print(line, flush=True)
    if headline is None:
        _emit_headline(None)
    else:
        print(headline, flush=True)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="tiresias_tpu_torch.bench",
        description="the port's benchmark harness (see the module doc)")
    p.add_argument("--section", default=None,
                   help="run ONE section in-process (default: the "
                   "orchestrator over every section)")
    p.add_argument("--sections", default=None,
                   help="orchestrate only these secondary sections "
                   "(comma-separated), after the headline")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu (the "
                   "kernels' plain twins: tests only)")
    args = p.parse_args(argv)
    public = [n for n in SECTIONS if not n.startswith("_")]
    if args.section is not None:
        if args.section not in SECTIONS:
            print(f"bench: --section needs one of: {', '.join(public)}",
                  file=sys.stderr)
            return 2
        dev = resolve_device(args.device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        SECTIONS[args.section](args.device)
        counts = {k: v for k, v in build.LAUNCHES.items() if v}
        print(json.dumps({"_launches": 1, "section": args.section,
                          "counts": counts}), flush=True)
        return 0
    sections = SECONDARY
    if args.sections:
        names = args.sections.split(",")
        unknown = [n for n in names if n not in dict(SECONDARY)]
        if unknown:
            print(f"bench: unknown sections {unknown}; choose from: "
                  f"{', '.join(n for n, _ in SECONDARY)}", file=sys.stderr)
            return 2
        sections = tuple((n, d) for n, d in SECONDARY if n in names)
    return _orchestrate(args.device, sections)


if __name__ == "__main__":
    sys.exit(main())
