"""Smoke run of the PyTorch port's search paths on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``tiresias_tpu_torch/csrc``,
checks each against its plain PyTorch twin at the main path's shapes, then
drives the port through the entry points a user calls — ``Tiresias.sync()``
over a directory of WAVs, a 10,000-track catalog (30 s tracks, tier 1024)
saved and restored, and ``search_pcm_batch``/``search_pcm`` at batch 1 and
64, first in the dialplan configuration, then (``[strict]``) in the strict
bag, aligned and margin configurations — and checks the TIR* results
against the plain twins and a brute-force search. The lattice vote kernel
is also held to its twin, and timed, on the search queries' own histograms
against the catalog's value map.

Prints one line per phase, then a JSON line with each kernel's launches on
the main path, its error against its twin and both times, then the card's
name and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Exits non-zero, printing no result, when CUDA is unavailable or any phase
fails. Everything it writes goes to temporary directories it removes.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
import wave

import numpy as np

SR = 8000
TRACK_S = 30
HOP = 256
EXCERPT = 94 * HOP  # 3.008 s, hop-aligned at both ends: 94 frames
N_SYNC_FILES = 256  # WAVs written and ingested through Tiresias.sync()
N_TRACKS = 10000  # catalog size (BASELINE.json's 10k-track DB)
N_EXCERPTS = 64  # queries cut from stored tracks
N_NOISE = 8  # silence and noise queries
# Fingerprint agreement, kernel vs twin, both float32: 1e-4 dB where the
# DCT coefficient has |c| >= 1 (value >= 0 dB); below that 10*log10|c|
# magnifies the float32 summation-order difference of c itself, so the
# bound scales with 1/|c| (an absolute bound of ~2.3e-5 on c). Float32
# kernels differ from the twin by ~4e-6 dB; TF32-rounded inputs move values
# by ~1e-3 dB, so the check also runs that control and requires it to fail.
FP_ATOL_DB = 1e-4
FP_ATOL_C = 1.0
# The [strict] path: coefs=2 without truncation (PARITY.md D8), bag and
# aligned (D9) votes, and margin acceptance, at tolerance 0.1.
STRICT_TOL = 0.1
STRICT_MODES = {
    "bag": {"coefs": 2, "trunc_coef1": False},
    "aligned": {"coefs": 2, "trunc_coef1": False, "aligned": True},
    "margin": {"coefs": 2, "trunc_coef1": False, "aligned": True,
               "min_margin": 0.2},
}
N_STRICT_BRUTE = 4  # queries per mode held to the numpy brute force


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def fp_within_bound(got, want) -> tuple[float, float]:
    """(max |got - want| in dB, max ratio of the error to its bound)."""
    import torch

    err = (got - want).abs()
    c = torch.pow(10.0, want.double() / 10.0)
    bound = FP_ATOL_DB * torch.clamp(FP_ATOL_C / c, min=1.0)
    return float(err.max()), float((err.double() / bound).max())


def tf32_rounded(x):
    """``x`` float32 rounded to TF32's 10-bit mantissa (nearest, ties away),
    as a tensor-core TF32 matmul rounds its inputs."""
    import torch

    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def check_fp(label: str, got, want, control) -> float:
    """Holds a kernel's fingerprints to its twin's within the bound, and the
    twin on TF32-rounded inputs (``control``) outside it. Returns the
    kernel's max error in dB."""
    err, ratio = fp_within_bound(got, want)
    c_err, c_ratio = fp_within_bound(control, want)
    if ratio > 1.0:
        fail(f"{label} disagrees with its twin (max err {err} dB, "
             f"{ratio:.3f}x the bound)")
    if c_ratio <= 1.0:
        fail(f"{label}: the TF32 control is within the bound ({c_err} dB), "
             f"so the bound cannot tell float32 from TF32")
    say(f"[kernels] {label}: max err {err} dB ({ratio:.3f}x bound "
        f"{FP_ATOL_DB} dB); TF32-rounded control {c_err} dB "
        f"({c_ratio:.3f}x bound)")
    return err


def call_ms(fn, reps: int = 20) -> float:
    """Median wall time of one call on the stream (CUDA events around each
    call after two warm-ups): device time plus whatever launch overhead the
    host adds before the work reaches the card."""
    import torch

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


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call: the CUDA kernel and memory-op time
    torch.profiler records over ``reps`` calls, divided by ``reps``. Fails
    the run when the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # per-cycle event note
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    total_us = sum(
        getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
    )
    if total_us <= 0:
        fail("torch.profiler recorded no CUDA device time")
    return total_us / 1e3 / reps


def timed(label: str, kernel, plain, plain_reps: int = 20) -> dict:
    """Device and per-call times of a kernel wrapper and its twin, taken in
    turns (plain, kernel, kernel, plain) so drift hits both alike; a slow
    twin is timed over ``plain_reps`` calls."""
    d_plain = [device_ms(plain, plain_reps)]
    d_kern = [device_ms(kernel), device_ms(kernel)]
    d_plain.append(device_ms(plain, plain_reps))
    out = {
        "ms": float(np.median(d_kern)),
        "plain_ms": float(np.median(d_plain)),
        "call_ms": call_ms(kernel),
        "plain_call_ms": call_ms(plain, plain_reps),
    }
    say(f"[kernels] {label}: device {out['ms']} ms (plain {out['plain_ms']} "
        f"ms); per call incl. launch {out['call_ms']} ms (plain "
        f"{out['plain_call_ms']} ms)")
    return out


def synth_tracks(n: int, seconds: float, seed: int, device):
    """``n`` seeded speech-like int16 signals [n, seconds*SR] (harmonic
    stacks with vibrato and amplitude modulation plus a little noise, in
    syllables of random loudness), synthesized on the device. Without the
    syllables every track's fingerprint stays within ~0.6 dB, and an
    aligned search at tolerance 0.1 gives other tracks 75-90% of the true
    track's votes (a 256-track sample); with them, ~40%."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=g, device=device)

    t = torch.arange(int(seconds * SR), device=device, dtype=torch.float32) / SR
    f0, vibf = u(90, 220, n, 1), u(3, 7, n, 1)
    vib = 1.0 + 0.03 * torch.sin(2 * torch.pi * vibf * t)
    out = torch.zeros((n, t.shape[0]), device=device)
    for h in range(1, 9):
        amp = u(0.2, 1.0, n, 1) / h
        mod = 1.0 + 0.5 * torch.sin(
            2 * torch.pi * u(0.5, 3.0, n, 1) * t + u(0, 6.28, n, 1)
        )
        out += amp * mod * torch.sin(2 * torch.pi * f0 * h * vib * t)
    out += 0.02 * torch.randn(out.shape, generator=g, device=device)
    out *= 0.3 / out.abs().amax(dim=1, keepdim=True).clamp(min=1e-9)
    # syllables: consecutive 60-400 ms segments, each at its own level
    # between -30 and 0 dB
    seg = u(0.06, 0.4, n, int(seconds / 0.06) + 1)
    which = torch.searchsorted(torch.cumsum(seg, 1),
                               t.expand(n, -1).contiguous())
    level_db = torch.gather(u(-30.0, 0.0, n, seg.shape[1]), 1,
                            which.clamp(max=seg.shape[1] - 1))
    out *= torch.pow(10.0, level_db / 20.0)
    return torch.clamp(torch.round(out * 32768.0), -32768, 32767).to(
        torch.int16
    )


def write_wav_i16(path: str, pcm: np.ndarray) -> None:
    with wave.open(path, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(SR)
        wf.writeframes(pcm.astype("<i2").tobytes())


def phase_card(device) -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else (
        f"nvidia-smi failed: {smi.stderr.strip()}"
    )
    say(f"[card] {card}")
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(device)}")
    return {"card": card}


def phase_build() -> None:
    from tiresias_tpu_torch.utils import build

    build.kernel_library()
    say(f"[build] kernels built and loaded in {build.build_seconds():.3f} s "
        f"into {build.build_dir()}")


def phase_kernels(device, dsp) -> list[dict]:
    """Each kernel against its twin at the main path's shapes."""
    import torch

    from tiresias_tpu_torch.ops import match_lattice as ml
    from tiresias_tpu_torch.ops import mfcc_kernels as mk

    consts = mk.device_constants(dsp, SR, device)
    out = []
    # K1: 64 queries x 128-frame bucket (3 s queries)
    q = synth_tracks(64, 128 * HOP / SR, 101, device).float() / 32768.0
    frames = mk.frames_from_pcm(q, HOP, dsp.buf_size).reshape(-1, 512)
    frames = frames.contiguous()
    consts_tf32 = tuple(tf32_rounded(c) for c in consts)
    err = check_fp(
        f"K1 mfcc_rows [{frames.shape[0]}, 512]", mk.mfcc_rows(frames, consts),
        mk.mfcc_rows_plain(frames, consts),
        mk.mfcc_rows_plain(tf32_rounded(frames), consts_tf32),
    )
    t = timed("K1 mfcc_rows", lambda: mk.mfcc_rows(frames, consts),
              lambda: mk.mfcc_rows_plain(frames, consts))
    out.append({
        "name": "mfcc_rows", "route": "cuda",
        "source": "tiresias_tpu_torch/csrc/mfcc.cu",
        "replaces": "tiresias_tpu/ops/mfcc_pallas.py:171",
        "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
    })
    # K2: 64 x 30 s signals in the ingest frame bucket (938 -> 960 frames)
    pcm = synth_tracks(64, 960 * HOP / SR, 102, device).float() / 32768.0
    err = check_fp(
        f"K2 mfcc_framed [64, {pcm.shape[1]}]",
        mk.mfcc_framed(pcm, consts, HOP, dsp.buf_size),
        mk.mfcc_framed_plain(pcm, consts, HOP, dsp.buf_size),
        mk.mfcc_framed_plain(tf32_rounded(pcm), consts_tf32, HOP,
                             dsp.buf_size),
    )
    t = timed("K2 mfcc_framed",
              lambda: mk.mfcc_framed(pcm, consts, HOP, dsp.buf_size),
              lambda: mk.mfcc_framed_plain(pcm, consts, HOP, dsp.buf_size))
    out.append({
        "name": "mfcc_framed", "route": "cuda",
        "source": "tiresias_tpu_torch/csrc/mfcc.cu",
        "replaces": "tiresias_tpu/ops/mfcc_pallas.py:217",
        "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
    })
    del pcm
    # K3': B in {1, 64} x 10,112 rows (a 10k-track map, 128-row padding),
    # dense counts in every bucket (the worst case; real query histograms
    # are timed in phase_lattice_real)
    g = torch.Generator(device=device).manual_seed(103)
    rows = 10112
    vm = torch.rand((rows, ml.K_SIZE), generator=g, device=device) * 8.0
    vm[10000:] = torch.inf
    times = {}
    for b in (1, 64):
        counts = torch.randint(0, 6, (b, ml.K_SIZE), generator=g,
                               device=device, dtype=torch.int32)
        for tol in (0.001, 1.0):
            for bound in (5, None):  # counts < 6: one u8 plane; or four
                if not torch.equal(ml.hit_votes(counts, vm, tol, bound),
                                   ml.lattice_votes_reference(counts, vm,
                                                              tol)):
                    fail(f"K3' lattice_votes != twin at B={b} tol={tol} "
                         f"max_count={bound}")
        say(f"[kernels] K3' lattice_votes [{b}, 640] x [{rows}, 640] dense "
            f"counts: votes exact at tol 0.001 and 1.0, 1 and 4 planes")
        times[b] = timed(
            f"K3' lattice_votes dense B={b}",
            lambda: ml.hit_votes(counts, vm, 1.0, 5),
            lambda: ml.lattice_votes_reference(counts, vm, 1.0),
        )
    out.append({
        "name": "lattice_votes", "route": "cuda",
        "source": "tiresias_tpu_torch/csrc/lattice.cu",
        "replaces": "tiresias_tpu/ops/match_lattice.py:369",
        "max_abs_err": 0.0, "ms": times[64]["ms"],
        "plain_ms": times[64]["plain_ms"],
    })
    out += phase_match_kernels(device)
    return out


def match_case(device, seed: int, rows: int, t: int, coefs: int, b: int,
               f: int, live_frames: int | None = None):
    """Seeded store-layout rows ``[rows, t, coefs]`` (PAD_VALUE past each
    row's end; row 1 empty, row 2 full, or every row ``live_frames`` long)
    and ``b`` queries ``[b, f, coefs]``: noisy excerpts of stored rows and
    random frames, with ``n_frames`` a little under ``f``."""
    import torch

    from tiresias_tpu_torch.ops.mfcc import PAD_VALUE

    g = np.random.default_rng(seed)
    db = g.uniform(-30.0, 20.0, (rows, t, coefs)).astype(np.float32)
    if live_frames is None:
        n = g.integers(f, t + 1, rows)
        n[1], n[2] = 0, t
    else:
        n = np.full(rows, live_frames)
    db[np.arange(t)[None, :] >= n[:, None]] = PAD_VALUE
    src = [r for r in g.integers(0, rows, b) if n[r] >= f + 1][: b // 2]
    q = [db[r, 1 : 1 + f] for r in src]
    q += [g.uniform(-30.0, 20.0, (f, coefs)) for _ in range(b - len(q))]
    q = np.stack(q).astype(np.float32)
    q += g.normal(0.0, 0.02, q.shape).astype(np.float32)
    n_frames = np.array([f - (i % 3) * 5 for i in range(b)], np.int32)
    return (torch.from_numpy(db).to(device), torch.from_numpy(q).to(device),
            n_frames)


def phase_match_kernels(device) -> list[dict]:
    """K4 and K5 against their twin, int32 exact: coefs 1, 2, 4 and 8, the
    band filter off and on (on: q0 frames dropped and q1 conditions
    bypassed), tolerances 0.05, 1 and 2e5 (past the Pallas kernels' masking
    limit), a 1,536-frame tier (K5 walks it in 4 time chunks) and a
    300-frame query (over one shared-memory stage of either kernel). Then
    both times at the [strict] shapes."""
    import torch

    from tiresias_tpu_torch.ops import match as tm
    from tiresias_tpu_torch.ops import match_kernels as tk
    from tiresias_tpu_torch.ops.mfcc import PAD_VALUE

    fns = {False: tk.match_votes_fused, True: tk.match_votes_fused_aligned}
    checked = 0
    for coefs in (1, 2, 4, 8):
        for rows, t, f in ((200, 256, 24), (300, 1536, 300)):
            db, q, n_frames = match_case(device, 200 + coefs + t, rows, t,
                                         8, 5, f)
            for band in ((-1, -1), (1, 300)):
                qq, act, use2 = tm.prepare_query(q, n_frames, *band,
                                                 trunc_coef1=False)
                for tol in (0.05, 1.0, 2e5):
                    for aligned, fn in fns.items():
                        got = fn(db, qq, act, use2, tol, coefs)
                        want = tm.match_votes(
                            db, db[..., 0] != PAD_VALUE, qq, act, use2, tol,
                            coefs=coefs, aligned=aligned)
                        if not torch.equal(got, want):
                            bad = (got != want).nonzero()[0].tolist()
                            fail(f"K{5 if aligned else 4} != twin at coefs "
                                 f"{coefs} tier {t} F {f} band {band} tol "
                                 f"{tol}: [{bad}] {got[bad[0], bad[1]]} vs "
                                 f"{want[bad[0], bad[1]]}")
                        if tol == 1.0 and band == (-1, -1) and not (
                                got > 0).any():
                            fail(f"K4/K5 check at coefs {coefs} has no votes")
                        checked += 1
    say(f"[kernels] K4 match_votes / K5 match_votes_aligned == twins (int32 "
        f"exact) in {checked} cases: coefs 1, 2, 4, 8 x band off/on x tol "
        f"0.05, 1, 2e5; tiers 256 and 1536 (K5: 4 time chunks), queries of "
        f"24 and 300 frames (K4: 2 stages, K5: 3)")
    # [strict] shapes: 10,112 rows (10,000 tracks of 938 frames, 128-row
    # padding) x 1,024 frames x 2 coefs; 94 active frames in a 128 bucket
    db, _, _ = match_case(device, 300, 10112, 1024, 2, 2, 128,
                          live_frames=938)
    db[10000:] = PAD_VALUE
    out, times = [], {}
    for b in (1, 64):
        _, q, _ = match_case(device, 301 + b, 256, 256, 2, b, 128)
        qq, act, use2 = tm.prepare_query(q, np.full(b, 94), -1, -1,
                                         trunc_coef1=False)
        mask = db[..., 0] != PAD_VALUE
        for aligned, fn in fns.items():
            name = f"K{5 if aligned else 4} {fn.__name__} B={b}"
            times[aligned, b] = timed(
                name, lambda: fn(db, qq, act, use2, STRICT_TOL, 2),
                lambda: tm.match_votes(db, mask, qq, act, use2, STRICT_TOL,
                                       coefs=2, aligned=aligned),
                plain_reps=2,
            )
    for aligned, name, line in ((False, "match_votes", 58),
                                (True, "match_votes_aligned", 171)):
        out.append({
            "name": name, "route": "cuda",
            "source": "tiresias_tpu_torch/csrc/match.cu",
            "replaces": f"tiresias_tpu/ops/match_pallas.py:{line}",
            "max_abs_err": 0.0, "ms": times[aligned, 64]["ms"],
            "plain_ms": times[aligned, 64]["plain_ms"],
        })
    return out


def phase_ingest(device, cfg, media: str) -> float:
    """Write seeded 30 s WAVs, then ``Tiresias(cfg).sync()``."""
    from tiresias_tpu_torch.api import Tiresias
    from tiresias_tpu_torch.utils import build

    pcm = synth_tracks(N_SYNC_FILES, TRACK_S, 104, device).cpu().numpy()
    for i, p in enumerate(pcm):
        write_wav_i16(os.path.join(media, f"sync{i:04d}.wav"), p)
    t0 = time.perf_counter()
    eng = Tiresias(cfg)
    report = eng.sync()
    eng.close()
    dt = time.perf_counter() - t0
    if report.created != N_SYNC_FILES or report.failed:
        fail(f"sync created {report.created}/{N_SYNC_FILES} "
             f"(failed {report.failed})")
    if build.LAUNCHES["mfcc_framed"] <= 0:
        fail("sync did not launch the framed MFCC kernel")
    rate = N_SYNC_FILES * TRACK_S / dt  # audio-hours per wall-clock hour
    say(f"[ingest] sync created {report.created} x {TRACK_S} s WAVs in "
        f"{dt:.3f} s: {rate:.1f} audio-hrs/hr (decode + md5 + fingerprint + "
        f"store + checkpoint)")
    return rate


def phase_catalog(device, cfg, starts: dict):
    """Grow the catalog to N_TRACKS 30 s tracks in batches of 512 as
    ingest's drain does, save, close, and restore. Returns the restored
    engine and the excerpts ``{track: pcm[start : start + EXCERPT]}`` cut
    at ``starts``."""
    from tiresias_tpu_torch.api import Tiresias
    from tiresias_tpu_torch.ops.mfcc import fingerprint_signals

    eng = Tiresias(cfg)
    excerpts = {}
    t0 = time.perf_counter()
    fp_s = 0.0
    for lo in range(len(eng.store), N_TRACKS, 512):
        n = min(512, N_TRACKS - lo)
        pcm = synth_tracks(n, TRACK_S, 1000 + lo, device).cpu().numpy()
        t1 = time.perf_counter()
        fps, n_frames = fingerprint_signals(list(pcm), SR, cfg.dsp,
                                            device=device)
        fp_s += time.perf_counter() - t1
        for i in range(n):
            track = lo + i
            eng.store.add_audio(
                f"gen{track:05d}.wav", "media", fps[i, : n_frames[i]],
                f"gen-{track}",
            )
            if track in starts:
                s = starts[track]
                excerpts[track] = pcm[i, s : s + EXCERPT].copy()
    build_s = time.perf_counter() - t0
    eng.save()
    entries = [(e.uuid, e.name, e.hash, e.n_frames) for e in eng.store.entries]
    host = eng.store.host_db()
    eng.close()
    t0 = time.perf_counter()
    eng = Tiresias(cfg)
    restore_s = time.perf_counter() - t0
    if [(e.uuid, e.name, e.hash, e.n_frames)
            for e in eng.store.entries] != entries:
        fail("restored catalog differs from the saved one")
    for a, b in zip(eng.store.host_db(), host):
        if not np.array_equal(a, b):
            fail("restored fingerprints differ from the saved ones")
    tiers = sorted(v.tier_frames for v in eng.store.search_views())
    say(f"[catalog] {len(entries)} tracks (tiers {tiers}) built in "
        f"{build_s:.3f} s ({fp_s:.3f} s fingerprinting), saved, restored "
        f"in {restore_s:.3f} s with identical entries and fingerprints")
    return eng, excerpts


def phase_search(device, eng, queries):
    """Time the searches: batch 1 and batch 64 at tol 0.001 and 1.0."""
    import torch

    results = {}
    t0 = time.perf_counter()
    eng.search_pcm_batch(None, queries[:1], SR)  # value-map build
    torch.cuda.synchronize(device)
    first_s = time.perf_counter() - t0
    lat = {1: [], 64: []}
    for tol in (0.001, 1.0):
        res = []
        for lo in range(0, len(queries), 64):
            t1 = time.perf_counter()
            res += eng.search_pcm_batch(None, queries[lo : lo + 64], SR,
                                        tolerance=tol)
            if lo + 64 <= len(queries):
                lat[64].append((time.perf_counter() - t1) / 64)
        for _ in range(10):
            t1 = time.perf_counter()
            eng.search_pcm_batch(None, queries[:64], SR, tolerance=tol)
            lat[64].append((time.perf_counter() - t1) / 64)
        single = []
        for q in queries:
            t1 = time.perf_counter()
            single.append(eng.search_pcm(None, q, SR, tolerance=tol))
            lat[1].append(time.perf_counter() - t1)
        if [r.to_channel_vars() for r in single] != [
                r.to_channel_vars() for r in res]:
            fail(f"batch-1 and batch-64 TIR* differ at tol {tol}")
        results[tol] = res
    p50 = {b: 1e3 * float(np.median(v)) for b, v in lat.items()}
    dev_ms = {
        1: device_ms(lambda: eng.search_pcm(None, queries[0], SR), reps=10),
        64: device_ms(lambda: eng.search_pcm_batch(None, queries[:64], SR),
                      reps=5) / 64,
    }
    say(f"[search] device time {dev_ms[1]:.4f} ms/query at batch 1 "
        f"({100 * dev_ms[1] / p50[1]:.1f}% of the p50 wall time), "
        f"{dev_ms[64]:.4f} ms/query at batch 64 "
        f"({100 * dev_ms[64] / p50[64]:.1f}%)")
    found = sum(r.found for r in results[1.0][:N_EXCERPTS])
    say(f"[search] {len(queries)} queries ({N_EXCERPTS} excerpts + "
        f"{N_NOISE} silence/noise) x tol {{0.001, 1.0}}; first search "
        f"(value-map build) {first_s:.3f} s; p50 {p50[1]:.4f} "
        f"ms/query at batch 1, {p50[64]:.4f} ms/query at batch 64; "
        f"excerpts FOUND at tol 1.0: {found}/{N_EXCERPTS}")
    return results, p50


def phase_verify(device, eng, queries, results):
    """TIR* against the plain twins on the same tensors and against a
    brute-force search over the stored fingerprints. Returns the catalog's
    value map and the queries' max1 values and valid-frame mask."""
    import torch

    from tiresias_tpu_torch.api.engine import top1_by_key
    from tiresias_tpu_torch.ops import match_lattice as ml
    from tiresias_tpu_torch.ops import mfcc_kernels as mk
    from tiresias_tpu_torch.ops.mfcc import (
        fingerprint_padded_batch,
        pad_frames_bucket,
    )

    dsp = eng.config.dsp
    (view,) = eng.store.search_views()
    vm = eng.store.value_map_for(view)
    padded, n_frames = pad_frames_bucket(queries, HOP)
    qfp = fingerprint_padded_batch(padded, SR, dsp, device=device)
    frames = mk.frames_from_pcm(
        torch.from_numpy(padded).to(device).float() / 32768.0, HOP, 512
    )
    b, f = frames.shape[:2]
    qfp_plain = mk.mfcc_rows_plain(
        frames.reshape(b * f, 512), mk.device_constants(dsp, SR, device)
    ).reshape(b, f, -1)
    nf = torch.from_numpy(n_frames.astype(np.int64)).to(device)
    valid = torch.arange(f, device=device)[None, :] < nf[:, None]
    err, ratio = fp_within_bound(qfp[valid], qfp_plain[valid])
    if ratio > 1.0:
        fail(f"query fingerprints: kernel vs twin {err} dB ({ratio}x bound)")
    lo, hi = ml.band_thresholds(-1, -1)
    rows = torch.arange(vm.shape[0], device=device)
    for tol, res in results.items():
        c = ml.histogram(qfp[..., 0].contiguous(), valid, lo, hi)
        m, _, best = top1_by_key(ml.lattice_votes_reference(c, vm, tol), rows)
        m, best = m.cpu().numpy(), best.cpu().numpy()
        for i, r in enumerate(res):
            want = (("FOUND", int(m[i]), view.entries[best[i]].name)
                    if m[i] > 0 else ("NOTFOUND", 0, None))
            if (r.status, r.match_count, r.name) != want:
                fail(f"query {i} tol {tol}: engine {r} != plain twins {want}")
            if tol == 1.0 and i < N_EXCERPTS and not (
                    r.found and r.match_count >= r.frame_count - 1):
                fail(f"excerpt {i} at tol 1.0: {r}")
    say(f"[verify] engine TIR* == plain-twin TIR* on the same tensors for "
        f"{len(queries)} queries x 2 tolerances; query fingerprints within "
        f"{err} dB of the twin ({ratio:.3f}x bound); every excerpt FOUND at "
        f"tol 1.0 with >= frame_count - 1 votes")
    db = [eng.store.get_fingerprint(e.uuid)[:, 0] for e in eng.store.entries]
    db0 = np.full((len(db), max(len(d) for d in db)), np.nan, np.float32)
    for a, d in enumerate(db):
        db0[a, : len(d)] = d
    t0 = time.perf_counter()
    qfp0 = qfp[..., 0].cpu().numpy()
    for tol, res in results.items():
        for i, r in enumerate(res):
            q0 = qfp0[i, : n_frames[i]]
            votes = brute_force_votes(db0, q0, tol)
            best = int(np.argmax(votes))  # lowest index among the maxima
            want = ((eng.store.entries[best].name, int(votes[best]))
                    if votes[best] > 0 else (None, 0))
            if (r.name, r.match_count, r.frame_count) != (*want, len(q0)):
                fail(f"query {i} tol {tol}: engine {r} != brute force {want}")
    say(f"[verify] engine TIR* == a brute-force numpy search over all "
        f"{len(db)} tracks for {len(queries)} queries x 2 tolerances "
        f"({time.perf_counter() - t0:.1f} s)")
    return vm, qfp[..., 0].contiguous(), valid


def phase_lattice_real(vm, q0, valid) -> None:
    """K3' on the traffic the engine sends: the catalog's own value map and
    the histograms of the search queries (64 excerpts + 8 silence/noise) at
    batch 64 and 1, and one long query (every query's frames in one row,
    counts past 255 in a bucket: two u8 planes). Int32-exact against the
    twin, then timed."""
    import torch

    from tiresias_tpu_torch.ops import match_lattice as ml

    lo, hi = ml.band_thresholds(-1, -1)
    f = q0.shape[1]
    c = ml.histogram(q0, valid, lo, hi)
    nz = (c > 0).sum(dim=1)
    steps = torch.unique(torch.nonzero(c.any(dim=0))[:, 0] // ml.STEP)
    say(f"[kernels] K3' real histograms: {c.shape[0]} queries x {f} frames, "
        f"{int(nz[:N_EXCERPTS].min())}-{int(nz[:N_EXCERPTS].max())} non-zero "
        f"buckets per excerpt, {int(nz.max())} at most; the union covers "
        f"{len(steps)} of {ml.K_SIZE // ml.STEP} steps of {ml.STEP} buckets; "
        f"max count {int(c.max())}")
    long_c = ml.histogram(q0.reshape(1, -1), valid.reshape(1, -1), lo, hi)
    cases = {
        "B=72": (c, f), "B=64": (c[:N_EXCERPTS], f), "B=1": (c[:1], f),
        f"long B=1 F={q0.numel()}": (long_c, q0.numel()),
    }
    if int(long_c.max()) <= 255:
        fail(f"the long query's counts stay at {int(long_c.max())} <= 255")
    for name, (counts, bound) in cases.items():
        for tol in (0.001, 1.0):
            got = ml.hit_votes(counts, vm, tol, bound)
            if not torch.equal(got, ml.lattice_votes_reference(counts, vm,
                                                               tol)):
                fail(f"K3' lattice_votes != twin on real histograms {name} "
                     f"tol {tol}")
        say(f"[kernels] K3' lattice_votes real {name} ({ml.count_planes(bound)}"
            f" plane(s)) x [{vm.shape[0]}, 640]: votes exact at tol 0.001 "
            f"and 1.0")
        if name != "B=72":
            timed(f"K3' lattice_votes real {name}",
                  lambda: ml.hit_votes(counts, vm, 1.0, bound),
                  lambda: ml.lattice_votes_reference(counts, vm, 1.0))


def phase_strict(device, eng, queries):
    """The strict path on the restored catalog: each STRICT_MODES entry
    through ``search_pcm_batch`` (batch 64) and ``search_pcm`` (batch 1).
    Every excerpt must be FOUND with >= frame_count - 1 votes."""
    import torch

    results, p50 = {}, {}
    for mode, kw in STRICT_MODES.items():
        eng.search_pcm_batch(None, queries[:1], SR, tolerance=STRICT_TOL,
                             **kw)
        torch.cuda.synchronize(device)
        lat = {1: [], 64: []}
        res = []
        for lo in range(0, len(queries), 64):
            t1 = time.perf_counter()
            res += eng.search_pcm_batch(None, queries[lo : lo + 64], SR,
                                        tolerance=STRICT_TOL, **kw)
            if lo + 64 <= len(queries):
                lat[64].append((time.perf_counter() - t1) / 64)
        for _ in range(5):
            t1 = time.perf_counter()
            eng.search_pcm_batch(None, queries[:64], SR,
                                 tolerance=STRICT_TOL, **kw)
            lat[64].append((time.perf_counter() - t1) / 64)
        single = []
        for q in queries:
            t1 = time.perf_counter()
            single.append(eng.search_pcm(None, q, SR, tolerance=STRICT_TOL,
                                         **kw))
            lat[1].append(time.perf_counter() - t1)
        if [r.to_channel_vars() for r in single] != [
                r.to_channel_vars() for r in res]:
            fail(f"[strict] {mode}: batch-1 and batch-64 TIR* differ")
        found = sum(r.found and r.match_count >= r.frame_count - 1
                    for r in res[:N_EXCERPTS])
        if found != N_EXCERPTS:
            fail(f"[strict] {mode}: only {found}/{N_EXCERPTS} excerpts FOUND "
                 f"with >= frame_count - 1 votes")
        p50[mode] = {b: 1e3 * float(np.median(v)) for b, v in lat.items()}
        dev = {
            1: device_ms(lambda: eng.search_pcm(
                None, queries[0], SR, tolerance=STRICT_TOL, **kw), reps=10),
            64: device_ms(lambda: eng.search_pcm_batch(
                None, queries[:64], SR, tolerance=STRICT_TOL, **kw),
                reps=3) / 64,
        }
        say(f"[strict] {mode} {kw} tol {STRICT_TOL}: p50 "
            f"{p50[mode][1]:.4f} ms/query at batch 1 (device "
            f"{dev[1]:.4f} ms, {100 * dev[1] / p50[mode][1]:.1f}%), "
            f"{p50[mode][64]:.4f} ms/query at batch 64 (device "
            f"{dev[64]:.4f} ms, {100 * dev[64] / p50[mode][64]:.1f}%); "
            f"excerpts FOUND with >= frame_count - 1 votes: "
            f"{found}/{N_EXCERPTS}; noise/silence FOUND: "
            f"{sum(r.found for r in res[N_EXCERPTS:])}/{N_NOISE}")
        results[mode] = res
    return results, p50


def phase_verify_strict(device, eng, queries, results) -> None:
    """[strict] TIR* against the plain twin on the same tensors for every
    query, and against an in-script numpy brute force over all stored
    tracks for N_STRICT_BRUTE queries per mode."""
    import torch

    from tiresias_tpu_torch.api.engine import top1_by_key
    from tiresias_tpu_torch.ops import match as tm
    from tiresias_tpu_torch.ops.mfcc import (
        fingerprint_padded_batch,
        pad_frames_bucket,
    )

    (view,) = eng.store.search_views()
    padded, n_frames = pad_frames_bucket(queries, HOP)
    qfp = fingerprint_padded_batch(padded, SR, eng.config.dsp, device=device)
    q, active, use2 = tm.prepare_query(qfp, n_frames, -1, -1,
                                       trunc_coef1=False)
    rows = torch.arange(view.db.shape[0], device=device)
    for aligned in (False, True):
        votes = torch.cat([
            tm.match_votes(view.db, view.mask, q[lo : lo + 64],
                           active[lo : lo + 64], use2[lo : lo + 64],
                           STRICT_TOL, coefs=2, aligned=aligned)
            for lo in range(0, len(queries), 64)
        ])
        m, _, best = top1_by_key(votes, rows)
        v2 = torch.where(rows[None, :] == best[:, None], -1, votes)
        v2 = v2.max(dim=1).values.clamp(min=0)
        m, best, v2 = (x.cpu().numpy() for x in (m, best, v2))
        for mode in ("aligned", "margin") if aligned else ("bag",):
            mm = STRICT_MODES[mode].get("min_margin", 0.0)
            for i, r in enumerate(results[mode]):
                v1 = int(m[i])
                want = (("FOUND", v1, view.entries[best[i]].name)
                        if v1 > 0 and v1 - v2[i] >= mm * v1
                        else ("NOTFOUND", 0, None))
                if (r.status, r.match_count, r.name) != want:
                    fail(f"[strict] {mode} query {i}: engine {r} != plain "
                         f"twin {want}")
    say(f"[verify] [strict] engine TIR* == plain-twin TIR* on the same "
        f"tensors for {len(queries)} queries x {len(STRICT_MODES)} modes")
    fps = [eng.store.get_fingerprint(e.uuid) for e in eng.store.entries]
    db = np.full((len(fps), max(len(x) for x in fps), 2), np.nan, np.float32)
    for a, x in enumerate(fps):
        db[a, : len(x)] = x[:, :2]
    qfp = qfp.cpu().numpy()
    picks = [0, N_EXCERPTS // 2, N_EXCERPTS - 1, N_EXCERPTS + N_NOISE - 1]
    t0 = time.perf_counter()
    for i in picks[:N_STRICT_BRUTE]:
        qi = qfp[i, : n_frames[i], :2]
        for aligned in (False, True):
            votes = brute_force_strict(db, qi, STRICT_TOL, aligned)
            best = int(np.argmax(votes))  # lowest index among the maxima
            v1 = int(votes[best])
            v2 = int(np.delete(votes, best).max(initial=0))
            for mode in ("aligned", "margin") if aligned else ("bag",):
                mm = STRICT_MODES[mode].get("min_margin", 0.0)
                want = ((eng.store.entries[best].name, v1)
                        if v1 > 0 and v1 - v2 >= mm * v1 else (None, 0))
                r = results[mode][i]
                if (r.name, r.match_count, r.frame_count) != (*want, len(qi)):
                    fail(f"[strict] {mode} query {i}: engine {r} != brute "
                         f"force {want}")
    say(f"[verify] [strict] engine TIR* == a brute-force numpy search over "
        f"all {len(fps)} tracks for {N_STRICT_BRUTE} queries x "
        f"{len(STRICT_MODES)} modes ({time.perf_counter() - t0:.1f} s)")


def brute_force_strict(db: np.ndarray, q: np.ndarray, tol: float,
                       aligned: bool) -> np.ndarray:
    """Strict search written out over every stored frame, band filter off:
    query frame ``f`` matches stored frame ``t`` of track ``a`` when both
    coefficients lie within ``tol`` (float32). Bag: one vote per frame with
    any match; aligned: the best offset ``t - f``'s match count. ``db`` is
    ``[tracks, frames, 2]`` with NaN past each track's end."""
    tol = np.float32(tol)
    a, t, _ = db.shape
    f = len(q)
    votes = np.zeros(a, np.int64)
    acc = np.zeros((a, t + f - 1), np.int32) if aligned else None
    for fi in range(f):
        ok = (np.abs(db[..., 0] - q[fi, 0]) <= tol) & (
            np.abs(db[..., 1] - q[fi, 1]) <= tol)
        if aligned:
            acc[:, f - 1 - fi : f - 1 - fi + t] += ok
        else:
            votes += ok.any(axis=1)
    return acc.max(axis=1).astype(np.int64) if aligned else votes


def brute_force_votes(db0: np.ndarray, q0: np.ndarray, tol: float):
    """The dialplan search written out over every stored frame: track ``a``
    gets one vote per query frame ``f`` when some stored coefficient 0 lies
    within ``tol`` of ``q0[f]`` truncated toward zero. ``db0`` is
    ``[tracks, frames]`` with NaN past each track's end (never within)."""
    votes = np.zeros(len(db0), np.int64)
    hits = {}
    for v in q0:
        v = float(int(v))
        if v not in hits:
            hits[v] = ((db0 >= v - tol) & (db0 <= v + tol)).any(axis=1)
        votes += hits[v]
    return votes


def run(device) -> dict:
    import torch

    from tiresias_tpu_torch import ContextConfig, TiresiasConfig
    from tiresias_tpu_torch.utils import build

    card = phase_card(device)
    phase_build()
    kernels = phase_kernels(device, TiresiasConfig().dsp)
    tmp = tempfile.mkdtemp(prefix="tiresias_chip_smoke_")
    try:
        media = os.path.join(tmp, "media")
        os.makedirs(media)
        cfg = TiresiasConfig(
            contexts=(ContextConfig("media", media),),
            data_dir=os.path.join(tmp, "data"),
        )
        rng = np.random.default_rng(106)
        tracks = np.linspace(N_SYNC_FILES, N_TRACKS - 1, N_EXCERPTS)
        starts = {  # hop-aligned and after t0, so only frame 0 differs
            int(t): HOP * int(rng.integers(1, (TRACK_S * SR - EXCERPT) // HOP))
            for t in tracks.astype(int)
        }
        torch.cuda.synchronize(device)
        build.reset_launch_counts()  # --- the main path starts here ---
        rate = phase_ingest(device, cfg, media)
        eng, excerpts = phase_catalog(device, cfg, starts)
        queries = [excerpts[t] for t in starts]
        queries += [np.zeros(EXCERPT, np.int16)] * (N_NOISE // 2)
        queries += [
            np.clip(rng.normal(0, 3000, EXCERPT), -32768, 32767).astype(
                np.int16) for _ in range(N_NOISE - N_NOISE // 2)
        ]
        run_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        results, p50 = phase_search(device, eng, queries)
        torch.cuda.synchronize(device)
        launches = dict(build.LAUNCHES)  # --- the main path ends here ---
        search_peak = torch.cuda.max_memory_allocated(device)
        say(f"[search] max_memory_allocated {search_peak} B during the "
            f"searches, {max(run_peak, search_peak)} B over the run")
        for name in ("mfcc_rows", "mfcc_framed", "lattice_votes"):
            if launches[name] <= 0:
                fail(f"the main path never launched {name}")
        say(f"[launches] main path: {launches}")
        phase_lattice_real(*phase_verify(device, eng, queries, results))
        torch.cuda.synchronize(device)
        build.reset_launch_counts()  # --- the strict path starts here ---
        strict, strict_p50 = phase_strict(device, eng, queries)
        torch.cuda.synchronize(device)
        strict_launches = dict(build.LAUNCHES)  # --- and ends here ---
        for name in ("match_votes", "match_votes_aligned"):
            if strict_launches[name] <= 0:
                fail(f"the strict path never launched {name}")
        say(f"[launches] strict path: {strict_launches}")
        launches.update(match_votes=strict_launches["match_votes"],
                        match_votes_aligned=strict_launches[
                            "match_votes_aligned"])
        phase_verify_strict(device, eng, queries, strict)
        eng.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    return {"kernels": kernels, "card": card["card"], "ingest_rate": rate,
            "p50": p50, "strict_p50": strict_p50}


def main() -> int:
    # one card: the first visible one, so device_count() is the cards used
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0")
    os.environ["CUDA_VISIBLE_DEVICES"] = visible.split(",")[0]
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "tiresias_tpu_torch")):
        fail("run from a checkout: tiresias_tpu_torch/ is missing")
    sys.path.insert(0, here)
    from tiresias_tpu_torch.utils.device import device_report, resolve_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device("cuda:0")
    out = run(device)
    if "jax" in sys.modules:
        fail("the port imported jax")
    say(json.dumps({"kernels": out["kernels"]}))
    say(out["card"])  # name, power limit — as nvidia-smi prints them
    say(json.dumps({"ok": True, "device": device_report(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
