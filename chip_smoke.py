"""Smoke run of the PyTorch port's search paths on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``tiresias_tpu_torch/csrc``,
checks each against its plain PyTorch twin at the main path's shapes (the
MFCC kernels on both routes, FFT and DFT product, and against a float64
numpy chain), then
drives the port through the entry points a user calls — ``Tiresias.sync()``
over a directory of WAVs, a 10,000-track catalog (30 s tracks, tier 1024)
saved and restored, and ``search_pcm_batch``/``search_pcm`` at batch 1 and
64, first in the dialplan configuration, then (``[strict]``) in the strict
bag, aligned and margin configurations — and checks the TIR* results
against the plain twins and a brute-force search. The lattice vote kernel
is also held to its twin, and timed, on the search queries' own histograms
against the catalog's value map; the strict vote kernels K4/K5 on their
sorted index, on each route, on synthetic rows (tol 0.1 and 2e5) and on the
catalog's own view and the search queries, with band statistics and each
case's bound from its own bands. Then the serving path (``[serve]``) on the
same catalog: ``warmup_async``, a ``RecognitionServer`` on port 0 driven
over real sockets — 128 int16 channels in 20 ms pcm ops (unpaced twice,
paced in real time, and unpaced with one score pass in flight), G.711
channels, a dialplan and an aligned group
in one tick, a continuous channel, a hangup — each TIR* held to
``search_pcm_batch`` on the same windows; the admin plane, with ranked
top-5 held to ``search_pcm_topk`` and to a numpy brute-force ranking; a
read-only replica engine following the owner's checkpoint by one
generation; and (``[cli]``) the command line in subprocesses.

Prints one line per phase, then a JSON line with each kernel's launches on
the main path, its error against its twin, its time, its twin's, and its
bound (bytes or operations over the card's published peaks), then the card's
name and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Exits non-zero, printing no result, when CUDA is unavailable or any phase
fails. Everything it writes goes to temporary directories it removes.
"""

from __future__ import annotations

import contextlib
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
N_STRICT_BRUTE = 2  # queries per mode held to the numpy brute force
# The [prefilter] phase: the certified prefilters against the full scans on
# a catalog grown to 100,000 tracks (102,400 rows at tier 1,024), where the
# JAX package expects them to pay off
N_PF_TRACKS = 100_000
N_PF_QUERIES = 64
# The [serve] path (BASELINE.json config #5: 128 simultaneous 8 kHz streams)
N_CHANNELS = 128
WINDOW = 3 * SR  # the dialplan's default duration, 3000 ms
PCM_OP = SR // 50  # one 20 ms frame per pcm op, as a PBX delivers them
SERVE_ALIGNED = {"coefs": 2, "trunc_coef1": False, "aligned": True,
                 "tolerance": STRICT_TOL}
# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM3 bytes/s,
# FP32 outside the tensor cores, int8 on the tensor cores. Each kernel's
# bound_ms is the larger of its bytes and its operations over these.
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
INT8_OPS_S = 1979e12


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
    import torch

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
    import torch

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


def device_ms(fn, reps: int = 20, attempts: int = 3, flush: bool = False,
              names: tuple | None = None):
    """Device time per call: the CUDA kernel and memory-op time
    torch.profiler records over ``reps`` calls, divided by ``reps``. With
    ``names``, a dict of each kernel name that contains one of them (the
    share of each launch of a pair). With ``flush``, the L2 cache is
    flushed before each call, and the flush is left out of the sum. A
    profile that records none of the summed time (CUPTI occasionally
    delivers none for a short window) is taken again, up to ``attempts``
    profiles (one while the previous call's profiles were all empty); then
    this call times with CUDA events instead (:func:`events_ms`), and a split
    by ``names`` is unknown (None). The clock used is appended to
    ``CLOCKS``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
                for _ in range(reps):
                    if buf is not None:
                        buf.bitwise_not_()
                    fn()
                torch.cuda.synchronize()
        per = {n: 0.0 for n in names or ("",)}
        for e in prof.key_averages():
            if buf is not None and "bitwise_not" in e.key:
                continue
            us = getattr(e, "self_device_time_total", 0)
            for n in per:
                if n in e.key:
                    per[n] += us / 1e3 / reps
        if sum(per.values()) > 0:
            CLOCKS.append("profiler")
            return per if names else per[""]
        say(f"[profiler] no CUDA device time recorded over {reps} calls")
    say(f"[profiler] no CUDA device time in {attempts} profile(s) in a "
        f"row: this call times with CUDA events (events_ms)")
    CLOCKS.append("events")
    if names:
        return dict.fromkeys(names)
    return events_ms(fn, reps, flush)


def stream_ms(fn, reps: int = 10) -> float:
    """Time per call of ``reps`` back-to-back calls on the stream, from CUDA
    events around them (after two warm-ups): device time plus whatever gaps
    the host leaves between launches. A yardstick beside ``device_ms`` that
    needs no profiler."""
    import torch

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


def topk_ms(bound) -> dict:
    """Device time of the prefilters' candidate selection (``torch.topk``
    of each query's bounds, a library call) at both candidate budgets."""
    import torch

    from tiresias_tpu_torch.ops import match_kernels as tk
    from tiresias_tpu_torch.ops import match_lattice as ml

    out = {}
    for k in (ml.LATTICE_PREFILTER_K, tk.PREFILTER_K):
        k = min(k, bound.shape[1])
        out[f"torch.topk {list(bound.shape)} int32, k={k}"] = device_ms(
            lambda: torch.topk(bound, k, dim=1))
    return out


def library_bounds(tag: str, b: int, a: int, k: int, kk: int) -> dict:
    """The bounds of the prefilters' library and plain-torch steps, from
    their shapes: ``torch.topk`` of [b, a] int32 bounds (the bounds read
    once; k int32 values and int64 indices a query written once) at both
    candidate budgets, and ``rescore_rows`` of [b, k, kk] (the gathered
    float32 rows, the int32 histograms and the int64 ids read once, the
    int32 votes written once; a compare and an add per element)."""
    from tiresias_tpu_torch.ops import match_kernels as tk
    from tiresias_tpu_torch.ops import match_lattice as ml

    out = {f"torch.topk [{b}, {a}] k={kt}": bound(4 * b * a + 12 * b * kt, 0)
           for kt in (ml.LATTICE_PREFILTER_K, tk.PREFILTER_K)}
    out[f"rescore_rows [{b}, {k}, {kk}]"] = bound(
        4 * b * k * kk + 4 * b * kk + 12 * b * k, 2 * b * k * kk)
    say(f"{tag} bounds (3.35 TB/s, 67 TFLOP/s): " + "; ".join(
        f"{n} {v['bound_ms']:.6f} ms ({v['bound_by']})"
        for n, v in out.items()))
    return {n: v["bound_ms"] for n, v in out.items()}


def pf_notes(eng) -> dict:
    """Counts of the certificates the engine notes, per prefilter mode:
    ``{mode: [certified, fell back]}`` (the engine counts the fallbacks in
    ``search.prefilter_fallbacks`` too)."""
    notes: dict = {}
    note = eng._pf_note

    def counted(view, mode, certified):
        notes.setdefault(mode, [0, 0])[0 if certified else 1] += 1
        note(view, mode, certified)

    eng._pf_note = counted
    return notes


class gates_closed:
    """Within the block every prefilter gate refuses (candidate budgets past
    any view), so the engine full-scans: the control the prefiltered path
    is held and timed against."""

    def __enter__(self):
        from tiresias_tpu_torch.ops import match_kernels as tk
        from tiresias_tpu_torch.ops import match_lattice as ml

        self.saved = (ml.LATTICE_PREFILTER_K, tk.PREFILTER_K)
        ml.LATTICE_PREFILTER_K = tk.PREFILTER_K = 10**9

    def __exit__(self, *exc):
        from tiresias_tpu_torch.ops import match_kernels as tk
        from tiresias_tpu_torch.ops import match_lattice as ml

        ml.LATTICE_PREFILTER_K, tk.PREFILTER_K = self.saved


def fallbacks() -> float:
    from tiresias_tpu_torch.utils.tracing import metrics

    return metrics.snapshot()["counters"].get("search.prefilter_fallbacks",
                                              0.0)


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


def bound(n_bytes: float, n_ops: float, peak: float | None = None) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) at HBM_BYTES_S and the
    operations at ``peak`` (default FP32_OPS_S, the non-tensor FP32 peak)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / (peak or FP32_OPS_S)
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def mfcc_ops_per_frame(n: int, n_filters: int, n_coefs: int, mel_nnz: int,
                       route: str) -> float:
    """FP32 operations per frame of the MFCC chain, from its shapes. FFT
    route: window (N), 5 M log2 M for the M = N/2-point complex FFT, ~10 M
    for the split, 3 per magnitude, 2 per mel weight, the paired DCT. DFT
    route: the window-folded DFT product (4 N (N/2+1)), the dense mel
    product (2 (N/2+1) n_filters) and the DCT."""
    m = n // 2
    dct = 2 * n_filters * n_coefs
    if route == "fft":
        return (n + 5 * m * np.log2(m) + 10 * m + 3 * (m + 1) + 2 * mel_nnz
                + dct)
    return 4 * n * (m + 1) + 2 * (m + 1) * n_filters + dct


def float64_chain(frames: np.ndarray, dsp, consts) -> np.ndarray:
    """The fingerprint of ``frames [R, N]`` in float64 numpy: the periodic
    Hann window, ``np.fft.rfft``, |.|, the mel bank, aubio's safe_log10, the
    DCT and 10*log10|.| — the same function as both kernel routes, with the
    same float32 mel and DCT tables, rounded nowhere else."""
    n = frames.shape[1]
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))

    def safe_log10(x):
        return np.where(x >= 1e-37, np.log10(np.maximum(x, 1e-37)),
                        np.log10(2e-42))

    mag = np.abs(np.fft.rfft(frames.astype(np.float64) * w, axis=1))
    mel = mag @ consts.mel_t.double().cpu().numpy()
    c = safe_log10(mel) @ consts.dct_t.double().cpu().numpy()
    return 10.0 * safe_log10(np.abs(c))


def check_float64(label: str, kernel, twin, ref64) -> dict:
    """The kernel's and the twin's distance from the float64 chain: the max
    and the RMS of |error| over the fingerprint bound. Reported, not held to
    each other: both sit at float32 output rounding (an ulp of a 30 dB value
    is 1.9e-6 dB), where they tie within noise; the hard check is the
    kernel-vs-twin bound of check_fp."""
    import torch

    ref = torch.from_numpy(ref64)
    out = {}
    for name, got in (("kernel", kernel), ("twin", twin)):
        got = got.double().cpu()
        err = (got - ref).abs()
        c = torch.pow(10.0, ref / 10.0)
        r = err / (FP_ATOL_DB * torch.clamp(FP_ATOL_C / c, min=1.0))
        out[name] = (float(err.max()), float(r.max()),
                     float(torch.sqrt((r * r).mean())))
    say(f"[kernels] {label} vs a float64 numpy rfft chain (max dB, max and "
        f"RMS over the bound): kernel {out['kernel']}, DFT-product twin "
        f"{out['twin']}")
    return {"f64_err_db": out["kernel"][0], "f64_rms_ratio": out["kernel"][2],
            "twin_f64_err_db": out["twin"][0],
            "twin_f64_rms_ratio": out["twin"][2]}


def timed_routes(label: str, fns: dict, reps: int = 20) -> dict:
    """Device times of the FFT kernel, the DFT-product kernel and the twin
    in turns (plain, dft, fft, fft, dft, plain), and the FFT kernel's
    per-call time."""
    times = {k: [] for k in fns}
    for k in ("plain", "dft", "fft", "fft", "dft", "plain"):
        times[k].append(device_ms(fns[k], reps))
    out = {k: float(np.median(v)) for k, v in times.items()}
    out["call_ms"] = call_ms(fns["fft"])
    say(f"[kernels] {label}: device FFT route {out['fft']} ms, DFT-product "
        f"route {out['dft']} ms ({out['dft'] / out['fft']:.2f}x), plain twin "
        f"{out['plain']} ms; FFT route per call incl. launch "
        f"{out['call_ms']} ms")
    return out


def phase_mfcc_kernels(device, dsp) -> list[dict]:
    """K1 and K2 on both routes against the twin, float64 and each other:
    K1 at [8192, 512] (64 queries x 128-frame bucket) and [128, 512] (one
    query), K2 at 64 x 960 frames (30 s ingest batch). The FFT stage alone
    (torch.fft.rfft of the same windowed frames) is timed as a yardstick."""
    import torch

    from tiresias_tpu_torch.ops import mfcc_kernels as mk

    consts = mk.device_constants(dsp, SR, device)
    consts_tf32 = tuple(tf32_rounded(c) for c in consts[:4])
    n, nf, nc = dsp.buf_size, dsp.n_filters, dsp.n_coefs
    mel_nnz = int((consts.mel_t != 0).sum())
    tables = sum(t.numel() * 4 for t in consts.fft)
    dft_tables = sum(t.numel() * 4 for t in consts[:4])
    win = consts.fft.win2.reshape(-1)
    k1 = {}
    for b in (64, 1):
        q = synth_tracks(b, 128 * HOP / SR, 101, device).float() / 32768.0
        frames = mk.frames_from_pcm(q, HOP, n).reshape(-1, n).contiguous()
        r = frames.shape[0]
        label = f"K1 mfcc_rows [{r}, {n}]"
        got = mk.mfcc_rows(frames, consts)
        want = mk.mfcc_rows_plain(frames, consts)
        err = check_fp(label, got, want, mk.mfcc_rows_plain(
            tf32_rounded(frames), consts_tf32))
        dft_err = check_fp(f"{label} DFT-product route",
                           mk.mfcc_rows_dft(frames, consts), want,
                           mk.mfcc_rows_plain(tf32_rounded(frames),
                                              consts_tf32))
        f64 = check_float64(label, got, want, float64_chain(
            frames.cpu().numpy(), dsp, consts))
        t = timed_routes(label, {
            "fft": lambda: mk.mfcc_rows(frames, consts),
            "dft": lambda: mk.mfcc_rows_dft(frames, consts),
            "plain": lambda: mk.mfcc_rows_plain(frames, consts),
        })
        xw = frames * win
        t["fft_stage_ms"] = device_ms(lambda: torch.fft.rfft(xw))
        say(f"[kernels] yardstick, FFT stage alone: torch.fft.rfft of the "
            f"{r} windowed frames {t['fft_stage_ms']} ms (not the chain; "
            f"not used by the port)")
        io = r * n * 4 + r * nc * 4
        k1[r] = dict(t, err=err, dft_err=dft_err, **f64,
                     fft_bound=bound(io + tables, r * mfcc_ops_per_frame(
                         n, nf, nc, mel_nnz, "fft")),
                     dft_bound=bound(io + dft_tables, r * mfcc_ops_per_frame(
                         n, nf, nc, mel_nnz, "dft")))
    big, one = k1[8192], k1[128]
    # K2: 64 x 30 s signals in the ingest frame bucket (938 -> 960 frames)
    pcm = synth_tracks(64, 960 * HOP / SR, 102, device).float() / 32768.0
    label = f"K2 mfcc_framed [64, {pcm.shape[1]}]"
    got = mk.mfcc_framed(pcm, consts, HOP, n)
    want = mk.mfcc_framed_plain(pcm, consts, HOP, n)
    control = mk.mfcc_framed_plain(tf32_rounded(pcm), consts_tf32, HOP, n)
    k2_err = check_fp(label, got, want, control)
    k2_dft_err = check_fp(f"{label} DFT-product route",
                          mk.mfcc_framed_dft(pcm, consts, HOP, n), want,
                          control)
    del control
    frames = mk.frames_from_pcm(pcm, HOP, n).reshape(-1, n)
    sub = slice(0, 8192)  # the float64 chain on the first 8192 frames
    k2_f64 = check_float64(label + " (first 8192 frames)",
                           got.reshape(-1, nc)[sub], want.reshape(-1, nc)[sub],
                           float64_chain(frames[sub].cpu().numpy(), dsp,
                                         consts))
    k2 = timed_routes(label, {
        "fft": lambda: mk.mfcc_framed(pcm, consts, HOP, n),
        "dft": lambda: mk.mfcc_framed_dft(pcm, consts, HOP, n),
        "plain": lambda: mk.mfcc_framed_plain(pcm, consts, HOP, n),
    }, reps=10)
    xw = frames * win
    k2["fft_stage_ms"] = device_ms(lambda: torch.fft.rfft(xw), 10)
    say(f"[kernels] yardstick, FFT stage alone: torch.fft.rfft of the "
        f"{frames.shape[0]} windowed frames {k2['fft_stage_ms']} ms (not the "
        f"chain; not used by the port)")
    r2 = frames.shape[0]
    io2 = pcm.numel() * 4 + r2 * nc * 4
    k2_fft_bound = bound(io2 + tables, r2 * mfcc_ops_per_frame(
        n, nf, nc, mel_nnz, "fft"))
    k2_dft_bound = bound(io2 + dft_tables, r2 * mfcc_ops_per_frame(
        n, nf, nc, mel_nnz, "dft"))
    del pcm, frames, xw
    for name, t, bd in (("K1 [8192, 512]", big, big["fft_bound"]),
                        ("K1 [128, 512]", one, one["fft_bound"]),
                        ("K2 64 x 960", k2, k2_fft_bound)):
        say(f"[kernels] {name} FFT route: {t['fft']} ms against a bound of "
            f"{bd['bound_ms']:.5f} ms ({bd['bound_by']}), "
            f"{100 * bd['bound_ms'] / t['fft']:.1f}% of it")
    none = "no single PyTorch call computes the MFCC chain"
    return [
        {"name": "mfcc_rows", "route": "cuda",
         "source": "tiresias_tpu_torch/csrc/mfcc_fft.cu",
         "replaces": "tiresias_tpu/ops/mfcc_pallas.py:171",
         "max_abs_err": big["err"], "ms": big["fft"],
         "plain_ms": big["plain"], **big["fft_bound"], "library_ms": None,
         "library": none, "shape": "[8192, 512]",
         "ms_128_rows": one["fft"], "bound_ms_128_rows":
             one["fft_bound"]["bound_ms"],
         "fft_stage_ms": big["fft_stage_ms"],
         **{k: v for k, v in big.items() if "f64" in k}},
        {"name": "mfcc_framed", "route": "cuda",
         "source": "tiresias_tpu_torch/csrc/mfcc_fft.cu",
         "replaces": "tiresias_tpu/ops/mfcc_pallas.py:217",
         "max_abs_err": k2_err, "ms": k2["fft"], "plain_ms": k2["plain"],
         **k2_fft_bound, "library_ms": None, "library": none,
         "shape": "64 x 960 frames", "fft_stage_ms": k2["fft_stage_ms"],
         **k2_f64},
        {"name": "mfcc_rows_dft", "route": "cuda",
         "source": "tiresias_tpu_torch/csrc/mfcc.cu",
         "replaces": "tiresias_tpu/ops/mfcc_pallas.py:171",
         "max_abs_err": big["dft_err"], "ms": big["dft"],
         "plain_ms": big["plain"], **big["dft_bound"], "library_ms": None,
         "library": none, "shape": "[8192, 512]",
         "ms_128_rows": one["dft"],
         "note": "route for windows that are no power of two in 64-4096"},
        {"name": "mfcc_framed_dft", "route": "cuda",
         "source": "tiresias_tpu_torch/csrc/mfcc.cu",
         "replaces": "tiresias_tpu/ops/mfcc_pallas.py:217",
         "max_abs_err": k2_dft_err, "ms": k2["dft"], "plain_ms": k2["plain"],
         **k2_dft_bound, "library_ms": None, "library": none,
         "shape": "64 x 960 frames",
         "note": "route for windows that are no power of two in 64-4096"},
    ]


def phase_kernels(device, dsp) -> list[dict]:
    """Each kernel against its twin at the main path's shapes."""
    import torch

    from tiresias_tpu_torch.ops import match_lattice as ml

    out = phase_mfcc_kernels(device, dsp)
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
            for cap in (5, None):  # counts < 6: one u8 plane; or four
                if not torch.equal(ml.hit_votes(counts, vm, tol, cap),
                                   ml.lattice_votes_reference(counts, vm,
                                                              tol)):
                    fail(f"K3' lattice_votes != twin at B={b} tol={tol} "
                         f"max_count={cap}")
        say(f"[kernels] K3' lattice_votes [{b}, 640] x [{rows}, 640] dense "
            f"counts: votes exact at tol 0.001 and 1.0, 1 and 4 planes")
        times[b] = timed(
            f"K3' lattice_votes dense B={b}",
            lambda: ml.hit_votes(counts, vm, 1.0, 5),
            lambda: ml.lattice_votes_reference(counts, vm, 1.0),
        )
    # dense counts touch every bucket: the whole map is read once, and the
    # contraction is 2 B rows K int8 tensor-core operations
    lattice_bound = bound(4 * (64 * ml.K_SIZE + rows * ml.K_SIZE + 64 * rows),
                          2 * 64 * rows * ml.K_SIZE, INT8_OPS_S)
    out.append({
        "name": "lattice_votes", "route": "cuda",
        "source": "tiresias_tpu_torch/csrc/lattice.cu",
        "replaces": "tiresias_tpu/ops/match_lattice.py:369",
        "max_abs_err": 0.0, "ms": times[64]["ms"],
        "plain_ms": times[64]["plain_ms"], **lattice_bound,
        "library_ms": None,
        "library": "no single PyTorch call computes the tolerance-hit count",
        "shape": f"dense counts, B=64 x {rows} rows x 640 buckets",
    })
    # the dialplan prefilter's uint8 map of the same distances: padding
    # rows on the 255 sentinel
    vmq = ml.quantize_value_map(vm * 0.5)
    # bound_scan on that uint8 map from raw query values: 1,920 frames a
    # query, three in every bucket (dense counts), and two NaN and an
    # out-of-lattice frame in the last query
    inf = float("inf")
    ctx = torch.randint(0, 3, (rows,), generator=g, device=device,
                        dtype=torch.int32)
    for b in (64, 1):
        q0 = (torch.arange(3 * ml.K_SIZE, device=device) % ml.K_SIZE
              + ml.K_MIN + 0.5).float().repeat(b, 1)
        q0[-1, :3] = torch.tensor([float("nan"), inf, 1e9], device=device)
        valid = torch.ones_like(q0, dtype=torch.bool)
        for tol in (0.001, 0.5, 3.984375, 10.0):
            check_scan(f"dialplan dense B={b} tol {tol}",
                       ml.dialplan_scan(tol, -inf, inf), (vmq,), q0, valid,
                       ctx_ids=ctx, ctx_id=1)
        SCAN[f"dialplan dense B={b}"] = time_scan(
            f"dialplan dense [{b}, {q0.shape[1]}] frames x [{rows}, 640] "
            f"uint8 B={b} tol 0.5", ml.dialplan_scan(0.5, -inf, inf), (vmq,),
            q0, valid)
    say("[kernels] bound_scan dialplan dense: bound and histogram exact "
        "against the twin at tol 0.001, 0.5, 3.984375 (saturation) and 10, "
        "with and without a context")
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


def match_edge_case(device):
    """Stored values next to fl(q0 ± tol) for tol 0.1, ±0.0, ±inf and NaN
    stored frames, a row whose frames share one d0, and ±inf, ±0.0, NaN and
    huge query values: (db, prepared query)."""
    import torch

    from tiresias_tpu_torch.ops import match as tm
    from tiresias_tpu_torch.ops.mfcc import PAD_VALUE

    g = np.random.default_rng(5)
    db = g.uniform(-3, 3, (64, 256, 2)).astype(np.float32)
    db[1] = PAD_VALUE
    db[2, :, 0] = 0.5
    for k, v in enumerate((np.inf, -np.inf, np.nan, -0.0, 0.0)):
        db[3, k::7, 0] = v
    q = g.uniform(-3, 3, (6, 40, 2)).astype(np.float32)
    q[0, :10, 0] = [np.inf, -np.inf, 0.0, -0.0, 0.5, np.nan, 1e-8, -1e-8,
                    3e38, -3e38]
    q[1, :, 0] = 0.5
    tol = np.float32(0.1)
    for i in range(20):
        for s, e in enumerate((np.float32(q[2, i, 0] + tol),
                               np.float32(q[2, i, 0] - tol))):
            for k in range(-2, 3):
                d = e
                for _ in range(abs(k)):
                    d = np.nextafter(d, np.float32(np.inf * np.sign(k)))
                db[4 + i, 50 + 5 * s + k + 2, 0] = d
    dbt = torch.from_numpy(db).to(device)
    return dbt, tm.prepare_query(torch.from_numpy(q).to(device), None, -1, -1,
                                 trunc_coef1=False)


def band_stats(index, q, active, use2, tol: float, cand=None) -> dict:
    """In-band stored frames per (active query frame, row), summed over the
    index chunks, from the index's own binary search: mean, p99, max, the
    total (the in-band pairs) and the active frames; the pairs a bag
    search must test, up to and including each band's first entry that
    also passes coefficient 1 (``walked``); and the binary-search compares
    (``probes``). With ``cand [B, k]`` the rows of query b are its
    candidates only (the candidate form's work)."""
    import torch

    from tiresias_tpu_torch.ops import match_index as mi

    hist = torch.zeros(index.chunk * index.n_chunks + 1, dtype=torch.int64,
                       device=q.device)
    walked, probes = 0, 0.0
    steps = 2 * torch.ceil(torch.log2(index.n_live.double() + 1)).sum(dim=1)
    u = torch.arange(index.chunk, device=q.device)
    for lo in range(q.shape[0]):
        s = slice(lo, lo + 1)
        rows = slice(None) if cand is None else cand[lo].long()
        sub = index if cand is None else mi.MatchIndex(
            index.entries[rows], index.pos[rows], index.n_live[rows],
            index.chunk, index.t_len)
        b0, b1 = mi.band_bounds_plain(sub, q[s, :, 0], tol)
        d1 = sub.entries[..., 1][None, None]
        probes += int(active[s].sum()) * float(steps[rows].sum())
        w = (b1 - b0).sum(dim=-1)[active[s]]  # [frames, rows]
        hist += torch.bincount(w.reshape(-1), minlength=hist.shape[0])
        hit = (u >= b0[..., None]) & (u < b1[..., None])
        hit &= ((d1 - q[s, :, 1][:, :, None, None, None]).abs() <= tol) | (
            ~use2[s][:, :, None, None, None])
        first = torch.where(hit.any(dim=-1), hit.int().argmax(dim=-1) - b0 + 1,
                            b1 - b0)
        walked += int(first.sum(dim=-1)[active[s]].sum())
        del hit
    n = int(hist.sum())
    vals = torch.arange(hist.shape[0], device=q.device)
    pairs = int((hist * vals).sum())
    cum = torch.cumsum(hist, 0)
    p99 = int(torch.searchsorted(cum, torch.tensor(0.99 * n,
                                                   device=q.device)))
    used = (index.n_live if cand is None
            else index.n_live[torch.unique(cand.long())])
    return {"mean": pairs / max(n, 1), "p99": p99,
            "max": int(vals[hist > 0].max()) if n else 0, "pairs": pairs,
            "walked": walked, "active_frames": int(active.sum()),
            "live": int(used.sum()), "probes": probes,
            "rows": int(index.n_live.shape[0] if cand is None
                        else cand.shape[1]),
            "cand_bytes": 0 if cand is None else 4 * cand.numel()}


def scan_bound(scans, maps, q, active, use2=None, ctx_ids=None) -> dict:
    """``bound_scan``'s bounds from this run's inputs (bytes), of the pair
    and of each kernel: the map bytes across the 32-bucket steps some query
    counts in (the kernel reads no other map byte), the query column each
    map buckets, ``active`` once, ``use2`` once where a map bypasses, the
    context ids when given, the int32 bound written once; the prologue
    writes and the vote kernel reads the u8 planes of those steps. The
    steps come from the twin's histograms."""
    import torch

    from tiresias_tpu_torch.ops import match_lattice as ml

    q3 = q if q.ndim == 3 else q[..., None]
    b, f = active.shape
    planes = ml.count_planes(f)
    steps = []
    for sp, c in zip(scans, ml.scan_histograms(scans, q3, active, use2)):
        n = -(-sp.k_size // ml.STEP)
        flagged = torch.nn.functional.pad(c.any(dim=0),
                                          (0, n * ml.STEP - sp.k_size))
        steps.append(int(flagged.reshape(n, ml.STEP).any(dim=1).sum()))
    q_bytes = (4 * b * f * len(scans) + b * f
               + (b * f if any(sp.bypass for sp in scans) else 0))
    map_bytes = sum(min(ml.STEP * n, sp.k_size) * m.shape[0]
                    for n, sp, m in zip(steps, scans, maps))
    plane_bytes = planes * b * ml.STEP * sum(steps)
    votes = 4 * b * maps[0].shape[0]
    ctx = 0 if ctx_ids is None else ctx_ids.numel() * ctx_ids.element_size()
    return {"pair": bound(q_bytes + map_bytes + ctx + votes, 0),
            "planes": bound(q_bytes + plane_bytes, 0),
            "votes": bound(map_bytes + plane_bytes + ctx + votes, 0),
            "steps": steps, "map_bytes": map_bytes}


# bound_scan's timings by case, filled by the phases that run them
SCAN: dict = {}


def check_scan(label: str, scans, maps, q, active, use2=None, ctx_ids=None,
               ctx_id=None) -> None:
    """``bound_scan`` == its twin (bound and first-map histogram), int32
    for int32, with and without the context."""
    import torch

    from tiresias_tpu_torch.ops import match_lattice as ml

    for cid in ((None, ctx_id) if ctx_ids is not None else (None,)):
        ids = None if cid is None else ctx_ids
        got, c = ml.bound_scan(scans, maps, q, active, use2, ids, cid, True)
        want, want_c = ml.bound_scan_reference(scans, maps, q, active, use2,
                                               ids, cid, True)
        if not (torch.equal(got, want) and torch.equal(c, want_c)):
            fail(f"bound_scan != its twin: {label} ctx {cid}")


def time_scan(label: str, scans, maps, q, active, use2=None, ctx_ids=None,
              ctx_id=None, reps: int = 20) -> dict:
    """``bound_scan`` timed twice: device ms (profiler; the pair's two
    kernels summed per profile), stream ms (CUDA events over back-to-back
    calls) and device ms with the L2 flushed before each call
    (:func:`events_ms`); the twin's device time, whole and by its two
    stages (the histograms; the votes, credit, min and mask); the split
    between the pair's two kernels; the clock the device times came from
    (:data:`CLOCKS`); and the bound from these inputs. Each call masks the
    context when ``ctx_ids`` is given."""
    from tiresias_tpu_torch.ops import match_lattice as ml

    n0 = len(CLOCKS)

    def new():
        return ml.bound_scan(scans, maps, q, active, use2, ctx_ids, ctx_id)

    # the pair's device time is the sum of its two kernels in each profile
    names = ("bound_scan_planes_kernel", "bound_scan_kernel")
    turns = []
    splits = []
    for _ in range(2):
        splits.append(device_ms(new, reps, names=names))
        dev = (sum(splits[-1].values()) if None not in splits[-1].values()
               else events_ms(new, reps))
        turns.append((dev, stream_ms(new, reps),
                      events_ms(new, reps // 2, flush=True)))
    med = [float(np.median([t[i] for t in turns])) for i in range(3)]
    split = {n: (float(np.median([sp[n] for sp in splits]))
                 if None not in [sp[n] for sp in splits] else None)
             for n in names}
    twin = device_ms(lambda: ml.bound_scan_reference(
        scans, maps, q, active, use2, ctx_ids, ctx_id), 5)
    q3 = q if q.ndim == 3 else q[..., None]
    counts = ml.scan_histograms(scans, q3, active, use2)
    twin_planes = device_ms(lambda: ml.scan_histograms(scans, q3, active,
                                                       use2), 5)
    twin_votes = device_ms(lambda: ml.scan_votes_reference(
        scans, maps, counts, active, use2, ctx_ids, ctx_id), 5)
    bd = scan_bound(scans, maps, q, active, use2, ctx_ids)
    out = {"ms": med[0], "stream_ms": med[1], "cold_ms": med[2],
           "planes_ms": split["bound_scan_planes_kernel"],
           "votes_ms": split["bound_scan_kernel"], "plain_ms": twin,
           "plain_planes_ms": twin_planes, "plain_votes_ms": twin_votes,
           "clock": clocks_since(n0),
           **bd["pair"], "planes_bound_ms": bd["planes"]["bound_ms"],
           "votes_bound_ms": bd["votes"]["bound_ms"], "steps": bd["steps"],
           "map_bytes": bd["map_bytes"],
           "turns": [list(t) for t in turns]}
    say(f"[kernels] bound_scan {label}: device {out['ms']} ms (planes "
        f"{out['planes_ms']}, votes {out['votes_ms']}), stream "
        f"{out['stream_ms']} ms, L2 flushed {out['cold_ms']} ms; twin "
        f"{twin} ms (histograms {twin_planes}, votes {twin_votes}); "
        f"device clock {out['clock']}; bound {out['bound_ms']:.6f} ms "
        f"({out['bound_by']}: {bd['map_bytes']} map bytes in "
        f"{bd['steps']} flagged steps, queries, votes), "
        f"{100 * out['bound_ms'] / out['ms']:.1f}% of it warm, "
        f"{100 * out['bound_ms'] / out['cold_ms']:.1f}% flushed; turns "
        f"(device, stream, flushed) {out['turns']}")
    return out


def index_bound(index, stats: dict, b: int, f: int, aligned: bool,
                coefs: int = 2) -> dict:
    """The bound of one index search: the live index entries read once (10
    bytes each), the queries and the votes; two binary searches per
    (active query frame, row, chunk), one compare per step, plus 4
    operations per pair tested: every in-band pair (aligned), or up to each
    band's first hit (bag)."""
    n_bytes = (10 * stats["live"] + b * (coefs + 2) * f * 4
               + b * stats["rows"] * 4 + stats["cand_bytes"])
    tested = stats["pairs"] if aligned else stats["walked"]
    return bound(n_bytes, stats["probes"] + 4 * tested)


def routes_delta(device, fn) -> tuple:
    """The work items of each route one call of ``fn`` adds: (K4 index, K4
    dense, K5 index, K5 dense)."""
    import torch

    from tiresias_tpu_torch.ops import match_kernels as tk

    before = tk.route_counts(device).clone()
    fn()
    torch.cuda.synchronize(device)
    return tuple((tk.route_counts(device) - before).tolist())


def timed_match(label: str, fns: dict, plain=None, plain_reps: int = 2,
                reps: int = 10, events: bool = False):
    """Device times of the auto route and the forced dense route (and the
    forced index route, and the candidate form's "per_item" and "grouped"
    forms, when ``fns`` has them) in turns, two rounds, and of the twin
    around them when given. With ``events``, each turn also takes the
    CUDA-event time of back-to-back calls (``stream_ms``), printed with
    both rounds of both clocks: a check on the profiler's sums."""
    extra = [k for k in ("index", "per_item", "grouped") if k in fns]
    order = ["dense", "auto"] + extra
    times = {k: [] for k in order}
    ev = {k: [] for k in order}
    if plain is not None:
        times["plain"] = [device_ms(plain, plain_reps)]
    for k in order + order[::-1]:
        times[k].append(device_ms(fns[k], reps))
        if events:
            ev[k].append(stream_ms(fns[k], reps))
    if plain is not None:
        times["plain"].append(device_ms(plain, plain_reps))
    out = {k: float(np.median(v)) for k, v in times.items()}
    if events:
        out["stream"] = {k: float(np.median(v)) for k, v in ev.items()}
        say(f"[kernels] {label}: rounds, device (profiler) / stream (CUDA "
            f"events) ms: " + "; ".join(
                f"{k} {times[k]} / {ev[k]}" for k in order))
    say(f"[kernels] {label}: device {out['auto']} ms, dense route "
        f"{out['dense']} ms ({out['dense'] / out['auto']:.2f}x)"
        + "".join(f", {k.replace('_', '-')} {'route' if k == 'index' else 'form'}"
                  f" {out[k]} ms" for k in extra)
        + (f", plain twin {out['plain']} ms" if plain is not None else ""))
    return out


def say_bands(label: str, st: dict, routes: tuple, aligned: bool) -> None:
    idx, dense = routes[2:] if aligned else routes[:2]
    share = 100 * st["mean"] * st["rows"] / max(1, st["live"])
    say(f"[kernels] {label} bands: {st['mean']:.3f} in-band frames per "
        f"(active query frame, row) on average ({share:.2f}% of a row's "
        f"live frames), p99 {st['p99']}, max {st['max']}; items on the "
        f"index route {idx}, on the dense route {dense} "
        f"({100 * dense / max(1, idx + dense):.1f}% dense)")


def phase_match_kernels(device) -> list[dict]:
    """K4 and K5 against their twin, int32 exact, on each route (auto,
    forced dense, forced index): coefs 1, 2, 4 and 8, the band filter off
    and on (on: q0 frames dropped and q1 conditions bypassed), tolerances
    0.05, 1 and 2e5 (past the Pallas kernels' masking limit), tiers of 256,
    1,536 and 5,000 frames (three index chunks), 24-, 300- and 40-frame
    queries, and stored values at the edges of fl(q0 ± tol). Then, at the
    [strict] shapes: the index build, and both kernels' times on the auto
    and the dense route in turns, with band statistics and each case's
    bound, at tol 0.1 (case a) and 2e5 (case c) on uniform rows, and at tol
    0.1 on rows with a narrow coefficient 0 (cases d and e, with the index
    route timed too), batch 64 and 1."""
    import torch

    from tiresias_tpu_torch.ops import match as tm
    from tiresias_tpu_torch.ops import match_index as mi
    from tiresias_tpu_torch.ops import match_kernels as tk
    from tiresias_tpu_torch.ops.mfcc import PAD_VALUE

    fns = {False: tk.match_votes_fused, True: tk.match_votes_fused_aligned}
    checked = 0

    def check(db, qq, act, use2, tol, coefs, tag):
        nonlocal checked
        index = mi.build_match_index(db)
        mask = (db[..., 0] != PAD_VALUE) & ~torch.isnan(db[..., 0])
        for aligned, fn in fns.items():
            want = tm.match_votes(db, mask, qq, act, use2, tol, coefs=coefs,
                                  aligned=aligned)
            for route in ("auto", "dense", "index"):
                got = fn(db, qq, act, use2, tol, coefs, index=index,
                         route=route)
                if not torch.equal(got, want):
                    bad = (got != want).nonzero()[0].tolist()
                    fail(f"K{5 if aligned else 4} != twin on the {route} "
                         f"route at {tag} tol {tol}: [{bad}] "
                         f"{got[bad[0], bad[1]]} vs {want[bad[0], bad[1]]}")
                checked += 1
            if tol == 1.0 and tag[-1] == (-1, -1) and not (want > 0).any():
                fail(f"K4/K5 check at {tag} has no votes")

    for coefs in (1, 2, 4, 8):
        for rows, t, f in ((200, 256, 24), (300, 1536, 300), (40, 5000, 40)):
            db, q, n_frames = match_case(device, 200 + coefs + t, rows, t,
                                         8, 5, f)
            for band in ((-1, -1), (1, 300)):
                qq, act, use2 = tm.prepare_query(q, n_frames, *band,
                                                 trunc_coef1=False)
                for tol in (0.05, 1.0, 2e5):
                    check(db, qq, act, use2, tol, coefs,
                          (coefs, t, f, band))
    db, (qq, act, use2) = match_edge_case(device)
    for tol in (0.0, 0.1, 1.0, float("inf")):
        check(db, qq, act, use2, tol, 2, ("edge values",))
    say(f"[kernels] K4 match_votes / K5 match_votes_aligned == twins (int32 "
        f"exact) in {checked} cases: routes auto, dense and index x coefs "
        f"1, 2, 4, 8 x band off/on x tol 0.05, 1, 2e5; tiers 256, 1536 and "
        f"5000 (3 index chunks), queries of 24, 300 and 40 frames; edge "
        f"values at tol 0, 0.1, 1, inf")
    # [strict] shapes: 10,112 rows (10,000 tracks of 938 frames, 128-row
    # padding) x 1,024 frames x 2 coefs; 94 active frames in a 128 bucket
    db, _, _ = match_case(device, 300, 10112, 1024, 2, 2, 128,
                          live_frames=938)
    db[10000:] = PAD_VALUE
    index = mi.build_match_index(db)
    build_ms = device_ms(lambda: mi.build_match_index(db), 5)
    say(f"[kernels] build_match_index [10112, 1024, 2]: device {build_ms} ms "
        f"({index.entries.numel() * 4 + index.pos.numel() * 2} B of index)")
    mask = db[..., 0] != PAD_VALUE
    # (d), (e): the same live frames with coefficient 0 drawn narrow, as in
    # a catalog of speech-like tracks: N(-10, 0.6) dB (bands ~9% of a row)
    # and N(-10, 0.22) dB with coefficient 1 N(-5, 0.6) dB (bands ~25%, with
    # few coefficient-1 hits); their queries are stored frames of 100 rows
    g = torch.Generator(device=device).manual_seed(305)
    narrow = {}
    for case, sd0 in (("d", 0.6), ("e", 0.22)):
        dn = db.clone()
        dn[..., 0] = torch.randn(dn.shape[:2], generator=g,
                                 device=device) * sd0 - 10.0
        if case == "e":
            dn[..., 1] = torch.randn(dn.shape[:2], generator=g,
                                     device=device) * 0.6 - 5.0
        dn[~mask] = PAD_VALUE
        narrow[case] = (dn, mi.build_match_index(dn))
    res = {}
    for b in (64, 1):
        _, q, _ = match_case(device, 301 + b, 256, 256, 2, b, 128)
        qq, act, use2 = tm.prepare_query(q, np.full(b, 94), -1, -1,
                                         trunc_coef1=False)
        cases = [("a", db, index, qq, STRICT_TOL), ("c", db, index, qq, 2e5)]
        for case, (dn, idn) in narrow.items():
            qn = qq.clone()
            qn[..., :2] = dn[torch.arange(b, device=device) % 100, 5:133, :2]
            cases.append((case, dn, idn, qn, STRICT_TOL))
        for case, d, idx, qc, tol in cases:
            st = band_stats(idx, qc, act, use2, tol)
            for aligned, fn in fns.items():
                name = f"K{5 if aligned else 4} {fn.__name__} ({case}) B={b}"
                routes_timed = ("auto", "dense") + (
                    ("index",) if case in "de" else ())
                call = {r: (lambda r=r: fn(d, qc, act, use2, tol, 2,
                                           index=idx, route=r))
                        for r in routes_timed}
                plain = None
                if case == "a":
                    plain = (lambda al=aligned: tm.match_votes(
                        db, mask, qq, act, use2, tol, coefs=2, aligned=al))
                t = timed_match(name, call, plain, reps=10 if b > 1 else 50)
                routes = routes_delta(device, call["auto"])
                say_bands(name, st, routes, aligned)
                res[case, aligned, b] = dict(t, routes=routes, stats=st,
                                             bound=index_bound(idx, st, b,
                                                               128, aligned))
                bd = res[case, aligned, b]["bound"]
                say(f"[kernels] {name}: bound {bd['bound_ms']:.5f} ms "
                    f"({bd['bound_by']}) from this run's bands, "
                    f"{100 * bd['bound_ms'] / t['auto']:.1f}% of it")
    del narrow
    # the strict/aligned prefilter's bound maps (10,112 x 768 per
    # coefficient) and 64 queries
    from tiresias_tpu_torch.ops import match_lattice as ml

    _, q, _ = match_case(device, 301 + 64, 256, 256, 2, 64, 128)
    qq, act, use2 = tm.prepare_query(q, np.full(64, 94), -1, -1,
                                     trunc_coef1=False)
    specs, maps = ml.build_bound_maps(db, mask, 2)
    maps_ms = device_ms(lambda: ml.build_bound_maps(db, mask, 2), 3)
    say(f"[kernels] bound maps {len(maps)} x {list(maps[0].shape)} uint8 "
        f"built in {maps_ms} ms of device time")
    # bound_scan, the strict prefilter's bound stage, on those maps and
    # queries: the twin at every tolerance, context or not, then timed (the
    # K-a row's case)
    g = torch.Generator(device=device).manual_seed(107)
    ctx = torch.randint(0, 3, (db.shape[0],), generator=g, device=device,
                        dtype=torch.int32)
    for tol in (0.01, STRICT_TOL, 0.5, 2.0):
        for b in (64, 1):
            check_scan(f"synthetic bound maps B={b} tol {tol}",
                       ml.strict_scan(specs, tol), maps, qq[:b], act[:b],
                       use2[:b], ctx, 1)
    say(f"[kernels] bound_scan on the bound maps ({len(maps)} x "
        f"{list(maps[0].shape)} uint8) with 64 and 1 synthetic queries: "
        f"bound and histogram exact against the twin at tol 0.01, 0.1, 0.5 "
        f"and 2.0 (past saturation), with and without a context")
    SCAN["strict synthetic B=64"] = time_scan(
        f"strict synthetic 2 x {list(maps[0].shape)} B=64 tol 0.1",
        ml.strict_scan(specs, STRICT_TOL), maps, qq, act, use2)
    del maps
    # every live stored frame (10,000 rows x 938) against each of the 94
    # active frames of 64 queries: a subtract and a compare per coefficient
    pairs = 64 * 10000 * 938 * 94
    dense_bound = bound(db.numel() * 4 + 64 * 128 * 2 * 4 + 64 * 10112 * 4,
                        pairs * 2 * 2)
    out = []
    none = "no single PyTorch call computes tolerance votes"
    for aligned, name, line in ((False, "match_votes", 58),
                                (True, "match_votes_aligned", 171)):
        a64, a1 = res["a", aligned, 64], res["a", aligned, 1]
        c64 = res["c", aligned, 64]
        out.append({
            "name": name, "route": "cuda",
            "source": "tiresias_tpu_torch/csrc/match.cu",
            "replaces": f"tiresias_tpu/ops/match_pallas.py:{line}",
            "max_abs_err": 0.0, "ms": a64["auto"],
            "plain_ms": a64["plain"], **a64["bound"], "library_ms": None,
            "library": none,
            "shape": "B=64 x 10,112 rows x 1,024 frames x 2 coefs, tol 0.1",
            "dense_route_ms": a64["dense"], "dense_bound_ms":
                dense_bound["bound_ms"], "ms_b1": a1["auto"],
            "dense_route_ms_b1": a1["dense"], "bound_ms_b1":
                a1["bound"]["bound_ms"], "ms_tol_2e5": c64["auto"],
            "dense_route_ms_tol_2e5": c64["dense"],
            "bands": {k: v for k, v in a64["stats"].items()},
            "index_build_ms": build_ms,
        })
    out.append({
        "name": "match_votes_aligned_dense", "route": "cuda",
        "source": "tiresias_tpu_torch/csrc/match.cu",
        "replaces": "tiresias_tpu/ops/match_pallas.py:171",
        "max_abs_err": 0.0, "ms": res["a", True, 64]["dense"],
        "plain_ms": res["a", True, 64]["plain"], **dense_bound,
        "library_ms": None, "library": none,
        "shape": "every (query, row) item: B=64 x 10,112 rows x 1,024 "
                 "frames x 2 coefs (K5's forced dense route, both kernels)",
        "ms_tol_2e5": res["c", True, 64]["dense"],
    })
    return out


def phase_match_real(device, eng, queries) -> list[dict]:
    """K4 and K5 on the traffic the strict path sends (case b): the restored
    catalog's own view and index, the 64 excerpts + 8 noise queries at tol
    0.1, batch 64 and 1; int32-exact against the twin on every route, then
    the auto and dense routes in turns, with band statistics, route shares
    and this run's bound."""
    import torch

    from tiresias_tpu_torch.ops import match as tm
    from tiresias_tpu_torch.ops import match_kernels as tk
    from tiresias_tpu_torch.ops.mfcc import (
        fingerprint_padded_batch,
        pad_frames_bucket,
    )

    (view,) = eng.store.search_views()
    index = eng.store.match_index_for(view)
    padded, n_frames = pad_frames_bucket(queries, HOP)
    qfp = fingerprint_padded_batch(padded, SR, eng.config.dsp, device=device)
    q, active, use2 = tm.prepare_query(qfp, n_frames, -1, -1,
                                       trunc_coef1=False)
    f = q.shape[1]
    fns = {False: tk.match_votes_fused, True: tk.match_votes_fused_aligned}
    for b in (64, 1):
        qq, act, u2 = q[:b], active[:b], use2[:b]
        st = band_stats(index, qq, act, u2, STRICT_TOL)
        for aligned, fn in fns.items():
            name = (f"K{5 if aligned else 4} {fn.__name__} (b) real catalog "
                    f"B={b}")
            want = tm.match_votes(view.db, view.mask, qq, act, u2,
                                  STRICT_TOL, coefs=2, aligned=aligned)
            call = {r: (lambda r=r: fn(view.db, qq, act, u2, STRICT_TOL, 2,
                                       index=index, route=r))
                    for r in ("auto", "dense", "index")}
            for r, c in call.items():
                if not torch.equal(c(), want):
                    fail(f"{name}: the {r} route != twin")
            t = timed_match(name, call, reps=10 if b > 1 else 50)
            routes = routes_delta(device, call["auto"])
            say_bands(name, st, routes, aligned)
            bd = index_bound(index, st, b, f, aligned)
            say(f"[kernels] {name}: bound {bd['bound_ms']:.5f} ms "
                f"({bd['bound_by']}), {100 * bd['bound_ms'] / t['auto']:.1f}%"
                f" of it; votes exact on the auto, dense and index routes")
    out = phase_match_cand(device, eng, view, index, q, active, use2, f)
    phase_cand_sharing(device, view, q[:64], active[:64], use2[:64])
    return out


def phase_cand_sharing(device, view, q, act, use2) -> None:
    """The candidate forms by how many queries share each row: the
    catalog's view repeated 7 times (70,784 rows, so 64 x 1,024 slots can
    fall on distinct rows), each group of s queries on one list of 1,024
    rows (lists disjoint), s = 1, 2, 4, 8 and 64; the grouped form's auto,
    dense and index routes and the per-item form, exact against the full
    kernels' votes at those rows, timed in turns. The crossover of K5's
    routes sets CAND_SHARED (ops/match_kernels.py)."""
    import torch

    from tiresias_tpu_torch.ops import match_index as mi
    from tiresias_tpu_torch.ops import match_kernels as tk

    db = view.db.repeat(7, 1, 1).contiguous()
    index = mi.build_match_index(db)
    g = torch.Generator(device=device).manual_seed(109)
    perm = torch.randperm(db.shape[0], generator=g, device=device)
    fns = {False: tk.match_votes_fused, True: tk.match_votes_fused_aligned}
    full = {al: fn(db, q, act, use2, STRICT_TOL, 2, index=index)
            for al, fn in fns.items()}
    for s in (1, 2, 4, 8, 64):
        lists = perm[: 64 // s * 1024].reshape(64 // s, 1024)
        cand = lists[torch.arange(64, device=device) // s].to(
            torch.int32).contiguous()
        for al in (False, True):
            want = full[al].gather(1, cand.long())
            call = {r: (lambda r=r, al=al: tk.match_votes_cand(
                        db, q, act, use2, STRICT_TOL, cand, 2, index=index,
                        route=r, aligned=al))
                    for r in ("auto", "dense", "index", "per_item")}
            for r, c in call.items():
                if not torch.equal(c(), want):
                    fail(f"[kernels] sharing s={s} K{5 if al else 4}: the {r}"
                         f" route != the full kernel's votes at those rows")
            name = (f"K{5 if al else 4} candidate forms, {s} queries per "
                    f"row, B=64 x k=1,024 of {db.shape[0]} rows")
            timed_match(name, call, reps=5, events=True)
            say(f"[kernels] {name}: auto routes (K4 index, K4 dense, K5 "
                f"index, K5 dense) {routes_delta(device, call['auto'])}; "
                f"votes exact on every route and form")
    del db, index
    torch.cuda.empty_cache()


CAND_ROUTES = ("auto", "dense", "index", "grouped", "per_item")


def check_grouping(label: str, cand, rows: int, f: int) -> dict:
    """The candidate form's work list on the card against its twin (the
    same items; row by row the same slots), how the candidates share rows
    (distinct rows, slots per chosen row, work items of K4's and K5's
    grouped forms) and the grouping's device time beside its twin's, at
    each kernel's queries per item."""
    import torch

    from tiresias_tpu_torch.ops import match_kernels as tk

    flat = cand.reshape(-1).long()
    valid = flat[(flat >= 0) & (flat < rows)]
    per_row = torch.bincount(valid, minlength=rows)
    chosen = per_row[per_row > 0].float()
    out = {"slots": int(valid.numel()), "distinct_rows": int(chosen.numel()),
           "slots_per_row_mean": float(chosen.mean()),
           "slots_per_row_max": int(chosen.max())}
    for aligned in (False, True):
        g = tk.cand_group_size(aligned, f)
        slots, items, n = tk.group_candidates(cand, rows, g)
        ps, pi, pn = tk.group_candidates_plain(cand, rows, g)
        n = int(n)
        ks = slots[: ps.numel()].long()
        if (n != int(pn) or not torch.equal(items[:n], pi)
                or not torch.equal(flat[ks], flat[ps.long()])
                or not torch.equal(ks[torch.argsort(flat[ks] * flat.numel()
                                                    + ks)], ps.long())):
            fail(f"[kernels] group_candidates ({label}, g={g}) != its twin")
        key = "k5" if aligned else "k4"
        ms = [device_ms(lambda: tk.group_candidates_plain(cand, rows, g), 10),
              device_ms(lambda: tk.group_candidates(cand, rows, g), 20),
              device_ms(lambda: tk.group_candidates(cand, rows, g), 20),
              device_ms(lambda: tk.group_candidates_plain(cand, rows, g), 10)]
        out[key] = {"g": g, "items": n, "ms": float(np.median(ms[1:3])),
                    "plain_ms": float(np.median(ms[::3])),
                    # cand read once, slots and items written once
                    **bound(4 * flat.numel() + 4 * ps.numel() + 16 * n, 0)}
    say(f"[kernels] candidates ({label}) B={cand.shape[0]} x k="
        f"{cand.shape[1]}: {out['slots']} valid slots on "
        f"{out['distinct_rows']} distinct rows, {out['slots_per_row_mean']:.3f}"
        f" slots per chosen row on average, max {out['slots_per_row_max']}; "
        f"work items K4 {out['k4']['items']} (g={out['k4']['g']}), K5 "
        f"{out['k5']['items']} (g={out['k5']['g']}); group_candidates == "
        f"twin; device {out['k4']['ms']} / {out['k5']['ms']} ms (plain twin "
        f"{out['k4']['plain_ms']} / {out['k5']['plain_ms']} ms), bound "
        f"{out['k5']['bound_ms']:.5f} ms ({out['k5']['bound_by']})")
    return out


def phase_match_cand(device, eng, view, index, q, active, use2, f):
    """K4/K5's candidate form on the traffic the strict prefilter sends:
    the catalog's own view and index, each query's 1,024 candidates by its
    bound (the engine's own selection), batch 64 and 1, and two synthetic
    sharings at batch 64: every query on query 0's 1,024 candidates, and
    the slots spread evenly over the view's rows. On each: the work list
    against its twin, the sharing and the grouping's time; every route of
    the grouped form (auto, dense, index, "grouped") and the per-item form
    int32-exact against the full kernels' votes at those rows (and the twin,
    on the catalog's candidates); the grouped form's routes and the
    per-item form timed in turns, with the candidates' own band statistics
    and bound. Then the ops-level prefiltered and full-scan votes in turns.
    Returns the candidate forms' kernel entries."""
    import torch

    from tiresias_tpu_torch.ops import match_kernels as tk
    from tiresias_tpu_torch.ops import match_lattice as ml

    fns = {False: tk.match_votes_fused, True: tk.match_votes_fused_aligned}
    specs, maps = eng.store.bound_maps_for(view, 2)
    rows = view.db.shape[0]
    # bound_scan on the catalog's bound maps with the search queries
    ctx = eng.store.ctx_ids_for(view)
    for b in (64, 1):
        for tol in (0.01, STRICT_TOL, 0.5):
            check_scan(f"catalog bound maps B={b} tol {tol}",
                       ml.strict_scan(specs, tol), maps, q[:b], active[:b],
                       use2[:b], ctx, int(ctx[0]))
        SCAN[f"strict catalog B={b}"] = time_scan(
            f"strict catalog 2 x {list(maps[0].shape)} B={b} tol 0.1",
            ml.strict_scan(specs, STRICT_TOL), maps, q[:b], active[:b],
            use2[:b])
    cases = []
    for b in (64, 1):
        idx, _ = ml.select_candidates(
            ml.bound_votes(specs, maps, q[:b], active[:b], use2[:b],
                           STRICT_TOL), tk.PREFILTER_K)
        cases.append(("catalog", b, idx.to(torch.int32).contiguous()))
    k = cases[0][2].shape[1]
    cases.append(("same rows", 64, cases[0][2][:1].repeat(64, 1).contiguous()))
    cases.append(("even", 64, (torch.arange(64 * k, device=device).reshape(
        64, k) % rows).to(torch.int32)))
    res, sharing = {}, {}
    for label, b, cand in cases:
        qq, act, u2 = q[:b], active[:b], use2[:b]
        sharing[label, b] = check_grouping(label, cand, rows, f)
        st = band_stats(index, qq, act, u2, STRICT_TOL, cand)
        for aligned in (False, True):
            kname = ("match_votes_aligned_cand" if aligned
                     else "match_votes_cand")
            name = (f"K{5 if aligned else 4} {kname} (b) {label} candidates "
                    f"B={b} x k={k}")
            want = fns[aligned](view.db, qq, act, u2, STRICT_TOL, 2,
                                index=index).gather(1, cand.long())
            call = {r: (lambda r=r, al=aligned: tk.match_votes_cand(
                        view.db, qq, act, u2, STRICT_TOL, cand, 2,
                        index=index, route=r, aligned=al))
                    for r in CAND_ROUTES}
            for r, c in call.items():
                if not torch.equal(c(), want):
                    fail(f"{name}: the {r} route != the full kernel's votes "
                         f"at those rows")
            if b > 1:  # "grouped" is the auto route there
                del call["grouped"]
            plain = None
            if label == "catalog":
                # the twin loops over the queries in thousands of small ops:
                # one call, timed with events (a profile of it costs minutes)
                a_ev = torch.cuda.Event(enable_timing=True)
                b_ev = torch.cuda.Event(enable_timing=True)
                a_ev.record()
                twin = tk.match_votes_cand_plain(view.db, qq, act, u2,
                                                 STRICT_TOL, cand, 2, aligned)
                b_ev.record()
                b_ev.synchronize()
                if not torch.equal(twin, want):
                    fail(f"{name}: the twin != the full kernel's votes")
                plain = a_ev.elapsed_time(b_ev)
                say(f"[kernels] {name}: plain twin {plain} ms (one call, "
                    f"CUDA events)")
            t = timed_match(name, call, reps=10 if b > 1 else 50,
                            events=True)
            t["plain"] = plain
            routes = routes_delta(device, call["auto"])
            say_bands(name, st, routes, aligned)
            bd = index_bound(index, st, b, f, aligned)
            grouped = t["grouped" if b == 1 else "auto"]
            say(f"[kernels] {name}: bound {bd['bound_ms']:.5f} ms "
                f"({bd['bound_by']}) from the candidates' own bands, "
                f"{100 * bd['bound_ms'] / t['auto']:.1f}% of it; grouped "
                f"{grouped} ms against per-item {t['per_item']} ms "
                f"({t['per_item'] / grouped:.2f}x); votes exact on every "
                f"route and form" + (" and the twin" if plain else ""))
            res[label, aligned, b] = dict(t, bound=bd, stats=st)
        if label != "catalog":
            continue
        # every (query, candidate) pair tested: the dense route's bound
        live = index.n_live.sum(dim=1)[cand.long().reshape(-1)].reshape(
            cand.shape)
        pairs = float((act.sum(dim=1) * live.sum(dim=1)).sum())
        res["dense", b] = bound(
            sharing[label, b]["distinct_rows"] * view.db.shape[1] * 2 * 4
            + b * 4 * f * 4 + 2 * 4 * cand.numel(), pairs * 2 * 2)
        # the ops-level prefilter against the full scan, in turns
        for aligned in (False, True):
            mode = "aligned" if aligned else "bag"
            pf = (lambda al=aligned: tk.aligned_prefiltered_votes(
                view.db, maps, qq, act, u2, STRICT_TOL, specs=specs,
                coefs=2, aligned=al, index=index))
            full = (lambda al=aligned: fns[al](view.db, qq, act, u2,
                                               STRICT_TOL, 2, index=index))
            votes, cert = pf()
            ref = full()
            m = votes.max(dim=1).values
            if not torch.equal(m[cert], ref.max(dim=1).values[cert]):
                fail(f"[prefilter] {mode} ops B={b}: a certified top-1 != "
                     f"the full scan's")
            reps = 5 if b > 1 else 20
            t = [(device_ms(fn, reps), stream_ms(fn, reps))
                 for fn in (full, pf, pf, full)]
            dev = [float(np.median([t[i][0] for i in ii]))
                   for ii in ((1, 2), (0, 3))]
            st_ms = [float(np.median([t[i][1] for i in ii]))
                     for ii in ((1, 2), (0, 3))]
            say(f"[prefilter] {mode} ops B={b} tol {STRICT_TOL}: prefiltered "
                f"{dev[0]} ms device, {st_ms[0]} ms on the stream (bound_scan "
                f"bound, top-1024, candidate form); full scan {dev[1]} ms "
                f"device, {st_ms[1]} ms on the stream; certified "
                f"{int(cert.sum())}/{b}")
    none = "no single PyTorch call computes tolerance votes"
    shape = ("B=64 x 1,024 candidates of the 10,112-row catalog x 1,024 "
             "frames x 2 coefs, tol 0.1")
    out = []
    for aligned, kname in ((False, "match_votes_cand"),
                           (True, "match_votes_aligned_cand")):
        r64, r1 = res["catalog", aligned, 64], res["catalog", aligned, 1]
        common = {"route": "cuda",
                  "source": "tiresias_tpu_torch/csrc/match.cu",
                  "replaces": "tiresias_tpu/ops/match_pallas.py:566",
                  "max_abs_err": 0.0, "plain_ms": r64["plain"], **r64["bound"],
                  "library_ms": None, "library": none,
                  "plain_timing": "one call of the twin, CUDA events",
                  "bound_ms_b1": r1["bound"]["bound_ms"],
                  "bands": dict(r64["stats"])}
        synthetic = {
            f"{form}_ms_{lab.replace(' ', '_')}": res[lab, aligned, 64][key]
            for lab in ("same rows", "even")
            for form, key in (("grouped", "auto"), ("per_item", "per_item"))}
        out.append({
            "name": kname, **common, "ms": r64["auto"],
            "shape": shape + " (grouped form: one block per row and up to "
                     "g of its queries; its work list included)",
            "per_item_ms": r64["per_item"], "dense_route_ms": r64["dense"],
            "index_route_ms": r64["index"], "ms_b1": r1["grouped"],
            "per_item_ms_b1": r1["per_item"], **synthetic,
            "stream_ms": r64["stream"], "stream_ms_b1": r1["stream"],
        })
        out.append({
            "name": kname + "_per_item", **common, "ms": r64["per_item"],
            "shape": shape + " (per-item form: one block per (query, "
                     "candidate); the auto route at batch 1)",
            "grouped_ms": r64["auto"], "ms_b1": r1["per_item"],
        })
    d64 = {"max_abs_err": 0.0, "route": "cuda",
           "source": "tiresias_tpu_torch/csrc/match.cu",
           "replaces": "tiresias_tpu/ops/match_pallas.py:566",
           "plain_ms": res["catalog", True, 64]["plain"], **res["dense", 64],
           "plain_timing": "one call of the twin, CUDA events",
           "library_ms": None, "library": none}
    out.append({
        "name": "match_votes_aligned_cand_dense", **d64,
        "ms": res["catalog", True, 64]["dense"],
        "shape": "every (query, candidate) item: B=64 x 1,024 candidates x "
                 "1,024 frames x 2 coefs (the grouped form's forced dense "
                 "route: its index kernel lists every item, the dense "
                 "kernel serves them)",
        "ms_b1": res["catalog", True, 1]["dense"],
    })
    out.append({
        "name": "match_votes_aligned_cand_dense_per_item", **d64,
        "ms": res["catalog", True, 64]["per_item"],
        "shape": "the per-item K5 call at B=64 x 1,024 candidates (its index "
                 "kernel and its dense kernel, which takes the items with "
                 "wide bands: most of them on the catalog)",
        "ms_b1": res["catalog", True, 1]["per_item"],
    })
    s64 = sharing["catalog", 64]
    out.append({
        "name": "group_candidates", "route": "cuda",
        "source": "tiresias_tpu_torch/csrc/match.cu",
        "replaces": "tiresias_tpu/ops/match_pallas.py:566 (the per-query "
                    "db[idx] gather becomes a row-major work list)",
        "max_abs_err": 0.0, "ms": s64["k5"]["ms"],
        "plain_ms": s64["k5"]["plain_ms"], "bound_ms": s64["k5"]["bound_ms"],
        "bound_by": s64["k5"]["bound_by"], "library_ms": None,
        "library": "no single PyTorch call computes it (a stable sort of "
                   "the row ids neither drops invalid ids nor cuts items)",
        "shape": "cand [64, 1,024] of the catalog over 10,112 rows, g=8 "
                 "(K5); three kernels: counts, scan, scatter",
        "ms_g16": s64["k4"]["ms"], "ms_b1": sharing["catalog", 1]["k5"]["ms"],
        "sharing": {f"{lab} B={b}": v for (lab, b), v in sharing.items()},
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
    """Time the searches: batch 1 and batch 64 at tol 0.001 and 1.0, each
    through the engine's own dispatch (the certified dialplan prefilter
    where its gate admits the view) and with every gate closed (the full
    scan), in turns; TIR* must be equal between the two."""
    import torch

    results = {}
    t0 = time.perf_counter()
    eng.search_pcm_batch(None, queries[:1], SR)  # value-map build
    torch.cuda.synchronize(device)
    first_s = time.perf_counter() - t0
    notes = pf_notes(eng)
    fb0 = fallbacks()
    (view,) = eng.store.search_views()
    admitted = eng._lattice_pf_ok(view, 0.001)
    paths = ("prefilter", "full")
    lat = {(p, b): [] for p in paths for b in (1, 64)}

    def run(path, tol):
        res = []
        for lo in range(0, len(queries), 64):
            t1 = time.perf_counter()
            res += eng.search_pcm_batch(None, queries[lo : lo + 64], SR,
                                        tolerance=tol)
            if lo + 64 <= len(queries):
                lat[path, 64].append((time.perf_counter() - t1) / 64)
        for _ in range(10):
            t1 = time.perf_counter()
            eng.search_pcm_batch(None, queries[:64], SR, tolerance=tol)
            lat[path, 64].append((time.perf_counter() - t1) / 64)
        single = []
        for q in queries:
            t1 = time.perf_counter()
            single.append(eng.search_pcm(None, q, SR, tolerance=tol))
            lat[path, 1].append(time.perf_counter() - t1)
        if [r.to_channel_vars() for r in single] != [
                r.to_channel_vars() for r in res]:
            fail(f"[search] {path}: batch-1 and batch-64 TIR* differ at tol "
                 f"{tol}")
        return res

    for i, tol in enumerate((0.001, 1.0)):
        got = {}
        for path in paths[:: 1 - 2 * i]:  # in turns: pf, full, full, pf
            if path == "full":
                with gates_closed():
                    got[path] = run(path, tol)
            else:
                got[path] = run(path, tol)
        if [r.to_channel_vars() for r in got["prefilter"]] != [
                r.to_channel_vars() for r in got["full"]]:
            fail(f"[search] prefiltered and full-scan TIR* differ at tol "
                 f"{tol}")
        results[tol] = got["prefilter"]
    p50 = {k: 1e3 * float(np.median(v)) for k, v in lat.items()}
    dev_ms = {}
    for path in paths:
        with (gates_closed() if path == "full" else contextlib.nullcontext()):
            dev_ms[path, 1] = device_ms(
                lambda: eng.search_pcm(None, queries[0], SR), reps=10)
            dev_ms[path, 64] = device_ms(
                lambda: eng.search_pcm_batch(None, queries[:64], SR),
                reps=5) / 64
    for path in paths:
        say(f"[search] {path}: device time {dev_ms[path, 1]:.4f} ms/query at "
            f"batch 1 ({100 * dev_ms[path, 1] / p50[path, 1]:.1f}% of the p50 "
            f"wall time), {dev_ms[path, 64]:.4f} ms/query at batch 64 "
            f"({100 * dev_ms[path, 64] / p50[path, 64]:.1f}%); p50 "
            f"{p50[path, 1]:.4f} ms/query at batch 1, {p50[path, 64]:.4f} "
            f"ms/query at batch 64")
    found = sum(r.found for r in results[1.0][:N_EXCERPTS])
    cert, miss = notes.get("lattice", [0, 0])
    say(f"[search] {len(queries)} queries ({N_EXCERPTS} excerpts + "
        f"{N_NOISE} silence/noise) x tol {{0.001, 1.0}}; first search "
        f"(value-map build) {first_s:.3f} s; excerpts FOUND at tol 1.0: "
        f"{found}/{N_EXCERPTS}; TIR* equal prefiltered and full scan")
    say(f"[search] dialplan prefilter: {cert} searches certified, {miss} fell "
        f"back to the full scan (search.prefilter_fallbacks "
        f"+{fallbacks() - fb0:.0f}); gate misses now {dict(eng._pf_misses)}")
    if admitted and cert + miss == 0:
        fail("[search] the dialplan prefilter's gate admits the catalog's "
             "view but no search took it")
    return results, {k: p50[("prefilter", k)] for k in (1, 64)}, {
        "p50": {f"{p}_b{b}": v for (p, b), v in p50.items()},
        "device_ms": {f"{p}_b{b}": v for (p, b), v in dev_ms.items()},
        "certified": cert, "fell_back": miss}


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
    db0 = host_coefs(eng.store)[0]
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
        f"{len(db0)} tracks for {len(queries)} queries x 2 tolerances "
        f"({time.perf_counter() - t0:.1f} s)")
    return vm, qfp[..., 0].contiguous(), valid


def phase_lattice_real(vm, q0, valid) -> dict:
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
    # the dialplan prefilter on the same traffic: bound_scan against the
    # catalog's quantized map, then the ops-level prefiltered and full-scan
    # votes in turns, and the two steps that are library calls
    vmq = ml.quantize_value_map(vm)
    inf = float("inf")
    # bound_scan, the dialplan prefilter's bound stage, on the same traffic
    raw = {"B=72": (q0, valid), "B=64": (q0[:N_EXCERPTS], valid[:N_EXCERPTS]),
           "B=1": (q0[:1], valid[:1]),
           "long B=1": (q0.reshape(1, -1), valid.reshape(1, -1))}
    for name, (qb, vb) in raw.items():
        for tol in (0.001, 1.0):
            check_scan(f"dialplan real {name} tol {tol}",
                       ml.dialplan_scan(tol, lo, hi), (vmq,), qb, vb)
    say(f"[kernels] bound_scan dialplan real B=72/B=64/B=1/long x "
        f"[{vmq.shape[0]}, 640] uint8: bound and histogram exact against the "
        f"twin at tol 0.001 and 1.0")
    for name in ("B=64", "B=1"):
        SCAN[f"dialplan real {name}"] = time_scan(
            f"dialplan real {name} x [{vmq.shape[0]}, 640] uint8 tol 0.001",
            ml.dialplan_scan(0.001, lo, hi), (vmq,), *raw[name])
    for b in (64, 1):
        qb, vb = q0[:b], valid[:b]
        for tol in (0.001, 1.0):
            _, cert = ml.lattice_prefiltered_votes(vm, vmq, qb, vb, tol, -inf,
                                                   inf)
            t_pf, t_full = [], []
            for fn, acc in ((lambda: ml.lattice_votes(vm, qb, vb, tol, -inf,
                                                      inf), t_full),
                            (lambda: ml.lattice_prefiltered_votes(
                                vm, vmq, qb, vb, tol, -inf, inf), t_pf),
                            (lambda: ml.lattice_prefiltered_votes(
                                vm, vmq, qb, vb, tol, -inf, inf), t_pf),
                            (lambda: ml.lattice_votes(vm, qb, vb, tol, -inf,
                                                      inf), t_full)):
                acc.append(device_ms(fn, 10))
            say(f"[prefilter] dialplan ops B={b} tol {tol}: prefiltered "
                f"{float(np.median(t_pf))} ms (bound_scan, top-256, "
                f"rescore), full scan {float(np.median(t_full))} ms, device; "
                f"certified {int(cert.sum())}/{b}")
    bound64, c = ml.bound_scan(ml.dialplan_scan(1.0, -inf, inf), (vmq,),
                               q0[:N_EXCERPTS], valid[:N_EXCERPTS],
                               with_counts=True)
    idx, _ = ml.select_candidates(bound64, ml.LATTICE_PREFILTER_K)
    library = {
        f"rescore_rows {list(idx.shape) + [vm.shape[1]]}": device_ms(
            lambda: ml.rescore_rows(vm, c, idx, 1.0)),
    }
    library.update(topk_ms(bound64))
    for name, ms in library.items():
        say(f"[library] {name}: device {ms} ms")
    library["bound_ms"] = library_bounds("[library]", *bound64.shape,
                                         idx.shape[1], vm.shape[1])
    return library


def phase_strict(device, eng, queries):
    """The strict path on the restored catalog: each STRICT_MODES entry
    through ``search_pcm_batch`` (batch 64) and ``search_pcm`` (batch 1),
    through the engine's own dispatch (the certified strict/aligned
    prefilter where its gate admits the view) and with every gate closed
    (the full scan), in turns; TIR* equal between the two, and every
    excerpt FOUND with >= frame_count - 1 votes."""
    import torch

    results, p50, info = {}, {}, {}
    notes = pf_notes(eng)
    paths = ("prefilter", "full")
    (view,) = eng.store.search_views()
    for i, (mode, kw) in enumerate(STRICT_MODES.items()):
        eng.search_pcm_batch(None, queries[:1], SR, tolerance=STRICT_TOL,
                             **kw)
        torch.cuda.synchronize(device)
        admitted = eng._strict_pf_ok(view, 2, STRICT_TOL, 1,
                                     bool(kw.get("aligned")))
        lat = {(p, b): [] for p in paths for b in (1, 64)}
        got, dev = {}, {}
        before = {m: list(v) for m, v in notes.items()}
        fb0 = fallbacks()
        for path in paths[:: 1 - 2 * (i % 2)]:
            with (gates_closed() if path == "full"
                  else contextlib.nullcontext()):
                res = []
                for lo in range(0, len(queries), 64):
                    t1 = time.perf_counter()
                    res += eng.search_pcm_batch(None, queries[lo : lo + 64],
                                                SR, tolerance=STRICT_TOL,
                                                **kw)
                    if lo + 64 <= len(queries):
                        lat[path, 64].append((time.perf_counter() - t1) / 64)
                for _ in range(5):
                    t1 = time.perf_counter()
                    eng.search_pcm_batch(None, queries[:64], SR,
                                         tolerance=STRICT_TOL, **kw)
                    lat[path, 64].append((time.perf_counter() - t1) / 64)
                single = []
                for q in queries:
                    t1 = time.perf_counter()
                    single.append(eng.search_pcm(None, q, SR,
                                                 tolerance=STRICT_TOL, **kw))
                    lat[path, 1].append(time.perf_counter() - t1)
                if [r.to_channel_vars() for r in single] != [
                        r.to_channel_vars() for r in res]:
                    fail(f"[strict] {mode} {path}: batch-1 and batch-64 TIR* "
                         f"differ")
                got[path] = res
                dev[path, 1] = device_ms(lambda: eng.search_pcm(
                    None, queries[0], SR, tolerance=STRICT_TOL, **kw),
                    reps=10)
                dev[path, 64] = device_ms(lambda: eng.search_pcm_batch(
                    None, queries[:64], SR, tolerance=STRICT_TOL, **kw),
                    reps=3) / 64
        if [r.to_channel_vars() for r in got["prefilter"]] != [
                r.to_channel_vars() for r in got["full"]]:
            fail(f"[strict] {mode}: prefiltered and full-scan TIR* differ")
        res = got["prefilter"]
        found = sum(r.found and r.match_count >= r.frame_count - 1
                    for r in res[:N_EXCERPTS])
        if found != N_EXCERPTS:
            fail(f"[strict] {mode}: only {found}/{N_EXCERPTS} excerpts FOUND "
                 f"with >= frame_count - 1 votes")
        pf_mode = "aligned" if kw.get("aligned") else "bag"
        cert, miss = (a - b for a, b in zip(notes.get(pf_mode, [0, 0]),
                                            before.get(pf_mode, [0, 0])))
        if admitted and cert + miss == 0:
            fail(f"[strict] {mode}: the prefilter's gate admits the view but "
                 f"no search took it")
        pm = {k: 1e3 * float(np.median(v)) for k, v in lat.items()}
        p50[mode] = {b: pm["prefilter", b] for b in (1, 64)}
        for path in paths:
            say(f"[strict] {mode} {kw} tol {STRICT_TOL} {path}: p50 "
                f"{pm[path, 1]:.4f} ms/query at batch 1 (device "
                f"{dev[path, 1]:.4f} ms, "
                f"{100 * dev[path, 1] / pm[path, 1]:.1f}%), "
                f"{pm[path, 64]:.4f} ms/query at batch 64 (device "
                f"{dev[path, 64]:.4f} ms, "
                f"{100 * dev[path, 64] / pm[path, 64]:.1f}%)")
        say(f"[strict] {mode}: excerpts FOUND with >= frame_count - 1 votes: "
            f"{found}/{N_EXCERPTS}; noise/silence FOUND: "
            f"{sum(r.found for r in res[N_EXCERPTS:])}/{N_NOISE}; TIR* equal "
            f"prefiltered and full scan; {pf_mode} prefilter: {cert} searches "
            f"certified, {miss} fell back (search.prefilter_fallbacks "
            f"+{fallbacks() - fb0:.0f})")
        results[mode] = res
        info[mode] = {"p50": {f"{p}_b{b}": v for (p, b), v in pm.items()},
                      "device_ms": {f"{p}_b{b}": v
                                    for (p, b), v in dev.items()},
                      "certified": cert, "fell_back": miss}
    say(f"[strict] gate misses now {dict(eng._pf_misses)}")
    return results, p50, info


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
    d0, d1 = host_coefs(eng.store)
    qfp = qfp.cpu().numpy()
    picks = [0, N_EXCERPTS // 2, N_EXCERPTS - 1, N_EXCERPTS + N_NOISE - 1]
    t0 = time.perf_counter()
    for i in picks[:N_STRICT_BRUTE]:
        qi = qfp[i, : n_frames[i], :2]
        both = brute_force_strict(d0, d1, qi, STRICT_TOL)
        for aligned in (False, True):
            votes = both[aligned]
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
        f"all {len(d0)} tracks for {N_STRICT_BRUTE} queries x "
        f"{len(STRICT_MODES)} modes ({time.perf_counter() - t0:.1f} s)")


class ServeClient:
    """A blocking JSON-lines client of the recognition server: one socket,
    lines out, lines in."""

    def __init__(self, port: int) -> None:
        import socket

        self.sock = socket.create_connection(("127.0.0.1", port), timeout=120)
        self.f = self.sock.makefile("rw")

    def send(self, *messages: dict) -> None:
        for m in messages:
            self.f.write(json.dumps(m) + "\n")

    def flush(self) -> None:
        self.f.flush()

    def read(self) -> dict:
        line = self.f.readline()
        if not line:
            fail("[serve] the server closed the connection")
        msg = json.loads(line)
        if "error" in msg:
            fail(f"[serve] the server answered an error: {msg}")
        return msg

    def admin(self, cmd: str, **fields) -> dict:
        self.send({"op": "admin", "cmd": cmd, **fields})
        self.flush()
        return self.read()["admin"]

    def close(self) -> None:
        self.f.close()
        self.sock.close()


def b64(arr: np.ndarray) -> str:
    import base64

    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


def start_server(eng):
    """A RecognitionServer for ``eng`` on port 0, its event loop on a
    daemon thread. Returns (server, stop)."""
    import asyncio
    import threading

    from tiresias_tpu_torch.serve.server import RecognitionServer

    started, holder = threading.Event(), {}

    def runner():
        async def main():
            srv = RecognitionServer(eng, port=0, samplerate=SR,
                                    max_channels=N_CHANNELS)
            await srv.start()
            holder["srv"], holder["loop"] = srv, asyncio.get_running_loop()
            started.set()
            try:
                await srv.serve_forever()
            except asyncio.CancelledError:
                pass

        asyncio.run(main())

    thread = threading.Thread(target=runner, daemon=True)
    thread.start()
    if not started.wait(60):
        fail("[serve] the server did not start")

    def stop():
        asyncio.run_coroutine_threadsafe(
            holder["srv"].stop(), holder["loop"]).result(60)

    return holder["srv"], stop


def stream_channels(port: int, groups: list, n_conns: int = 8,
                    paced: bool = False):
    """Open every channel of ``groups`` (``(name, open fields, windows)``,
    one window per channel), spread over ``n_conns`` connections, and feed
    each its window in PCM_OP-sample pcm ops, all channels interleaved
    frame by frame as a PBX delivers them: as fast as the sockets take
    them, or ``paced`` in real time (one round of ops every 20 ms).
    Returns ({channel: result message}, seconds from the last pcm op to
    the last result)."""
    chans = [(f"{name}{i}", fields, w) for name, fields, ws in groups
             for i, w in enumerate(ws)]
    conns = [ServeClient(port) for _ in range(n_conns)]
    owner = {cid: conns[j % n_conns] for j, (cid, _, _) in enumerate(chans)}
    for cid, fields, _ in chans:
        owner[cid].send({"op": "open", "channel": cid, "duration_ms": 3000,
                         **fields})
    for c in conns:
        c.flush()
    for cid, _, _ in chans:
        if owner[cid].read().get("opened") is not True:
            fail(f"[serve] channel {cid} did not open")
    longest = max(len(w) for _, _, w in chans)
    t_start = time.perf_counter()
    for off in range(0, longest, PCM_OP):
        for cid, _, w in chans:
            if off < len(w):
                owner[cid].send({"op": "pcm", "channel": cid,
                                 "pcm": b64(w[off : off + PCM_OP])})
        for c in conns:
            c.flush()
        if paced:
            due = t_start + (off // PCM_OP + 1) * PCM_OP / SR
            time.sleep(max(0.0, due - time.perf_counter()))
    t_last = time.perf_counter()
    results = {}
    for cid, _, _ in chans:
        msg = owner[cid].read()
        results[msg["channel"]] = msg
    wall = time.perf_counter() - t_last
    for c in conns:
        c.close()
    if set(results) != {cid for cid, _, _ in chans}:
        fail(f"[serve] {len(results)} of {len(chans)} channels answered")
    return results, wall


def hold_channels(label: str, results: dict, name: str, direct) -> int:
    """Every channel ``name<i>``'s TIR* must equal ``direct[i]``, the
    engine's own answer for the same window. Returns the FOUND count."""
    for i, want in enumerate(direct):
        got = dict(results[f"{name}{i}"]["result"])
        got.pop("CONFIDENCE")
        if got != want.to_channel_vars():
            fail(f"[serve] {label} channel {name}{i}: server {got} != "
                 f"search_pcm_batch {want.to_channel_vars()}")
    return sum(r.found for r in direct)


def ranked_vars(ranked) -> list:
    return [(r["TIRFILENAME"], int(r["TIRMATCHCOUNT"]), int(r["TIRFRAMECOUNT"]))
            for r in ranked]


def phase_serve(device, eng, cfg, queries) -> dict:
    """The serving path on the restored catalog: warm-up, a
    RecognitionServer driven over real sockets (128 int16 channels, G.711
    channels, a dialplan and an aligned group in one tick, a continuous
    channel, a hangup), the admin plane with ranked top-k held to the
    direct call and to a numpy brute force, and a read-only replica
    following the owner by one generation. Returns the launch counts."""
    import torch

    from tiresias_tpu_torch.api import Tiresias
    from tiresias_tpu_torch.ops.mfcc import (
        fingerprint_padded_batch,
        pad_frames_bucket,
    )
    from tiresias_tpu_torch.serve.server import warmup_batch_sizes
    from tiresias_tpu_torch.utils import build
    from tiresias_tpu_torch.utils.g711 import decode as g711_decode
    from tiresias_tpu_torch.utils.g711 import encode
    from tiresias_tpu_torch.utils.tracing import metrics

    def timings(name):
        return metrics.snapshot()["timings"].get(name, [])

    def counter(name):
        return metrics.snapshot()["counters"].get(name, 0)

    # launches the SERVER made: counted around each socket-driven section
    # only, never around the direct calls its answers are compared with
    served = dict.fromkeys(build.LAUNCHES, 0)

    def through_server(fn, *args):
        torch.cuda.synchronize(device)
        build.reset_launch_counts()
        out = fn(*args)
        torch.cuda.synchronize(device)
        for name, n in build.LAUNCHES.items():
            served[name] += n
        return out

    # -- warm-up: the kernel library is already loaded (its build is the
    # [build] line); a freshly restored replica engine pays the map build
    rep = Tiresias(cfg, exclusive=False)
    n_maps = len(timings("engine.warmup.maps"))
    t0 = time.perf_counter()
    rep.warmup_async(samplerate=SR, batch_sizes=warmup_batch_sizes(N_CHANNELS),
                     laws=("ulaw",)).join()
    rep_warm_s = time.perf_counter() - t0
    maps_s = timings("engine.warmup.maps")[n_maps]
    if any(v.value_map is None or v.seq_dev is None
           for v in rep.store.search_views()):
        fail("[serve] warmup_async left the dialplan maps unbuilt")
    t0 = time.perf_counter()
    thread = eng.warmup_async(
        samplerate=SR, batch_sizes=warmup_batch_sizes(N_CHANNELS),
        laws=("ulaw",))
    ready_s = time.perf_counter() - t0
    thread.join()
    say(f"[serve] warmup_async on a freshly restored engine: "
        f"{rep_warm_s:.3f} s to full warmth, of it {maps_s:.3f} s the search "
        f"maps (value map, seq and context rows of {len(rep.store)} tracks); "
        f"kernel library build + load {build.build_seconds():.3f} s (the "
        f"[build] line, once per checkout); on the warm owner engine "
        f"{ready_s:.3f} s to READY")

    errors0 = {k: counter(k) for k in (
        "serve.search_errors", "serve.score_pass_errors",
        "serve.watch_errors", "serve.follow_errors", "engine.follow_errors")}
    srv, stop = start_server(eng)
    port = srv.port
    windows = [queries[i % len(queries)][:WINDOW] for i in range(N_CHANNELS)]
    dial = {"tolerance": 1.0}  # the dialplan configuration, unit tolerance

    # -- 128 int16 channels (config #5), five times. Unpaced, the client
    # outruns the server's JSON parsing, so the score passes share the
    # interpreter with the event loop; the first drive also pays first-use
    # costs at its pass sizes (pinned staging buffers, allocator blocks).
    # The third is paced in real time, 20 ms a round, as live trunks are:
    # every window completes in the last round. The fourth, unpaced, lets
    # the scorer keep ONE pass in flight instead of MAX_SCORES_IN_FLIGHT:
    # a reading for the question of how passes should coalesce, not a
    # setting the server offers. The fifth, unpaced with the server's own
    # limit, runs with the interpreter's thread switch interval at 0.5 ms
    # instead of its 5 ms: every torch call and kernel launch gives the
    # interpreter lock up, and a pass that must wait a whole interval for
    # the event loop to hand it back at each of them would show here.
    from tiresias_tpu_torch.serve import server as server_mod

    in_flight = server_mod.MAX_SCORES_IN_FLIGHT
    direct = eng.search_pcm_batch(None, windows, SR, **dial)
    drives = []
    switch_s = sys.getswitchinterval()
    for name in ("c", "r", "p", "s", "g"):
        server_mod.MAX_SCORES_IN_FLIGHT = 1 if name == "s" else in_flight
        sys.setswitchinterval(0.0005 if name == "g" else switch_s)
        n_match = len(timings("search.match"))
        n_pass = len(timings("serve.batch_search"))
        scored0 = counter("serve.windows_scored")
        results, wall = through_server(
            stream_channels, port, [(name, dial, windows)], 8, name == "p")
        passes = len(timings("serve.batch_search")) - n_pass
        scored = counter("serve.windows_scored") - scored0
        match_ms = 1e3 * np.asarray(timings("search.match")[n_match:])
        found = hold_channels("int16", results, name, direct)
        drives.append(
            f"last pcm op to last result {1e3 * wall:.3f} ms, "
            f"{int(scored)} windows in {passes} device passes "
            f"({scored / max(1, passes):.1f} channels per pass), "
            f"search.match p50 {float(np.median(match_ms)):.3f} ms per pass "
            f"(max {float(match_ms.max()):.3f} ms)")
    server_mod.MAX_SCORES_IN_FLIGHT = in_flight
    sys.setswitchinterval(switch_s)
    n_excerpt_chans = sum(i % len(queries) < N_EXCERPTS
                          for i in range(N_CHANNELS))
    if sum(r.found for i, r in enumerate(direct)
           if i % len(queries) < N_EXCERPTS) != n_excerpt_chans:
        fail("[serve] an excerpt channel was not FOUND")
    t_direct = []
    for _ in range(5):
        t1 = time.perf_counter()
        eng.search_pcm_batch(None, windows, SR, **dial)
        t_direct.append(time.perf_counter() - t1)
    say(f"[serve] {N_CHANNELS} int16 channels x {WINDOW // PCM_OP} pcm ops of "
        f"20 ms over 8 connections: every TIR* == search_pcm_batch on the "
        f"same windows, {found} FOUND ({n_excerpt_chans} excerpt channels, "
        f"all FOUND); first drive, unpaced: {drives[0]}; second, unpaced: "
        f"{drives[1]}; third, paced in real time: {drives[2]}; fourth, "
        f"unpaced with one pass in flight (the server allows {in_flight}): "
        f"{drives[3]}; fifth, unpaced with {in_flight} in flight and a "
        f"thread switch interval of 0.5 ms instead of {1e3 * switch_s:g} ms: "
        f"{drives[4]}; "
        f"one direct search_pcm_batch of the {N_CHANNELS} windows p50 "
        f"{1e3 * float(np.median(t_direct)):.3f} ms")

    # -- G.711 on the wire: 32 u-law channels, codes expanded on the device
    codes = [encode(w.astype(np.float32) / 32768.0, "ulaw")
             for w in windows[:32]]
    results, wall_u = through_server(
        stream_channels, port, [("u", {**dial, "format": "ulaw"}, codes)])
    direct_u = eng.search_pcm_batch(None, codes, SR, wire_law="ulaw", **dial)
    found_u = hold_channels("ulaw", results, "u", direct_u)
    # the device's table gather is the host expansion bit for bit: the
    # same codes expanded on the host must give the same TIR*
    host_u = eng.search_pcm_batch(
        None, [g711_decode(c, "ulaw") for c in codes], SR, **dial)
    if [r.to_channel_vars() for r in host_u] != [
            r.to_channel_vars() for r in direct_u]:
        fail("[serve] u-law codes expanded on the device and on the host "
             "give different TIR*")

    # -- two groups in one tick: 32 aligned channels (K5) beside 32 dialplan
    results, wall_m = through_server(
        stream_channels, port,
        [("a", SERVE_ALIGNED, windows[:32]), ("d", dial, windows[32:64])])
    direct_a = eng.search_pcm_batch(None, windows[:32], SR, **SERVE_ALIGNED)
    found_a = hold_channels("aligned", results, "a", direct_a)
    found_d = hold_channels(
        "dialplan beside aligned", results, "d",
        eng.search_pcm_batch(None, windows[32:64], SR, **dial))
    if found_a != 32:
        fail(f"[serve] aligned group: {found_a}/32 excerpts FOUND")
    say(f"[serve] 32 u-law channels: TIR* == search_pcm_batch(wire_law="
        f"'ulaw') == the same codes expanded on the host, {found_u} FOUND "
        f"(the catalog holds linear-PCM tracks; G.711 noise moves "
        f"coefficient 0 past the tolerance), last op to last result "
        f"{1e3 * wall_u:.3f} ms; 32 aligned {SERVE_ALIGNED} + 32 dialplan "
        f"channels in one tick: both groups == search_pcm_batch, "
        f"{found_a} + {found_d} FOUND, {1e3 * wall_m:.3f} ms")

    # -- a continuous channel, and a hangup before the duration
    c = ServeClient(port)
    c.send({"op": "open", "channel": "cont", "duration_ms": 1000,
            "continuous": True, **dial})
    c.flush()
    c.read()
    track = queries[0]
    for off in range(0, 3 * SR + PCM_OP, PCM_OP):
        c.send({"op": "pcm", "channel": "cont",
                "pcm": b64(track[off : off + PCM_OP])})
    c.flush()
    got = sorted(through_server(lambda: [c.read() for _ in range(3)]),
                 key=lambda m: m["window"])
    if [m["window"] for m in got] != [0, 1, 2]:
        fail(f"[serve] continuous windows {[m['window'] for m in got]}")
    for k, m in enumerate(got):
        want = eng.search_pcm(None, track[k * SR : (k + 1) * SR], SR, **dial)
        m["result"].pop("CONFIDENCE")
        if m["result"] != want.to_channel_vars():
            fail(f"[serve] continuous window {k}: {m['result']} != {want}")
    searched = counter("search.queries")
    c.send({"op": "hangup", "channel": "cont"},
           {"op": "open", "channel": "early", "duration_ms": 3000},
           {"op": "pcm", "channel": "early", "pcm": b64(track[:PCM_OP * 10])},
           {"op": "hangup", "channel": "early"})
    c.flush()
    hung = [c.read() for _ in range(3)]
    if [m["result"]["TIRSTATUS"] for m in (hung[0], hung[2])] != [
            "HANGUP", "HANGUP"] or counter("search.queries") != searched:
        fail(f"[serve] hangup before the duration: {hung}")
    say("[serve] continuous channel: windows 0, 1, 2 == search_pcm of each "
        "second; hangup before the duration -> HANGUP, no search")

    # -- admin plane
    contexts = c.admin("show_contexts")["contexts"]
    audios = c.admin("show_audios", context="media")["audios"]
    if [x["name"] for x in contexts] != ["media"] or len(audios) != len(
            eng.store):
        fail(f"[serve] admin listings: {contexts}, {len(audios)} audios")
    one = c.admin("search", pcm=b64(windows[0]), **dial)["result"]
    one.pop("CONFIDENCE")
    if one != direct[0].to_channel_vars():
        fail(f"[serve] admin search: {one}")
    batch = c.admin("search", queries=[{"pcm": b64(w)} for w in windows[:8]],
                    **dial)["results"]
    for got_r, want in zip(batch, direct[:8]):
        got_r.pop("CONFIDENCE")
        if got_r != want.to_channel_vars():
            fail(f"[serve] admin batch search: {got_r} != {want}")
    # ranked top-5, dialplan and aligned: the server, the direct call, and
    # (2 queries per mode) a numpy brute force over every stored track
    (view,) = eng.store.search_views()
    padded, n_frames = pad_frames_bucket(windows[:2], HOP)
    qfp = fingerprint_padded_batch(padded, SR, cfg.dsp,
                                   device=device).cpu().numpy()
    names = [e.name for e in eng.store.entries]
    d0, d1 = host_coefs(eng.store)
    t0 = time.perf_counter()
    for mode, kw in (("dialplan", dial), ("aligned", SERVE_ALIGNED)):
        for i in range(2):
            ranked = c.admin("search", pcm=b64(windows[i]), top=5,
                             **kw)["ranked"]
            want = eng.search_pcm_topk(None, windows[i], SR, k=5, **kw)
            if ranked_vars(ranked) != [
                    (r.name, r.match_count, r.frame_count) for r in want]:
                fail(f"[serve] top-5 {mode} query {i}: server "
                     f"{ranked_vars(ranked)} != search_pcm_topk {want}")
            qi = qfp[i, : n_frames[i], :2]
            votes = (brute_force_votes(d0, qi[:, 0], kw["tolerance"])
                     if mode == "dialplan"
                     else brute_force_strict(d0, d1, qi, STRICT_TOL)[1])
            # D5: votes descending, then insertion order (a stable sort)
            order = np.argsort(-votes, kind="stable")[:5]
            brute = [(names[a], int(votes[a]), len(qi)) for a in order
                     if votes[a] > 0]
            if ranked_vars(ranked) != brute:
                fail(f"[serve] top-5 {mode} query {i}: {ranked_vars(ranked)} "
                     f"!= brute force {brute}")
    brute_s = time.perf_counter() - t0
    victim = one["TIRFILEUUID"]
    if c.admin("remove_audio", uuid=victim) != {"removed": True}:
        fail("[serve] remove_audio")
    after = c.admin("search", pcm=b64(windows[0]), **SERVE_ALIGNED)["result"]
    if after.get("TIRFILEUUID") == victim or eng.get_audio(victim):
        fail(f"[serve] the removed audio is still found: {after}")
    (view,) = eng.store.search_views()
    if view.value_map is None or not view.dead_rows:
        fail("[serve] remove_audio rebuilt the view in full: the delete "
             "must mask its row off the previous view")
    if c.admin("compact") != {"compacted": True}:
        fail("[serve] compact")
    (view,) = eng.store.search_views()
    if view.dead_rows or view.n_audios != N_TRACKS - 1:
        fail(f"[serve] compact left {len(view.dead_rows)} dead rows")
    if c.admin("save") != {"saved": True}:
        fail("[serve] save")
    c.send({"op": "stats"})
    c.flush()
    stats = c.read()["stats"]
    if stats["audios"] != N_TRACKS - 1 or not stats["owner"]:
        fail(f"[serve] stats: {stats}")
    say(f"[serve] admin: show_contexts, show_audios ({len(audios)} rows), "
        f"search (single, a batch of 8), top=5 in dialplan and aligned mode "
        f"== search_pcm_topk == a numpy brute-force ranking over "
        f"{len(names)} tracks with the D5 tiebreak (2 queries per mode, "
        f"{brute_s:.1f} s), remove_audio (no longer found; its row masked "
        f"off the previous view, the maps carried), compact, save, "
        f"stats (generation {stats['generation']}, search_p50_ms "
        f"{stats['search_p50_ms']})")

    # -- the replica follows the owner by one generation
    if not rep.refresh_from_checkpoint():  # the admin plane's saves
        fail("[serve] the replica did not see the admin plane's save")
    if rep.refresh_from_checkpoint():
        fail("[serve] the replica refreshed twice for one generation")
    fresh = synth_tracks(1, TRACK_S, 999, device).cpu().numpy()[0]
    entry = eng.add_audio_pcm("media", "fresh.wav", fresh, SR)
    if rep.refresh_from_checkpoint():
        fail("[serve] the replica refreshed before the owner saved")
    eng.save()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    if not rep.refresh_from_checkpoint():
        fail("[serve] the replica did not follow the owner's new generation")
    swap_s = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    after_b = torch.cuda.memory_allocated(device)
    res = rep.search_pcm(None, fresh[HOP * 100 : HOP * 100 + EXCERPT], SR,
                         **SERVE_ALIGNED)
    if res.uuid != entry.uuid:
        fail(f"[serve] the replica does not find the new track: {res}")
    say(f"[serve] replica (exclusive=False): refresh_from_checkpoint False "
        f"until the owner saved, True after ({swap_s:.3f} s: load, swap, "
        f"maps), then finds the track added in between; memory_allocated "
        f"{before} B before, max_memory_allocated {peak} B across the swap, "
        f"{after_b} B after")
    c.close()
    stop()
    rep.close()
    fired = {k: counter(k) - v for k, v in errors0.items()}
    if any(fired.values()):
        fail(f"[serve] error paths fired: {fired}")
    say(f"[serve] serve.search_errors and the score-pass, watch and follow "
        f"error counters: {fired}")
    return served


def phase_prefilter(device, tmp: str) -> dict:
    """The certified prefilters at N_PF_TRACKS tracks (102,400 rows at tier
    1,024): a read-only engine (never checkpointed) grows its catalog by
    fingerprinting seeded 30 s tracks as phase_catalog does, builds its
    maps, then runs dialplan searches at batch 64 and 1 and strict bag and
    aligned searches at batch 64, each through the engine's dispatch
    (prefiltered; the adaptive gate is reset before each run, so every
    search tries the prefilter) and with every gate closed (full scan), in
    turns: certificate counts, device ms and wall p50 of both, TIR* equal
    between them, and a numpy brute force over every stored track for 2
    queries per mode."""
    import torch

    from tiresias_tpu_torch import ContextConfig, TiresiasConfig
    from tiresias_tpu_torch.api import Tiresias
    from tiresias_tpu_torch.ops.mfcc import fingerprint_signals
    from tiresias_tpu_torch.utils import build

    cfg = TiresiasConfig(contexts=(ContextConfig("media", ""),),
                         data_dir=os.path.join(tmp, "prefilter_data"))
    eng = Tiresias(cfg, restore=False, exclusive=False)
    rng = np.random.default_rng(107)
    picks = np.linspace(0, N_PF_TRACKS - 1, N_PF_QUERIES).astype(int)
    starts = {int(t): HOP * int(rng.integers(1, (TRACK_S * SR - EXCERPT)
                                              // HOP)) for t in picks}
    excerpts = {}
    t0 = time.perf_counter()
    for lo in range(0, N_PF_TRACKS, 512):
        n = min(512, N_PF_TRACKS - lo)
        pcm = synth_tracks(n, TRACK_S, 5000 + lo, device).cpu().numpy()
        fps, n_frames = fingerprint_signals(list(pcm), SR, cfg.dsp,
                                            device=device)
        for i in range(n):
            track = lo + i
            eng.store.add_audio(f"pf{track:06d}.wav", "media",
                                fps[i, : n_frames[i]], f"pf-{track}")
            if track in starts:
                s = starts[track]
                excerpts[track] = pcm[i, s : s + EXCERPT].copy()
    grow_s = time.perf_counter() - t0
    queries = [excerpts[t] for t in sorted(starts)]
    store = eng.store
    t0 = time.perf_counter()
    (view,) = store.search_views()
    store.value_map_q_for(view)
    store.bound_maps_for(view, 2)
    store.match_index_for(view)
    torch.cuda.synchronize(device)
    maps_s = time.perf_counter() - t0
    index_bytes = (view.match_index.entries.numel() * 4
                   + view.match_index.pos.numel() * 2)
    say(f"[prefilter] catalog of {len(store)} tracks ({view.db.shape[0]} "
        f"rows x {view.tier_frames} frames) grown in {grow_s:.3f} s; view, "
        f"value map, uint8 map, bound maps and match index built in "
        f"{maps_s:.3f} s; memory_allocated "
        f"{torch.cuda.memory_allocated(device)} B (db "
        f"{view.db.numel() * 4} B, f32 map {view.value_map.numel() * 4} B, "
        f"u8 map {view.value_map_q.numel()} B, bound maps "
        f"{sum(m.numel() for m in next(iter(view.bound_maps.values()))[1])} "
        f"B, index {index_bytes} B)")
    from tiresias_tpu_torch.ops import match_lattice as ml
    from tiresias_tpu_torch.ops.mfcc import (
        fingerprint_padded_batch,
        pad_frames_bucket,
    )

    padded, n_frames = pad_frames_bucket(queries, HOP)
    qfp = fingerprint_padded_batch(padded, SR, cfg.dsp, device=device)
    valid = (torch.arange(qfp.shape[1], device=device)[None, :]
             < torch.from_numpy(n_frames.astype(np.int64)).to(device)[:, None])
    inf = float("inf")
    q0 = qfp[..., 0].contiguous()
    scan = ml.dialplan_scan(0.001, -inf, inf)
    bound100k, c = ml.bound_scan(scan, (view.value_map_q,), q0, valid,
                                 with_counts=True)
    ctx = store.ctx_ids_for(view)
    for b in (64, 1):
        for tol in (0.001, 1.0):
            check_scan(f"100,096 rows B={b} tol {tol}",
                       ml.dialplan_scan(tol, -inf, inf), (view.value_map_q,),
                       q0[:b], valid[:b], ctx_ids=ctx, ctx_id=int(ctx[0]))
        SCAN[f"dialplan {view.db.shape[0]} rows B={b}"] = time_scan(
            f"dialplan real B={b} x {list(view.value_map_q.shape)} uint8 tol "
            f"0.001", scan, (view.value_map_q,), q0[:b], valid[:b])
    library = topk_ms(bound100k)
    idx, _ = ml.select_candidates(bound100k, ml.LATTICE_PREFILTER_K)
    library[f"rescore_rows {list(idx.shape) + [view.value_map.shape[1]]}"] = (
        device_ms(lambda: ml.rescore_rows(view.value_map, c, idx, 0.001)))
    library[f"bound_scan {list(bound100k.shape)}"] = SCAN[
        f"dialplan {view.db.shape[0]} rows B=64"]["ms"]
    library[f"K3' full scan {list(bound100k.shape)}"] = device_ms(
        lambda: ml.hit_votes(c, view.value_map, 0.001, qfp.shape[1]))
    for name, ms in library.items():
        say(f"[prefilter] {name}: device {ms} ms")
    library["bound_ms"] = library_bounds(
        "[prefilter]", *bound100k.shape, idx.shape[1],
        view.value_map.shape[1])
    del bound100k, c
    notes = pf_notes(eng)
    cells = (("dialplan", {"coefs": 1, "tolerance": 0.001}, "lattice", 64),
             ("dialplan", {"coefs": 1, "tolerance": 0.001}, "lattice", 1),
             ("dialplan", {"coefs": 1, "tolerance": 1.0}, "lattice", 64),
             ("bag", dict(STRICT_MODES["bag"], tolerance=STRICT_TOL), "bag",
              64),
             ("aligned", dict(STRICT_MODES["aligned"], tolerance=STRICT_TOL),
              "aligned", 64))
    out = {"tracks": len(store), "rows": int(view.db.shape[0]),
           "grow_s": grow_s, "maps_s": maps_s, "library_ms": library}
    results = {}
    for name, kw, pf_mode, b in cells:
        batches = ([queries] if b == 64 else [[q] for q in queries[:16]])
        lat = {"prefilter": [], "full": []}
        got = {}
        cert0 = list(notes.get(pf_mode, [0, 0]))
        fb0 = fallbacks()
        launches0 = dict(build.LAUNCHES)
        dev = {"prefilter": [], "full": []}
        for path in ("prefilter", "full", "full", "prefilter"):
            with (gates_closed() if path == "full"
                  else contextlib.nullcontext()):
                res = []
                for batch in batches:
                    eng._pf_misses.clear()  # every search tries it
                    t1 = time.perf_counter()
                    res += eng.search_pcm_batch(None, batch, SR, **kw)
                    lat[path].append((time.perf_counter() - t1) / len(batch))
                if path in got and [r.to_channel_vars() for r in res] != [
                        r.to_channel_vars() for r in got[path]]:
                    fail(f"[prefilter] {name} B={b}: {path} TIR* changed "
                         f"between runs")
                got[path] = res
                eng._pf_misses.clear()  # 5 searches: under the 8 misses
                dev[path].append(device_ms(
                    lambda: eng.search_pcm_batch(None, batches[0], SR, **kw),
                    reps=3) / b)
        if [r.to_channel_vars() for r in got["prefilter"]] != [
                r.to_channel_vars() for r in got["full"]]:
            fail(f"[prefilter] {name} {kw} B={b}: prefiltered and full-scan "
                 f"TIR* differ")
        cert, miss = (a - c for a, c in zip(notes.get(pf_mode, [0, 0]),
                                            cert0))
        if cert + miss == 0:
            fail(f"[prefilter] {name} B={b}: no search took the prefilter")
        grouped = {}
        if pf_mode != "lattice":  # the grouped candidate form rescored
            kern = ("match_votes_aligned_cand" if pf_mode == "aligned"
                    else "match_votes_cand")
            grouped = {n: build.LAUNCHES[n] - launches0[n]
                       for n in ("group_candidates", kern)}
            if min(grouped.values()) <= 0:
                fail(f"[prefilter] {name} B={b}: the grouped candidate form "
                     f"never launched: {grouped}")
        p50 = {k: 1e3 * float(np.median(v)) for k, v in lat.items()}
        turns = {k: list(v) for k, v in dev.items()}
        dev = {k: float(np.median(v)) for k, v in dev.items()}
        found = sum(r.found for r in got["prefilter"])
        say(f"[prefilter] {name} {kw} B={b}: prefiltered p50 "
            f"{p50['prefilter']:.4f} ms/query wall, device "
            f"{dev['prefilter']:.4f} ms/query; full scan p50 "
            f"{p50['full']:.4f} ms/query wall, device {dev['full']:.4f} "
            f"ms/query (turns: prefiltered {turns['prefilter']}, full "
            f"{turns['full']}); certified {cert}, fell back {miss} (per search "
            f"call; "
            f"search.prefilter_fallbacks +{fallbacks() - fb0:.0f}); "
            f"FOUND {found}/{len(got['prefilter'])}; TIR* equal"
            + (f"; grouped candidate launches {grouped}" if grouped else ""))
        out[f"{name} tol {kw['tolerance']} B={b}"] = {
            "p50": p50, "device_ms": dev, "certified": cert,
            "fell_back": miss, "found": found, "launches": grouped}
        results[name, kw["tolerance"], b] = got["prefilter"]
    # the numpy brute force over every stored track, 2 queries per mode
    t0 = time.perf_counter()
    d0, d1 = host_coefs(store)
    qfp = qfp.cpu().numpy()
    names = [e.name for e in store.entries]
    checked = 0
    for i in (0, N_PF_QUERIES // 2):
        qi = qfp[i, : n_frames[i], :2]
        for tol in (0.001, 1.0):
            votes = brute_force_votes(d0, qi[:, 0], tol)
            best = int(np.argmax(votes))
            want = ((names[best], int(votes[best])) if votes[best] > 0
                    else (None, 0))
            r = results["dialplan", tol, 64][i]
            if (r.name, r.match_count) != want:
                fail(f"[prefilter] dialplan tol {tol} query {i}: engine {r} "
                     f"!= brute force {want}")
            checked += 1
        both = brute_force_strict(d0, d1, qi, STRICT_TOL)
        for mode, votes in (("bag", both[0]), ("aligned", both[1])):
            best = int(np.argmax(votes))
            want = ((names[best], int(votes[best])) if votes[best] > 0
                    else (None, 0))
            r = results[mode, STRICT_TOL, 64][i]
            if (r.name, r.match_count) != want:
                fail(f"[prefilter] {mode} query {i}: engine {r} != brute "
                     f"force {want}")
            checked += 1
    say(f"[verify] [prefilter] engine TIR* == a brute-force numpy search "
        f"over all {len(d0)} tracks for 2 queries x (dialplan at tol 0.001 "
        f"and 1.0, bag, aligned): {checked} checks "
        f"({time.perf_counter() - t0:.1f} s)")
    out["mutate"] = phase_mutate(
        device, eng, "100k",
        {f"pf{t:06d}.wav": x for t, x in excerpts.items()}, 4002)
    eng.close()
    del eng, store, view
    torch.cuda.empty_cache()
    return out


# The [mutate] phase: live appends and deletes against a serving catalog.
# The host link of the H100 SXM is PCIe Gen5 x16 (NVIDIA data sheet: 128
# GB/s both ways, 64 GB/s host to device); an update's bound is its new rows
# over the link plus its copy-on-write bytes over HBM.
LINK_BYTES_S = 64e9
N_MUTATE_ROUNDS = 5  # in-turns rounds of the update's wall time
N_FIRST_ROUNDS = 2  # in-turns rounds of the first search after a mutation


def same_bits(a, b) -> bool:
    """Bitwise equality (float32 compared as its bits: NaN and -0.0)."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def view_votes(store, view, qq, act, use2, cand) -> dict:
    """K3', bound_scan (the dialplan and the strict bound, with and without
    a context), K4, K5 and the candidate forms (grouped and per item) of
    the same queries on one view."""
    import torch

    from tiresias_tpu_torch.ops import match_kernels as tk
    from tiresias_tpu_torch.ops import match_lattice as ml

    inf = float("inf")
    specs, maps = store.bound_maps_for(view, 2)
    index = store.match_index_for(view)
    ctx = store.ctx_ids_for(view)
    q0 = torch.trunc(qq[..., 0]).contiguous()
    out = {
        "K3'": ml.lattice_votes(store.value_map_for(view), q0, act, 0.001,
                                -inf, inf),
        "bound_scan dialplan": ml.bound_scan(
            ml.dialplan_scan(0.001, -inf, inf),
            (store.value_map_q_for(view),), q0, act),
        "bound_scan strict": ml.bound_votes(specs, maps, qq, act, use2,
                                            STRICT_TOL),
        "bound_scan strict ctx": ml.bound_votes(specs, maps, qq, act, use2,
                                                STRICT_TOL, ctx, 0),
    }
    for aligned in (False, True):
        fn = tk.match_votes_fused_aligned if aligned else tk.match_votes_fused
        k = f"K{4 + aligned}"
        out[k] = fn(view.db, qq, act, use2, STRICT_TOL, 2, index=index)
        for route in ("grouped", "per_item"):
            out[f"{k} cand {route}"] = tk.match_votes_cand(
                view.db, qq, act, use2, STRICT_TOL, cand, 2, index=index,
                route=route, aligned=aligned)
    return out


def phase_mutate(device, eng, label: str, probes: dict, seed: int) -> list:
    """Live mutations of a serving engine's catalog, each after the maps
    were warm (``warm_search_maps`` in the dialplan and in the aligned
    configuration): appends up to the view's 128-row bucket edge, an append
    across it (the full rebuild the JAX rule takes there), appends of 1, 8
    and 64, deletes of 1 and 64, an append deleted before the next build,
    and a delete of a track appended since the last build. Per mutation:
    the route the update took (told from the returned view: an updated view
    carries the old one's derived tensors, a full build none), the wall ms
    of ``search_views()`` + both warms in turns against a forced full
    rebuild of the same store state, the update's device ms, its bound, the
    peak memory across it, and the first search after it (dialplan at batch
    1, aligned at batch 64) against the same search after a full rebuild;
    every tensor of the updated view bitwise equal to a full build's (the
    context ids on live rows), K3', bound_scan, K4, K5 and the candidate
    forms int32-equal on both views, TIR* equal, appended tracks FOUND,
    deleted ones never, and the old view's tensors unchanged. ``probes``:
    ``{name: excerpt}`` of catalog tracks."""
    import dataclasses

    import torch

    from tiresias_tpu_torch import MatchConfig
    from tiresias_tpu_torch.ops import match as tm
    from tiresias_tpu_torch.ops.mfcc import (
        fingerprint_padded_batch,
        pad_frames_bucket,
    )

    store = eng.store
    live_names = {e.name for e in store.iter_entries()}
    probes = {n: x for n, x in probes.items() if n in live_names}
    dial_cfg = eng.config
    aligned_cfg = dataclasses.replace(dial_cfg,
                                      match=MatchConfig(**SERVE_ALIGNED))
    tag = f"[mutate] {label}"

    def warm_both():
        eng.warm_search_maps()
        eng.config = aligned_cfg
        try:
            eng.warm_search_maps()
        finally:
            eng.config = dial_cfg

    def snapshot():
        return (store._views, {t: (tier.view_clean_from,
                                   set(tier.view_dead_pending))
                               for t, tier in store._tiers.items()})

    def restore(snap):
        views, tiers = snap
        for t, (clean, pending) in tiers.items():
            store._tiers[t].view_clean_from = clean
            store._tiers[t].view_dead_pending = set(pending)
        store._views, store._dirty = views, True

    def update(snap, full: bool):
        """One update from the snapshot's views (``full``: from none), the
        maps warmed; returns wall ms and the route of the view."""
        if full:
            store._views, store._dirty = None, True
        else:
            restore(snap)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        (view,) = store.search_views()
        route = ("incremental" if view.value_map is not None
                 or view.match_index is not None else "full")
        warm_both()
        torch.cuda.synchronize(device)
        return 1e3 * (time.perf_counter() - t0), route

    rng = np.random.default_rng(seed)
    appended: list = []  # (name, uuid, excerpt)
    deleted: set = set()
    n_new = [0]

    def append(n: int) -> list:
        pcm = synth_tracks(n, TRACK_S, seed + 7919 * n_new[0], device)
        pcm = pcm.cpu().numpy()
        out = []
        for p in pcm:
            name = f"{label}-new{n_new[0]:04d}.wav"
            n_new[0] += 1
            e = eng.add_audio_pcm("media", name, p, SR)
            if e is None:
                fail(f"{tag}: add_audio_pcm deduplicated {name}")
            s = HOP * int(rng.integers(1, (TRACK_S * SR - EXCERPT) // HOP))
            appended.append((name, e.uuid, p[s : s + EXCERPT].copy()))
            out.append(e.uuid)
        return out

    def delete(uuids) -> None:
        names = {e.uuid: e.name for e in store.iter_entries()}
        if eng.store.delete_audios(uuids) != len(uuids):
            fail(f"{tag}: a delete removed fewer tracks than asked")
        deleted.update(names[u] for u in uuids)

    def delete_catalog(n: int) -> None:
        # the probes' tracks first (their excerpts are queried), then
        # others spread over the catalog
        live = [e for e in store.iter_entries()
                if e.name not in deleted and "-new" not in e.name]
        queried = [e.uuid for e in live if e.name in probes][: min(n, 8)]
        rest = [e.uuid for e in live if e.uuid not in queried]
        pick = np.linspace(0, len(rest) - 1, n - len(queried)).astype(int)
        delete(queried + [rest[i] for i in pick])

    (view0,) = store.search_views()
    edge = view0.db.shape[0] - view0.n_audios
    mutations = (
        (f"append {edge} (to the 128-row bucket edge)",
         lambda: append(edge), "incremental"),
        ("append 1 (across the bucket edge)", lambda: append(1), "full"),
        ("append 1", lambda: append(1), "incremental"),
        ("append 8", lambda: append(8), "incremental"),
        ("append 64", lambda: append(64), "incremental"),
        ("delete 1", lambda: delete_catalog(1), "incremental"),
        ("delete 64", lambda: delete_catalog(64), "incremental"),
        ("append 1 and delete it before the build",
         lambda: delete(append(1)), "incremental"),
        ("delete a track appended since the last build",
         lambda: delete([appended[-3][1]]), "incremental"),
    )
    cand_g = torch.Generator(device=device).manual_seed(seed)
    out = []
    t_phase = time.perf_counter()
    for what, mutate, want_route in mutations:
        warm_both()
        (old,) = store.search_views()
        before = {k: x.clone() for k, x in old.tensors().items()}
        mutate()
        snap = snapshot()  # the old views and the mutated tiers' state
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        mem0 = torch.cuda.memory_allocated(device)
        first_ms, route = update(snap, full=False)
        peak = torch.cuda.max_memory_allocated(device)
        if route != want_route:
            fail(f"{tag} {what}: the update took the {route} route, the "
                 f"JAX rule takes the {want_route} one")
        (new,) = store.search_views()
        # the bound: the new rows over the link, every new tensor read from
        # the old view and written once (copy on write); a full build: the
        # whole matrix over the link and every tensor written once
        a_new = new.n_audios - (0 if route == "full" else old.n_audios)
        row_b = new.tier_frames * new.db.shape[2] * 4
        h2d = a_new * (row_b + 8 + 8 + 4) + 8 * len(
            new.dead_rows - old.dead_rows)
        old_t, new_t = old.tensors(), new.tensors()
        dev_b = sum((1 if route == "full" else 2) * x.numel()
                    * x.element_size() for k, x in new_t.items()
                    if x is not old_t.get(k))
        bound_ms = 1e3 * (h2d / LINK_BYTES_S + dev_b / HBM_BYTES_S)
        # wall ms in turns against a forced full rebuild
        walls = {"incremental": [], "full": []}
        for r in range(N_MUTATE_ROUNDS):
            for full in ((False, True) if r % 2 == 0 else (True, False)):
                ms, rt = update(snap, full)
                walls["full" if full else "incremental"].append(ms)
                if full and rt != "full":
                    fail(f"{tag} {what}: a forced rebuild carried maps")
        n0 = len(CLOCKS)
        dev_ms, h2d_ms = {}, {}
        for path, reps in (("incremental", 3), ("full", 1)):
            def fn():
                return update(snap, path == "full")

            split = device_ms(fn, reps, names=("Memcpy HtoD", ""))
            h2d_ms[path] = split["Memcpy HtoD"]
            # timed with CUDA events where the profiler saw nothing: no split
            dev_ms[path] = (split[""] if split[""] is not None
                            else events_ms(fn, reps))
        clock = clocks_since(n0)
        # the first search after the mutation, in turns with a full rebuild
        live_new = [(n, x) for n, u, x in appended if n not in deleted]
        dead_new = [(n, x) for n, u, x in appended if n in deleted]
        gone = [(n, probes[n]) for n in sorted(deleted) if n in probes]
        batch = (live_new[::-1][:16] + dead_new[::-1][:8] + gone[:8])
        batch += [(n, x) for n, x in probes.items()
                  if n not in deleted][: 64 - len(batch)]
        names = [n for n, _ in batch]
        pcms = [x for _, x in batch]
        firsts = {"incremental": {"dialplan": [], "aligned": []},
                  "full": {"dialplan": [], "aligned": []}}
        got = {}
        for r in range(N_FIRST_ROUNDS):
            for path in (("incremental", "full") if r % 2 == 0
                         else ("full", "incremental")):
                for mode, qs, kw in (("dialplan", pcms[:1], {}),
                                     ("aligned", pcms, SERVE_ALIGNED)):
                    if path == "full":
                        store._views, store._dirty = None, True
                    else:
                        restore(snap)
                    torch.cuda.synchronize(device)
                    t0 = time.perf_counter()
                    res = eng.search_pcm_batch(None, qs, SR, **kw)
                    firsts[path][mode].append(
                        1e3 * (time.perf_counter() - t0))
                    tir = [x.to_channel_vars() for x in res]
                    if got.setdefault(mode, tir) != tir:
                        fail(f"{tag} {what}: {mode} TIR* after the {path} "
                             f"update differs")
                    if mode == "aligned":
                        results = res
        for n, r in zip(names, results):
            if n in deleted and r.name == n:
                fail(f"{tag} {what}: the deleted track {n} was found")
            if n not in deleted and not (r.found and r.name == n):
                fail(f"{tag} {what}: {n} not FOUND ({r})")
        # the updated view against a full build of the same state
        update(snap, False)
        (inc,) = store.search_views()
        for k, x in old.tensors().items():
            if not same_bits(x, before[k]):
                fail(f"{tag} {what}: the update wrote into the old view's "
                     f"{k}")
        del before
        tier = store._tiers[inc.tier_frames]
        full = store._build_view(tier, len(tier.entries))
        for fn in (store.value_map_q_for, store.match_index_for,
                   store.seq_for, store.ctx_ids_for):
            fn(full)
        store.bound_maps_for(full, 2)
        got_t, want_t = inc.tensors(), full.tensors()
        if set(got_t) != set(want_t):
            fail(f"{tag} {what}: tensors {sorted(got_t)} != "
                 f"{sorted(want_t)}")
        live = torch.ones(inc.db.shape[0], dtype=torch.bool, device=device)
        live[sorted(inc.dead_rows)] = False
        for k in want_t:
            a, b = got_t[k], want_t[k]
            if k == "ctx_dev":  # a dead row keeps its id, as in JAX
                a, b = a[live], b[live]
            if not same_bits(a, b):
                fail(f"{tag} {what}: {k} of the updated view != a full "
                     f"build's")
        padded, n_frames = pad_frames_bucket(pcms, HOP)
        qfp = fingerprint_padded_batch(padded, SR, eng.config.dsp,
                                       device=device)
        qq, act, use2 = tm.prepare_query(qfp, n_frames, -1, -1,
                                         trunc_coef1=False)
        cand = torch.randint(0, inc.db.shape[0], (len(pcms), 33),
                             generator=cand_g, device=device,
                             dtype=torch.int32)
        va = view_votes(store, inc, qq, act, use2, cand)
        vb = view_votes(store, full, qq, act, use2, cand)
        for k in va:
            a, b = va[k], vb[k]
            if k.endswith("ctx"):
                a, b = a[:, live], b[:, live]
            if a.dtype != torch.int32 or not torch.equal(a, b):
                fail(f"{tag} {what}: {k} votes differ between the updated "
                     f"and the rebuilt view")
        del full, va, vb
        med = {k: float(np.median(v)) for k, v in walls.items()}
        first = {p: {m: float(np.median(v)) for m, v in d.items()}
                 for p, d in firsts.items()}
        rec = {"mutation": what, "route": route, "rows": inc.n_audios,
               "view_rows": int(inc.db.shape[0]),
               "dead_rows": len(inc.dead_rows),
               "wall_ms": med, "first_update_ms": first_ms,
               "turns": walls, "device_ms": dev_ms,
               "h2d_device_ms": h2d_ms, "clock": clock,
               "bound_ms": bound_ms, "h2d_bytes": h2d, "device_bytes": dev_b,
               "max_memory_allocated": peak, "memory_before": mem0,
               "first_search_ms": first}
        out.append(rec)
        say(f"{tag} {what}: route {route} ({inc.n_audios} rows in "
            f"{inc.db.shape[0]}, {len(inc.dead_rows)} dead); search_views + "
            f"warm maps wall {med['incremental']:.3f} ms (median of "
            f"{N_MUTATE_ROUNDS}) against a full rebuild's "
            f"{med['full']:.3f} ms, in turns; device {dev_ms['incremental']}"
            f" ms ({h2d_ms['incremental']} ms of it host-to-device copies) "
            f"against {dev_ms['full']} ms ({h2d_ms['full']} ms) ({clock}); "
            f"bound "
            f"{bound_ms:.6f} ms ({h2d} B over the link at 64 GB/s, {dev_b} B "
            f"at 3.35 TB/s); max_memory_allocated {peak} B "
            f"({mem0} B before); first search after it: dialplan B=1 "
            f"{first['incremental']['dialplan']:.3f} ms, aligned B=64 "
            f"{first['incremental']['aligned']:.3f} ms; after a full "
            f"rebuild {first['full']['dialplan']:.3f} / "
            f"{first['full']['aligned']:.3f} ms; every tensor bitwise equal "
            f"to a full build's, the votes of K3', bound_scan, K4, K5 and the "
            f"candidate forms int32-equal, TIR* equal, the old view "
            f"unchanged; {sum(n not in deleted for n in names)} probes FOUND, "
            f"{sum(n in deleted for n in names)} deleted never")
    # TIR* of the final catalog against the numpy brute force: 2 queries per
    # mode (an appended track's excerpt and a catalog track's)
    t0 = time.perf_counter()
    d0, d1 = host_coefs(store)
    names = [e.name for e in store.entries]
    qs = [next(x for n, _, x in appended[::-1] if n not in deleted),
          next(x for n, x in probes.items() if n not in deleted)]
    padded, n_frames = pad_frames_bucket(qs, HOP)
    qfp = fingerprint_padded_batch(padded, SR, eng.config.dsp,
                                   device=device).cpu().numpy()
    dial = eng.search_pcm_batch(None, qs, SR, tolerance=0.001)
    ali = eng.search_pcm_batch(None, qs, SR, **SERVE_ALIGNED)
    for i in range(2):
        qi = qfp[i, : n_frames[i], :2]
        for mode, votes, r in (
                ("dialplan", brute_force_votes(d0, qi[:, 0], 0.001), dial[i]),
                ("aligned", brute_force_strict(d0, d1, qi, STRICT_TOL)[1],
                 ali[i])):
            best = int(np.argmax(votes))
            want = ((names[best], int(votes[best])) if votes[best] > 0
                    else (None, 0))
            if (r.name, r.match_count) != want:
                fail(f"{tag} {mode} query {i}: engine {r} != brute force "
                     f"{want}")
    say(f"[verify] {tag}: TIR* == a brute-force numpy search over all "
        f"{len(d0)} live tracks for 2 queries x (dialplan tol 0.001, aligned "
        f"tol 0.1) ({time.perf_counter() - t0:.1f} s); phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return out


SHARD_MESH = (4, 2)  # eight cells on the one card: 2,560 rows per shard
SHARD_MODES = {
    "dialplan": {},
    **{m: {"tolerance": STRICT_TOL, **kw} for m, kw in STRICT_MODES.items()},
}
N_SHARD_REPS = 10  # in-turns timing rounds per engine, batch and mode


def shard_expected(mode: str, path: str, certified: bool) -> dict:
    """Launches of one batch-64 search on the (4, 2) mesh: each kernel of
    the path once per cell (8); a prefiltered search that fell back adds
    the full scan's."""
    full = {"dialplan": ("lattice_votes",), "bag": ("match_votes",)}.get(
        mode, ("match_votes_aligned",))
    if path == "full":
        return {k: 8 for k in full}
    pf = ["bound_scan_planes", "bound_scan"]
    if mode == "bag":
        pf += ["group_candidates", "match_votes_cand"]
    elif mode != "dialplan":
        pf += ["group_candidates", "match_votes_aligned_cand"]
    return {k: 8 for k in pf + ([] if certified else list(full))}


def phase_shard(device, eng, cfg, media: str, queries, excerpts: dict,
                card: str) -> dict:
    """The sharded path (ROADMAP item 13) on the card: NCCL at world size 1,
    the main 10,000-track checkpoint restored into a (4, 2) global mesh of
    eight cells on this card (2,560 rows per shard, both prefilter gates
    open), every search mode at batch 64 and 1 held to the unsharded engine
    (TIR*), each kernel of the path launched once per cell per search, both
    sharded prefilters at the ops level against the full scan, a meshed
    sync() of the 256 WAVs against the unsharded catalog, the long-signal
    fingerprint on one 30 s track, an append and a delete, and the p50 of
    the meshed and the unsharded engine in turns. Returns the phase's
    launches and numbers."""
    import socket

    import torch
    import torch.distributed as dist

    from tiresias_tpu_torch.api import Tiresias
    from tiresias_tpu_torch.config import TiresiasConfig
    from tiresias_tpu_torch.ops import match
    from tiresias_tpu_torch.ops.match_lattice import band_thresholds
    from tiresias_tpu_torch.ops.mfcc import (
        fingerprint_padded_batch,
        fingerprint_signal,
        pad_frames_bucket,
    )
    from tiresias_tpu_torch.parallel import distributed as tdist
    from tiresias_tpu_torch.parallel import sharding as sh
    from tiresias_tpu_torch.utils import build

    t_start = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdist.initialize_distributed(f"127.0.0.1:{port}", num_processes=1,
                                 process_id=0,
                                 local_device_ids=[device.index] * 8,
                                 device=device)
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        fail(f"[shard] expected NCCL at world size 1, got "
             f"{dist.get_backend()} x {dist.get_world_size()}")
    mesh = tdist.global_mesh(*SHARD_MESH)
    if not mesh.distributed or mesh.size != 8:
        fail(f"[shard] the global mesh is {mesh}")
    say(f"[shard] torch.distributed {dist.get_backend()} initialized at "
        f"world size {dist.get_world_size()}; global mesh {mesh}")
    out = {"mesh": list(SHARD_MESH)}
    try:
        torch.cuda.synchronize(device)
        build.reset_launch_counts()  # --- the sharded path starts here ---
        t0 = time.perf_counter()
        meng = Tiresias(cfg, exclusive=False, mesh=mesh)
        (view,) = meng.store.search_views()
        restore_s = time.perf_counter() - t0
        per = meng.store.shard_rows(view)
        pf_open = {"lattice": meng._lattice_pf_ok(view, 0.001),
                   "strict": meng._strict_pf_ok(view, 2, STRICT_TOL, 1,
                                                True)}
        say(f"[shard] restored {len(meng.store)} tracks into {view.rows} rows"
            f" ({per} per shard, {len(view.shards)} shards on {device}) in "
            f"{restore_s:.3f} s; prefilter gates open: {pf_open}")
        if per != -(-N_TRACKS // 512) * 128 or not all(pf_open.values()):
            fail("[shard] expected 2,560 rows per shard with both gates open")
        notes = pf_notes(meng)
        got = {}
        for mode, kw in SHARD_MODES.items():
            res = []
            for lo in range(0, len(queries), 64):
                res += meng.search_pcm_batch(None, queries[lo:lo + 64], SR,
                                             **kw)
            single = [meng.search_pcm(None, q, SR, **kw) for q in queries]
            got[mode] = (res, single)
        # a meshed sync of the 256 WAVs into a catalog of its own
        sync_cfg = TiresiasConfig(
            contexts=cfg.contexts,
            data_dir=os.path.join(os.path.dirname(media), "shard-sync"))
        t0 = time.perf_counter()
        seng = Tiresias(sync_cfg, mesh=mesh)
        report = seng.sync()
        sync_s = time.perf_counter() - t0
        # one 30 s track, its frames split over the eight cells
        sig = synth_tracks(1, TRACK_S, 7002, device).cpu().numpy()[0].astype(
            np.float32) / 32768.0
        usable = len(sig) // (HOP * 8) * (HOP * 8)
        long_fp = sh.sharded_fingerprint_long(mesh, sig[:usable], SR,
                                              eng.config.dsp)
        torch.cuda.synchronize(device)
        launches = dict(build.LAUNCHES)  # --- the sharded path ends here ---
        for name in ("mfcc_rows", "mfcc_framed", "bound_scan_planes",
                     "bound_scan", "match_votes", "match_votes_aligned",
                     "group_candidates", "match_votes_cand",
                     "match_votes_aligned_cand"):
            if launches[name] <= 0:
                fail(f"the sharded path never launched {name}")
        say(f"[launches] sharded path: {launches}")
        out["launches"] = launches
        cert = {m: list(v) for m, v in notes.items()}
        say(f"[shard] prefilter certificates during the path (certified, "
            f"fell back): {cert}")
        # TIR* against the unsharded engine, batch 64 and batch 1
        for mode, kw in SHARD_MODES.items():
            want = []
            for lo in range(0, len(queries), 64):
                want += eng.search_pcm_batch(None, queries[lo:lo + 64], SR,
                                             **kw)
            want = [r.to_channel_vars() for r in want]
            res, single = got[mode]
            if [r.to_channel_vars() for r in res] != want or [
                    r.to_channel_vars() for r in single] != want:
                fail(f"[shard] {mode}: meshed TIR* differ from the unsharded "
                     f"engine's")
        found = sum(r.found for r in got["bag"][0][:N_EXCERPTS])
        say(f"[shard] TIR* equal to the unsharded engine for {len(queries)} "
            f"queries x {list(SHARD_MODES)} at batch 64 and 1 ({found}/"
            f"{N_EXCERPTS} excerpts FOUND in bag mode)")
        # each kernel once per cell per search
        per_search = {}
        for mode, kw in SHARD_MODES.items():
            for path in ("prefilter", "full"):
                meng._pf_misses.clear()  # the adaptive gate re-armed
                fb0 = fallbacks()
                with (gates_closed() if path == "full"
                      else contextlib.nullcontext()):
                    torch.cuda.synchronize(device)
                    build.reset_launch_counts()
                    meng.search_pcm_batch(None, queries[:64], SR, **kw)
                    torch.cuda.synchronize(device)
                    n = {k: v for k, v in build.LAUNCHES.items() if v}
                want = shard_expected(mode, path, fallbacks() == fb0)
                if any(n.get(k, 0) != v for k, v in want.items()):
                    fail(f"[shard] {mode} {path}: launches {n}, each of "
                         f"{want} once per cell expected")
                per_search[f"{mode} {path}"] = n
        say(f"[launches] sharded, one batch-64 search on 8 cells: "
            f"{per_search}")
        out["per_search"] = per_search
        # the sharded prefilters at the ops level on the catalog's shards
        padded, n_frames = pad_frames_bucket(queries, HOP)
        qfp = fingerprint_padded_batch(padded, SR, eng.config.dsp,
                                       device=device)
        store = meng.store
        ops = {}
        lo_, hi_ = band_thresholds(-1, -1)
        q0 = torch.trunc(qfp[..., 0]).contiguous()
        valid = (torch.arange(qfp.shape[1], device=device)[None, :]
                 < torch.from_numpy(n_frames).to(device)[:, None])
        for tol in (0.001, 1.0):
            vm = store.sharded(view, store.value_map_for)
            votes, certs = sh.sharded_lattice_prefiltered(
                mesh, vm, store.sharded(view, store.value_map_q_for), q0,
                valid, tol, lo_, hi_)
            full = sh.sharded_lattice_votes(mesh, vm, q0, valid, tol, lo_,
                                            hi_)
            ops[f"dialplan tol {tol}"] = shard_certs(votes, certs, full)
        q, act, use2 = match.prepare_query(qfp, n_frames, -1, -1, False)
        db = store.sharded(view, lambda part: part.db)
        index = store.sharded(view, store.match_index_for)
        for aligned in (False, True):
            specs, maps = store.sharded_bound_maps(view, 2)
            votes, certs = sh.sharded_aligned_prefiltered(
                mesh, db, maps, q, act, use2, STRICT_TOL, specs, 2,
                aligned=aligned, index=index)
            full = sh.sharded_votes_kernels(mesh, db, q, act, use2,
                                            STRICT_TOL, 2, aligned,
                                            index=index)
            ops["aligned" if aligned else "bag"] = shard_certs(votes, certs,
                                                               full)
        for label, v in ops.items():
            say(f"[shard] ops {label}: per-shard certificates of "
                f"{len(queries)} queries {v['per_shard']}, all shards "
                f"{v['all']}; top-1 equal to the full scan wherever every "
                f"shard certifies")
        out["ops"] = ops
        # the meshed sync against the unsharded catalog
        if report.created != N_SYNC_FILES or report.failed:
            fail(f"[shard] meshed sync created {report.created}")
        worst, exact = 0.0, 0
        for e in seng.get_audios("media"):
            ref = next(x for x in eng.get_audios("media") if x.name == e.name)
            a = torch.from_numpy(seng.store.get_fingerprint(e.uuid))
            b = torch.from_numpy(eng.store.get_fingerprint(ref.uuid))
            exact += bool(torch.equal(a, b))
            worst = max(worst, fp_within_bound(a, b)[1])
        if worst > 1.0:
            fail(f"[shard] meshed sync fingerprints {worst:.3f}x the bound")
        say(f"[shard] meshed sync() of {report.created} WAVs in {sync_s:.3f} "
            f"s: {exact}/{report.created} fingerprints bitwise equal to the "
            f"unsharded catalog's, worst {worst:.3f}x the twin bound")
        seng.close()
        # the long-signal fingerprint with its halo exchange, against K2
        ref = torch.from_numpy(fingerprint_signal(sig[:usable], SR,
                                                  eng.config.dsp,
                                                  device=device))
        err, ratio = fp_within_bound(long_fp.cpu(), ref)
        if long_fp.shape != ref.shape or ratio > 1.0:
            fail(f"[shard] sharded_fingerprint_long {tuple(long_fp.shape)}: "
                 f"{ratio:.3f}x the bound")
        say(f"[shard] sharded_fingerprint_long of one {TRACK_S} s track over "
            f"8 cells (K1 per cell, halo {eng.config.dsp.buf_size - HOP} "
            f"samples): {tuple(long_fp.shape)}, max |err| {err:.2e} dB vs the "
            f"unsharded fingerprint ({ratio:.3f}x the bound)")
        # p50, meshed and unsharded in turns
        lat = {(e, b, m): [] for e in ("mesh", "flat") for b in (1, 64)
               for m in ("dialplan", "aligned")}
        engines = {"mesh": meng, "flat": eng}
        for r in range(N_SHARD_REPS):
            for name in (("mesh", "flat") if r % 2 == 0 else ("flat",
                                                              "mesh")):
                for m in ("dialplan", "aligned"):
                    kw = SHARD_MODES[m]
                    t1 = time.perf_counter()
                    engines[name].search_pcm(None, queries[r], SR, **kw)
                    lat[name, 1, m].append(time.perf_counter() - t1)
                    t1 = time.perf_counter()
                    engines[name].search_pcm_batch(None, queries[:64], SR,
                                                   **kw)
                    lat[name, 64, m].append((time.perf_counter() - t1) / 64)
        p50 = {f"{e}_b{b}_{m}": 1e3 * float(np.median(v))
               for (e, b, m), v in lat.items()}
        for m in ("dialplan", "aligned"):
            say(f"[shard] {m} p50 ms/query, meshed (4, 2) on one card vs "
                f"unsharded, in turns: batch 1 {p50[f'mesh_b1_{m}']:.4f} vs "
                f"{p50[f'flat_b1_{m}']:.4f}, batch 64 "
                f"{p50[f'mesh_b64_{m}']:.4f} vs {p50[f'flat_b64_{m}']:.4f} "
                f"({card})")
        out["p50"] = p50
        # an append and a delete on the meshed engine, then search
        (old,) = meng.store.search_views()
        probe_track = list(excerpts)[1]
        probe = synth_tracks(1, TRACK_S, 7001, device).cpu().numpy()[0]
        meng.add_audio_pcm("media", "shard-probe.wav", probe, SR)
        gone = next(e for e in meng.get_audios("media")
                    if e.name == f"gen{probe_track:05d}.wav")
        meng.delete_audio(gone.uuid)
        def no_full_build(*a, **k):
            fail("[shard] the update rebuilt the meshed view in full")

        t0 = time.perf_counter()
        if old.n_audios < old.rows:  # the append stays in its bucket
            meng.store._build_view = no_full_build
        (new,) = meng.store.search_views()
        meng.store.__dict__.pop("_build_view", None)
        update_ms = 1e3 * (time.perf_counter() - t0)
        touched = [s.index for s, o in zip(new.shards, old.shards)
                   if s.view is not o.view]
        # aligned: on this corpus bag votes tie many tracks at full votes
        kw = SHARD_MODES["aligned"]
        r_probe = meng.search_pcm(None, probe[SR:4 * SR], SR, **kw)
        r_gone = meng.search_pcm(None, excerpts[probe_track], SR, **kw)
        if r_probe.name != "shard-probe.wav" or r_gone.name == gone.name:
            fail(f"[shard] after append + delete: probe -> {r_probe.name}, "
                 f"deleted -> {r_gone.name}")
        say(f"[shard] append + delete on the meshed engine: update "
            f"{update_ms:.3f} ms touching shards {touched} of 4 (the rest "
            f"keep their views); the appended track FOUND, the deleted one "
            f"not ({r_gone.status} {r_gone.name})")
        out["update_ms"] = update_ms
        meng.close()
    finally:
        tdist.shutdown_distributed()
    say(f"[shard] phase took {time.perf_counter() - t_start:.1f} s")
    return out


def shard_certs(votes, certs, full) -> dict:
    """Per-shard and all-shard certificate counts of a sharded prefilter;
    fails unless every query whose shards all certify has the full scan's
    top-1 (votes and lowest row among the maxima)."""
    import torch

    ok = certs.all(dim=1)
    cols = torch.arange(votes.shape[1], device=votes.device)

    def top1(v):
        m = v.max(dim=1).values
        return m, torch.where(v == m[:, None], cols, v.shape[1]).min(
            dim=1).values

    for a, b in zip(top1(votes), top1(full)):
        if not torch.equal(a[ok], b[ok]):
            fail("[shard] a certified sharded prefilter's top-1 differs "
                 "from the full scan")
    return {"per_shard": certs.sum(dim=0).tolist(), "all": int(ok.sum())}


def phase_cli(device, tmp: str) -> None:
    """``python3 -m tiresias_tpu_torch.cli`` in subprocesses against a
    small data directory: create, show contexts, search (one file, and
    --top 3), fsck; every exit code 0."""
    here = os.path.dirname(os.path.abspath(__file__))
    media = os.path.join(tmp, "cli_media")
    os.makedirs(media)
    pcm = synth_tracks(4, 10, 105, device).cpu().numpy()
    for i, p in enumerate(pcm):
        write_wav_i16(os.path.join(media, f"cli{i}.wav"), p)
    conf = os.path.join(tmp, "cli.conf")
    with open(conf, "w") as f:
        f.write(f"[global]\ndata_dir={os.path.join(tmp, 'cli_data')}\n"
                f"coefs=2\ntrunc_coef1=no\naligned=yes\n"
                f"tolerance={STRICT_TOL}\n\n[media]\ndirectory={media}\n")
    query = os.path.join(tmp, "cli_query.wav")
    write_wav_i16(query, pcm[2][HOP * 40 : HOP * 40 + EXCERPT])
    env = dict(os.environ, PYTHONPATH=here)
    outs = {}
    t0 = time.perf_counter()
    for name, argv in (
        ("create", ["create"]),
        ("show contexts", ["show", "contexts"]),
        ("search", ["search", "media", query]),
        ("search --top 3", ["search", "media", query, "--top", "3"]),
        ("fsck", ["fsck", "--deep"]),
    ):
        proc = subprocess.run(
            [sys.executable, "-m", "tiresias_tpu_torch.cli", "-c", conf,
             *argv],
            env=env, capture_output=True, text=True, timeout=300,
        )
        if proc.returncode != 0:
            fail(f"[cli] {name} exited {proc.returncode}: {proc.stdout}"
                 f"{proc.stderr}")
        outs[name] = proc.stdout
    if "created[4]" not in outs["create"] or "media" not in outs[
            "show contexts"]:
        fail(f"[cli] create/show: {outs}")
    if "TIRFILENAME=cli2.wav" not in outs["search"]:
        fail(f"[cli] search: {outs['search']}")
    ranked = outs["search --top 3"].splitlines()
    if (not ranked[0].startswith("Rank") or len(ranked) < 2
            or "cli2.wav" not in ranked[1]):
        fail(f"[cli] search --top 3: {ranked}")
    if "checkpoint OK" not in outs["fsck"]:
        fail(f"[cli] fsck: {outs['fsck']}")
    say(f"[cli] create (4 WAVs), show contexts, search (FOUND cli2.wav), "
        f"search --top 3 ({len(ranked) - 1} rows, cli2.wav first), fsck --deep (checkpoint OK): exit codes 0 "
        f"on the card, {time.perf_counter() - t0:.1f} s in 5 processes")


def _strict_block(d0: np.ndarray, d1: np.ndarray, q: np.ndarray,
                  tol: np.float32):
    a, t = d0.shape
    f = len(q)
    bag = np.zeros(a, np.int64)
    acc = np.zeros((a, t + f - 1), np.int32)
    x = np.empty_like(d0)
    ok, ok1 = np.empty(d0.shape, bool), np.empty(d0.shape, bool)
    for fi in range(f):
        np.less_equal(np.abs(np.subtract(d0, q[fi, 0], out=x), out=x), tol,
                      out=ok)
        np.less_equal(np.abs(np.subtract(d1, q[fi, 1], out=x), out=x), tol,
                      out=ok1)
        ok &= ok1
        bag += ok.any(axis=1)
        acc[:, f - 1 - fi : f - 1 - fi + t] += ok
    return bag, acc.max(axis=1).astype(np.int64)


def brute_force_strict(d0: np.ndarray, d1: np.ndarray, q: np.ndarray,
                       tol: float, workers: int = 8):
    """Strict search written out over every stored frame, band filter off:
    query frame ``f`` matches stored frame ``t`` of track ``a`` when both
    coefficients lie within ``tol`` (float32). Returns (bag votes: one per
    frame with any match; aligned votes: the best offset ``t - f``'s match
    count). ``d0``/``d1`` are ``[tracks, frames]`` with NaN past each
    track's end; row blocks run on threads (numpy's loops release the
    interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    tol = np.float32(tol)
    step = -(-len(d0) // workers)
    with ThreadPoolExecutor(workers) as ex:
        parts = list(ex.map(
            lambda lo: _strict_block(d0[lo : lo + step], d1[lo : lo + step],
                                     q, tol), range(0, len(d0), step)))
    return tuple(np.concatenate([p[i] for p in parts]) for i in (0, 1))


def host_coefs(store) -> tuple:
    """Coefficients 0 and 1 of every stored track in catalog order, as two
    contiguous ``[tracks, frames]`` float32 arrays with NaN past each
    track's end (never within any tolerance)."""
    fps = [store.get_fingerprint(e.uuid) for e in store.entries]
    out = np.full((2, len(fps), max(len(x) for x in fps)), np.nan,
                  np.float32)
    for a, x in enumerate(fps):
        out[:, a, : len(x)] = x[:, :2].T
    return out[0], out[1]


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


def tag_clock(entries: list[dict], n0: int) -> list[dict]:
    """Gives each kernels-line entry that has none the clocks of the
    device_ms calls since ``CLOCKS[n0]`` (the phase that timed it)."""
    for e in entries:
        e.setdefault("clock", clocks_since(n0))
    return entries


def scan_entries() -> list[dict]:
    """The kernels line's entries of ``bound_scan``'s two kernels, each
    timed alone inside the pair (profiler) at the K-a row's case (the strict
    bound maps, 64 synthetic queries, tol 0.1), with the pair's time and
    every other case beside them."""
    main = SCAN["strict synthetic B=64"]
    cases = {k: {f: v[f] for f in ("ms", "stream_ms", "cold_ms", "plain_ms",
                                   "bound_ms", "planes_ms", "votes_ms",
                                   "clock")}
             for k, v in SCAN.items()}
    common = {
        "route": "cuda", "source": "tiresias_tpu_torch/csrc/lattice.cu",
        "max_abs_err": 0.0, "library_ms": None,
        "library": "no single PyTorch call computes the bound",
        "shape": "strict bound maps 2 x [10112, 768] uint8, B=64 synthetic "
                 "queries x 128 frames, tol 0.1",
        "pair_ms": main["ms"], "pair_bound_ms": main["bound_ms"],
        "pair_plain_ms": main["plain_ms"], "clock": main["clock"],
    }
    return [
        {"name": "bound_scan_planes", **common,
         "replaces": "tiresias_tpu/ops/match_lattice.py:583",
         "ms": main["planes_ms"], "plain_ms": main["plain_planes_ms"],
         "plain": "the twin's histograms (scan_histograms)",
         "bound_ms": main["planes_bound_ms"], "bound_by": "bytes"},
        {"name": "bound_scan", **common,
         "replaces": "tiresias_tpu/ops/match_lattice.py:304",
         "ms": main["votes_ms"], "plain_ms": main["plain_votes_ms"],
         "plain": "the twin's votes, credit, min and mask "
                  "(scan_votes_reference)",
         "bound_ms": main["votes_bound_ms"], "bound_by": "bytes",
         "cases": cases},
    ]


def run(device) -> dict:
    import torch

    from tiresias_tpu_torch import ContextConfig, TiresiasConfig
    from tiresias_tpu_torch.ops import match_kernels as tk
    from tiresias_tpu_torch.utils import build

    t_start = time.perf_counter()

    def took(label: str) -> None:
        say(f"[time] {label} done at {time.perf_counter() - t_start:.1f} s")

    card = phase_card(device)
    phase_build()
    n0 = len(CLOCKS)
    kernels = phase_kernels(device, TiresiasConfig().dsp)
    tag_clock(kernels, n0)
    took("[kernels]")
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
        took("[ingest] and [catalog]")
        queries = [excerpts[t] for t in starts]
        queries += [np.zeros(EXCERPT, np.int16)] * (N_NOISE // 2)
        queries += [
            np.clip(rng.normal(0, 3000, EXCERPT), -32768, 32767).astype(
                np.int16) for _ in range(N_NOISE - N_NOISE // 2)
        ]
        run_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        results, p50, search_info = phase_search(device, eng, queries)
        torch.cuda.synchronize(device)
        launches = dict(build.LAUNCHES)  # --- the main path ends here ---
        search_peak = torch.cuda.max_memory_allocated(device)
        say(f"[search] max_memory_allocated {search_peak} B during the "
            f"searches, {max(run_peak, search_peak)} B over the run")
        for name in ("mfcc_rows", "mfcc_framed", "lattice_votes",
                     "bound_scan_planes", "bound_scan"):
            if launches[name] <= 0:
                fail(f"the main path never launched {name}")
        say(f"[launches] main path: {launches}")
        took("[search]")
        library = phase_lattice_real(*phase_verify(device, eng, queries,
                                                   results))
        took("[verify] and the real-histogram kernels")
        torch.cuda.synchronize(device)
        routes0 = tk.route_counts(device).clone()
        build.reset_launch_counts()  # --- the strict path starts here ---
        strict, strict_p50, strict_info = phase_strict(device, eng, queries)
        torch.cuda.synchronize(device)
        strict_launches = dict(build.LAUNCHES)  # --- and ends here ---
        routes = (tk.route_counts(device) - routes0).tolist()
        # the candidate forms: grouped at batch > 1, per item at batch 1
        match_names = ("match_votes", "match_votes_aligned",
                       "match_votes_aligned_dense", "group_candidates",
                       "match_votes_cand", "match_votes_aligned_cand",
                       "match_votes_aligned_cand_dense",
                       "match_votes_cand_per_item",
                       "match_votes_aligned_cand_per_item",
                       "match_votes_aligned_cand_dense_per_item")
        scan_names = ("bound_scan_planes", "bound_scan")
        for name in match_names + scan_names:
            if strict_launches[name] <= 0:
                fail(f"the strict path never launched {name}")
        if routes[0] <= 0 or routes[2] <= 0:
            fail(f"the strict path never took the index route: {routes}")
        say(f"[launches] strict path: {strict_launches}; work items (K4 "
            f"index, K4 dense, K5 index, K5 dense): {routes}")
        launches.update({k: strict_launches[k] for k in match_names})
        for name in scan_names:
            launches[name] += strict_launches[name]
        took("[strict]")
        phase_verify_strict(device, eng, queries, strict)
        took("[verify] [strict]")
        n0 = len(CLOCKS)
        kernels += tag_clock(phase_match_real(device, eng, queries), n0)
        took("the catalog's K4/K5 and candidate forms")
        shard = phase_shard(device, eng, cfg, media, queries, excerpts,
                            card["card"])
        shard_launches = shard["launches"]
        took("[shard]")
        torch.cuda.synchronize(device)
        build.reset_launch_counts()  # --- the serve path starts here ---
        serve_launches = phase_serve(device, eng, cfg, queries)
        for names in (("mfcc_rows",), ("lattice_votes", "bound_scan"),
                      ("match_votes_aligned", "match_votes_aligned_cand")):
            if sum(serve_launches[n] for n in names) <= 0:
                fail(f"the serve path never launched {' or '.join(names)}")
        say(f"[launches] serve path: {serve_launches}")
        took("[serve]")
        mutate = {"10k": phase_mutate(
            device, eng, "10k",
            {f"gen{t:05d}.wav": x for t, x in excerpts.items()}, 4001)}
        took("[mutate] 10k")
        eng.close()
        del eng
        torch.cuda.empty_cache()
        prefilter = phase_prefilter(device, tmp)
        mutate["100k"] = prefilter.pop("mutate")
        took("[prefilter] and [mutate] 100k")
        phase_cli(device, tmp)
        took("[cli]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kernels += scan_entries()
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_serve"] = serve_launches[k["name"]]
        k["launches_shard"] = shard_launches[k["name"]]
    clocks = {c: CLOCKS.count(c) for c in ("profiler", "events")}
    say(f"[clocks] device_ms calls by clock: {clocks}")
    return {"kernels": kernels, "card": card["card"], "ingest_rate": rate,
            "p50": p50, "strict_p50": strict_p50,
            "summary": {"search": search_info, "strict": strict_info,
                        "library_ms": library, "prefilter": prefilter,
                        "mutate": mutate, "shard": shard,
                        "bound_scan": SCAN, "clocks": clocks}}


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
    say(f"[summary] {json.dumps(out['summary'])}")
    say(json.dumps({"kernels": out["kernels"]}))
    say(out["card"])  # name, power limit — as nvidia-smi prints them
    say(json.dumps({"ok": True, "device": device_report(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
