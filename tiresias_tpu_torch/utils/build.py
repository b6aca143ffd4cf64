"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles in its own ``nvcc`` process, all started together,
and the objects link into one shared library with a plain C interface,
loaded with :mod:`ctypes` (no PyTorch headers: seconds to build, not
minutes). The library lands in ``build/kernels/`` beside the package
(``TIRESIAS_KERNEL_DIR`` overrides it), named by a hash of the sources and
flags so an edited source never loads a stale build. Nothing is built at
import time; the first kernel launch builds.

ABI of every entry point: pointers and the stream are ``void*``, sizes
``int``, the tolerance ``float``; each returns ``cudaGetLastError()`` right
after its launch, and the wrapper raises on a non-zero code (a refused
launch never runs, and ``torch.cuda.synchronize()`` would not report it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
SOURCES = ("mfcc_fft.cu", "mfcc.cu", "lattice.cu", "match.cu")
HEADERS = ("common.cuh",)
# No --use_fast_math / -ftz=true: the aubio log floor 2e-42 is subnormal.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# Kernel launches per wrapper. Each wrapper adds one where it launches its
# kernel and nowhere else, so a run can show that its main path went through
# the kernels (chip_smoke.py zeroes the counts before driving the path).
# mfcc_rows / mfcc_framed count the FFT route, the *_dft names the DFT route;
# K5 is two kernels: match_votes_aligned (the index kernel) and
# match_votes_aligned_dense (the dense kernel over its work list); the work
# items of each route are counted on the device
# (ops/match_kernels.py::route_counts). bound_scan_planes and bound_scan
# are the prefilters' bound stage (its
# planes prologue and its votes); the *_cand names are K4/K5's grouped
# candidate form (the strict/aligned prefilter's rescore) and
# group_candidates its work list (three kernels, one launch count); the
# *_per_item names the per-item candidate form (the forced "per_item" route,
# and batch 1).
LAUNCHES: dict[str, int] = {
    "mfcc_rows": 0, "mfcc_framed": 0, "mfcc_rows_dft": 0,
    "mfcc_framed_dft": 0, "lattice_votes": 0,
    "bound_scan_planes": 0, "bound_scan": 0,
    "match_votes": 0, "match_votes_aligned": 0,
    "match_votes_aligned_dense": 0, "group_candidates": 0,
    "match_votes_cand": 0, "match_votes_aligned_cand": 0,
    "match_votes_aligned_cand_dense": 0, "match_votes_cand_per_item": 0,
    "match_votes_aligned_cand_per_item": 0,
    "match_votes_aligned_cand_dense_per_item": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # frames, rows, win, dft_re, dft_im, n_bins, mel_t, n_filters, dct_t,
    # n_coefs, out, stream
    "tiresias_mfcc_rows": [_P, _I, _I, _P, _P, _I, _P, _I, _P, _I, _P, _P],
    # pcm, batch, n_samples, hop, n_frames, dft_re, dft_im, n_bins, mel_t,
    # n_filters, dct_t, n_coefs, out, stream
    "tiresias_mfcc_framed": [
        _P, _I, _I, _I, _I, _P, _P, _I, _P, _I, _P, _I, _P, _P,
    ],
    # frames, rows, n_fft, win2, tw, tws, mel_idx, mel_w, n_filters, dct_t,
    # n_coefs, out, stream
    "tiresias_mfcc_rows_fft": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _I, _P,
                               _P],
    # pcm, batch, n_samples, hop, n_frames, win2, tw, tws, mel_idx, mel_w,
    # n_filters, dct_t, n_coefs, out, stream
    "tiresias_mfcc_framed_fft": [
        _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P,
    ],
    # counts, value_map, batch, rows, k_size, tol, n_planes, scratch,
    # votes, stream
    "tiresias_lattice_votes": [_P, _P, _I, _I, _I, _F, _I, _P, _P, _P],
    # n_maps, max k_size, batch, n_planes -> scratch bytes
    "tiresias_bound_scan_scratch": [_I, _I, _I, _I],
    # q, active, use2, batch, frames, n_coefs, n_maps, ints (host), floats
    # (host), n_planes, scratch, counts (or null), stream
    "tiresias_bound_scan_planes": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _I,
                                   _P, _P, _P],
    # maps (host array of device pointers), n_maps, ints, floats, batch,
    # rows, n_planes, scratch, ctx_ids (or null), ctx_id, votes, stream
    "tiresias_bound_scan": [_P, _I, _P, _P, _I, _I, _I, _P, _P, _I, _P, _P],
    # db, query_rows, entries, pos, n_live, batch, rows, t_len, n_coefs,
    # coefs, f_len, chunk, n_chunks, tol, dense share, cand (or null),
    # n_cand, votes, routes, stream
    "tiresias_match_votes": [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P, _I,
        _P, _P, _P,
    ],
    # the same with the warps per block before cand, and the work list
    # and its length after votes
    "tiresias_match_votes_aligned": [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P,
        _I, _P, _P, _P, _P, _P,
    ],
    # chunk, f_len, batch
    "tiresias_match_aligned_warps": [_I, _I, _I],
    # cand, batch, n_cand, rows, queries per item, counts, slots, items,
    # n_items, stream
    "tiresias_group_candidates": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # db, query_rows, entries, pos, n_live, t_len, n_coefs, coefs, f_len,
    # chunk, n_chunks, tol, share, small-batch share, queries for the
    # share, n_cand, queries per item, slots, items, n_items, max items,
    # votes, routes, stream
    "tiresias_match_votes_group": [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _I, _I,
        _P, _P, _P, _I, _P, _P, _P,
    ],
    # the same with the warps per block before n_cand, and the work list
    # and its length after votes
    "tiresias_match_votes_aligned_group": [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _I, _I,
        _I, _P, _P, _P, _I, _P, _P, _P, _P, _P,
    ],
}

_lock = threading.Lock()
# the serve layer launches from several executor threads at once: an
# unguarded ``+= 1`` would lose counts
_count_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_seconds: float | None = None


def reset_launch_counts() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def build_dir() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
    return os.environ.get(
        "TIRESIAS_KERNEL_DIR", os.path.join(root, "build", "kernels")
    )


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(env)
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels build from "
        "tiresias_tpu_torch/csrc on first use"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def kernel_library() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use. Raises when the
    build or the load fails — there is no fallback."""
    global _lib, _build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        out_dir = build_dir()
        os.makedirs(out_dir, exist_ok=True)
        so = os.path.join(out_dir, f"libtiresias_kernels.{_digest()}.so")
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            nvcc = _nvcc()
            objs = [f"{tmp}.{name}.o" for name in SOURCES]
            try:
                procs = [
                    subprocess.Popen(
                        [nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                         os.path.join(CSRC, name)],
                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True,
                    )
                    for name, obj in zip(SOURCES, objs)
                ]
                outs = [proc.communicate()[0] for proc in procs]
                for proc, out, name in zip(procs, outs, SOURCES):
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"nvcc failed on {name} ({proc.returncode}):\n"
                            f"{out}"
                        )
                proc = subprocess.run(
                    [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                )
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc link failed ({proc.returncode}):\n{proc.stdout}"
                    )
            finally:
                for obj in objs:
                    if os.path.exists(obj):
                        os.remove(obj)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        _build_seconds = time.perf_counter() - t0
        return _lib


def build_seconds() -> float | None:
    """Seconds the first :func:`kernel_library` call took (build + load)."""
    return _build_seconds


def check(name: str, rc: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` code from a launch;
    otherwise count the launch."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    with _count_lock:
        LAUNCHES[name] += 1
