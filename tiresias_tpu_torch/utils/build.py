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
import re
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
SOURCES = ("mfcc_fft.cu", "mfcc.cu", "lattice.cu", "match.cu", "select.cu")
HEADERS = ("common.cuh",)
# No --use_fast_math / -ftz=true: the aubio log floor 2e-42 is subnormal.
# -Xptxas=-v: each kernel's registers, stack frame and spills, kept beside
# the library (ptxas_report).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# Kernel launches per wrapper. Each wrapper adds one where it launches its
# kernel and nowhere else, so a run can show that its main path went through
# the kernels (chip_smoke.py zeroes the counts before driving the path).
# mfcc_rows / mfcc_framed count the FFT route, the *_dft names the DFT route;
# K5's full scan is match_votes_aligned (the index kernel) and
# match_votes_aligned_bits (the bit-sliced kernel: the rows the index kernel
# lists, or every row), match_votes_aligned_dense its forced every-pair
# route; the work items of each route are counted on the device
# (ops/match_kernels.py::route_counts). bound_scan_planes and bound_scan
# are the prefilters' bound stage (its
# planes prologue and its votes); the *_cand names are K4/K5's grouped
# candidate form (the strict/aligned prefilter's rescore) and
# group_candidates its work list (three kernels, one launch count), with
# K5's index kernel match_votes_aligned_cand and its wide kernels (also the
# full scan's below SMALL_BATCH): match_votes_aligned_cand_bits, the
# bit-sliced kernel's launch over work items (the items of
# BITS_MIN_QUERIES queries or more that the index kernel lists, the forced
# route "bits" and queries too long for the index kernel, in the full scan
# at any batch too), and
# match_votes_aligned_cand_dense, the grouped every-pair kernel (the items
# of fewer queries, and the forced route "dense");
# match_votes_aligned_bits is the same kernel's launch over the rows that
# the full scan's index kernel lists from SMALL_BATCH on; the
# *_per_item names the per-item candidate form (the forced "per_item" route,
# and batch 1); select_candidates is every prefilter's candidate
# selection (K-b: one kernel, kb_select_kernel) and rescore_rows the
# dialplan prefilter's rescore.
LAUNCHES: dict[str, int] = {
    "mfcc_rows": 0, "mfcc_framed": 0, "mfcc_rows_dft": 0,
    "mfcc_framed_dft": 0, "lattice_votes": 0,
    "bound_scan_planes": 0, "bound_scan": 0,
    "match_votes": 0, "match_votes_aligned": 0,
    "match_votes_aligned_dense": 0, "group_candidates": 0,
    "match_votes_cand": 0, "match_votes_aligned_cand": 0,
    "match_votes_aligned_cand_dense": 0, "match_votes_cand_per_item": 0,
    "match_votes_aligned_cand_per_item": 0,
    "match_votes_aligned_bits": 0, "match_votes_aligned_cand_bits": 0,
    "select_candidates": 0, "rescore_rows": 0,
}

# The CUDA kernels each counted launch runs once, by a part of their names
# as torch.profiler records them (demangled; template arguments kept): a
# profile's launches per call of a kernel are its counter's per call
# (utils/timing.py reads a profile that lost records with them).
KERNEL_NAMES: dict[str, tuple[str, ...]] = {
    "mfcc_rows": ("mfcc_rows_fft_kernel",),
    "mfcc_framed": ("mfcc_framed_fft_kernel",),
    "mfcc_rows_dft": ("mfcc_rows_kernel",),
    "mfcc_framed_dft": ("mfcc_framed_kernel",),
    "lattice_votes": ("lattice_planes_kernel", "lattice_votes_kernel"),
    "bound_scan_planes": ("bound_scan_planes_kernel",),
    "bound_scan": ("bound_scan_kernel",),
    "match_votes": ("match_votes_kernel<false>",),
    "match_votes_aligned": ("match_votes_aligned_kernel<false>",),
    "match_votes_aligned_dense": ("match_votes_aligned_dense_kernel",),
    "group_candidates": ("group_count_kernel", "group_scan_kernel",
                         "group_scatter_kernel"),
    "match_votes_cand": ("match_votes_group_kernel",),
    "match_votes_aligned_cand": ("match_votes_aligned_group_kernel",),
    "match_votes_aligned_cand_dense": (
        "match_votes_aligned_group_dense_kernel",),
    "match_votes_cand_per_item": ("match_votes_kernel<true>",),
    "match_votes_aligned_cand_per_item": ("match_votes_aligned_kernel<true>",),
    "match_votes_aligned_bits": ("match_votes_aligned_bits_kernel_ws<",),
    "match_votes_aligned_cand_bits": ("match_votes_aligned_bits_kernel_ws<",),
    "select_candidates": ("kb_select_kernel", "kb_select_grid_kernel"),
    "rescore_rows": ("rescore_rows_kernel",),
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
    # the same with the kept coefficient-1 order (d1, pos1, n1) after
    # n_live, the warps per block before cand, and the work list, its
    # length, the rows' query masks and row flags after votes
    "tiresias_match_votes_aligned": [
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
        _F, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P,
    ],
    # chunk, f_len, batch
    "tiresias_match_aligned_warps": [_I, _I, _I],
    # db, query_rows, entries, pos, n_live, d1, pos1, n1, batch, rows,
    # t_len, n_coefs, coefs, f_len, chunk, n_chunks, tol, votes, routes,
    # stream
    "tiresias_match_votes_aligned_bits": [
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
        _P, _P, _P,
    ],
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
    # the same with the kept coefficient-1 order (d1, pos1, n1) after
    # n_live, the bit-sliced kernel's share and its fewest queries an item,
    # the warps per block and the wide kernels' mask before n_cand, the
    # full scan's batch (0 otherwise) and the rows after g, and the work
    # lists and their lengths after votes
    "tiresias_match_votes_aligned_group": [
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F,
        _I, _F, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P,
        _P,
    ],
    # bound, batch, rows, k, the plan (ctas, cooperative, slice, chunk,
    # slots, resident, data_elems), scratch (or null), idx, unselected_max,
    # stream
    "tiresias_select_candidates": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _P, _P, _P, _P],
    # batch, ctas, cooperative -> 4-byte words of scratch
    "tiresias_select_scratch": [_I, _I, _I],
    # cooperative, data_elems, slots -> dynamic shared memory of a CTA
    "tiresias_select_smem": [_I, _I, _I],
    # rows, the plan (ctas, slice, chunk, slots, resident, data_elems) ->
    # clusters the card holds at once
    "tiresias_select_max_clusters": [_I, _I, _I, _I, _I, _I, _I],
    # value_map, k_size, counts, idx, batch, k, tol, ctx_ids (or null),
    # ctx_id, votes, stream
    "tiresias_rescore_rows": [_P, _I, _P, _P, _I, _I, _F, _P, _I, _P, _P],
}

_lock = threading.Lock()
# the serve layer launches from several executor threads at once: an
# unguarded ``+= 1`` would lose counts
_count_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_report = [""]  # the loaded library's ptxas report
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
                with open(f"{tmp}.ptxas", "w") as f:
                    f.write("".join(outs))
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
            os.replace(f"{tmp}.ptxas", f"{so}.ptxas")
            os.replace(tmp, so)
        _report[0] = f"{so}.ptxas"
        lib = ctypes.CDLL(so)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        _build_seconds = time.perf_counter() - t0
        return _lib


def ptxas_report(part: str) -> list[dict]:
    """What ``ptxas -v`` reported, when the loaded library was built, for
    each kernel whose (mangled) name holds ``part``: ``{"kernel",
    "registers", "stack", "spill_stores", "spill_loads"}`` (bytes a
    thread). Empty before the first :func:`kernel_library` call."""
    if not _report[0] or not os.path.exists(_report[0]):
        return []
    out, cur = [], None
    with open(_report[0]) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = {"kernel": m.group(1)} if part in m.group(1) else None
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and "stack" not in cur:
                cur.update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                out.append(cur)
                cur = None
    return out


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
