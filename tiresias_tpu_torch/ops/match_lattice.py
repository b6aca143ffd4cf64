"""Lattice matcher for the dialplan path (port of
``tiresias_tpu.ops.match_lattice``).

The reference's dialplan searches one coefficient and truncates the query's
max1 to an integer, so every query frame lives on an integer lattice and the
vote factorizes exactly (PARITY.md section 3):

    M[a, k]    = min_t |db[a, t, 0] - k|            (distance map, per DB)
    C[b, k]    = #{active frames f : trunc(q[b, f, 0]) == k}   (histogram)
    votes[b,a] = sum_k C[b, k] * (M[a, k] <= tol)   (kernel K3')

The map build is plain torch (the JAX package left it to XLA); the vote is
the hand-written kernel ``csrc/lattice.cu`` behind :func:`hit_votes` (u8
tensor-core products that skip the buckets no query of a tile uses), with
:func:`lattice_votes_reference` as its plain twin. The certified
prefilters' bound stage, from the raw query values to the final bound, is
the kernel pair :func:`bound_scan` (plain twin :func:`bound_scan_reference`);
their candidate selection and the dialplan rescore are the kernels of
``csrc/select.cu`` behind :func:`select_candidates` and :func:`rescore_rows`
(twins :func:`select_candidates_reference`, :func:`rescore_rows_reference`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from tiresias_tpu_torch.utils import build

# Integer lattice covering every reachable truncated fingerprint value:
# stored values are floored at 10*log10(2e-42) ~ -417; +127 is far beyond
# anything finite PCM produces. Out-of-lattice query frames score zero.
K_MIN = -512
K_SIZE = 640  # covers [-512, 127]

# Rows per build block: bounds the [rows, T] int64 bucket index and the
# [rows, K] float temporaries of the distance transform.
BUILD_CHUNK = 8192


def band_thresholds(
    freq_ignore_low: int, freq_ignore_high: int
) -> tuple[float, float]:
    """Band-filter thresholds in the fingerprint's log domain, rounded to
    float32 as the JAX matcher compares them; disabled sides are +-inf
    (fp_handler.c:293-306)."""
    lo = (
        10.0 * np.log10(freq_ignore_low) if freq_ignore_low > 0 else -np.inf
    )
    hi = (
        10.0 * np.log10(freq_ignore_high) if freq_ignore_high > 0 else np.inf
    )
    return float(np.float32(lo)), float(np.float32(hi))


def _build_block(db0, db_mask, k_min: int, k_size: int) -> torch.Tensor:
    """One block of :func:`build_value_map`: the exact O(A*(T+K)) 1-D
    distance transform of ``_build_value_map_block`` (match_lattice.py
    :132-174). Bucket each value by ``floor(v)``, keep the per-bucket min
    and max VALUE, then

        M[a, k] = min(suffix_min_{j>=k}(vmin[a, j]) - k,
                      k - prefix_max_{j<k}(vmax[a, j]))

    which is bitwise ``min_t |fl(v - k)|`` (one float32 subtraction per
    candidate, monotone in v). Masked entries scatter +-inf, the identities
    of min/max; all-masked rows come out +inf everywhere. A NaN among a
    row's unmasked values makes the whole row NaN, as XLA's NaN-propagating
    min/max scans make it in the JAX package (never a hit; quantized: 0)."""
    a = db0.shape[0]
    dev = db0.device
    nan_rows = (torch.isnan(db0) & db_mask).any(dim=1)
    db_mask = db_mask & ~torch.isnan(db0)
    v_lo = torch.where(db_mask, db0, torch.inf)
    v_hi = torch.where(db_mask, db0, -torch.inf)
    # clip in float and zero masked entries BEFORE the integer cast (a
    # NaN or inf cast is undefined); masked entries carry identities anyway
    bins = torch.clamp(torch.floor(db0) - k_min, 0, k_size - 1)
    bins = torch.where(db_mask, bins, 0.0).to(torch.int64)
    vmin = torch.full((a, k_size), torch.inf, device=dev).scatter_reduce(
        1, bins, v_lo, "amin"
    )
    vmax = torch.full((a, k_size), -torch.inf, device=dev).scatter_reduce(
        1, bins, v_hi, "amax"
    )
    suffix_min = torch.flip(torch.cummin(torch.flip(vmin, [1]), 1).values, [1])
    prefix_max = torch.cat(
        [
            torch.full((a, 1), -torch.inf, device=dev),
            torch.cummax(vmax, 1).values[:, :-1],
        ],
        dim=1,
    )
    ks = torch.arange(k_min, k_min + k_size, dtype=torch.float32, device=dev)
    vm = torch.minimum(suffix_min - ks[None, :], ks[None, :] - prefix_max)
    return torch.where(nan_rows[:, None], torch.nan, vm)


def build_value_map(
    db0: torch.Tensor, db_mask: torch.Tensor, k_min: int = K_MIN,
    k_size: int = K_SIZE,
) -> torch.Tensor:
    """``M [A, K]`` float32: distance from each lattice integer to the
    nearest unmasked stored max1 frame of each audio, built in row blocks
    of :data:`BUILD_CHUNK` on the inputs' device."""
    db0 = db0.to(torch.float32)
    parts = [
        _build_block(db0[lo : lo + BUILD_CHUNK], db_mask[lo : lo + BUILD_CHUNK],
                     k_min, k_size)
        for lo in range(0, db0.shape[0], BUILD_CHUNK)
    ]
    if not parts:
        return torch.empty((0, k_size), dtype=torch.float32, device=db0.device)
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def frame_buckets(q0, active, band_lo: float, band_hi: float,
                  k_min: int = K_MIN, k_size: int = K_SIZE):
    """Per-frame lattice bucket and validity under the reference's
    truncation (``trunc``, the C ``(int)`` cast — not floor), lattice-range
    and band rules. Out-of-lattice values (NaN, +-inf, pathological
    magnitudes) are masked and replaced BEFORE the integer cast."""
    kq = torch.trunc(q0)
    in_range = (kq >= k_min) & (kq < k_min + k_size)
    in_band = (kq >= band_lo) & (kq <= band_hi)
    valid = active & in_range & in_band
    idx = torch.where(valid, kq, float(k_min)).to(torch.int64) - k_min
    return idx, valid


def histogram(q0, active, band_lo: float, band_hi: float,
              k_min: int = K_MIN, k_size: int = K_SIZE) -> torch.Tensor:
    """Query histogram ``C [B, K]`` int32 — exact counts by scatter-add."""
    idx, valid = frame_buckets(q0, active, band_lo, band_hi, k_min, k_size)
    c = torch.zeros((q0.shape[0], k_size), dtype=torch.int32, device=q0.device)
    return c.scatter_add_(1, idx, valid.to(torch.int32))


def lattice_votes_reference(
    counts: torch.Tensor, value_map: torch.Tensor, tol: float
) -> torch.Tensor:
    """K3''s plain twin: ``C @ (M <= tol).T`` as ``_hit_matmul`` computes
    it (float32 product of small integers — exact), returned as int32. A
    uint8 map compares as float32 (lossless), as XLA promotes it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hits = (value_map.to(torch.float32) <= tol).to(torch.float32)
    return (counts.to(torch.float32) @ hits.T).to(torch.int32)


# K3''s work layout (csrc/lattice.cu): buckets in steps of 32 (the depth of
# one u8 mma), queries in tiles of 64. Its scratch holds the u8 count planes
# [planes, B, steps * 32] and one non-empty flag per (tile, step).
STEP = 32
QUERY_TILE = 64


def count_planes(max_count: int | None) -> int:
    """u8 planes K3' splits the counts into (``count = sum_p 256^p *
    plane_p``): the fewest that hold ``max_count``, a bound on every count
    the caller already knows (a histogram's counts are at most its frame
    count). Without a bound, four: any non-negative int32."""
    if max_count is None:
        return 4
    if max_count < 0:
        raise ValueError(f"max_count must be >= 0, got {max_count}")
    for planes in (1, 2, 3):
        if max_count < 256**planes:
            return planes
    return 4


def hit_votes(
    counts: torch.Tensor, value_map: torch.Tensor, tol: float,
    max_count: int | None = None,
) -> torch.Tensor:
    """K3': ``votes [B, A] int32 = sum_k counts[b, k] * (M[a, k] <= tol)``
    without materializing the ``[A, K]`` hit matrix. ``tol`` is compared
    as float32. ``max_count`` bounds every count (see :func:`count_planes`);
    it picks the kernel's plane count and never needs a readback. The
    kernel stages a query tile's counts in shared memory, which holds
    ``K * planes`` up to about 3,600."""
    tol = float(np.float32(tol))
    planes = count_planes(max_count)
    if counts.device.type == "cpu":
        return lattice_votes_reference(counts, value_map, tol)
    if counts.device.type != "cuda" or value_map.device != counts.device:
        raise ValueError(
            f"hit_votes: counts on {counts.device}, map on {value_map.device}"
        )
    if (
        counts.dtype != torch.int32 or value_map.dtype != torch.float32
        or not counts.is_contiguous() or not value_map.is_contiguous()
        or counts.ndim != 2 or value_map.ndim != 2
        or counts.shape[1] != value_map.shape[1]
        or value_map.data_ptr() % 16
    ):
        raise ValueError(
            "hit_votes needs contiguous counts [B, K] int32 and a 16-byte "
            "aligned value_map [A, K] float32 (got "
            f"{tuple(counts.shape)} {counts.dtype}, "
            f"{tuple(value_map.shape)} {value_map.dtype})"
        )
    b, k = counts.shape
    a = value_map.shape[0]
    votes = torch.empty((b, a), dtype=torch.int32, device=counts.device)
    if b == 0 or a == 0:
        return votes
    if k == 0:
        return votes.zero_()
    steps = -(-k // STEP)
    scratch = torch.empty(
        planes * b * steps * STEP + -(-b // QUERY_TILE) * steps,
        dtype=torch.uint8, device=counts.device,
    )
    rc = build.kernel_library().tiresias_lattice_votes(
        counts.data_ptr(), value_map.data_ptr(), b, a, k, tol, planes,
        scratch.data_ptr(), votes.data_ptr(),
        torch.cuda.current_stream(counts.device).cuda_stream,
    )
    build.check("lattice_votes", rc)
    return votes


def lattice_votes(
    value_map: torch.Tensor,
    q0: torch.Tensor,
    active: torch.Tensor,
    tolerance: float,
    band_lo: float,
    band_hi: float,
    k_min: int = K_MIN,
    k_size: int = K_SIZE,
) -> torch.Tensor:
    """Votes ``[B, A]`` int32: histogram of the truncated query max1
    values, then K3' against the distance map.

    Args:
      value_map: ``M [A, K]`` from :func:`build_value_map`.
      q0: ``[B, F]`` query max1 values (truncation is applied here).
      active: ``[B, F]`` valid-frame mask (the band filter is applied on the
        lattice here).
      tolerance: inclusive.
      band_lo / band_hi: from :func:`band_thresholds`.
    """
    c = histogram(q0, active, band_lo, band_hi, k_min, k_size)
    # a bucket holds at most every frame: the plane count K3' needs
    return hit_votes(c, value_map, tolerance, max_count=q0.shape[1])


# ---- certified prefilters (PARITY.md D17/D19/D20) ------------------------ #
#
# A prefilter bounds every row's votes from above with the quantized maps
# below (:func:`bound_scan`), rescores the ``k`` rows of highest bound
# exactly, and certifies the result when the ``top``-th best rescored score
# strictly beats the highest bound left unselected; the engine full-scans
# otherwise.

# Distances in the uint8 maps are ``floor(d * BOUND_Q)``, saturating at
# BOUND_FAR (dead, tombstoned and padding rows hold it). Floor only
# under-states a distance, so ``(Mq <= tol * BOUND_Q)`` is a superset of the
# exact hit set for any tolerance: the bound stays valid.
BOUND_Q = 64
BOUND_FAR = 255

# Bound-map specs of the strict/aligned prefilter: ``(scale, lo, hi)`` of a
# coefficient's CLIPPED, SCALED values. Clipping is 1-Lipschitz, so a true
# hit |q_c - d_c| <= tol implies a clipped-scaled lattice hit within
# ``s * tol + 1``; K is ``(hi - lo) * s + 128`` (768 for both).
BOUND_SPEC_C0 = (4.0, -120.0, 40.0)  # coef 0 spans the energy floor
BOUND_SPEC_CN = (8.0, -40.0, 40.0)  # higher coefs concentrate near 0

# Candidates the dialplan prefilter rescores (the engine takes it above
# 2 x this many rows per view).
LATTICE_PREFILTER_K = 256


def quantize_value_map(value_map: torch.Tensor) -> torch.Tensor:
    """uint8 companion of the dialplan distance map: ``floor(d * BOUND_Q)``
    clipped to [0, BOUND_FAR] (+inf rows land on the sentinel; a NaN row,
    :func:`_build_block`, becomes 0, as XLA converts NaN)."""
    q = torch.clamp(torch.floor(value_map * float(BOUND_Q)), 0.0,
                    float(BOUND_FAR))
    return torch.nan_to_num(q, nan=0.0).to(torch.uint8)


def bound_coef_indices(n_coefs: int) -> tuple[int, ...]:
    """The coefficients the strict/aligned bound tests, for a search that
    tests ``n_coefs`` (a bound on a coefficient the search does not test
    would be unsound): coefs 1-2 discriminate best, and two coefficients
    AND both."""
    if n_coefs >= 3:
        return (1, 2)
    if n_coefs == 2:
        return (0, 1)
    return (0,)


def bound_specs(n_coefs: int) -> tuple:
    """Per-coefficient specs ``(coef, scale, lo, hi, k_min, k_size)`` of the
    bound maps."""
    out = []
    for c in bound_coef_indices(n_coefs):
        s, lo, hi = BOUND_SPEC_C0 if c == 0 else BOUND_SPEC_CN
        out.append((c, s, lo, hi, int(lo * s), int((hi - lo) * s) + 128))
    return tuple(out)


def build_bound_map(db: torch.Tensor, db_mask: torch.Tensor,
                    spec: tuple) -> torch.Tensor:
    """One spec's uint8 ``[A, k_size]`` bound map: the value map of
    ``clip(db[..., c], lo, hi) * s`` quantized as :func:`quantize_value_map`,
    built in row blocks where ``db`` lies."""
    c, s, lo, hi, k_min, k_size = spec
    parts = [
        quantize_value_map(_build_block(
            torch.clamp(db[r0 : r0 + BUILD_CHUNK, :, c], lo, hi) * s,
            db_mask[r0 : r0 + BUILD_CHUNK], k_min, k_size,
        ))
        for r0 in range(0, db.shape[0], BUILD_CHUNK)
    ]
    return torch.cat(parts) if len(parts) != 1 else parts[0]


def build_bound_maps(db: torch.Tensor, db_mask: torch.Tensor,
                     coefs: int | None = None) -> tuple:
    """``(specs, maps)``: one :func:`build_bound_map` per spec (``coefs``:
    how many coefficients the search tests; default every stored one)."""
    if coefs is None:
        coefs = db.shape[2]
    specs = bound_specs(min(coefs, db.shape[2]))
    return specs, tuple(build_bound_map(db, db_mask, sp) for sp in specs)


def bound_threshold(scale: float | None, tolerance: float) -> float:
    """The uint8 maps' threshold in float32, as the JAX package computes it:
    ``tol * BOUND_Q`` for the dialplan map (``scale`` None), ``(s * tol +
    1) * BOUND_Q`` for a bound spec (the +1 is the truncation allowance)."""
    f32 = np.float32
    tol = f32(tolerance)
    if scale is None:
        return float(tol * f32(BOUND_Q))
    return float((f32(scale) * tol + f32(1.0)) * f32(BOUND_Q))


class ScanMap(NamedTuple):
    """How a bound scan buckets the query's values onto one uint8 map, and
    the threshold the map's distances are compared with (float32).
    ``clip``: ``(lo, hi, scale)`` of a strict bound coefficient's clipped,
    scaled values, or None (the dialplan map: the values themselves).
    ``bypass``: count only ``active & use2`` frames and credit every
    ``active & ~use2`` one (coefficient 1 of the strict bound)."""

    coef: int
    clip: tuple | None
    k_min: int
    k_size: int
    band_lo: float
    band_hi: float
    bypass: bool
    threshold: float


@functools.lru_cache(maxsize=256)
def strict_scan(specs: tuple, tolerance: float) -> tuple:
    """The strict/aligned bound's scan of its bound maps (one per spec of
    :func:`bound_specs`); the lattice band stays open."""
    inf = float("inf")
    return tuple(
        ScanMap(c, (lo, hi, s), k_min, k_size, -inf, inf, c == 1,
                bound_threshold(s, tolerance))
        for c, s, lo, hi, k_min, k_size in specs
    )


@functools.lru_cache(maxsize=256)
def dialplan_scan(tolerance: float, band_lo: float, band_hi: float,
                  k_min: int = K_MIN, k_size: int = K_SIZE) -> tuple:
    """The dialplan prefilter's scan of the quantized value map."""
    return (ScanMap(0, None, k_min, k_size, band_lo, band_hi, False,
                    bound_threshold(None, tolerance)),)


def _scan_checked(scans, maps, q, active, use2):
    if not scans or len(scans) != len(maps):
        raise ValueError(f"bound_scan: {len(scans)} scans for {len(maps)} "
                         f"maps")
    if use2 is None and any(sp.bypass for sp in scans):
        raise ValueError("bound_scan: a bypass map needs use2")
    return q if q.ndim == 3 else q[..., None]


def scan_histograms(scans: tuple, q: torch.Tensor, active: torch.Tensor,
                    use2: torch.Tensor | None = None) -> list:
    """Per :class:`ScanMap`, the histogram ``[B, k_size]`` int32 of the
    query's bucketed values (``q``: ``[B, F, C]``): column ``coef``, clipped
    and scaled, counted over ``active`` (``active & use2`` on a bypass
    map) by :func:`histogram`."""
    out = []
    for sp in scans:
        qc = q[..., sp.coef]
        if sp.clip is not None:
            lo, hi, s = sp.clip
            qc = torch.clamp(qc, lo, hi) * s
        act_c = active & use2 if sp.bypass else active
        out.append(histogram(qc, act_c, sp.band_lo, sp.band_hi, sp.k_min,
                             sp.k_size))
    return out


def bound_scan_reference(scans: tuple, maps: tuple, q: torch.Tensor,
                         active: torch.Tensor,
                         use2: torch.Tensor | None = None,
                         ctx_ids: torch.Tensor | None = None,
                         ctx_id: int | None = None,
                         with_counts: bool = False):
    """:func:`bound_scan`'s plain twin: per map the histogram of its bucketed
    query values and :func:`lattice_votes_reference` against the map, the
    bypass credit, the minimum over the maps, then -1 on every row whose
    ``ctx_ids`` is not ``ctx_id``."""
    counts = scan_histograms(scans, _scan_checked(scans, maps, q, active,
                                                  use2), active, use2)
    out = scan_votes_reference(scans, maps, counts, active, use2, ctx_ids,
                               ctx_id)
    return (out, counts[0]) if with_counts else out


def scan_votes_reference(scans: tuple, maps: tuple, counts: list,
                         active: torch.Tensor,
                         use2: torch.Tensor | None = None,
                         ctx_ids: torch.Tensor | None = None,
                         ctx_id: int | None = None) -> torch.Tensor:
    """:func:`bound_scan_reference`'s stage after the histograms ``counts``
    (one per map): the votes, the bypass credit, the minimum and the
    context mask."""
    out = None
    for sp, m, c in zip(scans, maps, counts):
        v = lattice_votes_reference(c, m, sp.threshold)
        if sp.bypass:
            v = v + (active & ~use2).sum(dim=1, dtype=torch.int32)[:, None]
        out = v if out is None else torch.minimum(out, v)
    if ctx_ids is not None:
        out = torch.where((ctx_ids == ctx_id)[None, :], out, -1)
    return out


def bound_scan(scans: tuple, maps: tuple, q: torch.Tensor,
               active: torch.Tensor, use2: torch.Tensor | None = None,
               ctx_ids: torch.Tensor | None = None,
               ctx_id: int | None = None, with_counts: bool = False):
    """A certified prefilter's bound ``[B, A]`` int32 from the raw query
    values: for each of the one or two uint8 ``maps`` the votes of the
    query's values bucketed as its :class:`ScanMap` says, the bypass
    credit, the minimum over the maps, and -1 on rows outside the context
    (``ctx_ids != ctx_id``). ``q``: ``[B, F, C]`` (or ``[B, F]``, one
    column) float32; ``active``, ``use2``: ``[B, F]`` bool. With
    ``with_counts``, also the first map's histogram ``[B, k_size]`` int32
    (the dialplan rescore's).

    On a CUDA tensor: the ``bound_scan`` kernel pair of ``csrc/lattice.cu``
    (the planes prologue, then the votes with the min, credit and mask in
    the epilogue); on a CPU tensor: :func:`bound_scan_reference`."""
    if q.device.type == "cpu":
        return bound_scan_reference(scans, maps, q, active, use2, ctx_ids,
                                    ctx_id, with_counts)
    q3 = _scan_checked(scans, maps, q, active, use2)
    dev = q.device
    b, f = active.shape
    rows = maps[0].shape[0]
    ok = (dev.type == "cuda" and q3.dtype == torch.float32
          and q3.shape[:2] == (b, f) and active.dtype == torch.bool
          and active.device == dev and len(maps) <= 2
          and (use2 is None or (use2.shape == (b, f)
                                and use2.dtype == torch.bool
                                and use2.device == dev))
          and (ctx_ids is None or (ctx_ids.shape == (rows,)
                                   and ctx_ids.device == dev)))
    for sp, m in zip(scans, maps):
        ok = ok and (m.device == dev and m.dtype == torch.uint8
                     and m.shape == (rows, sp.k_size) and m.is_contiguous()
                     and 0 <= sp.coef < q3.shape[2])
    if not ok:
        raise ValueError(
            f"bound_scan needs float32 queries [B, F(, C)], bool masks "
            f"[B, F] and one or two contiguous uint8 maps [A, k_size] on "
            f"one CUDA device (got q {tuple(q.shape)} {q.dtype} on {dev}, "
            f"maps {[(tuple(m.shape), m.dtype, str(m.device)) for m in maps]})"
        )
    votes = torch.empty((b, rows), dtype=torch.int32, device=dev)
    counts = (torch.empty((b, scans[0].k_size), dtype=torch.int32,
                          device=dev) if with_counts else None)
    if b and rows:
        _bound_scan_launch(scans, maps, q3.contiguous(), active.contiguous(),
                           None if use2 is None else use2.contiguous(),
                           ctx_ids, ctx_id, votes, counts)
    elif with_counts:
        counts.zero_()
    return (votes, counts) if with_counts else votes


@functools.lru_cache(maxsize=256)
def _scan_args(scans: tuple):
    """The kernels' host arrays of a scan: ints ``(coef, k_min, k_size,
    bypass)`` and floats ``(lo, hi, scale, band_lo, band_hi, threshold)``
    per map, and the widest map's bucket count."""
    ints = (ctypes.c_int * (4 * len(scans)))(*[
        v for sp in scans for v in (sp.coef, sp.k_min, sp.k_size,
                                    int(sp.bypass))])
    floats = (ctypes.c_float * (6 * len(scans)))(*[
        v for sp in scans
        for v in (sp.clip or (float("-inf"), float("inf"), 1.0))
        + (sp.band_lo, sp.band_hi, sp.threshold)])
    return ints, floats, max(sp.k_size for sp in scans)


@functools.lru_cache(maxsize=1024)
def _scan_scratch_bytes(n_maps: int, max_k: int, batch: int,
                        planes: int) -> int:
    return build.kernel_library().tiresias_bound_scan_scratch(
        n_maps, max_k, batch, planes)


def _bound_scan_launch(scans, maps, q3, active, use2, ctx_ids, ctx_id,
                       votes, counts) -> None:
    b, f, n_coefs = q3.shape
    n = len(scans)
    ints, floats, max_k = _scan_args(scans)
    planes = count_planes(f)  # a bucket holds at most every frame
    lib = build.kernel_library()
    scratch = torch.empty(_scan_scratch_bytes(n, max_k, b, planes),
                          dtype=torch.uint8, device=q3.device)
    if ctx_ids is not None:
        if not -2**31 <= int(ctx_id) < 2**31:
            raise ValueError(f"bound_scan: ctx_id {ctx_id} is not an int32")
        ctx_ids = ctx_ids.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(q3.device).cuda_stream
    rc = lib.tiresias_bound_scan_planes(
        q3.data_ptr(), active.data_ptr(),
        (active if use2 is None else use2).data_ptr(), b, f, n_coefs, n,
        ints, floats, planes, scratch.data_ptr(),
        None if counts is None else counts.data_ptr(), stream)
    build.check("bound_scan_planes", rc)
    rc = lib.tiresias_bound_scan(
        (ctypes.c_void_p * n)(*[m.data_ptr() for m in maps]), n, ints,
        floats, b, votes.shape[1], planes, scratch.data_ptr(),
        None if ctx_ids is None else ctx_ids.data_ptr(),
        0 if ctx_ids is None else int(ctx_id), votes.data_ptr(), stream)
    build.check("bound_scan", rc)


def bound_votes(specs: tuple, maps: tuple, q: torch.Tensor,
                active: torch.Tensor, use2: torch.Tensor,
                tolerance: float, ctx_ids: torch.Tensor | None = None,
                ctx_id: int | None = None) -> torch.Tensor:
    """Upper bound ``[B, A]`` int32 on every row's strict bag (and so
    aligned) votes: the minimum over the bound coefficients of that
    coefficient's clipped-scaled lattice votes on its uint8 map
    (:func:`bound_scan`). A frame whose q1 lies outside the band (``use2``
    False) bypasses the coefficient-1 test in the matcher, so it is
    credited to that coefficient unconditionally. With ``ctx_ids``, rows
    whose context is not ``ctx_id`` get -1."""
    return bound_scan(strict_scan(specs, tolerance), maps, q, active, use2,
                      ctx_ids, ctx_id)


def bound_tol_ok(specs_or_coefs, tolerance: float) -> bool:
    """Whether the uint8 maps still inform at this tolerance: the threshold
    must stay below BOUND_FAR, or every row passes the bound (valid, but
    the certificate can never hold). ``None``: the dialplan map; a coef
    count or a spec tuple: the strict bound, informative while ANY of its
    coefficients is."""
    if tolerance < 0:
        return False
    if specs_or_coefs is None:
        return tolerance * BOUND_Q < BOUND_FAR
    if isinstance(specs_or_coefs, int):
        specs_or_coefs = bound_specs(specs_or_coefs)
    return any((sp[1] * tolerance + 1.0) * BOUND_Q < BOUND_FAR
               for sp in specs_or_coefs)


def certificate(votes_k: torch.Tensor, unselected_max: torch.Tensor,
                top: int = 1) -> torch.Tensor:
    """``[B]`` bool: the ``top``-th best rescored score strictly beats the
    highest unselected bound (strict: a certified winner ties no unselected
    row, so the D5 tiebreak stays exact), or nothing unselected can score."""
    if top == 1:
        kth = votes_k.max(dim=1).values
    else:
        kth = torch.topk(votes_k, top, dim=1).values[:, -1]
    return (kth > unselected_max) | (unselected_max <= 0)


def scatter_candidates(votes_k: torch.Tensor, idx: torch.Tensor,
                       n_rows: int) -> torch.Tensor:
    """Candidate scores scattered into ``[B, n_rows]`` int32, zeros
    elsewhere."""
    out = torch.zeros((votes_k.shape[0], n_rows), dtype=torch.int32,
                      device=votes_k.device)
    return out.scatter_reduce_(1, idx.to(torch.int64), votes_k, "amax")


def select_candidates_reference(bound: torch.Tensor, k: int):
    """:func:`select_candidates` in plain torch: the ``k`` highest of the
    unique keys ``(bound, -row)`` (so no tie is left to ``torch.topk``),
    their rows in ascending order, and the highest bound among the rest
    (``-1`` when ``k`` takes every row)."""
    b, a = bound.shape
    rows = torch.arange(a, dtype=torch.int64, device=bound.device)
    key = bound.to(torch.int64) * a + (a - 1 - rows)
    idx = torch.topk(key, k, dim=1).indices.sort(dim=1).values
    if k == a:
        rest = torch.full((b,), -1, dtype=torch.int32, device=bound.device)
    else:
        rest = bound.scatter(1, idx, torch.iinfo(torch.int32).min).max(
            dim=1).values
    return idx.to(torch.int32), rest


# K-b's plan (csrc/select.cu): a thread-block cluster of CTAs per row, each
# CTA one slice of it in shared memory, or streamed through a ring of chunks
# where the slice does not fit; or, for a long row at a small batch, the
# cooperative route: the row spread over the whole card, one CTA an SM
SELECT_MAX_ROWS = 62_914_560        # rows a query (the selection's range)
SELECT_TILE = 4_096                 # rows of a first-pass tile (8 a lane)
SELECT_SLOTS = 8                    # chunks (mbarriers) of a resident slice
SELECT_RING = (6, 8_192)            # streamed: slots, rows a slot
SELECT_MIN_SLICE = 1_024            # no cluster splits a row finer
SELECT_GRID_MIN_CTAS = 16           # the cooperative route: CTAs a row, least
_SMEM_BLOCK = 232_448               # shared memory a block may use (opt-in)
_SMEM_SM = 233_472                  # an SM's
_SMEM_STATIC = 1_024                # the kernel's static shared memory, at most
_SMEM_RESERVED = 1_024              # the system's share of a block


class SelectPlan(NamedTuple):
    """One ``kb_select`` launch: ``ctas`` CTAs per row, each over ``slice``
    rows, as a thread-block cluster (``kb_select_kernel``) or, with
    ``cooperative``, as a share of a cooperative grid of one CTA an SM
    (``kb_select_grid_kernel``); ``resident``: the slice stays in shared
    memory after the first pass (``data_elems`` = slice + 4: it is copied
    from its 16-byte aligned start), else every pass streams it through
    ``slots`` chunks of ``chunk`` rows; ``smem`` dynamic shared-memory bytes
    a CTA; ``ctas_per_sm`` the CTAs an SM holds."""
    ctas: int
    cooperative: bool
    slice: int
    chunk: int
    slots: int
    resident: bool
    data_elems: int
    smem: int
    ctas_per_sm: int


def _select_smem(cooperative: bool, data_elems: int, slots: int) -> int:
    # the slice, the histogram [2048], the cluster route's group maxima
    # [2048], the mbarriers (the kernel's own: tiresias_select_smem)
    return data_elems * 4 + 2048 * 4 + (0 if cooperative else 2048 * 4) \
        + slots * 8


def _select_slice_plan(rows: int, ctas: int, cooperative: bool) -> SelectPlan:
    slice_ = -(-rows // ctas)
    slice_ += -slice_ % 4
    data = slice_ + 4
    chunk = -(-data // SELECT_SLOTS)
    chunk += -chunk % SELECT_TILE
    slots = -(-data // chunk)
    smem = _select_smem(cooperative, data, slots)
    resident = smem <= _SMEM_BLOCK - _SMEM_STATIC
    if not resident and not cooperative:
        slots, chunk = SELECT_RING
        data = slots * chunk
        smem = _select_smem(cooperative, data, slots)
    per_sm = 1 if cooperative else min(
        2, _SMEM_SM // (smem + _SMEM_STATIC + _SMEM_RESERVED))
    return SelectPlan(ctas, cooperative, slice_, chunk, slots, resident,
                      data, smem, per_sm)


def select_plan(batch: int, rows: int, sms: int,
                max_clusters) -> SelectPlan:
    """K-b's launch for bounds ``[batch, rows]`` on a card of ``sms`` SMs
    that holds ``max_clusters(plan)`` clusters of a cluster plan at once
    (``tiresias_select_max_clusters``): the smallest cluster (2 to 16 CTAs
    a row) whose slices fit in shared memory, doubled while the batch
    leaves SMs idle, each slice keeps ``SELECT_MIN_SLICE`` rows and the card
    holds every cluster at once. A row past 16 slices (~860,000 rows) takes
    the cooperative route, ``sms // batch`` CTAs a row, where that is at
    least ``SELECT_GRID_MIN_CTAS`` and its slices fit in shared memory;
    else its 16 slices stream."""
    if batch < 1 or not 1 <= rows <= SELECT_MAX_ROWS:
        raise ValueError(f"select_candidates: [{batch}, {rows}] bounds are "
                         f"outside the kernel's range (1 to "
                         f"{SELECT_MAX_ROWS:,} rows)")
    plan = _select_slice_plan(rows, 2, False)
    while plan.ctas < 16:
        wider = _select_slice_plan(rows, 2 * plan.ctas, False)
        if plan.resident and (
                batch * plan.ctas >= sms
                or wider.slice < SELECT_MIN_SLICE
                or batch > max_clusters(wider)):
            break
        plan = wider
    if not plan.resident and sms // batch >= SELECT_GRID_MIN_CTAS:
        grid = _select_slice_plan(rows, sms // batch, True)
        if grid.resident:
            return grid
    return plan


@functools.lru_cache(maxsize=256)
def _max_clusters(index: int, plan: SelectPlan) -> int:
    with torch.cuda.device(index):
        n = build.kernel_library().tiresias_select_max_clusters(
            plan.slice * plan.ctas, plan.ctas, plan.slice, plan.chunk,
            plan.slots, int(plan.resident), plan.data_elems)
    if n < 0:
        raise RuntimeError(f"select_candidates: the card refuses the plan "
                           f"{plan} (CUDA error {-n})")
    return n


@functools.lru_cache(maxsize=1024)
def _device_plan(index: int, batch: int, rows: int):
    """(plan, scratch words) of bounds ``[batch, rows]`` on device
    ``index``, cached: a batch-1 search must not pay the plan's search. The
    plan's shared memory is checked against the kernel's own layout."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    plan = select_plan(batch, rows, sms,
                       functools.partial(_max_clusters, index))
    lib = build.kernel_library()
    smem = lib.tiresias_select_smem(int(plan.cooperative), plan.data_elems,
                                    plan.slots)
    if smem != plan.smem:
        raise RuntimeError(f"select_candidates: the plan {plan} takes "
                           f"{plan.smem} bytes of shared memory, the kernel "
                           f"{smem}")
    return plan, lib.tiresias_select_scratch(batch, plan.ctas,
                                             int(plan.cooperative))


def select_candidates(bound: torch.Tensor, k: int):
    """``(idx [B, k] int32, unselected_max [B] int32)`` of the bounds
    ``[B, A]`` int32 (K-b, ``approx_max_k`` and the unselected maximum in
    ``_prefilter_core``): the ``k`` rows of highest bound in ascending row
    order, and the highest bound among the rest, ``-1`` when none is left.
    Ties are fixed: with ``v`` the ``k``-th highest bound, every row above
    ``v`` is taken, then rows equal to ``v`` in ascending row order until
    ``k``. The selection is exact, where ``approx_max_k`` may miss rows on
    the TPU (recall 0.99): an exact selection only certifies more often, and
    no choice among tied rows moves a certificate (strict ``>``).

    On a CUDA tensor: one launch of a ``kb_select`` kernel
    (``csrc/select.cu``, as :func:`select_plan` says: a cluster of CTAs per
    row, or a cooperative grid over the card for a long row at a small
    batch; a histogram merged across the CTAs finds the ``k``-th value, an
    ordered compaction writes the rows); on a CPU tensor:
    :func:`select_candidates_reference`."""
    if bound.device.type == "cpu":
        return select_candidates_reference(bound, k)
    if not (bound.device.type == "cuda" and bound.dim() == 2
            and bound.dtype == torch.int32 and bound.is_contiguous()
            and 1 <= k <= bound.shape[1]):
        raise ValueError(
            f"select_candidates needs contiguous int32 bounds [B, A] on a "
            f"CUDA device and 1 <= k <= A (got {tuple(bound.shape)} "
            f"{bound.dtype} on {bound.device}, k={k})")
    b, a = bound.shape
    if b == 0:
        return (torch.empty((0, k), dtype=torch.int32, device=bound.device),
                torch.empty((0,), dtype=torch.int32, device=bound.device))
    dev = bound.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _select_launch(bound, k, *_device_plan(index, b, a))


def _select_launch(bound: torch.Tensor, k: int, plan: SelectPlan,
                   words: int):
    # one kb_select launch of ``plan`` (``words`` of scratch) on checked
    # bounds; tools/select_timing.py forces a route through it
    b, a = bound.shape
    dev = bound.device
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    unselected = torch.empty((b,), dtype=torch.int32, device=dev)
    scratch = (torch.empty((words,), dtype=torch.int32, device=dev)
               if words else None)
    rc = build.kernel_library().tiresias_select_candidates(
        bound.data_ptr(), b, a, k, plan.ctas, int(plan.cooperative),
        plan.slice, plan.chunk, plan.slots, int(plan.resident),
        plan.data_elems, scratch.data_ptr() if words else None,
        idx.data_ptr(), unselected.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check("select_candidates", rc)
    return idx, unselected


def rescore_rows_reference(value_map: torch.Tensor, counts: torch.Tensor,
                           idx: torch.Tensor, tol: float,
                           ctx_ids: torch.Tensor | None = None,
                           ctx_id: int | None = None) -> torch.Tensor:
    """:func:`rescore_rows` in plain torch: the rows ``idx`` gathered from
    the float32 map, contracted with the histogram in int32, and 0 where a
    row's context is not ``ctx_id``."""
    hit = value_map[idx] <= float(np.float32(tol))  # [B, k, K]
    votes = torch.where(hit, counts[:, None, :], 0).sum(dim=2,
                                                        dtype=torch.int32)
    if ctx_ids is not None:
        votes = torch.where(ctx_ids[idx] == ctx_id, votes, 0)
    return votes


def rescore_rows(value_map: torch.Tensor, counts: torch.Tensor,
                 idx: torch.Tensor, tol: float,
                 ctx_ids: torch.Tensor | None = None,
                 ctx_id: int | None = None) -> torch.Tensor:
    """Exact dialplan votes ``[B, k]`` int32 of each query's candidate rows
    ``idx`` (``_prefilter_core``'s ``vm[idx]`` and einsum): the sum of the
    histogram ``counts [B, K]`` int32 over the buckets where the row's
    float32 ``value_map [A, K]`` is ``<= np.float32(tol)`` (a NaN row gets
    no hit), and 0 where ``ctx_ids[row] != ctx_id``.

    On a CUDA tensor: ``rescore_rows_kernel`` of ``csrc/select.cu`` (the
    histogram in shared memory, a warp per candidate row); on a CPU tensor:
    :func:`rescore_rows_reference`."""
    if value_map.device.type == "cpu":
        return rescore_rows_reference(value_map, counts, idx, tol, ctx_ids,
                                      ctx_id)
    dev = value_map.device
    ok = (dev.type == "cuda" and value_map.dim() == 2
          and value_map.dtype == torch.float32 and value_map.is_contiguous()
          and counts.dim() == 2 and counts.dtype == torch.int32
          and counts.device == dev and idx.dim() == 2
          and idx.dtype == torch.int32 and idx.device == dev
          and counts.shape == (idx.shape[0], value_map.shape[1])
          and 1 <= value_map.shape[1] <= 12 * 1024
          and (ctx_ids is None or (ctx_ids.shape == (value_map.shape[0],)
                                   and ctx_ids.device == dev)))
    if not ok:
        raise ValueError(
            f"rescore_rows needs a contiguous float32 map [A, K], int32 "
            f"counts [B, K] and int32 rows [B, k] on one CUDA device (got "
            f"map {tuple(value_map.shape)} {value_map.dtype} on "
            f"{value_map.device}, counts {tuple(counts.shape)} "
            f"{counts.dtype}, idx {tuple(idx.shape)} {idx.dtype})")
    b, k = idx.shape
    votes = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0 or k == 0:
        return votes
    if ctx_ids is not None:
        if not -2**31 <= int(ctx_id) < 2**31:
            raise ValueError(f"rescore_rows: ctx_id {ctx_id} is not an int32")
        ctx_ids = ctx_ids.to(torch.int32).contiguous()
    counts = counts.contiguous()
    idx = idx.contiguous()
    rc = build.kernel_library().tiresias_rescore_rows(
        value_map.data_ptr(), value_map.shape[1], counts.data_ptr(),
        idx.data_ptr(), b, k, float(np.float32(tol)),
        None if ctx_ids is None else ctx_ids.data_ptr(),
        0 if ctx_ids is None else int(ctx_id), votes.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check("rescore_rows", rc)
    return votes


def lattice_prefiltered_votes(
    value_map: torch.Tensor,
    value_map_q: torch.Tensor,
    q0: torch.Tensor,
    active: torch.Tensor,
    tolerance: float,
    band_lo: float,
    band_hi: float,
    k: int | None = None,
    top: int = 1,
    ctx_ids: torch.Tensor | None = None,
    ctx_id: int | None = None,
    k_min: int = K_MIN,
    k_size: int = K_SIZE,
):
    """CERTIFIED two-stage dialplan search (PARITY.md D19): the uint8 bound
    scan (:func:`bound_scan` of ``value_map_q``, which also gives the query
    histograms), the ``k`` rows of highest bound, their
    exact votes on the float32 map, and the certificate.

    Returns ``(votes [B, A] int32 — candidate scores scattered, zeros
    elsewhere; certificate [B] bool)``. Where the certificate holds, the
    top-``top`` rows of ``votes`` (by votes, then lowest row) are the full
    scan's. Out-of-context rows (``ctx_ids != ctx_id``) get bound -1 and,
    if selected, score 0."""
    if k is None:
        k = LATTICE_PREFILTER_K
    n_rows = value_map.shape[0]
    k = min(int(k), n_rows)
    if top > k:
        raise ValueError(f"top={top} exceeds the candidate budget k={k}")
    bound, c = bound_scan(
        dialplan_scan(tolerance, band_lo, band_hi, k_min, k_size),
        (value_map_q,), q0, active, ctx_ids=ctx_ids, ctx_id=ctx_id,
        with_counts=True)
    idx, unselected_max = select_candidates(bound, k)
    votes_k = rescore_rows(value_map, c, idx, tolerance, ctx_ids, ctx_id)
    return (scatter_candidates(votes_k, idx, n_rows),
            certificate(votes_k, unselected_max, top))
