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
:func:`lattice_votes_reference` as its plain twin.
"""

from __future__ import annotations

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
    of min/max; all-masked rows come out +inf everywhere."""
    a = db0.shape[0]
    dev = db0.device
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
    return torch.minimum(suffix_min - ks[None, :], ks[None, :] - prefix_max)


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
    it (float32 product of small integers — exact), returned as int32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hits = (value_map <= tol).to(torch.float32)
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
    lib = build.kernel_library()
    rc = lib.tiresias_lattice_votes(
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
