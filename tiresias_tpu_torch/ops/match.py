"""General tolerance-vote matcher (port of ``tiresias_tpu.ops.match_jax``).

Every search configuration except the dialplan one (``coefs=1``, truncated
max1, bag votes — :mod:`tiresias_tpu_torch.ops.match_lattice`) votes with
this semantics (PARITY.md section 3, D8, D9):

    ok[b, f, a, t] = mask[a, t] ∧ active[b, f] ∧ |q0[b, f] − db[a, t, 0]| ≤ tol
                     ∧ (|q1[b, f] − db[a, t, 1]| ≤ tol ∨ ¬use2[b, f])
                     ∧ |qc[b, f] − db[a, t, c]| ≤ tol      (2 ≤ c < coefs)
    bag:      votes[b, a] = Σ_f ∃t ok[b, f, a, t]
    aligned:  votes[b, a] = max_o Σ_f ok[b, f, a, o + f − (F − 1)]

Everything here is plain PyTorch: :func:`match_votes` is the twin of the
hand-written kernels K4 and K5 (:mod:`tiresias_tpu_torch.ops.match_kernels`)
and masks explicitly. It works in blocks of 128 audios (and, aligned, of 256
offsets), so peak memory stays at ``B·F·128·T`` booleans whatever the store
size.
"""

from __future__ import annotations

import numpy as np
import torch

from tiresias_tpu_torch.config import DEF_SEARCH_TOLERANCE
from tiresias_tpu_torch.ops.match_lattice import band_thresholds

AUDIO_BLOCK = 128
OFFSET_BLOCK = 256  # aligned-voting offsets accumulated at a time


def prepare_query(
    query: torch.Tensor,
    n_frames=None,
    freq_ignore_low: int = -1,
    freq_ignore_high: int = -1,
    trunc_coef1: bool = True,
):
    """The reference's query-side preprocessing, batched
    (``match_jax.prepare_query``): q0 truncated toward zero when
    ``trunc_coef1`` (the C ``(int)`` cast, fp_handler.c:290); ``active`` from
    the (truncated) q0 against the band; ``use2`` from the raw q1 against the
    band (an out-of-band max2 drops only the max2 condition).

    Args:
      query: ``[B, F, C]`` fingerprint values.
      n_frames: ``[B]`` true frame counts (None: all F frames are valid).
    Returns:
      (q ``[B, F, C]`` float32, active ``[B, F]`` bool, use2 ``[B, F]`` bool).
    """
    q = query.to(torch.float32).clone()
    b, f, c = q.shape
    lo, hi = band_thresholds(freq_ignore_low, freq_ignore_high)
    if trunc_coef1:
        q[..., 0] = torch.trunc(q[..., 0])
    q0 = q[..., 0]
    if n_frames is None:
        valid = torch.ones((b, f), dtype=torch.bool, device=q.device)
    else:
        nf = torch.as_tensor(n_frames).to(q.device, torch.int64)
        valid = torch.arange(f, device=q.device)[None, :] < nf[:, None]
    active = valid & (q0 >= lo) & (q0 <= hi)
    if c >= 2:
        use2 = (q[..., 1] >= lo) & (q[..., 1] <= hi)
    else:
        use2 = torch.zeros((b, f), dtype=torch.bool, device=q.device)
    return q, active, use2


def _close(qc: torch.Tensor, dc: torch.Tensor, tol: float) -> torch.Tensor:
    """``|qc[b, f] − dc[a, t]| ≤ tol`` as ``[B, F, A, T]`` bool, compared
    in float32 as the kernels compare."""
    x = qc[:, :, None, None] - dc[None, None]
    return torch.le(x.abs_(), tol)


def _block_hits(d, m, q, active, use2, tol: float, coefs: int):
    """``ok [B, F, Ab, T]`` of one audio block ``d [Ab, T, C]``."""
    ok = _close(q[..., 0], d[..., 0], tol)
    for ci in range(1, coefs):
        okc = _close(q[..., ci], d[..., ci], tol)
        if ci == 1:
            # out-of-band max2 drops only the max2 condition (PARITY.md
            # 3.3); coefs > 2 is the documented extension with plain AND
            okc |= ~use2[:, :, None, None]
        ok &= okc
    ok &= m[None, None]
    ok &= active[:, :, None, None]
    return ok


def _aligned_scores(ok: torch.Tensor) -> torch.Tensor:
    """Best single offset's hit count ``[B, Ab]``: frame f's hit at stored
    frame t lands in offset ``o = t − f + F − 1``; offsets are accumulated
    OFFSET_BLOCK at a time, frame by frame, as shifted slices of ``ok``."""
    b, f, ab, t = ok.shape
    best = torch.zeros((b, ab), dtype=torch.int32, device=ok.device)
    n_off = t + f - 1
    for o0 in range(0, n_off, OFFSET_BLOCK):
        o1 = min(o0 + OFFSET_BLOCK, n_off)
        acc = torch.zeros((b, ab, o1 - o0), dtype=torch.int32, device=ok.device)
        for fi in range(f):
            t_lo = o0 + fi - (f - 1)  # stored frame of offset o0
            s_lo, s_hi = max(t_lo, 0), min(o1 + fi - (f - 1), t)
            if s_lo < s_hi:
                acc[:, :, s_lo - t_lo : s_hi - t_lo] += ok[:, fi, :, s_lo:s_hi]
        best = torch.maximum(best, acc.amax(dim=2))
    return best


def match_votes(
    db: torch.Tensor,
    db_mask: torch.Tensor,
    q: torch.Tensor,
    active: torch.Tensor,
    use2: torch.Tensor,
    tolerance: float,
    coefs: int = 1,
    aligned: bool = False,
    audio_block: int = AUDIO_BLOCK,
) -> torch.Tensor:
    """Vote counts ``[B, A]`` int32 — the plain twin of K4 (bag) and K5
    (``aligned=True``, offset-consistent voting, PARITY.md D9).

    Args:
      db: ``[A, T, C]`` stored fingerprints.
      db_mask: ``[A, T]`` bool validity.
      q, active, use2: from :func:`prepare_query`.
      tolerance: inclusive band, compared as float32.
      coefs: number of matched coefficients, in ``[1, C]``.
    """
    a, t, c = db.shape
    if coefs < 1 or coefs > c:
        raise ValueError(f"coefs must be in [1, {c}]")
    tol = float(np.float32(tolerance))
    votes = torch.zeros((q.shape[0], a), dtype=torch.int32, device=db.device)
    if q.shape[1] == 0:
        return votes
    for lo in range(0, a, audio_block):
        hi = min(lo + audio_block, a)
        ok = _block_hits(db[lo:hi], db_mask[lo:hi], q, active, use2, tol,
                         coefs)
        if aligned:
            votes[:, lo:hi] = _aligned_scores(ok)
        else:
            votes[:, lo:hi] = ok.any(dim=-1).sum(dim=1, dtype=torch.int32)
    return votes


def top1(votes: torch.Tensor, audio_filter: torch.Tensor | None = None):
    """(best_index ``[B]`` int32, match_count ``[B]``): the LOWEST index
    among the maximum votes, chosen explicitly (D5), and -1 when no audio
    got a vote. ``audio_filter``: optional ``[A]`` bool keep mask (the
    context filter, PARITY.md D7)."""
    b, a = votes.shape
    if a == 0:
        return (
            torch.full((b,), -1, dtype=torch.int32, device=votes.device),
            torch.zeros((b,), dtype=votes.dtype, device=votes.device),
        )
    if audio_filter is not None:
        votes = torch.where(audio_filter[None, :], votes, 0)
    count = votes.max(dim=1).values
    cols = torch.arange(a, device=votes.device)
    best = torch.where(votes == count[:, None], cols[None, :], a)
    best = best.min(dim=1).values
    best = torch.where(count > 0, best, -1).to(torch.int32)
    return best, count


def search_batch(
    db: torch.Tensor,
    db_mask: torch.Tensor,
    query: torch.Tensor,
    n_frames=None,
    coefs: int = 1,
    tolerance: float = DEF_SEARCH_TOLERANCE,
    freq_ignore_low: int = -1,
    freq_ignore_high: int = -1,
    audio_filter: torch.Tensor | None = None,
    trunc_coef1: bool = True,
    aligned: bool = False,
    with_top1: bool = True,
):
    """Full reference-semantics search over a batch of queries on the plain
    matcher: (best ``[B]`` (-1 = not found), match_count ``[B]``, votes
    ``[B, A]``); ``with_top1=False`` gives ``(None, None, votes)``."""
    if tolerance < 0:
        tolerance = DEF_SEARCH_TOLERANCE  # fp_handler.c:252-256
    q, active, use2 = prepare_query(
        query, n_frames, freq_ignore_low, freq_ignore_high, trunc_coef1
    )
    votes = match_votes(db, db_mask, q, active, use2, tolerance,
                        coefs=coefs, aligned=aligned)
    if not with_top1:
        return None, None, votes
    best, count = top1(votes, audio_filter)
    return best, count, votes
