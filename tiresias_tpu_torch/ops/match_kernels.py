"""Fused vote kernels K4 and K5 (port of ``tiresias_tpu.ops.match_pallas``).

K4 ``match_votes`` (bag votes) and K5 ``match_votes_aligned`` (offset-
consistent votes, PARITY.md D9) are hand-written CUDA in ``csrc/match.cu``;
:func:`tiresias_tpu_torch.ops.match.match_votes` is their plain twin. The
wrappers follow one rule: a CPU tensor takes the twin, a CUDA tensor
launches the kernel or raises — no tolerance or shape is routed elsewhere.

Operand convention (the store's layout): ``db [A, T, C]`` holds PAD_VALUE
in every frame that does not exist — past an audio's end, in padding rows
and in tombstoned rows — and the kernels treat ``d0 == PAD_VALUE`` as "no
frame" (the twin derives the same mask). The query goes in as
:func:`query_rows`: the Pallas operand rows plus an explicit active flag,
so every tolerance is served exactly (the Pallas kernels' value-encoded
masks stopped at ``PALLAS_TOL_MAX`` = 1e5).
"""

from __future__ import annotations

import numpy as np
import torch

from tiresias_tpu_torch.config import DEF_SEARCH_TOLERANCE
from tiresias_tpu_torch.ops import match
from tiresias_tpu_torch.ops.mfcc import PAD_VALUE
from tiresias_tpu_torch.utils import build

INACTIVE_Q = 1.0e6  # the Pallas operand's inactive-frame value (row 0)
_MAX_BLOCKS = 2**31 - 1  # grid.x limit of both launches
_MAX_GRID_Y = 65535
_K4_ITEMS = 512  # (query, 32-frame group) items per K4 block (kMaxItems)


def query_rows(q, active, use2, coefs: int) -> torch.Tensor:
    """Kernel query operand ``[B, coefs + 2, F]`` float32: rows
    ``0..coefs`` are ``match_pallas._query_rows`` (q0 with INACTIVE_Q in
    inactive frames, q1..q_{coefs-1}, the use2 flag), the last row is the
    active flag the kernels test."""
    rows = [torch.where(active, q[..., 0], INACTIVE_Q)]
    rows += [q[..., ci] for ci in range(1, coefs)]
    rows += [use2.to(torch.float32), active.to(torch.float32)]
    return torch.stack(rows, dim=1).contiguous()


def _votes(db, q, active, use2, tolerance, coefs: int, aligned: bool):
    a, t, c = db.shape
    if coefs < 1 or coefs > c:
        raise ValueError(f"coefs must be in [1, {c}]")
    tol = float(np.float32(tolerance))
    if db.device.type == "cpu":
        return match.match_votes(
            db, db[..., 0] != PAD_VALUE, q, active, use2, tol, coefs=coefs,
            aligned=aligned,
        )
    name = "match_votes_aligned" if aligned else "match_votes"
    if db.device.type != "cuda" or any(
        x.device != db.device for x in (q, active, use2)
    ):
        raise ValueError(
            f"{name}: db on {db.device}, query on {q.device}, flags on "
            f"{active.device}/{use2.device}"
        )
    b, f = active.shape
    if (
        db.dtype != torch.float32 or not db.is_contiguous()
        or q.ndim != 3 or q.shape[:2] != (b, f) or q.shape[2] < coefs
        or active.dtype != torch.bool or use2.dtype != torch.bool
        or use2.shape != (b, f)
    ):
        raise ValueError(
            f"{name} needs a contiguous db [A, T, C] float32, q [B, F, >= "
            f"coefs] and bool active/use2 [B, F] (got db {tuple(db.shape)} "
            f"{db.dtype}, q {tuple(q.shape)}, active {tuple(active.shape)} "
            f"{active.dtype}, use2 {tuple(use2.shape)} {use2.dtype})"
        )
    items = b * -(-f // 32)  # K4's work items: 32-frame query groups
    if (b * a if aligned else a) > _MAX_BLOCKS or (
            not aligned and -(-items // _K4_ITEMS) > _MAX_GRID_Y):
        raise ValueError(f"{name}: {b} queries x {a} rows exceed one launch")
    votes = torch.zeros((b, a), dtype=torch.int32, device=db.device)
    if b == 0 or a == 0 or f == 0:
        return votes
    rows = query_rows(q.to(torch.float32), active, use2, coefs)
    lib = build.kernel_library()
    fn = (lib.tiresias_match_votes_aligned if aligned
          else lib.tiresias_match_votes)
    rc = fn(
        db.data_ptr(), rows.data_ptr(), b, a, t, c, coefs, f, tol,
        votes.data_ptr(), torch.cuda.current_stream(db.device).cuda_stream,
    )
    build.check(name, rc)
    return votes


def match_votes_fused(db, q, active, use2, tolerance, coefs: int = 1):
    """K4: bag votes ``[B, A]`` int32 (``match_pallas.match_votes_pallas``).

    Args:
      db: ``[A, T, C]`` store layout (PAD_VALUE where no frame exists).
      q / active / use2: from :func:`match.prepare_query`.
    """
    return _votes(db, q, active, use2, tolerance, coefs, aligned=False)


def match_votes_fused_aligned(db, q, active, use2, tolerance,
                              coefs: int = 1):
    """K5: aligned votes ``[B, A]`` int32, the best single time offset's
    hit count (``match_pallas.match_votes_pallas_aligned``)."""
    return _votes(db, q, active, use2, tolerance, coefs, aligned=True)


def search_batch_fused(
    db: torch.Tensor,
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
    """``match_pallas.search_batch_pallas`` on K4/K5: takes the store-layout
    ``db`` directly and returns (best ``[B]``, match_count ``[B]``, votes
    ``[B, A]``), or ``(None, None, votes)`` with ``with_top1=False``."""
    if tolerance < 0:
        tolerance = DEF_SEARCH_TOLERANCE  # fp_handler.c:252-256
    q, active, use2 = match.prepare_query(
        query, n_frames, freq_ignore_low, freq_ignore_high, trunc_coef1
    )
    fn = match_votes_fused_aligned if aligned else match_votes_fused
    votes = fn(db, q, active, use2, tolerance, coefs=coefs)
    if not with_top1:
        return None, None, votes
    best, count = match.top1(votes, audio_filter)
    return best, count, votes
