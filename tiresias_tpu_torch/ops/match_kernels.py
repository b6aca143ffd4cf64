"""Fused vote kernels K4 and K5 (port of ``tiresias_tpu.ops.match_pallas``).

K4 ``match_votes`` (bag votes) and K5 ``match_votes_aligned`` (offset-
consistent votes, PARITY.md D9) are hand-written CUDA in ``csrc/match.cu``;
:func:`tiresias_tpu_torch.ops.match.match_votes` is their plain twin. The
wrappers follow one rule: a CPU tensor takes the twin, a CUDA tensor
launches the kernel or raises — no tolerance or shape is routed elsewhere.

Both kernels search the view's sorted index (:mod:`.match_index`): each
query frame's coefficient-0 band is found by binary search and only the
frames inside it are tested. A work item whose bands hold more than
``DENSE_SHARE`` of its live pairs takes the kernel's dense route instead,
chosen on the device per item; :func:`route_counts` counts the items of
each route. K4's dense route runs inside its kernel; K5's dense items go on
a work list on the device that a second kernel, which tests every frame
pair, serves in the same call (every (query, row) pair for a query whose
offset histogram does not fit in shared memory, over ~50,000 frames).

The certified strict/aligned prefilter (:func:`aligned_prefiltered_votes`,
PARITY.md D17/D20) bounds every row's votes with K3' on the view's uint8
bound maps, takes the ``PREFILTER_K`` rows of highest bound per query
(exact ``torch.topk``), and rescores them with the kernels' candidate form
(:func:`match_votes_cand`). The candidates of a batch share rows, so the
form groups them by row on the device first (:func:`group_candidates`, a
counting sort; :func:`group_candidates_plain` is its twin): one block per
work item of one row and up to ``CAND_GROUP`` of the queries that chose
it, the row's index chunks (K5's dense window) staged once for all of
them. The first design, one block per (query, candidate) item, stays as
the forced route ``"per_item"``, which batch 1 takes (no row is shared
there).

Operand convention (the store's layout): ``db [A, T, C]`` holds PAD_VALUE
in every frame that does not exist — past an audio's end, in padding rows
and in tombstoned rows — and the kernels treat ``d0 == PAD_VALUE`` as "no
frame" (the twin derives the same mask). The query goes in as
:func:`query_rows`: the Pallas operand rows plus an explicit active flag,
so every tolerance is served exactly (the Pallas kernels' value-encoded
masks stopped at ``PALLAS_TOL_MAX`` = 1e5).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from tiresias_tpu_torch.config import DEF_SEARCH_TOLERANCE
from tiresias_tpu_torch.ops import match
from tiresias_tpu_torch.ops import match_lattice as ml
from tiresias_tpu_torch.ops.match_index import MatchIndex, build_match_index
from tiresias_tpu_torch.ops.mfcc import PAD_VALUE
from tiresias_tpu_torch.utils import build

INACTIVE_Q = 1.0e6  # the Pallas operand's inactive-frame value (row 0)
_MAX_BLOCKS = 2**31 - 1  # grid.x limit of the launches
_MAX_GRID_Y = 65535
_K4_ITEMS = 512  # (query, 32-frame group) items per K4 block (kMaxItems)
# A work item takes the dense route when its bands hold more than this share
# of its (live stored frame, active query frame) pairs: K4 counts what is
# left of the bands after each frame's first kProbe entries, K5 the bands of
# its first 32 frames. K5's share is where the two routes crossed at batch
# 64 on an H100 (the index route's time grows ~0.8 ms per % of a row in the
# bands, the dense route takes ~25 ms; PERF.md). Below SMALL_BATCH
# queries a block has fewer items than warps (K4) or one warp per stored
# row (K5), and one lane walking a long band is slower than the warp
# sweeping the chunk (K4) or the dense kernel's 128 threads per item (K5),
# so the dense route takes over sooner there. The per-item candidate form
# has one query per block (one warp per item in K5), so it takes the
# small-batch shares at any batch: on chip_smoke's catalog candidates
# (bands 21% of a row) at batch 64 with the batch-64 share, K5 sent all but
# one item to the index route and took 3.484 ms, its dense route 2.471
# (H100 80GB HBM3, 700 W). The grouped form takes the batch-64 share for a
# work item of >= CAND_SHARED queries, the small-batch share for a row only
# one query chose: on catalog rows (bands ~22% of a row) K5's index route,
# a query's warps splitting its frames, beat its dense route from 2
# queries per item on and lost at 1 (chip_smoke's sharing sweep, PERF.md);
# K4's items fill its 8 warps from 2 queries of 4 x 32-frame groups.
DENSE_SHARE = {"bag": 0.5, "aligned": 0.35, "bag_small_batch": 0.125,
               "aligned_small_batch": 0.125}
SMALL_BATCH = 8
CAND_SHARED = 2
# route: "auto" (per item, by DENSE_SHARE); "dense" and "index" force one
# route for every item, to measure and test each. The candidate form also
# takes "grouped" (the grouped form whatever the batch) and "per_item" (the
# per-item form, auto routes).
_FORCED = {"dense": -1.0, "index": float("inf")}
_CAND_FORMS = ("grouped", "per_item")
# Queries per grouped work item, at most (kGroup4 / kGroup5 in match.cu):
# a row chosen by all 64 queries of a batch makes 4 (8) items, not one
# long block; K4 fills its 8 warps with 4 x 32-frame groups a query, and
# K5's dense kernel stages each item's queries in 2 KB each.
CAND_GROUP = {"bag": 16, "aligned": 8}
_ROUTES: dict[torch.device, torch.Tensor] = {}
# Candidates the strict/aligned prefilter rescores (the engine takes it above
# 2 x this many rows per view).
PREFILTER_K = 1024
_ROUTES_LOCK = threading.Lock()  # searches run on several threads at once


def query_rows(q, active, use2, coefs: int) -> torch.Tensor:
    """Kernel query operand ``[B, coefs + 2, F]`` float32: rows
    ``0..coefs`` are ``match_pallas._query_rows`` (q0 with INACTIVE_Q in
    inactive frames, q1..q_{coefs-1}, the use2 flag), the last row is the
    active flag the kernels test."""
    rows = [torch.where(active, q[..., 0], INACTIVE_Q)]
    rows += [q[..., ci] for ci in range(1, coefs)]
    rows += [use2.to(torch.float32), active.to(torch.float32)]
    return torch.stack(rows, dim=1).contiguous()


def route_counts(device) -> torch.Tensor:
    """The device's route counters, int64 ``[4]``: work items that took K4's
    index route, K4's dense route, K5's index route and K5's dense route,
    summed over launches (each launch adds on the device; read them outside
    a timed region). An item is a (query, 32-frame group, row) for K4 and a
    (query, row) for K5."""
    device = torch.device(device)
    with _ROUTES_LOCK:
        if device not in _ROUTES:
            _ROUTES[device] = torch.zeros(4, dtype=torch.int64, device=device)
        return _ROUTES[device]


def match_votes_cand_plain(db, q, active, use2, tolerance, cand,
                           coefs: int = 1, aligned: bool = False):
    """The candidate form's plain twin: ``votes [B, k]`` int32 of query b
    against row ``cand[b, j]``, the twin over each query's gathered rows
    (``match_pallas.aligned_prefiltered_votes``' ``db[idx]`` rescore). Row
    ids outside ``[0, A)`` score 0, as in the kernels."""
    b, k = cand.shape
    a = db.shape[0]
    votes = torch.zeros((b, k), dtype=torch.int32, device=db.device)
    for i in range(b):
        ok = (cand[i] >= 0) & (cand[i] < a)
        rows = db[cand[i][ok].to(torch.int64)]
        votes[i, ok] = match.match_votes(
            rows, rows[..., 0] != PAD_VALUE, q[i : i + 1], active[i : i + 1],
            use2[i : i + 1], tolerance, coefs=coefs, aligned=aligned,
        )[0]
    return votes


def group_candidates_plain(cand: torch.Tensor, rows: int, g: int):
    """The candidate form's work list in plain torch (the twin of
    :func:`group_candidates`): ``(slots, items, n_items)``. ``slots`` int32
    holds every slot ``s = b * k + j`` whose row ``cand[b, j]`` lies in
    ``[0, rows)``, once, grouped by row (rows ascending, slots ascending
    within a row); ``items [n, 4]`` int32 cuts each row's slots into work
    items of at most ``g``: (row, first slot in ``slots``, count, 0);
    ``n_items`` int32 ``[1]`` holds n."""
    if g < 1:
        raise ValueError("g must be >= 1")
    flat = cand.reshape(-1).to(torch.int64)
    slot = torch.arange(flat.numel(), device=cand.device)
    ok = (flat >= 0) & (flat < rows)
    row, slot = flat[ok], slot[ok]
    order = torch.argsort(row, stable=True)
    row, slot = row[order], slot[order]
    counts = torch.bincount(row, minlength=rows)
    first = torch.cumsum(counts, 0) - counts
    pieces = (counts + g - 1) // g
    item_row = torch.repeat_interleave(
        torch.arange(rows, device=cand.device), pieces)
    n = int(pieces.sum())
    k = torch.arange(n, device=cand.device) - torch.repeat_interleave(
        torch.cumsum(pieces, 0) - pieces, pieces)
    items = torch.stack([
        item_row, first[item_row] + k * g,
        torch.clamp(counts[item_row] - k * g, max=g),
        torch.zeros_like(item_row)], dim=1).to(torch.int32)
    return (slot.to(torch.int32), items,
            torch.tensor([n], dtype=torch.int32, device=cand.device))


def max_group_items(batch: int, n_cand: int, rows: int, g: int) -> int:
    """An upper bound of the work items (one row's slots, ceil(count / g)
    items a row): the launches' grid, known without a host sync."""
    slots = batch * n_cand
    return min(rows, slots) + -(-slots // g)


def group_candidates(cand: torch.Tensor, rows: int, g: int):
    """The work list of ``cand [B, k]`` int32 (contiguous): on the card a
    counting sort over rows in three small kernels (counts, one block's
    scan, scatter) with no host sync, giving ``slots [B * k]`` (the first
    n_valid used; a row's slots in the atomics' order), ``items
    [max_group_items, 4]`` and ``n_items [1]`` on the device; on the CPU
    :func:`group_candidates_plain`. Every vote is the same whatever the
    order of a row's slots."""
    if cand.device.type == "cpu":
        return group_candidates_plain(cand, rows, g)
    if cand.dtype != torch.int32 or cand.ndim != 2 or (
            not cand.is_contiguous()) or g < 1:
        raise ValueError(
            f"group_candidates needs contiguous cand [B, k] int32 and g >= 1 "
            f"(got {tuple(cand.shape)} {cand.dtype}, g {g})")
    b, k = cand.shape
    if b * k > _MAX_BLOCKS or rows > _MAX_BLOCKS:
        raise ValueError(f"group_candidates: {b} x {k} slots exceed one list")
    dev = cand.device
    counts = torch.empty(max(rows, 1), dtype=torch.int32, device=dev)
    slots = torch.empty(max(b * k, 1), dtype=torch.int32, device=dev)
    items = torch.empty((max_group_items(b, k, rows, g), 4),
                        dtype=torch.int32, device=dev)
    n_items = torch.empty(1, dtype=torch.int32, device=dev)
    rc = build.kernel_library().tiresias_group_candidates(
        cand.data_ptr(), b, k, rows, g, counts.data_ptr(), slots.data_ptr(),
        items.data_ptr(), n_items.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check("group_candidates", rc)
    return slots, items, n_items


def cand_group_size(aligned: bool, f: int) -> int:
    """Queries per work item of the grouped candidate form for ``f``-frame
    queries: ``CAND_GROUP``, and for K4 no more than one block's
    ``_K4_ITEMS`` (query, 32-frame group) items hold."""
    if aligned:
        return CAND_GROUP["aligned"]
    return max(1, min(CAND_GROUP["bag"], _K4_ITEMS // max(1, -(-f // 32))))


def _cand_grouped(lib, db, rows_q, index, cand, b, f, coefs, tol, aligned,
                  route, votes, stream):
    """K4/K5's grouped candidate form into ``votes [B, k]`` (zeroed)."""
    a, t, c = db.shape
    n_cand = cand.shape[1]
    mode = "aligned" if aligned else "bag"
    share = _FORCED.get(route, DENSE_SHARE[mode])
    share_small = _FORCED.get(route, DENSE_SHARE[mode + "_small_batch"])
    g = cand_group_size(aligned, f)
    slots, items, n_items = group_candidates(cand, a, g)
    routes = route_counts(db.device)
    common = (db.data_ptr(), rows_q.data_ptr(), index.entries.data_ptr(),
              index.pos.data_ptr(), index.n_live.data_ptr(), t, c, coefs, f,
              index.chunk, index.n_chunks, tol, share, share_small,
              CAND_SHARED)
    work_list = (slots.data_ptr(), items.data_ptr(), n_items.data_ptr(),
                 items.shape[0], votes.data_ptr())
    if not aligned:
        rc = lib.tiresias_match_votes_group(
            *common, n_cand, g, *work_list, routes.data_ptr(), stream)
        build.check("match_votes_cand", rc)
        return
    warps = lib.tiresias_match_aligned_warps(index.chunk, f, min(b, g))
    work = torch.empty(items.shape[0], dtype=torch.int32, device=db.device)
    n_work = torch.empty(2, dtype=torch.int64, device=db.device)
    rc = lib.tiresias_match_votes_aligned_group(
        *common, warps, n_cand, g, *work_list, work.data_ptr(),
        n_work.data_ptr(), routes.data_ptr() + 2 * routes.element_size(),
        stream)
    if warps:
        build.check("match_votes_aligned_cand", rc)
    build.check("match_votes_aligned_cand_dense", rc)


def _votes(db, q, active, use2, tolerance, coefs: int, aligned: bool,
           index: MatchIndex | None = None, route: str = "auto",
           cand: torch.Tensor | None = None):
    a, t, c = db.shape
    if coefs < 1 or coefs > c:
        raise ValueError(f"coefs must be in [1, {c}]")
    if route != "auto" and route not in _FORCED and (
            cand is None or route not in _CAND_FORMS):
        raise ValueError(
            "route must be 'auto', 'dense' or 'index'"
            + ("" if cand is None else ", 'grouped' or 'per_item'"))
    tol = float(np.float32(tolerance))
    if db.device.type == "cpu":
        if cand is not None:
            return match_votes_cand_plain(db, q, active, use2, tol, cand,
                                          coefs, aligned)
        return match.match_votes(
            db, db[..., 0] != PAD_VALUE, q, active, use2, tol, coefs=coefs,
            aligned=aligned,
        )
    name = ("match_votes_aligned" if aligned else "match_votes") + (
        "" if cand is None else "_cand")
    if db.device.type != "cuda" or any(
        x.device != db.device for x in (q, active, use2)
    ) or (cand is not None and cand.device != db.device):
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
    if cand is not None and (
        cand.dtype != torch.int32 or cand.ndim != 2 or cand.shape[0] != b
        or not cand.is_contiguous()
    ):
        raise ValueError(
            f"{name} needs contiguous cand [B, k] int32 row ids (got "
            f"{tuple(cand.shape)} {cand.dtype})"
        )
    n_cand = 0 if cand is None else cand.shape[1]
    # the per-item candidate form: forced, or at batch 1, where no row is
    # shared and the grouping would only add its own launches
    per_item = cand is not None and (
        route == "per_item" or (route == "auto" and b == 1))
    suffix = "_per_item" if per_item else ""
    items = b * -(-f // 32)  # K4's work items: 32-frame query groups
    blocks = (a if cand is None else b * n_cand if per_item
              else max_group_items(b, n_cand, a, 1))
    if blocks > _MAX_BLOCKS or (aligned and b * a > _MAX_BLOCKS) or (
            not aligned and cand is None
            and -(-items // _K4_ITEMS) > _MAX_GRID_Y):
        raise ValueError(f"{name}: {b} queries x {a} rows exceed one launch")
    if index is None:
        index = build_match_index(db)
    if (index.t_len != t or index.entries.shape[0] != a
            or index.entries.device != db.device):
        raise ValueError(f"{name}: the index was built for another db")
    votes = torch.zeros((b, a if cand is None else n_cand),
                        dtype=torch.int32, device=db.device)
    if votes.numel() == 0 or a == 0 or f == 0:
        return votes
    rows = query_rows(q.to(torch.float32), active, use2, coefs)
    lib = build.kernel_library()
    stream = torch.cuda.current_stream(db.device).cuda_stream
    if cand is not None and not per_item:
        _cand_grouped(lib, db, rows, index, cand, b, f, coefs, tol, aligned,
                      route, votes, stream)
        return votes
    routes = route_counts(db.device)
    key = ("aligned" if aligned else "bag") + (
        "" if b >= SMALL_BATCH and cand is None else "_small_batch")
    share = _FORCED.get(route, DENSE_SHARE[key])
    common = (index.entries.data_ptr(), index.pos.data_ptr(),
              index.n_live.data_ptr(), b, a, t, c, coefs, f, index.chunk,
              index.n_chunks, tol, share)
    cand_args = (None if cand is None else cand.data_ptr(), n_cand)
    if not aligned:
        rc = lib.tiresias_match_votes(
            db.data_ptr(), rows.data_ptr(), *common, *cand_args,
            votes.data_ptr(), routes.data_ptr(), stream)
        build.check(name + suffix, rc)
        return votes
    # K5: the index kernel, then the dense kernel over the items it put on
    # the work list (every item when the offset histogram does not fit in
    # shared memory: a query of more than ~50,000 frames); the candidate
    # form runs one warp per (query, candidate) item
    warps = lib.tiresias_match_aligned_warps(index.chunk, f,
                                             b if cand is None else 1)
    work = torch.empty(votes.numel() if warps else 0, dtype=torch.int32,
                       device=db.device)
    n_work = torch.empty(2, dtype=torch.int64, device=db.device)
    rc = lib.tiresias_match_votes_aligned(
        db.data_ptr(), rows.data_ptr(), *common, warps, *cand_args,
        votes.data_ptr(), work.data_ptr(), n_work.data_ptr(),
        routes.data_ptr() + 2 * routes.element_size(), stream)
    if warps:
        build.check(name + suffix, rc)
    build.check(name + "_dense" + suffix, rc)
    return votes


def match_votes_fused(db, q, active, use2, tolerance, coefs: int = 1,
                      index: MatchIndex | None = None, route: str = "auto"):
    """K4: bag votes ``[B, A]`` int32 (``match_pallas.match_votes_pallas``).

    Args:
      db: ``[A, T, C]`` store layout (PAD_VALUE where no frame exists).
      q / active / use2: from :func:`match.prepare_query`.
      index: ``build_match_index(db)`` (built here when None; the store
        caches one per view).
      route: ``"auto"``; ``"dense"`` or ``"index"`` force a route (tests and
        measurements).
    """
    return _votes(db, q, active, use2, tolerance, coefs, False, index, route)


def match_votes_fused_aligned(db, q, active, use2, tolerance,
                              coefs: int = 1,
                              index: MatchIndex | None = None,
                              route: str = "auto"):
    """K5: aligned votes ``[B, A]`` int32, the best single time offset's
    hit count (``match_pallas.match_votes_pallas_aligned``); arguments as
    :func:`match_votes_fused`."""
    return _votes(db, q, active, use2, tolerance, coefs, True, index, route)


def match_votes_cand(db, q, active, use2, tolerance, cand, coefs: int = 1,
                     index: MatchIndex | None = None, route: str = "auto",
                     aligned: bool = False):
    """K4 (K5 with ``aligned``) over candidate rows: ``votes [B, k]`` int32,
    query b's votes against row ``cand[b, j]`` (``cand [B, k]`` int32 row
    ids into ``db``; duplicates allowed), equal to the full kernel's votes
    at those rows. ``route``: ``"auto"`` takes the grouped form (one block
    per row and up to ``CAND_GROUP`` of its queries) at batch > 1 and the
    per-item form at batch 1; ``"grouped"`` and ``"per_item"`` force a
    form, ``"dense"`` and ``"index"`` a route of the grouped form (tests and
    measurements). Arguments otherwise as :func:`match_votes_fused`."""
    return _votes(db, q, active, use2, tolerance, coefs, aligned, index,
                  route, cand=cand)


def aligned_prefiltered_votes(
    db: torch.Tensor,
    maps: tuple,
    q: torch.Tensor,
    active: torch.Tensor,
    use2: torch.Tensor,
    tolerance: float,
    specs: tuple = (),
    coefs: int = 2,
    k: int = PREFILTER_K,
    ctx_ids: torch.Tensor | None = None,
    ctx_id: int | None = None,
    top: int = 1,
    aligned: bool = True,
    index: MatchIndex | None = None,
):
    """Aligned (or, ``aligned=False``, strict bag) votes by a CERTIFIED
    two-stage search (``match_pallas.aligned_prefiltered_votes``, PARITY.md
    D17/D20): the bound ``min_c`` of each bound coefficient's clipped-scaled
    lattice votes (:func:`match_lattice.bound_votes`: the ``bound_scan``
    kernel pair over the uint8 ``maps``, context mask included), which no
    row's bag votes, and so no row's aligned votes, exceed; the ``k`` rows
    of highest bound; their exact votes by K5 (K4)'s candidate form over
    the view's sorted ``index``; and the certificate, that the ``top``-th
    best rescored score strictly beats the highest unselected bound.

    Out-of-context rows (``ctx_ids != ctx_id``) get bound -1 and, if
    selected, score 0. Returns ``(votes [B, A] int32 — candidate scores
    scattered, zeros elsewhere; certificate [B] bool)``."""
    if not specs or len(specs) != len(maps):
        raise ValueError(
            "aligned_prefiltered_votes requires matching non-empty "
            "specs/maps (store.bound_maps_for provides both)"
        )
    a = db.shape[0]
    k = min(int(k), a)
    if top > k:
        # a top-k listing larger than the candidate budget cannot be
        # served exactly: the caller must full-scan instead
        raise ValueError(f"top={top} exceeds the candidate budget k={k}")
    # the band is already inside `active` (prepare_query); the bound's
    # lattice band stays open, or a band-edge frame could leave the bound
    # but not the votes
    bound = ml.bound_votes(specs, maps, q, active, use2, tolerance, ctx_ids,
                           ctx_id)
    keep = None if ctx_ids is None else ctx_ids == ctx_id
    idx, unselected_max = ml.select_candidates(bound, k)
    votes_k = match_votes_cand(db, q, active, use2, tolerance,
                               idx.to(torch.int32), coefs, index,
                               aligned=aligned)
    if keep is not None:
        votes_k = torch.where(keep[idx], votes_k, 0)
    return (ml.scatter_candidates(votes_k, idx, a),
            ml.certificate(votes_k, unselected_max, top))


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
