"""Sorted per-view index for the tolerance votes of K4 and K5.

The reference matches by range lookup: one ``WHERE max1 BETWEEN f ± tol``
query per query frame (fp_handler.c:308-359). In float32 the vote test on
coefficient 0 is ``|fl(d0 − q0)| <= tol``. Rounding is monotone, so for a
fixed ``q0`` the value ``fl(d0 − q0)`` never decreases as ``d0`` grows: the
stored frames whose ``d0`` passes form one contiguous run of a ``d0``-sorted
row. A binary search that evaluates the same float32 expression finds the
run's ends exactly (a search for ``fl(q0 ± tol)`` would not: it can take in
or leave out a value at the edge). The kernels then test coefficient 1 and
the rest only inside the run, and their votes equal the dense test's bit for
bit.

:func:`build_match_index` sorts each row's frames by ``d0`` within time
chunks of ``T_CHUNK`` frames (a 1,024-frame tier is one chunk), on the
device with plain torch ops, as the store builds the lattice value map.
Frames that cannot match (``d0`` PAD_VALUE or NaN) are left out of each
chunk's live run. :func:`band_bounds_plain` is the kernels' binary search
in torch, and :func:`votes_by_index_plain` their whole algorithm in torch,
for the tests; :func:`tiresias_tpu_torch.ops.match.match_votes` stays the
function's twin and the wrappers' CPU path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tiresias_tpu_torch.ops.match import _aligned_scores
from tiresias_tpu_torch.ops.mfcc import PAD_VALUE

T_CHUNK = 2048  # stored frames per sorted chunk (shared memory per stage)
_DEAD_KEY = torch.iinfo(torch.int32).max


@dataclasses.dataclass
class MatchIndex:
    """Each row's frames sorted by coefficient 0, per time chunk.

    ``entries [A, n_chunks, chunk, 2]`` float32 holds (d0, d1) of the
    sorted frames (d1 is 0 for a one-coefficient store; NaN past the live
    run), ``pos [A, n_chunks, chunk]`` int16 each entry's time within its
    chunk, and ``n_live [A, n_chunks]`` int32 the length of the live run:
    the frames whose d0 is neither PAD_VALUE nor NaN, in ascending d0
    (a genuine ±inf included), stable in time among equal keys.

    The kept coefficient-1 order (None for a one-coefficient store): ``d1
    [A, n_chunks, chunk]`` float32 the live frames' d1 ascending by
    :func:`sort_keys`, stable in time, those with a NaN d1 left out (NaN
    past the run), ``pos1`` int16 their times in the chunk, ``n1 [A,
    n_chunks]`` int32 the run's length; 6 more bytes a frame. The
    bit-sliced K5 builds its coefficient-1 bitsets from it."""

    entries: torch.Tensor
    pos: torch.Tensor
    n_live: torch.Tensor
    chunk: int
    t_len: int
    d1: torch.Tensor | None = None
    pos1: torch.Tensor | None = None
    n1: torch.Tensor | None = None

    @property
    def n_chunks(self) -> int:
        return int(self.n_live.shape[1])

    def row_tensors(self) -> dict:
        """The per-row tensors by field name (the kept order's where it is
        built): what a view update replaces row by row."""
        return {name: getattr(self, name)
                for name in ("entries", "pos", "n_live", "d1", "pos1", "n1")
                if getattr(self, name) is not None}


def sort_keys(d0: torch.Tensor) -> torch.Tensor:
    """int32 keys that order float32 values as ``<`` does (−inf first,
    +inf last; −0.0 just before +0.0, which compare equal)."""
    bits = d0.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def build_match_index(db: torch.Tensor, t_chunk: int = T_CHUNK) -> MatchIndex:
    """The index of ``db [A, T, C]`` (store layout, PAD_VALUE where no
    frame exists: past an audio's end, padding and tombstoned rows), built
    where ``db`` lies: 10 bytes per stored frame, 16 with the kept
    coefficient-1 order (``C > 1``)."""
    a, t, c = db.shape
    if t_chunk % 2 or not 2 <= t_chunk <= 32768:
        raise ValueError("t_chunk must be even and in [2, 32768]")
    chunk = min(t_chunk, t + t % 2)
    n_chunks = max(1, -(-t // chunk))
    pad = n_chunks * chunk - t
    d0 = db[..., 0]
    d1 = db[..., 1] if c > 1 else torch.zeros_like(d0)
    dead = (d0 == PAD_VALUE) | torch.isnan(d0)
    if pad:
        d0 = torch.nn.functional.pad(d0, (0, pad))
        d1 = torch.nn.functional.pad(d1, (0, pad))
        dead = torch.nn.functional.pad(dead, (0, pad), value=True)
    shape = (a, n_chunks, chunk)
    d0, d1, dead = d0.reshape(shape), d1.reshape(shape), dead.reshape(shape)
    keys = torch.where(dead, _DEAD_KEY, sort_keys(d0))
    order = torch.sort(keys, dim=-1, stable=True).indices
    live = ~dead.gather(-1, order)
    nan = torch.full((), float("nan"), device=db.device)
    entries = torch.stack([
        torch.where(live, d0.gather(-1, order), nan),
        torch.where(live, d1.gather(-1, order), nan),
    ], dim=-1).contiguous()
    kept = {}
    if c > 1:  # coefficient 1's order of the live frames, NaN d1 left out
        ok1 = ~dead & ~torch.isnan(d1)
        keys1 = torch.where(ok1, sort_keys(d1), _DEAD_KEY)
        order1 = torch.sort(keys1, dim=-1, stable=True).indices
        n1 = ok1.sum(dim=-1, dtype=torch.int32)
        run = torch.arange(chunk, device=db.device) < n1[..., None]
        kept = {"d1": torch.where(run, d1.gather(-1, order1),
                                  nan).contiguous(),
                "pos1": order1.to(torch.int16).contiguous(),
                "n1": n1.contiguous()}
    return MatchIndex(
        entries=entries,
        pos=order.to(torch.int16).contiguous(),
        n_live=(~dead).sum(dim=-1, dtype=torch.int32).contiguous(),
        chunk=chunk,
        t_len=t,
        **kept,
    )


def _before(x: torch.Tensor, d: torch.Tensor, tol: float) -> torch.Tensor:
    """Entry lies before the band: ``fl(d − q) < −tol``, or NaN from
    ``d = q = −inf`` (those sort first). With a NaN query every negative
    ``d`` counts as before, so the band is empty there too."""
    return (x < -tol) | (torch.isnan(x) & (d < 0))


def _bisect(pred, lo: torch.Tensor, hi: torch.Tensor, steps: int):
    """First index in ``[lo, hi)`` where ``pred`` is false (``pred`` true
    on a prefix), elementwise."""
    for _ in range(steps):
        go = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        p = pred(mid) & go
        lo = torch.where(p, mid + 1, lo)
        hi = torch.where(go & ~p, mid, hi)
    return lo


def _bfa(x: torch.Tensor) -> torch.Tensor:
    """``x [B, F]`` or ``[B, F, A]`` as ``[B, F, A or 1, 1]``, to broadcast
    against ``[B, F, A, n_chunks, ...]``."""
    return (x[:, :, None] if x.ndim == 2 else x)[..., None]


def band_bounds_plain(index: MatchIndex, q0: torch.Tensor, tol: float):
    """``(lo, hi)`` int64 ``[B, F, A, n_chunks]``: the entries
    ``[lo, hi)`` of each chunk's live run whose d0 passes
    ``|fl(d0 − q0)| <= tol`` — exactly those, found by binary search on
    the float32 expression itself, as the kernels search."""
    return _band_bounds(index.entries[..., 0], index.n_live, q0, tol)


def _band_bounds(keys: torch.Tensor, n_live: torch.Tensor, q0: torch.Tensor,
                 tol: float):
    """:func:`band_bounds_plain` over sorted ``keys [A, nc, chunk]`` with
    ``n_live [A, nc]`` live entries each; ``q0 [B, F]``, or ``[B, F, A]``
    for a query value of its own at each row."""
    tol = float(np.float32(tol))
    a, nc, chunk = keys.shape
    b, f = q0.shape[:2]
    q = _bfa(q0.to(torch.float32))[..., None]
    n = n_live.to(torch.int64)[None, None].expand(b, f, a, nc)
    flat = keys[None, None].expand(b, f, a, nc, chunk)
    steps = int(chunk).bit_length() + 1

    def x_at(i):
        d = flat.gather(-1, i.clamp(max=chunk - 1)[..., None])
        return d - q, d

    def before(i):
        x, d = x_at(i)
        return _before(x, d, tol)[..., 0]

    def inside(i):
        return (x_at(i)[0] <= tol)[..., 0]

    zero = torch.zeros_like(n)
    lo = _bisect(before, zero, n, steps)
    hi = _bisect(inside, lo, n, steps)
    return lo, hi


def votes_by_index_plain(index: MatchIndex, db, q, active, use2, tol,
                         coefs: int = 1, aligned: bool = False):
    """The kernels' algorithm in plain torch: bands of coefficient 0 from
    :func:`band_bounds_plain`; inside them only, coefficient 1 (where
    ``use2``) and 2..coefs-1 (read from ``db`` by time); then bag or
    aligned votes ``[B, A]`` int32 as :func:`match.match_votes` reduces."""
    tol = float(np.float32(tol))
    a, t, c = db.shape
    b, f = active.shape
    if coefs < 1 or coefs > c:
        raise ValueError(f"coefs must be in [1, {c}]")
    lo, hi = band_bounds_plain(index, q[..., 0], tol)
    chunk, nc = index.chunk, index.n_chunks
    u = torch.arange(chunk, device=db.device)
    inband = (u >= lo[..., None]) & (u < hi[..., None])  # [B,F,A,nc,chunk]
    inband &= active[:, :, None, None, None]
    ent = index.entries[None, None]
    if coefs > 1:
        ok1 = (ent[..., 1] - q[..., 1][:, :, None, None, None]).abs() <= tol
        inband &= ok1 | ~use2[:, :, None, None, None]
    tpos = (index.pos.to(torch.int64)
            + chunk * torch.arange(nc, device=db.device)[:, None])
    for ci in range(2, coefs):
        dc = torch.full((a, nc * chunk), float("nan"), device=db.device)
        dc[:, :t] = db[..., ci]
        dc = dc.gather(1, tpos.reshape(a, -1).clamp(max=nc * chunk - 1))
        okc = (dc.reshape(a, nc, chunk)[None, None]
               - q[..., ci][:, :, None, None, None]).abs() <= tol
        inband &= okc
    ok = torch.zeros((b, f, a, nc * chunk), dtype=torch.bool,
                     device=db.device)
    ok.scatter_(3, tpos.reshape(1, 1, a, -1).expand(b, f, a, -1),
                inband.reshape(b, f, a, -1))
    ok = ok[..., :t]
    if aligned:
        return _aligned_scores(ok)
    return ok.any(dim=-1).sum(dim=1, dtype=torch.int32)


# The bit-sliced K5 (csrc/match.cu, match_votes_aligned_bits_kernel_ws):
# counter planes (counts below 2**PLANES between folds) and the block of
# ranks a prefix bitset steps by (16, or 32 past 1,024-frame chunks).
PLANES = 8
FOLD_AT = 2**PLANES - 1
_WORD = 0xFFFFFFFF
_ITEM_QUERIES = 8  # queries per grouped work item, at most (kGroup5)


def block_shift(chunk: int) -> int:
    """log2 of the ranks per block of the prefix bitsets of a chunk."""
    return 4 if chunk <= 1024 else 5


def coef1_order(index: MatchIndex):
    """Coefficient 1's order of each chunk's live entries, as the index
    keeps it (:class:`MatchIndex`): ``(d1 [A, nc, chunk]`` float32
    ascending (NaN past the run), ``pos1 [A, nc, chunk]`` int64 times in the
    chunk, ``n1 [A, nc]`` int64 the entries whose d1 is not NaN)."""
    if index.d1 is None:
        raise ValueError("a one-coefficient index keeps no coefficient-1 "
                         "order")
    return index.d1, index.pos1.to(torch.int64), index.n1.to(torch.int64)


def prefix_bitsets(pos: torch.Tensor, n: torch.Tensor, chunk: int):
    """``P [A, nc, nb + 1, nwc]`` int64 (32-bit words): ``P[..., k, :]``
    holds the times (bits of the chunk's ``nwc`` words) of the entries
    ranked below ``k * g`` in the order ``pos [A, nc, chunk]`` (times), of
    which the first ``n [A, nc]`` are live."""
    a, nc, _ = pos.shape
    lg = block_shift(chunk)
    nb = -(-chunk // (1 << lg))
    nwc = -(-chunk // 32)
    r = torch.arange(chunk, device=pos.device)
    live = r < n[..., None].to(torch.int64)
    t = pos.to(torch.int64).clamp(0, chunk - 1)
    slot = (r >> lg) * nwc + (t >> 5)
    bit = torch.where(live, torch.ones_like(t) << (t & 31), 0)
    blocks = torch.zeros((a, nc, nb * nwc), dtype=torch.int64,
                         device=pos.device)
    blocks.scatter_add_(-1, slot, bit)  # distinct times: a sum is an OR
    blocks = blocks.reshape(a, nc, nb, nwc)
    zero = torch.zeros((a, nc, 1, nwc), dtype=torch.int64, device=pos.device)
    return torch.cat([zero, torch.cumsum(blocks, dim=2)], dim=2)


def band_bitsets(p: torch.Tensor, pos: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor, chunk: int) -> torch.Tensor:
    """The bitsets ``[B, F, A, nc, nwc]`` int64 of the rank bands ``[lo,
    hi)`` (``[B, F, A, nc]``): the whole blocks inside a band from the
    prefix bitsets ``p``, ``P[hb] & ~P[lb]``, and its at most ``2 (g − 1)``
    edge entries set from their times ``pos``."""
    lg = block_shift(chunk)
    g = 1 << lg
    b, f, a, nc = lo.shape
    nwc = p.shape[-1]
    lb = (lo + g - 1) >> lg
    hb = hi >> lg
    pb = p[None, None].expand(b, f, a, nc, -1, nwc)

    def row(k):
        return pb.gather(4, k[..., None, None].expand(b, f, a, nc, 1, nwc))[
            ..., 0, :]

    full = torch.where((hb > lb)[..., None], row(hb) & ~row(lb) & _WORD, 0)
    e1 = torch.minimum(hi, lb << lg)  # first edge [lo, e1)
    s2 = torch.maximum(hb << lg, e1)  # second edge [s2, hi)
    i = torch.arange(2 * g, device=lo.device)
    n1 = (e1 - lo)[..., None]
    r = torch.where(i < n1, lo[..., None] + i, s2[..., None] + i - n1)
    ok = i < n1 + (hi - s2)[..., None]
    posb = pos.to(torch.int64)[None, None].expand(b, f, a, nc, chunk)
    t = posb.gather(-1, r.clamp(0, chunk - 1))
    edges = torch.zeros_like(full)
    edges.scatter_add_(-1, t >> 5,
                       torch.where(ok, torch.ones_like(t) << (t & 31), 0))
    return full | edges


def _ripple(planes: list, x: torch.Tensor) -> None:
    """Adds the bits of ``x`` into the bit-sliced counters ``planes``."""
    for k in range(len(planes)):
        carry = planes[k] & x
        planes[k] = planes[k] ^ x
        x = carry


def _fold(planes: list, counts: torch.Tensor) -> None:
    """Adds the counters' values into ``counts [..., 32 * words]`` int32 and
    clears them."""
    bits = torch.arange(32, device=counts.device)
    for k, p in enumerate(planes):
        v = ((p[..., None] >> bits) & 1) << k  # [..., words, 32]
        counts += v.reshape(counts.shape).to(torch.int32)
        planes[k] = torch.zeros_like(p)


def _index_rows(index: MatchIndex, rows: torch.Tensor) -> MatchIndex:
    """The index of the rows ``rows`` (ids into it, repeats allowed)."""
    return dataclasses.replace(index, **{
        name: x[rows] for name, x in index.row_tensors().items()})


def aligned_votes_bits_plain(index: MatchIndex, db, q, active, use2, tol,
                             coefs: int = 1, cand=None,
                             max_pairs: int = 4096):
    """The bit-sliced K5 in plain torch: aligned votes ``[B, A]`` int32
    (PARITY.md D9), equal to :func:`match.match_votes` with ``aligned``.

    Per chunk of the index: coefficient 0's rank bands over the d0 order
    and coefficient 1's over the kept order (:func:`coef1_order`;
    :func:`_band_bounds`, the kernels' bisection on ``fl(d − q)``); each
    band's bitset over the chunk's times from :func:`prefix_bitsets` and
    its edge entries (:func:`band_bitsets`); hits ``B0 & (B1 | ~use2)``,
    then coefficients 2..coefs-1 on the hits; each frame's hits shifted to
    its offsets ``t − f + F − 1`` (words funnel-shifted as the kernel
    shifts them) and added into ``PLANES`` bit-sliced counters, folded into
    int32 counts every ``FOLD_AT`` frames and at the chunk's end; the max
    offset count. Every row is one work item of every query (the full scan,
    and the grouped form's no-list mode below SMALL_BATCH).

    With ``cand [B, k]`` int32 row ids: the grouped candidate form, votes
    ``[B, k]`` of query b against row ``cand[b, j]`` (0 for an id outside
    ``[0, A)``). Its work items, as the kernel takes them: the valid slots
    grouped by row (rows ascending, slots ascending), each row's cut into
    items of up to 8 queries, or at batch 1 each slot an item of its own;
    each item's row is staged once for its queries. Items are served
    ``max_pairs`` (query, row) pairs at a time.
    """
    tol = float(np.float32(tol))
    a, t_len, c = db.shape
    b, f = active.shape
    if coefs < 1 or coefs > c:
        raise ValueError(f"coefs must be in [1, {c}]")
    if cand is None:
        return _bits_votes(index, db, q, active, use2, tol, coefs)
    votes = torch.zeros(cand.shape, dtype=torch.int32, device=db.device)
    flat = cand.reshape(-1).to(torch.int64)
    slot = ((flat >= 0) & (flat < a)).nonzero()[:, 0]
    i = torch.arange(slot.numel(), device=db.device)
    item = i  # batch 1: each slot an item
    if b > 1:  # row-major: rows ascending, a row's slots ascending
        slot = slot[torch.argsort(flat[slot], stable=True)]
        row = flat[slot]
        first = torch.ones_like(row, dtype=torch.bool)
        first[1:] = row[1:] != row[:-1]
        start = torch.cummax(torch.where(first, i, 0), 0)[0]
        item = torch.cumsum((i - start) % _ITEM_QUERIES == 0, 0) - 1
    # whole items, up to max_pairs pairs at a time
    n_items = int(item[-1]) + 1 if item.numel() else 0
    cut = torch.searchsorted(item, torch.arange(
        0, n_items, max(1, max_pairs // _ITEM_QUERIES),
        device=db.device)).tolist()
    for lo, hi in zip(cut, cut[1:] + [slot.numel()]):
        s = slot[lo:hi]
        pa, pb = flat[s], s // cand.shape[1]
        # each pair its own row: queries [1, F, P]
        got = _bits_votes(
            _index_rows(index, pa), db[pa], q[pb].transpose(0, 1)[None],
            active[pb].T[None], use2[pb].T[None], tol, coefs)
        votes.view(-1)[s] = got[0]
    return votes


def _bits_votes(index: MatchIndex, db, q, active, use2, tol: float,
                coefs: int):
    """:func:`aligned_votes_bits_plain`'s votes ``[B, A]``: ``q [B, F, C]``
    and ``active`` / ``use2 [B, F]``, or (a query of its own at each row)
    ``[B, F, A, C]`` / ``[B, F, A]``."""
    a, t_len, c = db.shape
    b, f = active.shape[:2]
    dev = db.device
    votes = torch.zeros((b, a), dtype=torch.int32, device=dev)
    if f == 0 or a == 0:
        return votes
    chunk, nc = index.chunk, index.n_chunks
    nwc = -(-chunk // 32)
    q = q.to(torch.float32)
    lo0, hi0 = _band_bounds(index.entries[..., 0], index.n_live, q[..., 0],
                            tol)
    hits = band_bitsets(prefix_bitsets(index.pos, index.n_live, chunk),
                        index.pos, lo0, hi0, chunk)
    if coefs > 1:
        d1s, pos1, n1 = coef1_order(index)
        lo1, hi1 = _band_bounds(d1s, n1, q[..., 1], tol)
        b1 = band_bitsets(prefix_bitsets(pos1, n1, chunk), pos1, lo1, hi1,
                          chunk)
        hits = torch.where(_bfa(use2)[..., None], hits & b1, hits)
    hits = torch.where(_bfa(active)[..., None], hits, 0)
    if coefs > 2:  # the rest, packed into words of each chunk's times
        tt = nc * chunk
        ok = torch.ones((b, f, a, tt), dtype=torch.bool, device=dev)
        for ci in range(2, coefs):
            dc = torch.full((a, tt), float("nan"), device=dev)
            dc[:, :t_len] = db[..., ci]
            ok &= (_bfa(q[..., ci]) - dc[None, None]).abs() <= tol
        ok = ok.reshape(b, f, a, nc, -1)
        ok = torch.nn.functional.pad(ok, (0, nwc * 32 - chunk))
        ok = ok.reshape(b, f, a, nc, nwc, 32)
        rest = torch.zeros_like(hits)
        for bit in range(32):
            rest |= ok[..., bit].to(torch.int64) << bit
        hits &= rest
    n_off = t_len + f - 1
    words = -(-(chunk + f - 1) // 32)  # a chunk's offsets [t0, t0+chunk+F-1)
    acc = torch.zeros((b, a, nc * chunk + 32 * words), dtype=torch.int32,
                      device=dev)
    k = torch.arange(words, device=dev)
    zero = torch.zeros((b, a, 1), dtype=torch.int64, device=dev)
    for ch in range(nc):
        planes = [torch.zeros((b, a, words), dtype=torch.int64, device=dev)
                  for _ in range(PLANES)]
        counts = torch.zeros((b, a, 32 * words), dtype=torch.int32,
                             device=dev)
        for fi in range(f):
            h = torch.cat([zero, hits[:, fi, :, ch], zero], dim=-1)
            base = -(f - 1 - fi)  # offset o (from t0) reads time o + base
            qw = (base >> 5) + k  # word qw of the hits, then qw + 1
            lo_w = h[..., qw.clamp(-1, nwc) + 1]
            hi_w = h[..., (qw + 1).clamp(-1, nwc) + 1]
            sh = base & 31
            x = (lo_w >> sh) | ((hi_w << (32 - sh)) & _WORD) if sh else lo_w
            _ripple(planes, x)
            if (fi + 1) % FOLD_AT == 0:
                _fold(planes, counts)
        _fold(planes, counts)
        t0 = ch * chunk
        acc[:, :, t0 : t0 + 32 * words] += counts
    return acc[:, :, :n_off].amax(dim=-1).to(torch.int32)
