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
    (a genuine ±inf included), stable in time among equal keys."""

    entries: torch.Tensor
    pos: torch.Tensor
    n_live: torch.Tensor
    chunk: int
    t_len: int

    @property
    def n_chunks(self) -> int:
        return int(self.n_live.shape[1])


def sort_keys(d0: torch.Tensor) -> torch.Tensor:
    """int32 keys that order float32 values as ``<`` does (−inf first,
    +inf last; −0.0 just before +0.0, which compare equal)."""
    bits = d0.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def build_match_index(db: torch.Tensor, t_chunk: int = T_CHUNK) -> MatchIndex:
    """The index of ``db [A, T, C]`` (store layout, PAD_VALUE where no
    frame exists: past an audio's end, padding and tombstoned rows), built
    where ``db`` lies. About 10 bytes per stored frame."""
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
    return MatchIndex(
        entries=entries,
        pos=order.to(torch.int16).contiguous(),
        n_live=(~dead).sum(dim=-1, dtype=torch.int32).contiguous(),
        chunk=chunk,
        t_len=t,
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


def band_bounds_plain(index: MatchIndex, q0: torch.Tensor, tol: float):
    """``(lo, hi)`` int64 ``[B, F, A, n_chunks]``: the entries
    ``[lo, hi)`` of each chunk's live run whose d0 passes
    ``|fl(d0 − q0)| <= tol`` — exactly those, found by binary search on
    the float32 expression itself, as the kernels search."""
    tol = float(np.float32(tol))
    keys = index.entries[..., 0]  # [A, nc, chunk]
    a, nc, chunk = keys.shape
    b, f = q0.shape
    q = q0.to(torch.float32)[:, :, None, None, None]
    n = index.n_live.to(torch.int64)[None, None].expand(b, f, a, nc)
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
