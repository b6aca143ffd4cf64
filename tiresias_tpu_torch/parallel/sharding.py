"""Multi-device sharding: the (db, batch) mesh, per-shard kernels and one
gather rule (port of ``tiresias_tpu.parallel.sharding``).

The workload maps onto a 2-D grid of cells, as in the JAX package:

  * ``batch`` axis: data parallel. Query signals are split across the cells
    of a db row (and, for ingest, across every cell).
  * ``db`` axis: the catalog ``[A, T, C]`` is split on its audio axis, so
    each cell scans one slice of a catalog too large (or too slow) for one
    device. Each shard votes for its own audio columns, so the reduction is
    concatenation, not a sum.

A cell is a ``torch.device`` and the rank that owns it. Devices may repeat:
eight cells on ``cuda:0`` or on ``cpu`` are the counterpart of JAX's virtual
CPU devices. Each cell runs the hand-written kernels of the unsharded path
on its shard (K4/K5, K3', ``bound_scan`` and the candidate forms, K1/K2;
their plain twins on a CPU cell), launched under its own device.

Every sharded result is gathered by one rule (:func:`gather_cells`): the
blocks of this process's cells are stacked on the mesh's home device, and
when the mesh was built over a process group (:func:`~tiresias_tpu_torch.
parallel.distributed.global_mesh`) the per-rank blocks are exchanged with
``torch.distributed.all_gather``, at world size 1 too; then the blocks are
laid out in global order (db index first for audio columns, batch index
first for queries), which keeps the D5 tiebreak's lowest-row rule exact.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from tiresias_tpu_torch.config import DEF_SEARCH_TOLERANCE, DspConfig
from tiresias_tpu_torch.ops import match, match_lattice
from tiresias_tpu_torch.ops.match_index import build_match_index
from tiresias_tpu_torch.ops.match_kernels import (
    PREFILTER_K,
    aligned_prefiltered_votes,
    match_votes_fused,
    match_votes_fused_aligned,
)
from tiresias_tpu_torch.ops.mfcc import (
    PAD_VALUE,
    coef_scale_for,
    device_constants,
    fingerprint_padded_batch,
    mfcc_rows,
)
import tiresias_tpu_torch.parallel.distributed as tdist

DB_AXIS = "db"
BATCH_AXIS = "batch"


@dataclasses.dataclass(frozen=True)
class Cell:
    """One mesh cell: a device and the rank of the process that owns it."""

    device: torch.device
    rank: int = 0


class Mesh:
    """A ``(db, batch)`` grid of :class:`Cell`, rank-major in flat order.
    ``shape`` is ``{"db": n_db, "batch": n_batch}`` and ``devices`` the
    grid's devices as a numpy object array, as on a JAX mesh.
    ``distributed``: built over a process group, so results are exchanged
    between ranks (:func:`gather_cells`)."""

    def __init__(self, cells, distributed: bool = False) -> None:
        cells = np.asarray(cells, dtype=object)
        if cells.ndim != 2 or cells.size == 0:
            raise ValueError("a mesh is a non-empty 2-D grid of cells")
        self.cells = cells
        self.distributed = bool(distributed)
        self.rank = tdist.rank() if distributed else 0
        flat = list(cells.flat)
        if not distributed and any(c.rank != self.rank for c in flat):
            raise ValueError("cells of other ranks need a process group "
                             "(global_mesh)")
        self.rank_cells: dict[int, list[int]] = {}
        for n, c in enumerate(flat):
            self.rank_cells.setdefault(c.rank, []).append(n)
        mine = self.rank_cells.get(self.rank)
        if not mine:
            raise ValueError(f"rank {self.rank} owns no cell of the mesh")
        # where this process gathers: its first cell's device
        self.home = flat[mine[0]].device

    @property
    def shape(self) -> dict:
        return {DB_AXIS: self.cells.shape[0], BATCH_AXIS: self.cells.shape[1]}

    @property
    def size(self) -> int:
        return self.cells.size

    @property
    def devices(self) -> np.ndarray:
        out = np.empty(self.cells.shape, dtype=object)
        for idx, c in np.ndenumerate(self.cells):
            out[idx] = c.device
        return out

    def local_cells(self) -> list[tuple[int, int, Cell]]:
        """``(db index, batch index, cell)`` of this process's cells, in
        flat order."""
        nb = self.cells.shape[1]
        return [(n // nb, n % nb, self.cells.flat[n])
                for n in self.rank_cells[self.rank]]

    def shard_slots(self) -> list[tuple[int, torch.device]]:
        """The ``(db index, device)`` pairs this process holds a catalog
        shard for: one per db row of its cells and device among them."""
        out: list = []
        for i, _, c in self.local_cells():
            if (i, c.device) not in out:
                out.append((i, c.device))
        return out

    @property
    def is_multiprocess(self) -> bool:
        return len(self.rank_cells) > 1

    def __repr__(self) -> str:
        return (f"Mesh(db={self.cells.shape[0]}, batch={self.cells.shape[1]}"
                f", devices={sorted({str(c.device) for c in self.cells.flat})}"
                f", ranks={len(self.rank_cells)})")


def make_mesh(
    n_db: int | None = None,
    n_batch: int | None = None,
    devices=None,
    distributed: bool = False,
) -> Mesh:
    """A ``(db, batch)`` mesh over ``devices`` (``torch.device``, strings or
    :class:`Cell`; devices may repeat). The default is every rank's cells
    when a process group is initialized (``distributed`` then too), else
    every visible card. Defaults of the shape: every cell on the ``db`` axis
    (scan latency dominates at 10k tracks), ``batch=1``."""
    if devices is None:
        if tdist.is_initialized():
            return _grid(n_db, n_batch, tdist.global_cells(), True)
        devices = tdist.local_devices("cuda")
    return _grid(n_db, n_batch, list(devices), distributed)


def _grid(n_db, n_batch, devices: list, is_distributed: bool) -> Mesh:
    n = len(devices)
    if n_db is None and n_batch is None:
        n_db, n_batch = n, 1
    elif n_db is None:
        n_db = n // n_batch
    elif n_batch is None:
        n_batch = n // n_db
    if n_db * n_batch != n:
        raise ValueError(f"mesh {n_db}x{n_batch} != {n} devices")
    own = tdist.rank() if is_distributed else 0
    grid = np.empty(n, dtype=object)
    grid[:] = [Cell(_indexed(torch.device(d.device)), d.rank)
               if isinstance(d, Cell) else Cell(_indexed(torch.device(d)), own)
               for d in devices]
    return Mesh(grid.reshape(n_db, n_batch), distributed=is_distributed)


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` without an ordinal means the current card, as everywhere in
    the port; cells compare by their resolved device."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def on_device(device: torch.device):
    """The kernels launch on the CURRENT CUDA device: a cell whose device is
    not the current one launches under this context."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


@dataclasses.dataclass
class Sharded:
    """An array split on one mesh axis as this process holds it:
    ``parts[(index along the axis, device)]`` (a tensor, or any per-shard
    object such as a sorted index). ``rows``: the whole array's rows."""

    mesh: Mesh
    parts: dict
    rows: int

    def part(self, i: int, device: torch.device):
        return self.parts[(i, device)]


def shard_db(mesh: Mesh, db, db_mask):
    """Pad the audio axis to a multiple of the db axis and split it:
    ``(db Sharded, mask Sharded, A)``. Padding rows hold PAD_VALUE and an
    all-False mask, so no kernel ever gives them a vote."""
    db = np.asarray(db, np.float32)
    db_mask = np.asarray(db_mask, bool)
    n_db = int(mesh.shape[DB_AXIS])
    a = db.shape[0]
    a_pad = pad_to_multiple(max(a, n_db), n_db)
    if a_pad != a:
        db = np.concatenate([db, np.full((a_pad - a, *db.shape[1:]),
                                         PAD_VALUE, np.float32)])
        db_mask = np.concatenate(
            [db_mask, np.zeros((a_pad - a, *db_mask.shape[1:]), bool)])
    return (tdist.put_global(db, mesh, DB_AXIS),
            tdist.put_global(db_mask, mesh, DB_AXIS), a)


def _as_sharded(mesh: Mesh, x) -> Sharded:
    """``x`` split on the db axis, unless it is already. A tensor is sliced
    where it lies and each slice copied to its cell's device (no round trip
    through the host); a host array goes through :func:`put_global`."""
    if isinstance(x, Sharded):
        return x
    if not isinstance(x, torch.Tensor):
        return tdist.put_global(np.asarray(x), mesh, DB_AXIS)
    n = int(mesh.shape[DB_AXIS])
    if x.shape[0] % n:
        raise ValueError(
            f"{x.shape[0]} rows do not split evenly over {DB_AXIS}={n}")
    per = x.shape[0] // n
    return Sharded(mesh, {(i, d): x[i * per:(i + 1) * per].to(d).contiguous()
                          for i, d in mesh.shard_slots()}, x.shape[0])


def _index(db: Sharded, index: Sharded | None) -> Sharded:
    """K4/K5's sorted index of each shard: ``index`` when given (the store
    keeps one per shard view), else built here."""
    if index is not None:
        return index
    return Sharded(db.mesh, {k: build_match_index(x)
                             for k, x in db.parts.items()}, db.rows)


# ---- the gather rule ----------------------------------------------------- #


def _exchange(mesh: Mesh, local: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's ``local`` (same shape on every rank), in rank order, on
    this process's home device. NCCL moves CUDA tensors, Gloo CPU ones."""
    nccl = dist.get_backend() == "nccl"
    dev = mesh.home if nccl else torch.device("cpu")
    x = local.to(dev)
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    out = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    with on_device(dev):
        dist.all_gather(out, x.contiguous())
    return [o.to(mesh.home).to(local.dtype) for o in out]


def gather_cells(mesh: Mesh, blocks: list, flat: bool = False):
    """THE gather of every sharded result. ``blocks``: one ``[b, w]`` (or,
    with ``flat``, ``[b, ...]``) tensor per local cell, in
    :meth:`Mesh.local_cells` order. Returns, on the home device, the
    ``[n_batch * b, n_db * w]`` grid (cell (i, j) at query rows
    ``[j*b, (j+1)*b)`` and columns ``[i*w, (i+1)*w)``), or with ``flat`` the
    ``[n_cells * b, ...]`` concatenation in flat cell order (the batch split
    over every cell)."""
    home = mesh.home
    local = torch.stack([x.to(home) for x in blocks])
    n = mesh.size
    if mesh.distributed:
        lmax = max(len(v) for v in mesh.rank_cells.values())
        if local.shape[0] < lmax:
            local = torch.cat([local, local.new_zeros(
                (lmax - local.shape[0], *local.shape[1:]))])
        parts = _exchange(mesh, local)
        full = local.new_empty((n, *local.shape[1:]))
        for r, idx in mesh.rank_cells.items():
            full[idx] = parts[r][: len(idx)]
    else:
        full = local
    if flat:
        return full.reshape(n * full.shape[1], *full.shape[2:])
    n_db, n_batch = mesh.cells.shape
    b, w = full.shape[1], full.shape[2]
    return full.reshape(n_db, n_batch, b, w).permute(1, 2, 0, 3).reshape(
        n_batch * b, n_db * w)


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with zero rows (False, for bool) appended up to ``n`` rows: the
    zero-frame padding queries, which vote nowhere and certify trivially."""
    if x.shape[0] == n:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0], *x.shape[1:]))])


def _per_cell(mesh: Mesh, b: int, fn, queries: tuple):
    """Run ``fn(i, device, *query slices)`` on every local cell, under its
    device. ``queries`` (tensors with ``b`` rows) are padded to a multiple of
    the batch axis and cell (i, j) gets slice j, on its device. Returns each
    cell's output, in local-cell order."""
    n_batch = int(mesh.shape[BATCH_AXIS])
    b_pad = pad_to_multiple(max(b, n_batch), n_batch)
    per = b_pad // n_batch
    padded = [_pad_rows(x, b_pad) for x in queries]
    outs = []
    for i, j, cell in mesh.local_cells():
        dev = cell.device
        with on_device(dev):
            outs.append(fn(i, dev, *(
                x[j * per:(j + 1) * per].to(dev) for x in padded)))
    return outs


# ---- sharded search ------------------------------------------------------ #


def sharded_votes_kernels(
    mesh: Mesh, db, q: torch.Tensor, active: torch.Tensor,
    use2: torch.Tensor, tolerance: float, coefs: int = 1,
    aligned: bool = False, index: Sharded | None = None,
) -> torch.Tensor:
    """K4 (K5 with ``aligned``) per db shard: votes ``[B, A_pad]`` int32,
    each cell voting with its shard's sorted index on its slice of the
    batch (the counterpart of ``sharded_votes_pallas``). ``q``/``active``/
    ``use2`` come from :func:`match.prepare_query`; the batch is padded to
    the batch axis here."""
    db = _as_sharded(mesh, db)
    index = _index(db, index)
    vote = match_votes_fused_aligned if aligned else match_votes_fused
    b = int(q.shape[0])

    def cell(i, dev, qc, ac, uc):
        return vote(db.part(i, dev), qc, ac, uc, tolerance, coefs,
                    index=index.part(i, dev))

    outs = _per_cell(mesh, b, cell, (q, active, use2))
    return gather_cells(mesh, outs)[:b]


def sharded_lattice_votes(
    mesh: Mesh, value_map, q0: torch.Tensor, active: torch.Tensor,
    tolerance: float, band_lo: float, band_hi: float,
) -> torch.Tensor:
    """K3' per db shard: dialplan votes ``[B, A_pad]`` int32 on each shard's
    slice of the lattice distance map (the full scan of the dialplan
    configuration on a mesh)."""
    vm = _as_sharded(mesh, value_map)
    b = int(q0.shape[0])

    def cell(i, dev, qc, ac):
        return match_lattice.lattice_votes(vm.part(i, dev), qc, ac,
                                           tolerance, band_lo, band_hi)

    outs = _per_cell(mesh, b, cell, (q0, active))
    return gather_cells(mesh, outs)[:b]


def sharded_search(
    mesh: Mesh,
    db,
    db_mask,
    query: torch.Tensor | np.ndarray,
    n_frames: np.ndarray | None = None,
    coefs: int = 1,
    tolerance: float = 0.001,
    freq_ignore_low: int = -1,
    freq_ignore_high: int = -1,
    trunc_coef1: bool = True,
    aligned: bool = False,
    n_audios: int | None = None,
    with_top1: bool = True,
):
    """Reference-semantics search with the catalog sharded over the mesh
    (``aligned=True``: offset-aligned votes, PARITY.md D9). ``db`` holds
    PAD_VALUE wherever no frame exists (:func:`shard_db`), which is all the
    kernels read: ``db_mask`` is accepted for the JAX signature. Any batch
    size works (zero-frame padding queries fill the batch axis). Returns
    (best ``[B]``, match_count ``[B]``, votes ``[B, A]``), or
    ``(None, None, votes)`` with ``with_top1=False``. JAX's ``use_pallas``
    and ``interpret`` select nothing here: every cell runs K4/K5."""
    if tolerance < 0:
        # the -1 "use default" sentinel of every sibling entry point
        # (fp_handler.c:252-256)
        tolerance = DEF_SEARCH_TOLERANCE
    if not isinstance(query, torch.Tensor):
        query = torch.from_numpy(np.asarray(query, np.float32))
    query = query.to(mesh.home)
    q, active, use2 = match.prepare_query(
        query, n_frames, freq_ignore_low, freq_ignore_high, trunc_coef1)
    votes = sharded_votes_kernels(mesh, db, q, active, use2, tolerance,
                                  coefs, aligned)
    if n_audios is not None:
        votes = votes[:, :n_audios]
    if not with_top1:
        return None, None, votes
    best, count = match.top1(votes)
    return best, count, votes


def sharded_aligned_prefiltered(
    mesh: Mesh,
    db,
    maps: tuple,
    q: torch.Tensor,
    active: torch.Tensor,
    use2: torch.Tensor,
    tolerance: float,
    specs: tuple,
    coefs: int,
    ctx_ids=None,
    ctx_id: int | None = None,
    top: int = 1,
    k: int | None = None,
    aligned: bool = True,
    index: Sharded | None = None,
):
    """Certified two-stage aligned (strict bag with ``aligned=False``)
    search per db shard: each cell runs the port's
    :func:`~tiresias_tpu_torch.ops.match_kernels.aligned_prefiltered_votes`
    on its shard (``bound_scan``, ``torch.topk``, K5/K4's candidate form).

    Vote columns are disjoint and each shard's certificate covers its own
    rows, so when EVERY shard certifies the gathered top rows equal the full
    scan's; any failing shard must send the whole view to the full scan
    (the caller ANDs the certificates). Returns (votes ``[B, A_pad]``, certs
    ``[B, n_db]`` bool, one column per shard)."""
    db = _as_sharded(mesh, db)
    maps = tuple(_as_sharded(mesh, m) for m in maps)
    ctx = None if ctx_ids is None else _as_sharded(mesh, ctx_ids)
    index = _index(db, index)
    b = int(q.shape[0])

    def cell(i, dev, qc, ac, uc):
        votes, cert = aligned_prefiltered_votes(
            db.part(i, dev), tuple(m.part(i, dev) for m in maps), qc, ac, uc,
            tolerance, specs=specs, coefs=coefs,
            k=PREFILTER_K if k is None else k,
            ctx_ids=None if ctx is None else ctx.part(i, dev), ctx_id=ctx_id,
            top=top, aligned=aligned, index=index.part(i, dev))
        return votes, cert[:, None]

    outs = _per_cell(mesh, b, cell, (q, active, use2))
    return (gather_cells(mesh, [v for v, _ in outs])[:b],
            gather_cells(mesh, [c for _, c in outs])[:b])


def sharded_lattice_prefiltered(
    mesh: Mesh,
    vm,
    vm_q,
    q0: torch.Tensor,
    active: torch.Tensor,
    tolerance: float,
    band_lo: float,
    band_hi: float,
    ctx_ids=None,
    ctx_id: int | None = None,
    k: int | None = None,
    top: int = 1,
):
    """Certified two-stage dialplan search per db shard (PARITY.md D19):
    each cell runs the port's
    :func:`~tiresias_tpu_torch.ops.match_lattice.lattice_prefiltered_votes`
    on its slice of the maps (``bound_scan`` on the uint8 map, ``torch.topk``,
    ``rescore_rows`` on the float32 map). Composes across shards as
    :func:`sharded_aligned_prefiltered` does. Returns (votes ``[B, A_pad]``,
    certs ``[B, n_db]`` bool)."""
    vm = _as_sharded(mesh, vm)
    vm_q = _as_sharded(mesh, vm_q)
    ctx = None if ctx_ids is None else _as_sharded(mesh, ctx_ids)
    b = int(q0.shape[0])

    def cell(i, dev, qc, ac):
        votes, cert = match_lattice.lattice_prefiltered_votes(
            vm.part(i, dev), vm_q.part(i, dev), qc, ac, tolerance, band_lo,
            band_hi, k=k, top=top,
            ctx_ids=None if ctx is None else ctx.part(i, dev), ctx_id=ctx_id)
        return votes, cert[:, None]

    outs = _per_cell(mesh, b, cell, (q0, active))
    return (gather_cells(mesh, [v for v, _ in outs])[:b],
            gather_cells(mesh, [c for _, c in outs])[:b])


# ---- sharded fingerprinting --------------------------------------------- #


def _halos(mesh: Mesh, tails: list) -> list:
    """Each local cell's left halo, in local-cell order: the tail of the
    cell before it in flat order, zeros for cell 0 (the zero-initialised
    framing buffer). Within a process that is the neighbour's tail; across
    ranks it travels by ``batch_isend_irecv``: each rank sends its last
    tail to the owner of the next cell and receives its first halo from
    the owner of the cell before."""
    mine = mesh.rank_cells[mesh.rank]
    halos = [torch.zeros_like(tails[0])] + tails[:-1]
    if not (mesh.distributed and mesh.is_multiprocess):
        return halos
    owner = {f: r for r, idx in mesh.rank_cells.items() for f in idx}
    dev = (mesh.home if dist.get_backend() == "nccl"
           else torch.device("cpu"))
    ops, recv = [], None
    if mine[0] > 0:
        recv = torch.empty_like(tails[0], device=dev)
        ops.append(dist.P2POp(dist.irecv, recv, owner[mine[0] - 1]))
    if mine[-1] + 1 < mesh.size:
        ops.append(dist.P2POp(dist.isend, tails[-1].to(dev).contiguous(),
                              owner[mine[-1] + 1]))
    if ops:
        with on_device(dev):
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    if recv is not None:
        halos[0] = recv
    return halos


def sharded_fingerprint_long(
    mesh: Mesh,
    pcm,
    samplerate: int,
    dsp: DspConfig | None = None,
) -> torch.Tensor:
    """Sequence-parallel fingerprint of ONE long signal: its frame axis split
    over every cell in flat order, each cell receiving its left neighbour's
    last ``buf_size - hop_size`` samples as a halo (:func:`_halo`), framing
    its slice with that real left context and running K1 (``mfcc_rows``) on
    the frame rows.

    Args:
      pcm: ``[S]`` float32 with S a multiple of ``hop_size * cells``.
    Returns:
      ``[S // hop_size, n_coefs]`` on the home device, equal to the
      unsharded fingerprint (zeros before t0, as the framing buffer)."""
    dsp = dsp or DspConfig()
    pcm = np.asarray(pcm, np.float32)
    (s,) = pcm.shape
    n = mesh.size
    if s % (dsp.hop_size * n) != 0:
        raise ValueError(
            f"signal length {s} must be a multiple of hop*devices "
            f"({dsp.hop_size}*{n})")
    overlap = dsp.buf_size - dsp.hop_size
    per = s // n
    if per < overlap:
        # each cell ships its LAST `overlap` samples right; a shorter slice
        # cannot carry the halo
        raise ValueError(
            f"per-shard slice {per} is shorter than the window overlap "
            f"{overlap} (buf_size-hop_size); use a longer signal or fewer "
            "devices")
    cells = mesh.local_cells()
    nb = mesh.cells.shape[1]
    chunks = []
    for i, j, cell in cells:
        f = i * nb + j
        chunks.append(torch.from_numpy(pcm[f * per:(f + 1) * per]).to(
            cell.device))
    halos = _halos(mesh, [c[per - overlap:] for c in chunks])
    scale = coef_scale_for(dsp)
    outs = []
    for (i, j, cell), chunk, halo in zip(cells, chunks, halos):
        dev = cell.device
        with on_device(dev):
            ext = torch.cat([halo.to(dev), chunk])
            # frame f covers ext[f*hop : f*hop + buf): the chunk's samples
            # [(f+1)*hop - buf, (f+1)*hop) with real left context
            frames = ext.unfold(0, dsp.buf_size, dsp.hop_size).contiguous()
            out = mfcc_rows(frames, device_constants(dsp, int(samplerate),
                                                     dev))
            if scale is not None:
                out = out * torch.from_numpy(scale).to(dev)
            outs.append(out)
    return gather_cells(mesh, outs, flat=True)


def sharded_fingerprint(
    mesh: Mesh,
    pcm_padded,
    samplerate: int,
    dsp: DspConfig | None = None,
    law: str | None = None,
    n_valid=None,
) -> torch.Tensor:
    """Data-parallel fingerprinting: the batch ``[B, S]`` split over EVERY
    cell in flat order (the db axis folds into batch for ingest), each cell
    running the port's ``fingerprint_padded_batch`` (K2 ``mfcc_framed``, or
    K1 for short signals) on its slice at its device. The wire dtype is
    kept: int16 and G.711 uint8 (with ``law``; ``n_valid`` zeroes decoded
    padding) expand on the device. ``B`` must divide by the cell count.
    Returns ``[B, F, n_coefs]`` on the home device."""
    dsp = dsp or DspConfig()
    pcm = np.asarray(pcm_padded)
    if pcm.dtype == np.uint8 and law is None:
        raise ValueError("uint8 PCM requires a G.711 law (pass law=...)")
    if pcm.dtype not in (np.int16, np.uint8, np.float32):
        pcm = pcm.astype(np.float32)
    n = mesh.size
    if pcm.shape[0] % n != 0:
        raise ValueError(f"batch {pcm.shape[0]} not divisible by {n} devices")
    nv = None if n_valid is None else np.asarray(n_valid, np.int32)
    per = pcm.shape[0] // n
    nb = mesh.cells.shape[1]
    outs = []
    for i, j, cell in mesh.local_cells():
        f = i * nb + j
        sl = slice(f * per, (f + 1) * per)
        with on_device(cell.device):
            outs.append(fingerprint_padded_batch(
                pcm[sl], samplerate, dsp, law=law,
                n_valid=None if nv is None else nv[sl],
                device=cell.device))
    return gather_cells(mesh, outs, flat=True)
