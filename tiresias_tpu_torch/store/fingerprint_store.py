"""Device-resident fingerprint store + host catalog (port of
``tiresias_tpu.store.fingerprint_store``).

Host side is the JAX package's layout unchanged: each audio lives whole in
the power-of-two frame tier (128 * 2^k frames) that fits it; a tier is a
float32 ``[capacity, tier_frames, n_coefs]`` numpy matrix with
``PAD_VALUE`` beyond each audio's frames, rows in insertion order; deletes
tombstone rows and compact past a waste threshold; audios longer than the
top tier are split into consecutive segment rows of one catalog entry.

Device side, each non-empty tier has a :class:`TierView` of torch tensors
(rows padded to multiples of 128). On a ``(db, batch)`` mesh
(:mod:`tiresias_tpu_torch.parallel`) the rows pad to multiples of
``128 * n_db`` and a view holds one :class:`Shard` per db row of this
process's cells and device among them: a view of its own of the tier's rows
``[i * A_pad / n_db, (i + 1) * A_pad / n_db)`` on that device, whose
derived data is built there. An auto-split audio whose segment rows cross a
shard edge keeps its min-combined map row exact: the shard of its first row
carries the map rows of the segments beyond the edge. The lattice distance map, the certified
prefilters' uint8 maps (the quantized distance map and the strict/aligned
bound maps), K4/K5's sorted index, the per-row insertion seqs and the
per-row context ids are derived lazily per view. After a mutation the next
search updates the previous views row by row, as the JAX store does: an
append uploads only the new rows and builds their derived rows, a delete
tombstones its rows on the device; both write into new tensors, so a
search in flight keeps the views it started with. Only capacity growth past
a 128-row bucket and compaction rebuild a view in full.

The checkpoint is the JAX package's version-4 format — ``catalog.json``
plus immutable per-tier ``.npy`` segment files, committed by an atomic
catalog rename with the previous generation kept as ``.bak`` — so a
checkpoint written by either package restores in the other. Versions 1 and
2 (one ``fingerprints.npz`` beside the catalog: a dense matrix in global
insertion order, or one matrix per tier) load too, and the first save over
them writes version 4, keeping the legacy ``.bak`` pair consistent.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import re
import shutil
import threading
from typing import NamedTuple

import numpy as np
import torch

from tiresias_tpu_torch.config import DEF_N_COEFS
from tiresias_tpu_torch.utils.hashing import generate_uuid
from tiresias_tpu_torch.utils.logging import get_logger
from tiresias_tpu_torch.ops.match_index import MatchIndex, build_match_index
from tiresias_tpu_torch.ops.match_lattice import (
    BOUND_FAR,
    bound_coef_indices,
    build_bound_map,
    build_bound_maps,
    build_value_map,
    quantize_value_map,
)
from tiresias_tpu_torch.ops.mfcc import PAD_VALUE
from tiresias_tpu_torch.utils.device import resolve_device

log = get_logger(__name__)

CHECKPOINT_VERSION = 4
READABLE_VERSIONS = (1, 2, 3, 4)
CATALOG_FILE = "catalog.json"
MATRIX_FILE = "fingerprints.npz"  # v1/v2 checkpoints (still loadable)
SEGMENT_ROWS = 2048

AUDIO_BUCKET = 128
FRAME_BUCKET = 128
MAX_TIER_FRAMES = FRAME_BUCKET * 2**14  # ~2.1M frames ~ 18.6 h at 8 kHz

_SEG_GEN_RE = re.compile(r"^tier\d+_seg\d+\.g(\d+)\.npy$")


def tier_for(n_frames: int) -> int:
    """Smallest tier frame-capacity that fits ``n_frames``."""
    if n_frames > MAX_TIER_FRAMES:
        raise ValueError(
            f"audio of {n_frames} frames exceeds the maximum tier "
            f"({MAX_TIER_FRAMES}); split the file before ingest"
        )
    t = FRAME_BUCKET
    while t < n_frames:
        t *= 2
    return t


def split_frames(n_frames: int) -> list[int]:
    """Per-segment frame counts: ``[n_frames]`` when it fits a tier,
    otherwise MAX_TIER_FRAMES-sized chunks plus the tail. Segment rows
    min-combine in the lattice map (exact per-audio semantics)."""
    if n_frames <= MAX_TIER_FRAMES:
        return [n_frames]
    out = []
    rem = n_frames
    while rem > 0:
        out.append(min(rem, MAX_TIER_FRAMES))
        rem -= MAX_TIER_FRAMES
    return out


@dataclasses.dataclass
class AudioEntry:
    """One ``audio_list`` row (reference fp_handler.c:700-706)."""

    uuid: str
    name: str
    context: str
    hash: str
    n_frames: int
    # monotonic per-store insertion sequence; not persisted (the catalog's
    # entry order encodes it)
    seq: int = dataclasses.field(default=-1, compare=False)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("seq")
        return d

    @staticmethod
    def from_dict(d: dict) -> "AudioEntry":
        return AudioEntry(
            uuid=d["uuid"], name=d["name"], context=d["context"],
            hash=d["hash"], n_frames=int(d["n_frames"]),
        )


class CheckpointIncompatible(ValueError):
    """A checkpoint that is structurally valid but cannot be loaded into this
    store (version, n_coefs or coef_weights mismatch)."""


class CheckpointUnreadable(RuntimeError):
    """Checkpoint generations exist but none could be read; starting empty
    would let the next save garbage-collect the data."""


def _fsync_dir(directory: str) -> None:
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # filesystems without directory fsync
    finally:
        os.close(fd)


def _readable_catalog(path: str) -> bool:
    """Whether a catalog generation parses — the rotation guard: a corrupt
    current catalog must never be rotated over a good ``.bak``."""
    try:
        with open(path) as f:
            json.load(f)
        return True
    except Exception:  # noqa: BLE001 - any unreadable generation
        return False


def _read_catalog_gen(path: str) -> int:
    """A catalog generation's ``gen`` field, 0 when unreadable/absent."""
    try:
        with open(path) as f:
            return int(json.load(f).get("gen", 0))
    except Exception:  # noqa: BLE001 - any unreadable generation
        return 0


def _unreadable_version(version) -> str:
    return (
        f"checkpoint version {version!r} is not readable here "
        f"(versions {', '.join(map(str, READABLE_VERSIONS))} are)"
    )


def _max_seg_gen(directory: str) -> int:
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    return max(
        (int(m.group(1)) for m in map(_SEG_GEN_RE.match, names) if m),
        default=0,
    )


def _bucket(n: int, multiple: int) -> int:
    return max(multiple, -(-n // multiple) * multiple)


class _Tier:
    """One frame-capacity tier: dense host matrix + row-ordered entries."""

    def __init__(self, tier_frames: int, n_coefs: int) -> None:
        self.t = tier_frames
        self.n_coefs = n_coefs
        self.matrix = np.full((0, tier_frames, n_coefs), PAD_VALUE, np.float32)
        # one slot per matrix ROW; an auto-split audio's segment rows all
        # point at the same entry, row_frames holds each row's frame count
        self.entries: list[AudioEntry] = []
        self.row_frames: list[int] = []
        self.rows: dict[str, int] = {}  # uuid -> FIRST matrix row
        self.uuid_rows: dict[str, list[int]] = {}  # multi-row audios only
        self.dead: set[int] = set()  # tombstoned rows
        self.view_dead_pending: set[int] = set()  # dead since the last view
        # first row changed since the last checkpoint save
        self.dirty_from = 0
        # the same relative to the last device-view build: appends keep it
        # at the old row count (incremental update), compaction drops it
        # below (full rebuild)
        self.view_clean_from = 0

    @property
    def n_live(self) -> int:
        return len(self.entries) - len(self.dead)

    def ensure_capacity(self, n_rows: int) -> None:
        cap = self.matrix.shape[0]
        new_cap = cap
        while new_cap < n_rows:
            new_cap = max(AUDIO_BUCKET, new_cap * 2)
        if new_cap != cap:
            grown = np.full(
                (new_cap, self.t, self.n_coefs), PAD_VALUE, np.float32
            )
            grown[:cap] = self.matrix
            self.matrix = grown

    def _add_row(self, entry: AudioEntry, chunk: np.ndarray) -> int:
        row = len(self.entries)
        self.ensure_capacity(row + 1)
        self.matrix[row] = PAD_VALUE
        self.matrix[row, : chunk.shape[0]] = chunk
        self.entries.append(entry)
        self.row_frames.append(int(chunk.shape[0]))
        self.dirty_from = min(self.dirty_from, row)
        self.view_clean_from = min(self.view_clean_from, row)
        return row

    def add(self, entry: AudioEntry, fingerprint: np.ndarray) -> None:
        self.rows[entry.uuid] = self._add_row(entry, fingerprint)

    def add_segmented(
        self, entry: AudioEntry, fingerprint: np.ndarray, segs: list[int]
    ) -> None:
        rows = []
        off = 0
        for n in segs:
            rows.append(self._add_row(entry, fingerprint[off : off + n]))
            off += n
        self.rows[entry.uuid] = rows[0]
        self.uuid_rows[entry.uuid] = rows

    def delete_many(self, uuids) -> list[AudioEntry]:
        """Tombstone every audio whose uuid is in ``uuids``; returns the
        removed entries in (first-)row order."""
        doomed = sorted((r, u) for u, r in self.rows.items() if u in uuids)
        removed = []
        for first, u in doomed:
            removed.append(self.entries[first])
            self.rows.pop(u, None)
            rows = self.uuid_rows.pop(u, [first])
            self.dead.update(rows)
            self.view_dead_pending.update(rows)
        return removed

    def should_compact(self) -> bool:
        return (
            len(self.dead) >= AUDIO_BUCKET
            and 4 * len(self.dead) >= len(self.entries)
        )

    def compact(self) -> None:
        """Physically remove tombstoned rows (order-preserving)."""
        if not self.dead:
            return
        doomed = sorted(self.dead)
        n = len(self.entries)
        keep = np.ones(n, bool)
        keep[doomed] = False
        keep_idx = np.flatnonzero(keep)
        remap = {int(old): new for new, old in enumerate(keep_idx)}
        self.matrix[: len(keep_idx)] = self.matrix[keep_idx]
        self.matrix[len(keep_idx) : n] = PAD_VALUE
        self.entries = [self.entries[i] for i in keep_idx]
        self.row_frames = [self.row_frames[i] for i in keep_idx]
        self.rows = {}
        for i, e in enumerate(self.entries):
            self.rows.setdefault(e.uuid, i)
        self.uuid_rows = {
            u: [remap[r] for r in rws]
            for u, rws in self.uuid_rows.items()
            if u in self.rows
        }
        self.dead.clear()
        self.view_dead_pending.clear()
        self.dirty_from = min(self.dirty_from, doomed[0])
        self.view_clean_from = min(self.view_clean_from, doomed[0])


_view_gens = itertools.count()


@dataclasses.dataclass
class TierView:
    """A tier's device view — what one search scans. ``entries`` includes
    tombstoned rows; their ``db`` rows hold PAD_VALUE and their mask rows
    are all-False, so neither the lattice map (+inf rows) nor the vote
    kernels (PAD frames) ever give them a vote."""

    tier_frames: int
    db: torch.Tensor | None  # [A_pad, T, C] float32; None on a mesh
    mask: torch.Tensor | None  # [A_pad, T] bool; None on a mesh
    n_audios: int  # view rows, including tombstoned ones
    entries: list[AudioEntry]
    dead_rows: frozenset = frozenset()
    # per-row frame counts (an auto-split audio's segment rows repeat one
    # entry, so a row's count can differ from its entry's n_frames)
    row_frames: tuple = ()
    segments: tuple = ()  # row groups of auto-split audios
    value_map: torch.Tensor | None = None  # [A_pad, K], lazily built
    # the certified prefilters' uint8 maps, lazily: the dialplan map
    # quantized, and the strict/aligned bound maps keyed by
    # bound_coef_indices -> (specs, maps)
    value_map_q: torch.Tensor | None = None
    bound_maps: dict | None = None
    match_index: MatchIndex | None = None  # K4/K5's sorted index, lazily
    seq_dev: torch.Tensor | None = None  # [A_pad] int64, lazily built
    ctx_dev: torch.Tensor | None = None  # [A_pad] int32, lazily built
    seg_dev: tuple | None = None  # (followers, heads) int64, lazily built
    # process-unique, new on every view an update returns: the key of the
    # engine's adaptive prefilter gate
    gen: int = dataclasses.field(default_factory=lambda: next(_view_gens))
    # a meshed view: its shards (db and mask are None) and its padded rows
    shards: tuple = ()
    padded_rows: int = 0
    # a shard: the min of the map rows beyond its edge of each auto-split
    # audio whose first row it holds, as (row, [K] map row), and its rows
    # of audios whose first row lies in an earlier shard (+inf in the map)
    seg_ext: tuple = ()
    seg_orphans: tuple = ()

    @property
    def rows(self) -> int:
        """The view's padded row count ``A_pad``."""
        return self.padded_rows if self.db is None else self.db.shape[0]

    def tensors(self) -> dict:
        """Every device tensor the view holds, by name (the segment rows
        left out: they are rebuilt lazily); a meshed view's shards' as
        ``shard<i>@<device>.<name>``."""
        if self.shards:
            out = {f"shard{s.index}@{s.device}.{name}": x
                   for s in self.shards
                   for name, x in s.view.tensors().items()}
            for name in ("seq_dev", "ctx_dev"):
                if getattr(self, name) is not None:
                    out[name] = getattr(self, name)
            return out
        out = {"db": self.db, "mask": self.mask}
        for name in ("value_map", "value_map_q", "seq_dev", "ctx_dev"):
            if getattr(self, name) is not None:
                out[name] = getattr(self, name)
        for key, (_, maps) in (self.bound_maps or {}).items():
            for i, m in enumerate(maps):
                out[f"bound{key}[{i}]"] = m
        if self.match_index is not None:
            for name, x in self.match_index.row_tensors().items():
                out[f"index.{name}"] = x
        return out


class Shard(NamedTuple):
    """One catalog shard of a meshed view: db index ``index`` on
    ``device``, a :class:`TierView` of its own rows."""

    index: int
    device: torch.device
    view: TierView


def _combine_segment_rows(vm: torch.Tensor, groups, ext=(), orphans=(),
                          dead=frozenset()) -> torch.Tensor:
    """Min-combine an auto-split audio's map rows into its FIRST row (the
    others become +inf): min over segment rows is min over the whole
    audio's frames, the reference's one-vote-per-audio test. On a shard,
    ``ext`` adds the min of a group's map rows beyond the shard's edge
    (unless its first row is dead: then the whole audio is) and
    ``orphans`` are rows of groups whose first row another shard holds."""
    beyond = {head: row for head, row in ext if head not in dead}
    for g in groups:
        rows = torch.as_tensor(list(g), dtype=torch.int64, device=vm.device)
        combined = vm[rows].amin(dim=0)
        if g[0] in beyond:
            combined = torch.minimum(combined, beyond[g[0]])
        vm[g[0]] = combined
        if len(g) > 1:
            vm[rows[1:]] = torch.inf
    if orphans:
        vm[torch.as_tensor(list(orphans), dtype=torch.int64,
                           device=vm.device)] = torch.inf
    return vm


def _device_of(view: TierView, default: torch.device) -> torch.device:
    """Where a view's derived data lives: its own tensors' device (a
    shard's), else the store's (a meshed view's keys, on the home device)."""
    return default if view.db is None else view.db.device


def _with_rows(buf: torch.Tensor, lo: int, rows: torch.Tensor) -> torch.Tensor:
    """A copy of ``buf`` with rows ``[lo, lo + len(rows))`` replaced."""
    out = buf.clone()
    out[lo : lo + rows.shape[0]] = rows.to(out.device)
    return out


class FingerprintStore:
    """Tiered fingerprint matrices + catalog with the reference's CRUD
    semantics. One re-entrant lock guards mutation and catalog reads."""

    def __init__(self, n_coefs: int = DEF_N_COEFS, coef_weights=None,
                 device: torch.device | str = "cuda", mesh=None) -> None:
        """``coef_weights``: the DSP chain's per-coef weighting, recorded in
        the checkpoint; a restore under different weights is rejected.
        ``mesh``: a :class:`~tiresias_tpu_torch.parallel.Mesh`; the views
        are then sharded on its ``db`` axis, and ``device`` is the mesh's
        home device (where the per-view keys live)."""
        self.n_coefs = int(n_coefs)
        self.coef_weights = (
            tuple(float(x) for x in coef_weights) if coef_weights else None
        )
        self.mesh = mesh
        self.device = mesh.home if mesh is not None else resolve_device(
            device)
        self._lock = threading.RLock()
        self._save_lock = threading.Lock()
        self.entries: list[AudioEntry] = []  # global insertion order
        self.contexts: dict[str, str] = {}  # name -> directory
        self._tiers: dict[int, _Tier] = {}
        self._views: list[TierView] | None = None
        self._dirty = True
        self._next_seq = 0
        self._hash_index: dict[tuple[str, str], AudioEntry] = {}
        self._hash_count: dict[tuple[str, str], int] = {}
        self._uuid_tier: dict[str, int] = {}
        self._by_uuid: dict[str, AudioEntry] = {}
        self._ctx_ids: dict[str, int] = {}
        # incremental-checkpoint state
        self._save_dir: str | None = None
        self._save_gen = 0
        self._seg_manifest: dict[int, list[list]] = {}
        self._restored_gen = 0
        # newest generation observed at load time (>= _restored_gen after a
        # .bak fallback): what a follower compares the owner's catalog to
        self._seen_gen = 0

    # ---- contexts (fp_handler.c:912-1095) ----------------------------- #

    def create_context(self, name: str, directory: str = "") -> None:
        if not name:
            raise ValueError("context name required")
        with self._lock:
            self.contexts[name] = directory

    def get_context(self, name: str) -> dict | None:
        with self._lock:
            if name not in self.contexts:
                return None
            return {"name": name, "directory": self.contexts[name]}

    def get_contexts_all(self) -> list[dict]:
        with self._lock:
            return [{"name": n, "directory": d} for n, d in self.contexts.items()]

    def delete_context(self, name: str) -> bool:
        """Delete a context and all its audios (fp_handler.c:1039)."""
        with self._lock:
            if name not in self.contexts:
                return False
            self.delete_audios(
                e.uuid for e in self.entries if e.context == name
            )
            del self.contexts[name]
            return True

    # ---- audios (fp_handler.c:115-197, 479-575) ----------------------- #

    def find_by_hash(self, context: str, file_hash: str) -> AudioEntry | None:
        """MD5 dedupe lookup (fp_handler.c:494-507)."""
        with self._lock:
            return self._hash_index.get((context, file_hash))

    def add_audio(
        self,
        name: str,
        context: str,
        fingerprint: np.ndarray,
        file_hash: str,
        uuid: str | None = None,
        dedupe: bool = True,
    ) -> AudioEntry | None:
        """Insert one audio's fingerprint; None when deduped."""
        fingerprint = np.asarray(fingerprint, dtype=np.float32)
        if fingerprint.ndim != 2 or fingerprint.shape[1] < self.n_coefs:
            raise ValueError(
                f"fingerprint must be [n_frames, >= {self.n_coefs}] "
                f"(got {fingerprint.shape})"
            )
        with self._lock:
            if context not in self.contexts:
                raise KeyError(f"unknown context {context!r}")
            if dedupe and self.find_by_hash(context, file_hash) is not None:
                return None
            if uuid is not None and uuid in self._by_uuid:
                raise ValueError(f"audio uuid {uuid!r} already exists")
            entry = AudioEntry(
                uuid=uuid or generate_uuid(), name=name, context=context,
                hash=file_hash, n_frames=int(fingerprint.shape[0]),
            )
            self._restore_entry(entry, fingerprint)
            self._dirty = True
            return entry

    def get_audio(self, uuid: str) -> AudioEntry | None:
        with self._lock:
            return self._by_uuid.get(uuid)

    def get_audios_by_context(self, context: str) -> list[AudioEntry]:
        """fp_get_audio_lists_by_contextname (fp_handler.c:441)."""
        with self._lock:
            return [e for e in self.entries if e.context == context]

    def get_fingerprint(self, uuid: str) -> np.ndarray | None:
        with self._lock:
            t = self._uuid_tier.get(uuid)
            if t is None:
                return None
            tier = self._tiers[t]
            first = tier.rows[uuid]
            rows = tier.uuid_rows.get(uuid, [first])
            return np.concatenate(
                [tier.matrix[r, : tier.row_frames[r]] for r in rows]
            )

    def delete_audio(self, uuid: str) -> bool:
        """fp_delete_audio_list_info (fp_handler.c:115-159)."""
        return self.delete_audios([uuid]) == 1

    def delete_audios(self, uuids) -> int:
        """Bulk delete; returns the number actually deleted."""
        uuids = set(uuids)
        with self._lock:
            by_tier: dict[int, set[str]] = {}
            for u in uuids:
                t = self._uuid_tier.get(u)
                if t is not None:
                    by_tier.setdefault(t, set()).add(u)
            removed: list[AudioEntry] = []
            for t, us in by_tier.items():
                tier = self._tiers[t]
                for entry in tier.delete_many(us):
                    self._uuid_tier.pop(entry.uuid, None)
                    self._by_uuid.pop(entry.uuid, None)
                    removed.append(entry)
                if tier.should_compact():
                    tier.compact()
            if removed:
                # filter the catalog BEFORE the hash bookkeeping, so the
                # duplicate-survivor scan only sees live entries
                gone = {e.uuid for e in removed}
                self.entries = [e for e in self.entries if e.uuid not in gone]
                for entry in removed:
                    self._forget_hash(entry)
                self._dirty = True
            return len(removed)

    def compact(self) -> None:
        """Force tombstone reclamation in every tier (admin maintenance
        op; normally automatic past the waste threshold). The device views
        and their derived maps are rebuilt on the next search."""
        with self._lock:
            for tier in self._tiers.values():
                if tier.dead:
                    tier.compact()
                    self._dirty = True

    def _forget_hash(self, entry: AudioEntry) -> None:
        # duplicate-hash entries exist with dedupe=False: keep the index on
        # a surviving duplicate
        key = (entry.context, entry.hash)
        remaining = self._hash_count.get(key, 1) - 1
        if remaining <= 0:
            self._hash_count.pop(key, None)
            self._hash_index.pop(key, None)
            return
        self._hash_count[key] = remaining
        if self._hash_index.get(key) is entry:
            survivor = next(
                (e for e in self.entries
                 if e.context == entry.context and e.hash == entry.hash),
                None,
            )
            if survivor is None:
                self._hash_index.pop(key, None)
                self._hash_count.pop(key, None)
            else:
                self._hash_index[key] = survivor

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def frame_cap(self) -> int:
        """Largest live tier's frame capacity (0 when empty)."""
        with self._lock:
            return max((t for t, tier in self._tiers.items() if tier.n_live),
                       default=0)

    # ---- device views ------------------------------------------------- #

    def search_views(self) -> list[TierView]:
        """Per-tier device views (tiers ascending), cached until the store
        mutates. After a mutation a tier's previous view is updated row by
        row while its row count stays in the same 128-row bucket and no
        compaction moved its rows: rows tombstoned since then are masked
        off (:meth:`_mask_off_rows`), then the appended rows are added
        (:meth:`_extend_view`). Otherwise the view is built in full
        (:meth:`_build_view`). A tier no mutation touched keeps its view
        object."""
        with self._lock:
            if not self._dirty and self._views is not None:
                return self._views
            prev = {v.tier_frames: v for v in self._views or ()}
            views, built = [], []
            for t in sorted(self._tiers):
                tier = self._tiers[t]
                a = len(tier.entries)
                if a == 0:
                    continue
                old = prev.get(t)
                if (
                    old is not None
                    and old.rows == self._a_pad(a)
                    and a >= old.n_audios
                    and tier.view_clean_from >= old.n_audios
                ):
                    view = old
                    # rows >= old.n_audios arrive dead in the extension
                    pending = {
                        r for r in tier.view_dead_pending if r < old.n_audios
                    }
                    if pending:
                        view = self._mask_off_rows(view, pending)
                    if a > view.n_audios:
                        view = self._extend_view(tier, view, a)
                else:
                    view = self._build_view(tier, a)
                views.append(view)
                built.append((tier, a))
            # the bookkeeping moves only once every tier's view is built: an
            # update that raises leaves every tier's pending rows to the
            # next call, which starts again from the views kept here
            for tier, a in built:
                tier.view_clean_from = a
                tier.view_dead_pending = set()
            self._views = views
            self._dirty = False
            return views

    def _a_pad(self, n: int) -> int:
        """A view's padded rows: 128-row buckets, and on a mesh multiples of
        ``128 * n_db`` (the JAX store's rule), so shards are equal."""
        a_pad = _bucket(n, AUDIO_BUCKET)
        if self.mesh is not None:
            a_pad = _bucket(a_pad, AUDIO_BUCKET * self.mesh.shape["db"])
        return a_pad

    def shard_rows(self, view: TierView) -> int:
        """Rows per shard of a meshed view."""
        return view.rows // self.mesh.shape["db"]

    def sharded(self, view: TierView, part) -> "Sharded":
        """``part(shard view)`` of every shard of a meshed view, as the
        :class:`~tiresias_tpu_torch.parallel.sharding.Sharded` the sharded
        ops take (e.g. ``store.sharded(view, store.value_map_for)``)."""
        from tiresias_tpu_torch.parallel.sharding import Sharded

        return Sharded(self.mesh, {(s.index, s.device): part(s.view)
                                   for s in view.shards}, view.rows)

    def sharded_bound_maps(self, view: TierView, coefs: int) -> tuple:
        """:meth:`bound_maps_for` of a meshed view: ``(specs, maps)`` with
        one :class:`~tiresias_tpu_torch.parallel.sharding.Sharded` per bound
        map, each shard's map built on its own shard."""
        from tiresias_tpu_torch.parallel.sharding import Sharded

        per = {(s.index, s.device): self.bound_maps_for(s.view, coefs)
               for s in view.shards}
        specs = next(iter(per.values()))[0]
        maps = tuple(Sharded(self.mesh, {key: sm[1][m]
                                         for key, sm in per.items()},
                             view.rows)
                     for m in range(len(specs)))
        return specs, maps

    def _build_view(self, tier: _Tier, a: int) -> TierView:
        """A tier's view built in full from the host matrix, its derived
        data left to be built lazily (on a mesh, every shard of it)."""
        if self.mesh is not None:
            a_pad = self._a_pad(a)
            per = a_pad // self.mesh.shape["db"]
            return self._mesh_view(tier, a_pad, tuple(
                Shard(i, dev, self._build_shard(tier, a, i * per, per, dev))
                for i, dev in self.mesh.shard_slots()))
        db, mask = self._host_rows(tier, 0, a, _bucket(a, AUDIO_BUCKET))
        return TierView(
            tier_frames=tier.t, db=db, mask=mask, n_audios=a,
            entries=list(tier.entries),
            dead_rows=frozenset(tier.dead),
            row_frames=tuple(tier.row_frames),
            segments=tuple(tuple(r) for r in tier.uuid_rows.values()),
        )

    @staticmethod
    def _mesh_view(tier: _Tier, a_pad: int, shards: tuple,
                   **keys) -> TierView:
        """A meshed view of the tier's current rows over ``shards``."""
        return TierView(
            tier_frames=tier.t, db=None, mask=None,
            n_audios=len(tier.entries), entries=list(tier.entries),
            dead_rows=frozenset(tier.dead), row_frames=tuple(tier.row_frames),
            segments=tuple(tuple(r) for r in tier.uuid_rows.values()),
            shards=shards, padded_rows=a_pad, **keys,
        )

    def _build_shard(self, tier: _Tier, a: int, base: int, per: int,
                     device: torch.device) -> TierView:
        """Shard view of the tier's rows ``[base, base + per)`` (those below
        ``a`` from the host matrix, the rest padding) on ``device``."""
        n = min(max(a - base, 0), per)
        db, mask = self._host_rows(tier, base, base + n, per, device)
        segments, ext, orphans = self._shard_segments(tier, base, per,
                                                      device)
        return TierView(
            tier_frames=tier.t, db=db, mask=mask, n_audios=n,
            entries=tier.entries[base:base + n],
            dead_rows=frozenset(r - base for r in tier.dead
                                if base <= r < base + n),
            row_frames=tuple(tier.row_frames[base:base + n]),
            segments=segments, seg_ext=ext, seg_orphans=orphans,
        )

    def _shard_segments(self, tier: _Tier, base: int, per: int | None,
                        device: torch.device) -> tuple:
        """``(segments, seg_ext, seg_orphans)`` of the part of a view that
        holds the tier's rows ``[base, base + per)`` (``per`` None: every
        row), in the part's row numbers: the groups whose first row it
        holds (its own rows of each), the min map row of each such group's
        rows beyond the part (built from the host rows, which lie in the
        group's next rows: a group's rows are consecutive), and its rows of
        groups whose first row lies before it."""
        hi = None if per is None else base + per
        segments, ext, orphans = [], [], []
        for g in tier.uuid_rows.values():
            local = [r - base for r in g if r >= base and (hi is None
                                                           or r < hi)]
            if not local:
                continue
            if g[0] < base:
                orphans.extend(local)
                continue
            segments.append(tuple(local))
            beyond = [r for r in g if hi is not None and r >= hi]
            if beyond:
                db, mask = self._host_rows(tier, beyond[0], beyond[-1] + 1,
                                           device=device)
                ext.append((local[0],
                            build_value_map(db[..., 0], mask).amin(dim=0)))
        return tuple(segments), tuple(ext), tuple(orphans)

    def _host_rows(self, tier: _Tier, lo: int, a: int,
                   n_rows: int | None = None,
                   device: torch.device | None = None) -> tuple:
        """The device ``(db, mask)`` rows of the tier's rows ``[lo, a)``, the
        only rows that cross host to device, padded to ``n_rows`` with
        PAD_VALUE and all-False rows, on ``device`` (default the store's).
        A tombstoned row holds PAD_VALUE (the vote kernels read values
        only: its stale fingerprint would vote) and an all-False mask."""
        device = self.device if device is None else device
        n_rows = a - lo if n_rows is None else n_rows
        dead = sorted(r - lo for r in tier.dead if lo <= r < a)
        n_frames = np.zeros(n_rows, dtype=np.int64)
        n_frames[: a - lo] = tier.row_frames[lo:a]
        n_frames[dead] = 0
        db = torch.full((n_rows, tier.t, self.n_coefs), PAD_VALUE,
                        device=device)
        db[: a - lo].copy_(torch.from_numpy(tier.matrix[lo:a]))
        if dead:
            db[dead] = PAD_VALUE
        frames = torch.arange(tier.t, device=device)
        mask = frames[None, :] < torch.from_numpy(n_frames).to(
            device)[:, None]
        return db, mask

    def _mask_off_rows(self, old: TierView, rows: set[int]) -> TierView:
        """``old`` with the tombstoned ``rows`` masked off, as a new view
        (``old``'s tensors are never written): every convention a consumer
        masks by is updated — ``mask`` rows False, ``db`` rows PAD_VALUE
        (the vote kernels read values only), map rows at their far value
        (+inf; the uint8 maps' sentinel BOUND_FAR), and K4/K5's index rows
        rebuilt from the all-PAD rows (no live frame), equal to a full
        build's. The seqs, context ids and segment rows carry over, as in
        the JAX store: a dead row cannot vote (a deleted auto-split audio's
        group stays in ``segments`` until an extension or a full build
        drops it). A meshed view masks off each shard that holds one of
        the rows; the others keep their view objects."""
        if old.shards:
            per = self.shard_rows(old)
            return dataclasses.replace(
                old, dead_rows=old.dead_rows | frozenset(rows),
                gen=next(_view_gens),
                shards=tuple(
                    s._replace(view=self._mask_off_rows(s.view, local))
                    if local else s
                    for s in old.shards
                    for local in [{r - s.index * per for r in rows
                                   if 0 <= r - s.index * per < per}]),
            )
        idx = torch.tensor(sorted(rows), dtype=torch.int64,
                           device=old.db.device)

        def far(m: torch.Tensor) -> torch.Tensor:
            value = torch.inf if m.is_floating_point() else BOUND_FAR
            return m.index_fill(0, idx, value)

        db = old.db.index_fill(0, idx, PAD_VALUE)
        index = old.match_index
        if index is not None:
            part = build_match_index(db.index_select(0, idx)).row_tensors()
            index = dataclasses.replace(index, **{
                name: x.index_copy(0, idx, part[name])
                for name, x in index.row_tensors().items()})
        return TierView(
            tier_frames=old.tier_frames, db=db,
            mask=old.mask.index_fill(0, idx, False),
            n_audios=old.n_audios, entries=old.entries,
            dead_rows=old.dead_rows | frozenset(rows),
            row_frames=old.row_frames, segments=old.segments,
            seg_ext=old.seg_ext, seg_orphans=old.seg_orphans,
            value_map=None if old.value_map is None else far(old.value_map),
            value_map_q=(None if old.value_map_q is None
                         else far(old.value_map_q)),
            bound_maps=None if old.bound_maps is None else {
                key: (specs, tuple(far(m) for m in maps))
                for key, (specs, maps) in old.bound_maps.items()
            },
            match_index=index,
            seq_dev=old.seq_dev, ctx_dev=old.ctx_dev, seg_dev=old.seg_dev,
        )

    def _extend_view(self, tier: _Tier, old: TierView, a: int,
                     base: int = 0, per: int | None = None) -> TierView:
        """``old`` with the tier's rows ``[old.n_audios, a)`` appended, as a
        new view: only those rows cross host to device, and each derived
        tensor the old view carries gets the new rows' part built alone
        (every build is per row) and written into a copy (``old``'s tensors
        are never written: a search in flight keeps its catalog). A row
        appended and tombstoned since the last build arrives dead.

        ``old`` may be a part of a view: the shard holding the tier's rows
        ``[base, base + per)``, in which ``a`` ends at the shard's edge. A
        meshed view extends each shard that gains rows; the others keep
        their view objects."""
        if old.shards:
            per = self.shard_rows(old)
            shards = tuple(
                s._replace(view=self._extend_view(tier, s.view, a,
                                                  s.index * per, per))
                if min(a - s.index * per, per) > s.view.n_audios else s
                for s in old.shards)
            seq_dev, ctx_dev = self._extend_keys(tier, old, a, 0)
            return self._mesh_view(tier, old.padded_rows, shards,
                                   seq_dev=seq_dev, ctx_dev=ctx_dev)
        end = a if per is None else min(a, base + per)
        lo = old.n_audios
        dev = old.db.device
        db_rows, mask_rows = self._host_rows(tier, base + lo, end,
                                             device=dev)
        # segments are added under the store lock, so an auto-split audio's
        # rows lie all among the new rows or all before them
        segments, ext, orphans = self._shard_segments(tier, base, per, dev)
        value_map = value_map_q = None
        if old.value_map is not None:
            vm_rows = _combine_segment_rows(
                build_value_map(db_rows[..., 0], mask_rows),
                [tuple(r - lo for r in g) for g in segments if g[0] >= lo],
                [(h - lo, row) for h, row in ext if h >= lo],
                [r - lo for r in orphans if r >= lo],
            )
            value_map = _with_rows(old.value_map, lo, vm_rows)
            if old.value_map_q is not None:
                value_map_q = _with_rows(old.value_map_q, lo,
                                         quantize_value_map(vm_rows))
        bound_maps = None
        if old.bound_maps is not None:
            # no segment combining: the aligned prefilter bails out of a
            # view that holds auto-split audios
            bound_maps, rows_by_spec = {}, {}  # coef sets share specs
            for key, (specs, maps) in old.bound_maps.items():
                for spec in specs:
                    if spec not in rows_by_spec:
                        rows_by_spec[spec] = build_bound_map(
                            db_rows, mask_rows, spec)
                bound_maps[key] = (specs, tuple(
                    _with_rows(m, lo, rows_by_spec[spec])
                    for spec, m in zip(specs, maps)))
        index = old.match_index
        if index is not None:
            part = build_match_index(db_rows)
            if (part.chunk, part.t_len) != (index.chunk, index.t_len):
                raise RuntimeError(
                    f"match index chunk {part.chunk}/{part.t_len} != the "
                    f"view's {index.chunk}/{index.t_len}")
            rows = part.row_tensors()
            index = dataclasses.replace(index, **{
                name: _with_rows(x, lo, rows[name])
                for name, x in index.row_tensors().items()})
        seq_dev, ctx_dev = self._extend_keys(tier, old, end, base)
        return TierView(
            tier_frames=tier.t, db=_with_rows(old.db, lo, db_rows),
            mask=_with_rows(old.mask, lo, mask_rows), n_audios=end - base,
            entries=tier.entries[base:end],
            dead_rows=frozenset(r - base for r in tier.dead
                                if base <= r < end),
            row_frames=tuple(tier.row_frames[base:end]), segments=segments,
            seg_ext=ext, seg_orphans=orphans,
            value_map=value_map, value_map_q=value_map_q,
            bound_maps=bound_maps, match_index=index, seq_dev=seq_dev,
            ctx_dev=ctx_dev,
        )

    def _extend_keys(self, tier: _Tier, old: TierView, end: int,
                     base: int) -> tuple:
        """``old``'s insertion seqs and context ids (those it carries) with
        the rows ``[base + old.n_audios, end)`` appended."""
        lo = old.n_audios
        new = range(base + lo, end)
        seq_dev = ctx_dev = None
        if old.seq_dev is not None:
            seq_dev = _with_rows(old.seq_dev, lo, torch.tensor(
                [tier.entries[r].seq for r in new], dtype=torch.int64))
        if old.ctx_dev is not None:
            ctx_dev = _with_rows(old.ctx_dev, lo, torch.tensor(
                [-1 if r in tier.dead
                 else self._ctx_id_alloc(tier.entries[r].context)
                 for r in new], dtype=torch.int32))
        return seq_dev, ctx_dev

    def value_map_for(self, view: TierView) -> torch.Tensor:
        """Lattice distance map ``[A_pad, K]`` of one view, built on the
        device from the view's own (immutable) tensors and cached on it;
        segment rows min-combine, dead and padding rows are +inf."""
        with self._lock:
            if view.value_map is None:
                vm = build_value_map(view.db[..., 0], view.mask)
                view.value_map = _combine_segment_rows(
                    vm, view.segments, view.seg_ext, view.seg_orphans,
                    view.dead_rows)
            return view.value_map

    def value_map_q_for(self, view: TierView) -> torch.Tensor:
        """uint8 companion ``[A_pad, K]`` of :meth:`value_map_for` for the
        certified dialplan prefilter (``floor(d * 64)``; dead and padding
        rows hold the 255 sentinel), derived on the device from the f32 map
        and cached on the view."""
        with self._lock:
            if view.value_map_q is None:
                view.value_map_q = quantize_value_map(self.value_map_for(view))
            return view.value_map_q

    def bound_maps_for(self, view: TierView, coefs: int) -> tuple:
        """``(specs, maps)`` of the strict/aligned prefilter for a search
        testing ``coefs`` coefficients, built on the device from the view's
        own tensors (its mask leaves out dead and padding rows: sentinel
        255) and cached on the view, one entry per coefficient set. A view
        updated after a mutation carries them, updated row by row."""
        key = bound_coef_indices(min(coefs, self.n_coefs))
        with self._lock:
            if view.bound_maps is None:
                view.bound_maps = {}
            if key not in view.bound_maps:
                view.bound_maps[key] = build_bound_maps(view.db, view.mask,
                                                        coefs)
            return view.bound_maps[key]

    def match_index_for(self, view: TierView) -> MatchIndex:
        """K4/K5's sorted index of one view (``ops/match_index.py``), built
        on the device from the view's own (immutable) tensors and cached on
        it; dead and padding rows hold PAD_VALUE, so they have no live
        frame. A view updated after a mutation carries it, updated row by
        row."""
        with self._lock:
            if view.match_index is None:
                view.match_index = build_match_index(view.db)
            return view.match_index

    def seq_for(self, view: TierView) -> torch.Tensor:
        """Per-row global insertion seqs ``[A_pad]`` int64 (padding rows
        int64 max) — the multi-view D5 tiebreak key."""
        with self._lock:
            if view.seq_dev is None:
                seqs = np.full(view.rows, np.iinfo(np.int64).max, np.int64)
                seqs[: view.n_audios] = [e.seq for e in view.entries]
                view.seq_dev = torch.from_numpy(seqs).to(_device_of(
                    view, self.device))
            return view.seq_dev

    def segment_rows_for(self, view: TierView) -> tuple:
        """``(followers, heads)`` int64 row indices of the view's auto-split
        audios: every segment row after an audio's first, and that first
        row (the D15 merge target); both empty without over-long audios."""
        with self._lock:
            if view.seg_dev is None:
                pairs = [(r, g[0]) for g in view.segments for r in g[1:]]
                idx = torch.tensor(pairs, dtype=torch.int64).reshape(-1, 2)
                dev = _device_of(view, self.device)
                view.seg_dev = (idx[:, 0].to(dev), idx[:, 1].to(dev))
            return view.seg_dev

    def ctx_id_for(self, context: str) -> int:
        """Dense id of a context name; -2 (carried by no row) for a name
        that is neither live nor seen, without growing the map."""
        with self._lock:
            if context not in self._ctx_ids and context not in self.contexts:
                return -2
            return self._ctx_id_alloc(context)

    def _ctx_id_alloc(self, context: str) -> int:
        with self._lock:
            return self._ctx_ids.setdefault(context, len(self._ctx_ids))

    def ctx_ids_for(self, view: TierView) -> torch.Tensor:
        """Per-row context ids ``[A_pad]`` int32 (padding and dead rows -1),
        the context filter's keep key."""
        with self._lock:
            if view.ctx_dev is None:
                ids = np.full(view.rows, -1, np.int32)
                ids[: view.n_audios] = [
                    -1 if i in view.dead_rows
                    else self._ctx_id_alloc(e.context)
                    for i, e in enumerate(view.entries)
                ]
                view.ctx_dev = torch.from_numpy(ids).to(_device_of(
                    view, self.device))
            return view.ctx_dev

    def view_entries(self) -> list[AudioEntry]:
        """Catalog snapshot in the concatenated view row order (tiers
        ascending, row order within, dead rows included): result
        attribution uses this, not the live catalog, since a concurrent
        delete compacts rows and shifts indices."""
        with self._lock:
            return [e for v in self.search_views() for e in v.entries]

    def context_filter(self, context: str | None) -> np.ndarray | None:
        """Bool aligned with :meth:`view_entries` (the concatenated unpadded
        vote columns) selecting a context's audios, or None for the
        reference's scan-everything behavior (PARITY.md D7)."""
        if context is None:
            return None
        with self._lock:
            return np.array(
                [e.context == context for e in self.view_entries()], dtype=bool
            )

    def host_db(self) -> tuple[np.ndarray, np.ndarray]:
        """(db [A, T_max, C], mask [A, T_max]) dense numpy copy of the live
        rows in view order (tiers ascending, insertion order within)."""
        with self._lock:
            live = [
                (tier, i)
                for _, tier in sorted(self._tiers.items())
                for i in range(len(tier.entries)) if i not in tier.dead
            ]
            t = max([tier.t for tier, _ in live], default=FRAME_BUCKET)
            db = np.full((len(live), t, self.n_coefs), PAD_VALUE, np.float32)
            n_frames = np.zeros(len(live), np.int64)
            for j, (tier, i) in enumerate(live):
                db[j, : tier.t] = tier.matrix[i]
                n_frames[j] = tier.row_frames[i]
            return db, np.arange(t)[None, :] < n_frames[:, None]

    # ---- checkpoint (db_ctx_handler.c:673-772) ------------------------ #

    def save(self, directory: str) -> None:
        """Atomic, incremental version-4 checkpoint: per-tier immutable
        segment files (``tier<t>_seg<i>.g<gen>.npy``, at most SEGMENT_ROWS
        rows each), only the segments changed since the last save
        rewritten, and ``catalog.json`` as the single commit point (tmp +
        fsync + rename, previous generation kept as ``.bak``)."""
        with self._save_lock:
            self._save_locked(directory)

    def _save_locked(self, directory: str) -> None:
        rollback: dict[int, int] = {}
        with self._lock:
            os.makedirs(directory, exist_ok=True)
            fresh = directory != self._save_dir
            # never reuse a generation number another lineage in this
            # directory may reference
            self._save_gen = max(self._save_gen, _max_seg_gen(directory)) + 1
            gen = self._save_gen
            manifest: dict[int, list[list]] = {}
            for t, tier in sorted(self._tiers.items()):
                n = len(tier.entries)
                if n == 0:
                    continue
                old = [] if fresh else self._seg_manifest.get(t, [])
                dirty_from = 0 if fresh else tier.dirty_from
                segs: list[list] = []
                for s in range(-(-n // SEGMENT_ROWS)):
                    lo = s * SEGMENT_ROWS
                    hi = min(lo + SEGMENT_ROWS, n)
                    if (
                        hi <= dirty_from
                        and s < len(old)
                        and old[s][1] == hi - lo
                        and os.path.exists(os.path.join(directory, old[s][0]))
                    ):
                        segs.append([old[s][0], hi - lo])  # unchanged
                        continue
                    fname = f"tier{t}_seg{s}.g{gen}.npy"
                    tmp = os.path.join(directory, fname + ".tmp")
                    with open(tmp, "wb") as f:
                        np.save(f, tier.matrix[lo:hi])
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(tmp, os.path.join(directory, fname))
                    segs.append([fname, hi - lo])
                manifest[t] = segs
                rollback[t] = dirty_from
                tier.dirty_from = n
            entries_snap = list(self.entries)
            contexts_snap = dict(self.contexts)
            dead_snap = {
                str(t): sorted(self._tiers[t].dead)
                for t in manifest if self._tiers[t].dead
            }
        try:
            catalog = {
                "version": CHECKPOINT_VERSION,
                "n_coefs": self.n_coefs,
                "coef_weights": (
                    list(self.coef_weights) if self.coef_weights else None
                ),
                "gen": gen,
                "contexts": contexts_snap,
                "entries": [e.to_dict() for e in entries_snap],
                "tiers": {str(t): segs for t, segs in manifest.items()},
                "dead": dead_snap,
            }
            cat_path = os.path.join(directory, CATALOG_FILE)
            cat_tmp = cat_path + ".tmp"
            with open(cat_tmp, "w") as f:
                json.dump(catalog, f, separators=(",", ":"))
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(cat_path):
                if fresh:
                    self._pair_legacy_backup(directory, cat_path)
                if _readable_catalog(cat_path):
                    os.replace(cat_path, cat_path + ".bak")
                else:
                    # never rotate a corrupt current generation over the
                    # last good backup
                    log.warning(
                        "not rotating corrupt catalog over the good backup "
                        "generation in %s", directory,
                    )
                    os.unlink(cat_path)
            os.replace(cat_tmp, cat_path)
            _fsync_dir(directory)
        except BaseException:
            with self._lock:
                for t, df in rollback.items():
                    tier = self._tiers.get(t)
                    if tier is not None:
                        tier.dirty_from = min(tier.dirty_from, df)
            raise
        with self._lock:
            self._seg_manifest = manifest
            self._save_dir = directory
        self._gc_segments(directory)

    @staticmethod
    def _pair_legacy_backup(directory: str, cat_path: str) -> None:
        """Keep the ``.bak`` (catalog, matrix) pair consistent when the
        first version-4 save rotates a v1/v2 catalog. Legacy saves rotated
        ``catalog.json`` and ``fingerprints.npz`` together; a v4 save
        rotates only the catalog, which would pair the newest legacy
        catalog with the second-newest matrix. So the matrix the rotating
        catalog references is copied (not moved: a crash mid-upgrade must
        leave the current legacy pair intact) to ``.bak`` first. Runs only
        on the first save into a directory."""
        legacy = os.path.join(directory, MATRIX_FILE)
        if not os.path.exists(legacy):
            return
        try:
            with open(cat_path) as f:
                old_version = json.load(f).get("version", 0)
        except Exception:  # noqa: BLE001 - unreadable old catalog
            return
        if old_version not in (1, 2):
            return
        tmp = legacy + ".bak.tmp"
        shutil.copyfile(legacy, tmp)
        # the copied data must survive power loss before the rename
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)
        os.replace(tmp, legacy + ".bak")

    @staticmethod
    def _referenced_segments(cat_path: str) -> set[str]:
        try:
            with open(cat_path) as f:
                cat = json.load(f)
            return {
                seg[0]
                for segs in cat.get("tiers", {}).values()
                for seg in segs
            }
        except Exception:  # noqa: BLE001 - unreadable generation
            return set()

    def _gc_segments(self, directory: str) -> None:
        """Unlink segment files referenced by neither catalog generation."""
        cat_path = os.path.join(directory, CATALOG_FILE)
        live = self._referenced_segments(cat_path) | self._referenced_segments(
            cat_path + ".bak"
        )
        for name in os.listdir(directory):
            if (
                name.startswith("tier")
                and (name.endswith(".npy") or name.endswith(".npy.tmp"))
                and name not in live
            ):
                try:
                    os.unlink(os.path.join(directory, name))
                except OSError:
                    pass

    @staticmethod
    def load(
        directory: str, n_coefs: int = DEF_N_COEFS, coef_weights=None,
        device: torch.device | str = "cuda", mesh=None,
    ) -> "FingerprintStore":
        """Restore from a checkpoint; an empty store when none exists. A
        corrupt current generation falls back to ``.bak``; when generations
        exist but none is readable, raises :class:`CheckpointUnreadable`.
        ``mesh``: shard the views on its ``db`` axis (the store's device is
        then the mesh's home device)."""
        device = mesh.home if mesh is not None else resolve_device(device)
        errors: list[str] = []
        for suffix in ("", ".bak"):
            cat_path = os.path.join(directory, CATALOG_FILE + suffix)
            if not os.path.exists(cat_path):
                continue
            try:
                loaded = FingerprintStore._load_catalog(
                    directory, cat_path, suffix, n_coefs, coef_weights, device,
                    mesh,
                )
                loaded._seen_gen = loaded._restored_gen
                if suffix:
                    # .bak fallback: record the damaged CURRENT catalog's
                    # generation (when its JSON at least parses) so a
                    # follower doesn't mistake it for news on every poll
                    loaded._seen_gen = max(
                        loaded._seen_gen,
                        _read_catalog_gen(
                            os.path.join(directory, CATALOG_FILE)
                        ),
                    )
                return loaded
            except CheckpointIncompatible:
                raise  # incompatible checkpoint: fail loudly, don't mask
            except Exception as exc:  # noqa: BLE001 - corrupt generation
                errors.append(f"{suffix or 'current'}: {exc}")
                log.warning(
                    "checkpoint generation %r unreadable, trying previous",
                    suffix or "current",
                )
        if errors:
            raise CheckpointUnreadable(
                f"checkpoint in {directory!r} exists but no generation is "
                f"readable ({'; '.join(errors)}); refusing to start empty"
            )
        return FingerprintStore(n_coefs, coef_weights, device, mesh)

    @staticmethod
    def read_catalog_metadata(directory: str) -> dict | None:
        """Catalog metadata (contexts, audio-entry dicts, generation)
        WITHOUT loading any segment data — the cheap path for read-only
        listings and the follower's poll. Returns None when no checkpoint
        exists; same generation fallback, version rule and
        :class:`CheckpointUnreadable` semantics as :meth:`load`."""
        errors: list[str] = []
        for suffix in ("", ".bak"):
            cat_path = os.path.join(directory, CATALOG_FILE + suffix)
            if not os.path.exists(cat_path):
                continue
            try:
                with open(cat_path) as f:
                    catalog = json.load(f)
                if catalog.get("version") not in READABLE_VERSIONS:
                    raise CheckpointIncompatible(
                        _unreadable_version(catalog.get("version"))
                    )
                return {
                    "contexts": dict(catalog["contexts"]),
                    "entries": list(catalog["entries"]),
                    "gen": int(catalog.get("gen", 0)),
                }
            except CheckpointIncompatible:
                raise
            except Exception as exc:  # noqa: BLE001 - corrupt generation
                errors.append(f"{suffix or 'current'}: {exc}")
        if errors:
            raise CheckpointUnreadable(
                f"checkpoint in {directory!r} exists but no generation is "
                f"readable ({'; '.join(errors)})"
            )
        return None

    @staticmethod
    def _load_catalog(
        directory, cat_path, suffix, n_coefs, coef_weights, device, mesh=None
    ) -> "FingerprintStore":
        store = FingerprintStore(n_coefs, coef_weights, device, mesh)
        with open(cat_path) as f:
            catalog = json.load(f)
        version = catalog.get("version")
        if version not in READABLE_VERSIONS:
            raise CheckpointIncompatible(_unreadable_version(version))
        if int(catalog["n_coefs"]) != store.n_coefs:
            raise CheckpointIncompatible(
                f"checkpoint has n_coefs={catalog['n_coefs']}, store wants "
                f"{n_coefs}"
            )
        ckpt_w = catalog.get("coef_weights")
        ckpt_w = tuple(float(x) for x in ckpt_w) if ckpt_w else None
        if ckpt_w != store.coef_weights:
            raise CheckpointIncompatible(
                f"checkpoint fingerprints live in coef_weights={ckpt_w} "
                f"space, config wants {store.coef_weights}"
            )
        entries = [AudioEntry.from_dict(d) for d in catalog["entries"]]
        store.contexts = dict(catalog["contexts"])
        if version in (1, 2):
            store._load_legacy(
                os.path.join(directory, MATRIX_FILE + suffix), version,
                entries,
            )
            return store
        tiers: dict[int, np.ndarray] = {}
        for t_str, segs in catalog["tiers"].items():
            parts = []
            for fname, n_rows in segs:
                arr = np.load(os.path.join(directory, fname))
                if arr.shape[0] != n_rows:
                    raise ValueError(
                        f"segment {fname}: {arr.shape[0]} rows, manifest "
                        f"says {n_rows}"
                    )
                parts.append(arr.astype(np.float32))
            tiers[int(t_str)] = (
                np.concatenate(parts) if parts
                else np.zeros((0, int(t_str), store.n_coefs), np.float32)
            )
        dead = {int(t): set(rows) for t, rows in catalog.get("dead", {}).items()}
        store._walk_tiered(entries, tiers, dead)
        store._restored_gen = int(catalog.get("gen", 0))
        if suffix == "":
            # a current-generation restore extends its own manifest on the
            # next save; a .bak restore must not reuse newer-gen files
            store._save_dir = directory
            store._save_gen = store._restored_gen
            store._seg_manifest = {
                int(t): [list(s) for s in segs]
                for t, segs in catalog["tiers"].items()
            }
            for t, tier in store._tiers.items():
                # tombstones were compacted away during the walk: rows from
                # the first dead manifest row on no longer match the files
                d = dead.get(t)
                tier.dirty_from = min(d) if d else len(tier.entries)
        return store

    def _load_legacy(self, path: str, version: int,
                     entries: list[AudioEntry]) -> None:
        """Restore a v1/v2 catalog's fingerprints from its monolithic
        ``fingerprints.npz``: v1 holds one dense matrix in global insertion
        order, v2 one ``tier_<frames>`` matrix per tier in tier insertion
        order. The store keeps no save directory, so its first save writes
        every row as a version-4 checkpoint."""
        with np.load(path) as data:
            if version == 1:
                matrix = data["matrix"].astype(np.float32)
                if matrix.shape[0] != len(entries):
                    # a torn generation (a crash between the two renames):
                    # corruption, not incompatibility, so load falls back
                    raise ValueError(
                        "checkpoint catalog/matrix row count mismatch"
                    )
                for i, e in enumerate(entries):
                    self._restore_entry(e, matrix[i, : e.n_frames])
            else:
                self._walk_tiered(entries, {
                    int(k.split("_", 1)[1]): data[k].astype(np.float32)
                    for k in data.files
                })
        self._dirty = True

    def _walk_tiered(self, entries: list[AudioEntry],
                     tiers: dict[int, np.ndarray], dead=None) -> None:
        """Restore catalog ``entries`` whose fingerprints sit in per-tier
        matrices ``tiers``, rows in tier insertion order; ``dead`` maps a
        tier to its tombstoned rows (v4), skipped during the walk. An
        auto-split audio takes consecutive rows of the top tier."""
        dead = dead or {}
        cursors: dict[int, int] = {}

        def next_row(t: int) -> int:
            row = cursors.get(t, 0)
            while row in dead.get(t, ()):
                row += 1
            if t not in tiers or row >= tiers[t].shape[0]:
                raise ValueError("checkpoint catalog/matrix tier mismatch")
            cursors[t] = row + 1
            return row

        for e in entries:
            segs = split_frames(e.n_frames)
            if len(segs) == 1:
                t = tier_for(e.n_frames)
                self._restore_entry(e, tiers[t][next_row(t), : e.n_frames])
            else:
                t = MAX_TIER_FRAMES
                self._restore_entry(e, np.concatenate(
                    [tiers[t][next_row(t), :n] for n in segs]
                ))

    def _restore_entry(self, entry: AudioEntry, fingerprint: np.ndarray) -> None:
        entry.seq = self._next_seq
        self._next_seq += 1
        segs = split_frames(entry.n_frames)
        t = MAX_TIER_FRAMES if len(segs) > 1 else tier_for(entry.n_frames)
        tier = self._tiers.get(t)
        if tier is None:
            tier = self._tiers[t] = _Tier(t, self.n_coefs)
        if len(segs) == 1:
            tier.add(entry, fingerprint[:, : self.n_coefs])
        else:
            tier.add_segmented(entry, fingerprint[:, : self.n_coefs], segs)
        self.entries.append(entry)
        key = (entry.context, entry.hash)
        self._hash_index[key] = entry
        self._hash_count[key] = self._hash_count.get(key, 0) + 1
        self._uuid_tier[entry.uuid] = t
        self._by_uuid[entry.uuid] = entry

    def iter_entries(self) -> list[AudioEntry]:
        """A snapshot of the catalog in insertion order."""
        with self._lock:
            return list(self.entries)


def _fsck_walk_tiers(
    directory: str, catalog: dict, n_coefs: int,
    tiers_report: dict, referenced: set,
) -> None:
    """Structural walk of one v3/v4 catalog's tier manifest (fsck); any
    malformed shape raises and the caller reports the generation BAD."""
    tiers = catalog.get("tiers", {})
    if not isinstance(tiers, dict):
        raise ValueError(f"'tiers' is {type(tiers).__name__}, expected object")
    dead_map = catalog.get("dead", {})
    if not isinstance(dead_map, dict):
        raise ValueError(f"'dead' is {type(dead_map).__name__}, expected object")
    for t_key, segs in tiers.items():
        t = int(t_key)
        rows_total = 0
        t_errors: list[str] = []
        for fname, n_rows in segs:
            referenced.add(str(fname))
            path = os.path.join(directory, str(fname))
            n_rows = int(n_rows)
            if not os.path.exists(path):
                t_errors.append(f"{fname}: missing")
                continue
            try:
                arr = np.load(path, mmap_mode="r")
                shape, dtype = arr.shape, arr.dtype
                del arr
            except Exception as exc:  # noqa: BLE001 - torn/short file
                t_errors.append(f"{fname}: unreadable ({exc})")
                continue
            if shape != (n_rows, t, n_coefs):
                t_errors.append(
                    f"{fname}: shape {shape} != catalog "
                    f"({n_rows}, {t}, {n_coefs})"
                )
            elif dtype != np.float32:
                t_errors.append(f"{fname}: dtype {dtype} != float32")
            rows_total += n_rows
        dead = dead_map.get(t_key, [])
        bad_dead = [d for d in dead if not 0 <= int(d) < rows_total]
        if bad_dead:
            t_errors.append(
                f"dead rows out of range {bad_dead[:5]} (rows={rows_total})"
            )
        tiers_report[t] = {
            "segments": len(segs),
            "rows": rows_total,
            "dead": len(dead),
            "errors": t_errors,
        }


def fsck_checkpoint(
    directory: str, deep: bool = False, n_coefs: int | None = None
) -> dict:
    """Offline checkpoint integrity check (the ``tiresias fsck`` command).

    The checkpoint is a catalog JSON + immutable segment files per
    generation, so a broken disk/partial copy is verifiable OFFLINE without
    touching a serving process.

    Per generation ("current" and ".bak"): catalog parses, version is one
    the loader reads (1 to 4), a v1/v2 generation's ``fingerprints.npz``
    exists, every manifest segment file exists with the exact shape/dtype
    the catalog claims (header-only ``np.load(mmap_mode="r")`` — no data
    read), dead-row indices in range. Plus orphan detection: ``.npy``
    files no generation references (GC debris from a crash between
    segment write and catalog commit — harmless, reclaimable). ``deep``
    additionally performs a full :meth:`FingerprintStore.load` of the
    directory (the exact restore a server would run, incl. the
    generation-fallback rules) on the host: the restore fills numpy tiers
    only, no tensor is made, so it needs no card.

    ``n_coefs`` is the deployment's configured coefficient count (what a
    real server startup passes to :meth:`FingerprintStore.load`); the
    deep restore uses it so a config/checkpoint mismatch reports BAD here
    exactly as the startup would fail. None falls back to each catalog's
    own value (structure-only checking).

    Returns a report dict; ``report["ok"]`` is True when the newest
    readable generation is structurally sound (a server restart would
    serve it) — a damaged current with a clean ``.bak`` is ok=False:
    data SINCE the .bak would be lost silently on restart.
    """
    report: dict = {"directory": directory, "generations": {}, "ok": False}
    referenced: set = set()
    for suffix, label in (("", "current"), (".bak", "bak")):
        cat_path = os.path.join(directory, CATALOG_FILE + suffix)
        if not os.path.exists(cat_path):
            report["generations"][label] = None
            continue
        gen_report: dict = {"ok": False, "errors": []}
        report["generations"][label] = gen_report
        try:
            with open(cat_path) as f:
                catalog = json.load(f)
            if not isinstance(catalog, dict):
                raise ValueError(
                    f"top-level {type(catalog).__name__}, expected object"
                )
        except Exception as exc:  # noqa: BLE001 - corrupt generation
            gen_report["errors"].append(f"catalog unreadable: {exc}")
            continue
        version = catalog.get("version")
        gen_report.update(
            version=version,
            gen=int(catalog.get("gen", 0) or 0),
            entries=len(catalog.get("entries", [])),
            contexts=len(catalog.get("contexts", {})),
        )
        if version not in READABLE_VERSIONS:
            gen_report["errors"].append(_unreadable_version(version))
            continue
        cat_coefs = int(catalog.get("n_coefs", DEF_N_COEFS) or DEF_N_COEFS)
        n_coefs_gen = cat_coefs if n_coefs is None else int(n_coefs)
        if n_coefs is not None and cat_coefs != n_coefs_gen:
            gen_report["errors"].append(
                f"checkpoint has n_coefs={cat_coefs}, deployment config "
                f"wants {n_coefs_gen} (a server startup would refuse)"
            )
        if version in (1, 2):
            # legacy monolithic layout: one npz next to the catalog
            if not os.path.exists(
                    os.path.join(directory, MATRIX_FILE + suffix)):
                gen_report["errors"].append(
                    f"legacy v{version} {MATRIX_FILE}{suffix} missing"
                )
            gen_report["ok"] = not gen_report["errors"]
            continue
        tiers_report: dict = {}
        gen_report["tiers"] = tiers_report
        try:
            _fsck_walk_tiers(
                directory, catalog, n_coefs_gen, tiers_report, referenced
            )
        except Exception as exc:  # noqa: BLE001 - malformed catalog shape
            # the tool exists to DIAGNOSE corrupt checkpoints: any
            # unexpected structure (tiers as a scalar, non-numeric keys,
            # garbage row counts) is a finding, not a crash
            gen_report["errors"].append(f"catalog malformed: {exc}")
        for t in tiers_report.values():
            gen_report["errors"].extend(t["errors"])
        gen_report["ok"] = not gen_report["errors"]
    # orphans: segment files neither generation references (crash debris
    # between a segment write and its catalog commit; or a GC'd lineage)
    orphans = [
        f
        for f in os.listdir(directory)
        if f.endswith(".npy") and f not in referenced
    ] if os.path.isdir(directory) else []
    report["orphans"] = {
        "count": len(orphans),
        "bytes": sum(
            os.path.getsize(os.path.join(directory, f)) for f in orphans
        ),
    }
    cur = report["generations"].get("current")
    report["ok"] = bool(cur and cur["ok"])
    if deep:
        deep_report: dict = {"ok": False}
        report["deep"] = deep_report
        try:
            deep_coefs = n_coefs
            if deep_coefs is None:
                # structure-only mode: take the newest readable catalog's
                # own value so a default-less run still restores
                for label in ("current", "bak"):
                    g = report["generations"].get(label)
                    if g and "version" in g and g.get("version"):
                        suffix = "" if label == "current" else ".bak"
                        with open(
                            os.path.join(directory, CATALOG_FILE + suffix)
                        ) as f:
                            deep_coefs = int(
                                json.load(f).get("n_coefs", DEF_N_COEFS)
                            )
                        break
                deep_coefs = deep_coefs or DEF_N_COEFS
            store = FingerprintStore.load(
                directory, n_coefs=deep_coefs, device="cpu"
            )
            deep_report.update(
                ok=True, entries=len(store), gen=store._restored_gen,
                contexts=len(store.contexts),
            )
        except Exception as exc:  # noqa: BLE001 - any restore failure
            deep_report["error"] = str(exc)
        report["ok"] = report["ok"] and deep_report["ok"]
    return report
