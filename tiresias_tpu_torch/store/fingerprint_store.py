"""Device-resident fingerprint store + host catalog (port of
``tiresias_tpu.store.fingerprint_store``).

Host side is the JAX package's layout unchanged: each audio lives whole in
the power-of-two frame tier (128 * 2^k frames) that fits it; a tier is a
float32 ``[capacity, tier_frames, n_coefs]`` numpy matrix with
``PAD_VALUE`` beyond each audio's frames, rows in insertion order; deletes
tombstone rows and compact past a waste threshold; audios longer than the
top tier are split into consecutive segment rows of one catalog entry.

Device side, each non-empty tier has a :class:`TierView` of torch tensors
(rows padded to multiples of 128). Any mutation rebuilds the views on the
next search; the lattice distance map, the per-row insertion seqs and the
per-row context ids are derived lazily per view.

The checkpoint is the JAX package's version-4 format — ``catalog.json``
plus immutable per-tier ``.npy`` segment files, committed by an atomic
catalog rename with the previous generation kept as ``.bak`` — so a
checkpoint written by either package restores in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading

import numpy as np
import torch

from tiresias_tpu_torch.config import DEF_N_COEFS
from tiresias_tpu_torch.utils.hashing import generate_uuid
from tiresias_tpu_torch.utils.logging import get_logger
from tiresias_tpu_torch.ops.match_lattice import build_value_map
from tiresias_tpu_torch.ops.mfcc import PAD_VALUE
from tiresias_tpu_torch.utils.device import resolve_device

log = get_logger(__name__)

CHECKPOINT_VERSION = 4
CATALOG_FILE = "catalog.json"
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
    try:
        with open(path) as f:
            json.load(f)
        return True
    except (OSError, ValueError):
        return False


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
        # first row changed since the last checkpoint save
        self.dirty_from = 0

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
            self.dead.update(self.uuid_rows.pop(u, [first]))
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
        self.dirty_from = min(self.dirty_from, doomed[0])


@dataclasses.dataclass
class TierView:
    """A tier's device view — what one search scans. ``entries`` includes
    tombstoned rows; their ``db`` rows hold PAD_VALUE and their mask rows
    are all-False, so neither the lattice map (+inf rows) nor the vote
    kernels (PAD frames) ever give them a vote."""

    tier_frames: int
    db: torch.Tensor  # [A_pad, T, C] float32
    mask: torch.Tensor  # [A_pad, T] bool
    n_audios: int  # view rows, including tombstoned ones
    entries: list[AudioEntry]
    dead_rows: frozenset = frozenset()
    segments: tuple = ()  # row groups of auto-split audios
    value_map: torch.Tensor | None = None  # [A_pad, K], lazily built
    seq_dev: torch.Tensor | None = None  # [A_pad] int64, lazily built
    ctx_dev: torch.Tensor | None = None  # [A_pad] int32, lazily built
    seg_dev: tuple | None = None  # (followers, heads) int64, lazily built


def _combine_segment_rows(vm: torch.Tensor, groups) -> torch.Tensor:
    """Min-combine an auto-split audio's map rows into its FIRST row (the
    others become +inf): min over segment rows is min over the whole
    audio's frames, the reference's one-vote-per-audio test."""
    for g in groups:
        rows = torch.as_tensor(list(g), dtype=torch.int64, device=vm.device)
        vm[g[0]] = vm[rows].amin(dim=0)
        if len(g) > 1:
            vm[rows[1:]] = torch.inf
    return vm


class FingerprintStore:
    """Tiered fingerprint matrices + catalog with the reference's CRUD
    semantics. One re-entrant lock guards mutation and catalog reads."""

    def __init__(self, n_coefs: int = DEF_N_COEFS, coef_weights=None,
                 device: torch.device | str = "cuda") -> None:
        """``coef_weights``: the DSP chain's per-coef weighting, recorded in
        the checkpoint; a restore under different weights is rejected."""
        self.n_coefs = int(n_coefs)
        self.coef_weights = (
            tuple(float(x) for x in coef_weights) if coef_weights else None
        )
        self.device = resolve_device(device)
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

    # ---- device views ------------------------------------------------- #

    def search_views(self) -> list[TierView]:
        """Per-tier device views (tiers ascending), cached until the store
        mutates; any mutation rebuilds them in full."""
        with self._lock:
            if not self._dirty and self._views is not None:
                return self._views
            views = []
            for t in sorted(self._tiers):
                tier = self._tiers[t]
                a = len(tier.entries)
                if a == 0:
                    continue
                a_pad = _bucket(a, AUDIO_BUCKET)
                n_frames = np.zeros(a_pad, dtype=np.int64)
                n_frames[:a] = tier.row_frames
                if tier.dead:
                    n_frames[sorted(tier.dead)] = 0
                db = torch.full((a_pad, t, self.n_coefs), PAD_VALUE,
                                device=self.device)
                db[:a].copy_(torch.from_numpy(tier.matrix[:a]))
                if tier.dead:
                    # the vote kernels read values only: PAD_VALUE is the
                    # tombstone (a dead row's stale fingerprint would vote)
                    db[sorted(tier.dead)] = PAD_VALUE
                frames = torch.arange(t, device=self.device)
                mask = frames[None, :] < torch.from_numpy(n_frames).to(
                    self.device)[:, None]
                views.append(TierView(
                    tier_frames=t, db=db, mask=mask, n_audios=a,
                    entries=list(tier.entries),
                    dead_rows=frozenset(tier.dead),
                    segments=tuple(tuple(r) for r in tier.uuid_rows.values()),
                ))
            self._views = views
            self._dirty = False
            return views

    def value_map_for(self, view: TierView) -> torch.Tensor:
        """Lattice distance map ``[A_pad, K]`` of one view, built on the
        device from the view's own (immutable) tensors and cached on it;
        segment rows min-combine, dead and padding rows are +inf."""
        with self._lock:
            if view.value_map is None:
                vm = build_value_map(view.db[..., 0], view.mask)
                view.value_map = _combine_segment_rows(vm, view.segments)
            return view.value_map

    def seq_for(self, view: TierView) -> torch.Tensor:
        """Per-row global insertion seqs ``[A_pad]`` int64 (padding rows
        int64 max) — the multi-view D5 tiebreak key."""
        with self._lock:
            if view.seq_dev is None:
                seqs = np.full(view.db.shape[0], np.iinfo(np.int64).max,
                               np.int64)
                seqs[: view.n_audios] = [e.seq for e in view.entries]
                view.seq_dev = torch.from_numpy(seqs).to(self.device)
            return view.seq_dev

    def segment_rows_for(self, view: TierView) -> tuple:
        """``(followers, heads)`` int64 row indices of the view's auto-split
        audios: every segment row after an audio's first, and that first
        row (the D15 merge target); both empty without over-long audios."""
        with self._lock:
            if view.seg_dev is None:
                pairs = [(r, g[0]) for g in view.segments for r in g[1:]]
                idx = torch.tensor(pairs, dtype=torch.int64).reshape(-1, 2)
                view.seg_dev = (idx[:, 0].to(self.device),
                                idx[:, 1].to(self.device))
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
                ids = np.full(view.db.shape[0], -1, np.int32)
                ids[: view.n_audios] = [
                    -1 if i in view.dead_rows
                    else self._ctx_id_alloc(e.context)
                    for i, e in enumerate(view.entries)
                ]
                view.ctx_dev = torch.from_numpy(ids).to(self.device)
            return view.ctx_dev

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
    def _referenced_segments(cat_path: str) -> set[str]:
        try:
            with open(cat_path) as f:
                cat = json.load(f)
        except (OSError, ValueError):
            return set()
        return {seg[0] for segs in cat.get("tiers", {}).values() for seg in segs}

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
        device: torch.device | str = "cuda",
    ) -> "FingerprintStore":
        """Restore from a checkpoint; an empty store when none exists. A
        corrupt current generation falls back to ``.bak``; when generations
        exist but none is readable, raises :class:`CheckpointUnreadable`."""
        device = resolve_device(device)
        errors: list[str] = []
        for suffix in ("", ".bak"):
            cat_path = os.path.join(directory, CATALOG_FILE + suffix)
            if not os.path.exists(cat_path):
                continue
            try:
                return FingerprintStore._load_catalog(
                    directory, cat_path, suffix, n_coefs, coef_weights, device
                )
            except CheckpointIncompatible:
                raise
            except (OSError, ValueError, KeyError, TypeError,
                    AttributeError) as exc:
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
        return FingerprintStore(n_coefs, coef_weights, device)

    @staticmethod
    def _load_catalog(
        directory, cat_path, suffix, n_coefs, coef_weights, device
    ) -> "FingerprintStore":
        store = FingerprintStore(n_coefs, coef_weights, device)
        with open(cat_path) as f:
            catalog = json.load(f)
        version = catalog.get("version")
        if version not in (3, 4):
            raise CheckpointIncompatible(
                f"checkpoint version {version} is not readable here (3 and "
                "4 are); load and save it once with tiresias_tpu to upgrade"
            )
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
                store._restore_entry(e, tiers[t][next_row(t), : e.n_frames])
            else:
                t = MAX_TIER_FRAMES
                store._restore_entry(e, np.concatenate(
                    [tiers[t][next_row(t), :n] for n in segs]
                ))
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
