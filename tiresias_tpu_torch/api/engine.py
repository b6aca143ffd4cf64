"""Library API: the :class:`Tiresias` engine (port of
``tiresias_tpu.api.engine``).

    eng = Tiresias(config)                       # device="cuda" by default
    eng.sync()                                   # init_context/init_audio
    res = eng.search_file("ctx", "query.wav")    # Tiresias() dialplan app
    res.status, res.name, res.match_count, ...   # TIR* variables

A search fingerprints the query batch (K1) and votes per tier view. The
reference's dialplan configuration (``coefs=1``, truncated max1,
bag-of-frames votes — PARITY.md section 3) votes on the view's lattice map
(K3'); every other configuration (``coefs`` up to ``dsp.n_coefs``, no
truncation — D8, offset-aligned votes — D9) votes over the stored
fingerprints with K4 (bag) or K5 (aligned). Votes reduce to a top-1 on the
device with the D5 tiebreak (and the runner-up audio's votes for margin
acceptance) and are read back once; :meth:`Tiresias.search_pcm_topk` ranks
the same votes into each view's exact top-k on the device. Above twice a
candidate budget of rows per view, each mode first tries its certified
prefilter (a uint8 bound scan, the rows of highest bound rescored exactly,
a certificate read back per view) and full-scans where any query's
certificate fails; an adaptive gate stops trying after 8 misses in a row
per view and mode.

With ``mesh=`` (a ``(db, batch)`` :class:`~tiresias_tpu_torch.parallel.Mesh`,
``"auto"`` or ``"global"``) the store shards each view on the mesh's ``db``
axis; every cell votes with the same kernels on its shard and slice of the
batch, and the vote blocks are gathered to ``[B, A_pad]`` (across ranks
too) before the segment merge, the context filter and the top-1, which are
unchanged. The prefilters run per shard, and a view full-scans unless
every shard certifies. On a mesh over a process group (``"global"``) each
search exchanges its vote blocks and certificates with the other ranks by
``all_gather``, and collectives pair up by the order in which each rank
issues them: every rank must issue the same searches in the same order.
Within a process the engine runs one search's collectives at a time (other
threads wait), and ``warmup_async`` warms in the foreground; the serve
layer, whose clients reach each rank independently, refuses such a mesh.

The engine is driven from several threads at once by the serve layer
(score passes, admin searches, watch syncs, follow swaps): a search reads
``self.store`` and its views once and keeps that snapshot to its end, and
every thread launches on the device's default stream.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import threading

import numpy as np
import torch

from tiresias_tpu_torch.config import (
    DEF_DURATION_MS,
    DEF_SEARCH_TOLERANCE,
    MatchConfig,
    TiresiasConfig,
)
from tiresias_tpu_torch.utils import build
from tiresias_tpu_torch.utils.audio import ensure_samplerate, read_audio
from tiresias_tpu_torch.utils.g711 import SILENCE_BYTE
from tiresias_tpu_torch.utils.g711 import decode as g711_decode
from tiresias_tpu_torch.utils.hashing import file_md5, generate_uuid
from tiresias_tpu_torch.utils.locking import DataDirLock, DataDirLocked
from tiresias_tpu_torch.utils.logging import get_logger
from tiresias_tpu_torch.engine.sync import (
    SyncReport,
    ingest_files,
    sync_all,
    sync_context_audio,
)
from tiresias_tpu_torch.ops import match_kernels, match_lattice
from tiresias_tpu_torch.ops.match import prepare_query
from tiresias_tpu_torch.ops.match_kernels import (
    aligned_prefiltered_votes,
    match_votes_fused,
    match_votes_fused_aligned,
)
from tiresias_tpu_torch.ops.match_lattice import (
    band_thresholds,
    bound_tol_ok,
    lattice_prefiltered_votes,
    lattice_votes,
)
from tiresias_tpu_torch.ops.mfcc import (
    fingerprint_padded_batch,
    fingerprint_signal,
    pad_frames_bucket,
)
from tiresias_tpu_torch.parallel import distributed as tdist
from tiresias_tpu_torch.parallel.sharding import (
    Mesh,
    make_mesh,
    sharded_aligned_prefiltered,
    sharded_lattice_prefiltered,
    sharded_lattice_votes,
    sharded_votes_kernels,
)
from tiresias_tpu_torch.store.fingerprint_store import (
    AudioEntry,
    FingerprintStore,
)
from tiresias_tpu_torch.utils.device import resolve_device
from tiresias_tpu_torch.utils.tracing import metrics, phase, span

log = get_logger(__name__)

# TIRSTATUS values (reference application_handler.c:168-193)
STATUS_FOUND = "FOUND"
STATUS_NOTFOUND = "NOTFOUND"
STATUS_HANGUP = "HANGUP"


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """The TIR* contract (application_handler.c:193-234)."""

    status: str  # TIRSTATUS
    frame_count: int  # TIRFRAMECOUNT — all query frames, incl. band-skipped
    match_count: int  # TIRMATCHCOUNT — votes of the winner
    uuid: str | None = None  # TIRFILEUUID
    name: str | None = None  # TIRFILENAME
    context: str | None = None  # TIRCONTEXT
    hash: str | None = None  # TIRFILEHASH
    # per-channel window index (continuous streaming): the serve layer
    # pipelines score passes, so results MAY arrive out of order — this
    # monotone counter lets clients reorder (not part of the TIR* contract)
    window: int = 0

    @property
    def found(self) -> bool:
        return self.status == STATUS_FOUND

    @property
    def confidence(self) -> float:
        """match_count / frame_count (dialplan_application.rst:40-46)."""
        return self.match_count / self.frame_count if self.frame_count else 0.0

    def to_channel_vars(self) -> dict[str, str]:
        """The literal TIR* variable dict the dialplan app sets."""
        out = {
            "TIRSTATUS": self.status,
            "TIRFRAMECOUNT": str(self.frame_count),
            "TIRMATCHCOUNT": str(self.match_count),
        }
        if self.found:
            out.update(
                TIRFILEUUID=self.uuid or "",
                TIRFILENAME=self.name or "",
                TIRCONTEXT=self.context or "",
                TIRFILEHASH=self.hash or "",
            )
        return out


NOT_FOUND = SearchResult(status=STATUS_NOTFOUND, frame_count=0, match_count=0)


def parse_dialplan_args(argstring: str) -> dict:
    """Parse ``<context>,<duration>,[tolerance],[freq_ignore_low],
    [freq_ignore_high]`` (application_handler.c:81-137); empty optional
    fields fall back to config defaults."""
    parts = [p.strip() for p in argstring.split(",")]
    if not parts or not parts[0]:
        raise ValueError("context name required (application_handler.c:99-104)")
    out: dict = {"context": parts[0]}
    if len(parts) > 1 and parts[1]:
        out["duration_ms"] = int(parts[1])
    if len(parts) > 2 and parts[2]:
        out["tolerance"] = float(parts[2])
    if len(parts) > 3 and parts[3]:
        out["freq_ignore_low"] = int(parts[3])
    if len(parts) > 4 and parts[4]:
        out["freq_ignore_high"] = int(parts[4])
    return out


def top1_by_key(values: torch.Tensor, key: torch.Tensor):
    """Per row of ``values [B, A]``: (max, lowest ``key`` among the maxima,
    the column holding that key). D5 ties are broken here explicitly, never
    by ``argmax`` order; ``key`` is unique among rows that can win."""
    big = torch.iinfo(torch.int64).max
    m = values.max(dim=1).values
    cand = torch.where(values == m[:, None], key[None, :], big)
    k = cand.min(dim=1).values
    cols = torch.arange(values.shape[1], device=values.device)
    col = torch.where(cand == k[:, None], cols[None, :], big).min(dim=1).values
    return m, k, col


def topk_by_row(votes: torch.Tensor, seq: torch.Tensor, k: int) -> torch.Tensor:
    """One view's exact top-``k`` of ``votes [A]`` by (votes desc, row asc)
    as ``[3, k]`` int64: votes, ``seq`` of the row, row; short views pad
    with zero votes. Row order is insertion order within a tier, so this
    is the view's D5 order. The ranking key ``votes * 2^32 - row`` is
    unique per row: nothing rests on how ``torch.topk`` orders equal
    values (it promises no order)."""
    a = votes.shape[0]
    rows = torch.arange(a, device=votes.device)
    score = votes.to(torch.int64) * (1 << 32) - rows
    top = torch.topk(score, min(k, a)).indices
    out = torch.zeros((3, k), dtype=torch.int64, device=votes.device)
    out[0, : top.shape[0]] = votes[top]
    out[1, : top.shape[0]] = seq[top]
    out[2, : top.shape[0]] = top
    return out


class Tiresias:
    """Audio fingerprinting engine on PyTorch (the port's front door)."""

    def __init__(
        self,
        config: TiresiasConfig | None = None,
        restore: bool = True,
        exclusive: bool | None = None,
        device: str | torch.device = "cuda",
        mesh=None,
    ) -> None:
        """``device``: where fingerprints, maps and kernels live; ``cuda``
        raises when no card is usable (pass ``"cpu"`` explicitly for the
        plain PyTorch versions of the kernels).

        ``exclusive``: single-writer ownership of the data directory —
        True must own it, None (default) tries and falls back to a
        read-only engine, False is read-only by choice.

        ``mesh``: None (one device), a :class:`Mesh`, ``"auto"`` (a
        ``(n, 1)`` mesh over this process's devices of ``device``'s type,
        None when there is one) or ``"global"`` (:func:`global_mesh` over
        every rank's cells, None when there is one). With a mesh the
        engine's device is the mesh's home device."""
        self.mesh = mesh if isinstance(mesh, Mesh) else None
        self.device = (mesh.home if self.mesh is not None
                       else resolve_device(device))
        self.config = config or TiresiasConfig()
        # serializes sync/reload against each other (a serve watcher tick
        # racing an admin-plane sync): both walk the same directories and
        # the reconcile is only idempotent when runs don't interleave
        self._sync_mutex = threading.Lock()
        self._warm_lock = threading.Lock()
        self._warm_stop = threading.Event()
        self._warm_threads: list[threading.Thread] = []
        # the certified prefilters' adaptive gate: consecutive certificate
        # misses per (view gen, mode), least recently noted first
        self._pf_misses: dict = {}
        self._pf_lock = threading.Lock()
        # on a mesh over a process group: one search's collectives at a
        # time (see _collectives)
        self._collective_lock = threading.Lock()
        self.lock = DataDirLock(self.config.expanded_data_dir)
        if exclusive is not False:
            try:
                self.lock.acquire()
            except DataDirLocked as exc:
                if exclusive:
                    raise
                log.warning("engine is read-only: %s", exc)
        try:
            self.mesh = self._resolve_mesh(mesh)
            if self.mesh is not None:
                self.device = self.mesh.home
            self.checkpoint_dir = os.path.join(
                self.config.expanded_data_dir, "checkpoint"
            )
            dsp = self.config.dsp
            if restore:
                self.store = FingerprintStore.load(
                    self.checkpoint_dir, n_coefs=dsp.n_coefs,
                    coef_weights=dsp.coef_weights, device=self.device,
                    mesh=self.mesh,
                )
            else:
                self.store = FingerprintStore(
                    dsp.n_coefs, dsp.coef_weights, self.device, self.mesh
                )
            for ctx in self.config.contexts:
                self.store.create_context(ctx.name, ctx.directory)
        except BaseException:
            # a failed construction must not leave the data-dir lock held
            self.lock.release()
            raise

    def _resolve_mesh(self, mesh) -> Mesh | None:
        """The engine's mesh from the ``mesh`` argument (see __init__)."""
        if mesh is None or isinstance(mesh, Mesh):
            return mesh
        if mesh == "auto":
            devices = tdist.local_devices(self.device)
            if len(devices) < 2:
                return None
            return make_mesh(len(devices), 1, devices=devices)
        if mesh == "global":
            if not tdist.is_initialized():
                devices = tdist.local_devices(self.device)
                return make_mesh(devices=devices) if len(devices) > 1 else None
            gm = tdist.global_mesh()
            return gm if gm.size > 1 else None
        if isinstance(mesh, str):
            raise ValueError(
                f"mesh must be None, 'auto', 'global' or a Mesh, got {mesh!r}")
        raise TypeError(
            f"mesh must be None, 'auto', 'global' or a Mesh, not "
            f"{type(mesh).__name__}")

    def _ingest_mesh(self) -> Mesh | None:
        """Mesh for data-parallel ingest fingerprinting: the engine's mesh
        when this process owns every cell. A multi-process mesh returns
        None: each process ingests its own files on its home device
        (host-local inputs cannot form a batch split across ranks)."""
        if self.mesh is None or self.mesh.is_multiprocess:
            return None
        return self.mesh

    # ---- lifecycle ---------------------------------------------------- #

    def _require_owner(self) -> None:
        if not self.lock.held:
            raise DataDirLocked(
                self.config.expanded_data_dir, self.lock.owner_info()
            )

    def _collectives(self):
        """Held over a search's loop over the views: on a mesh over a process
        group each view's votes and certificates are ``all_gather``s, which
        pair with the other ranks' by the order this process issues them, so
        two threads' searches must not interleave theirs. Nothing to hold
        without a process group."""
        if self.mesh is not None and self.mesh.distributed:
            return self._collective_lock
        return contextlib.nullcontext()

    def _on_device(self):
        """Make the engine's card the calling thread's current CUDA device
        (the kernels launch on the current device, and executor threads
        start on device 0); nothing to do on the CPU."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def sync(self) -> SyncReport:
        """Reconcile store with config + filesystem (app_tiresias.c:230-358),
        checkpointing after each changed context."""
        self._require_owner()
        with self._sync_mutex, span("engine.sync"), self._on_device():
            return sync_all(
                self.store, self.config, self.checkpoint_dir, self.device,
                mesh=self._ingest_mesh(),
            )

    def sync_context(self, context: str) -> SyncReport:
        """Re-sync one context's directory, then checkpoint."""
        self._require_owner()
        ctx = self.store.get_context(context)
        if ctx is None or not ctx["directory"]:
            raise ValueError(f"unknown context {context!r}")
        with self._sync_mutex, span("engine.sync"), self._on_device():
            report = sync_context_audio(
                self.store, context, ctx["directory"], self.config.dsp,
                self.device, mesh=self._ingest_mesh(),
            )
            self.save()
            return report

    def refresh_from_checkpoint(self) -> bool:
        """Re-read the checkpoint and swap in the new store when the OWNER
        committed a newer generation — the read-only REPLICA's follow path
        (``serve --replica --follow N``).

        The owner checkpoints after every mutation; replicas poll this.
        The generation comparison is a catalog-metadata read (no
        fingerprint is deserialized when nothing changed). The new store is
        loaded onto the engine's device BESIDE the old one; in-flight
        searches keep the store they started with, the swap is one
        attribute assignment, and the old store's tensors are released
        when the last search drops it. Returns True when a newer generation
        was loaded. Owners return False (their store IS the source of
        truth), and an unreadable checkpoint keeps serving the current
        store (counted in ``engine.follow_errors``)."""
        if self.lock.held:
            return False
        try:
            meta = FingerprintStore.read_catalog_metadata(self.checkpoint_dir)
        except Exception:  # noqa: BLE001 - transient fault: keep serving
            log.warning("follow: checkpoint metadata unreadable; keeping "
                        "the current store")
            metrics.add("engine.follow_errors", 1)
            return False
        # _seen_gen, not only _save_gen: after a .bak fallback the store's
        # save generation is deliberately 0, but the newest generation
        # OBSERVED at load time was recorded — without it every poll would
        # re-deserialize the same fallback checkpoint forever
        have = max(self.store._save_gen, self.store._seen_gen)
        if meta is None or int(meta.get("gen", 0)) <= have:
            return False
        dsp = self.config.dsp
        try:
            store = FingerprintStore.load(
                self.checkpoint_dir, n_coefs=dsp.n_coefs,
                coef_weights=dsp.coef_weights, device=self.device,
                mesh=self.mesh,
            )
        except Exception:  # noqa: BLE001 - torn mid-rotation read etc.
            log.warning("follow: checkpoint reload failed; keeping the "
                        "current store", exc_info=True)
            metrics.add("engine.follow_errors", 1)
            return False
        for ctx in self.config.contexts:
            store.create_context(ctx.name, ctx.directory)
        self.store = store
        self.warm_search_maps()
        log.info(
            "follow: refreshed store from checkpoint (gen %d, %d audios)",
            store._restored_gen, len(store),
        )
        return True

    def reload(self, config: TiresiasConfig | None = None) -> SyncReport:
        """Live config reload — adopt a new config and re-sync.

        The reference declines reload outright (unload/load required,
        app_tiresias.c:608-614); here it is a config swap + sync, since the
        store reconciles declaratively. DSP parameters are the exception:
        fingerprints already in the store were computed under the old
        chain, so changing them requires a fresh engine (ValueError)."""
        if config is not None:
            if config.dsp != self.config.dsp:
                raise ValueError(
                    "reload cannot change DSP parameters — stored "
                    "fingerprints were computed under the old chain; "
                    "rebuild with a fresh data_dir"
                )
            if config.expanded_data_dir != self.config.expanded_data_dir:
                # the restored store and checkpoint_dir are bound to the
                # old directory; keeping them while self.config says
                # otherwise would checkpoint to the wrong place
                raise ValueError(
                    "reload cannot change data_dir — the store is bound "
                    "to the old checkpoint directory; construct a new "
                    "Tiresias for a different data_dir"
                )
        old_config = self.config
        if config is not None:
            self.config = config
        try:
            return self.sync()
        except Exception:
            # a failed sync must not leave the NEW config active: later
            # watch ticks would keep reconciling under a config the caller
            # was told failed (contexts the new conf dropped would be
            # deleted). Partial sync work is self-healing — the next tick
            # under the restored config re-ingests from disk.
            self.config = old_config
            raise

    def _warm_window(self, samplerate: int, duration_ms: int) -> int:
        """Samples of one warm-up query: the window, cut to whole hops."""
        hop = self.config.dsp.hop_size
        n = int(samplerate * duration_ms / 1000)
        return max(n - n % hop, hop)

    def _warm_search(self, silence: np.ndarray, samplerate: int,
                     batch_sizes, law: str | None = None) -> bool:
        """One silent search per batch size; False when close() cut in."""
        for b in batch_sizes:
            if self._warm_stop.is_set():
                return False
            with span("engine.warmup"):
                self.search_pcm_batch(
                    None, [silence] * b, samplerate, wire_law=law
                )
        return True

    def _warm_kernels(self) -> None:
        """Build (first use in a checkout) and load the kernel library."""
        if self.device.type == "cuda":
            with span("engine.warmup.kernels"):
                build.kernel_library()

    def warmup(
        self,
        samplerate: int = 8000,
        duration_ms: int = DEF_DURATION_MS,
        batch_sizes: tuple[int, ...] = (1,),
        laws: tuple[str, ...] = (),
    ) -> None:
        """Take every first-use cost before the first real request: build
        and load the CUDA kernel library, run one silent search per wire
        dtype the serve layer ships — int16 (the TCP format, kept
        unconverted to the device), float32 (library callers) and each
        G.711 law in ``laws`` — so the lazily uploaded constants (MFCC
        tables per samplerate, the G.711 expansion) are on the device, and
        build the per-view search maps (:meth:`warm_search_maps`). There
        are no per-shape programs to compile: ``batch_sizes`` only sizes
        the silent searches."""
        self._warm_kernels()
        with phase("engine.warmup.maps"):
            self.warm_search_maps()
        n = self._warm_window(samplerate, duration_ms)
        for dtype in (np.int16, np.float32):
            self._warm_search(np.zeros(n, dtype), samplerate, batch_sizes)
        for law in laws:
            self._warm_search(
                np.full(n, SILENCE_BYTE[law], np.uint8), samplerate,
                batch_sizes, law,
            )

    def warmup_async(
        self,
        samplerate: int = 8000,
        duration_ms: int = DEF_DURATION_MS,
        batch_sizes: tuple[int, ...] = (1,),
        laws: tuple[str, ...] = (),
    ) -> threading.Thread:
        """Readiness-tiered :meth:`warmup`: the serving-critical part — the
        kernel library, the search maps and the int16 search, in that
        order — runs before this returns; the float32 and G.711 searches
        run on a daemon thread, which is returned (join it to wait for
        full warmth; :meth:`close` does). On a multi-process mesh every
        search is a collective that the ranks must issue in one order, so
        the thread is joined before this returns."""
        self._warm_kernels()
        with phase("engine.warmup.maps"):
            self.warm_search_maps()
        n = self._warm_window(samplerate, duration_ms)
        self._warm_search(np.zeros(n, np.int16), samplerate, batch_sizes)

        def _background():
            if not self._warm_search(
                np.zeros(n, np.float32), samplerate, batch_sizes
            ):
                return
            for law in laws:
                if not self._warm_search(
                    np.full(n, SILENCE_BYTE[law], np.uint8), samplerate,
                    batch_sizes, law,
                ):
                    return

        t = threading.Thread(
            target=_background, name="tiresias-warmup", daemon=True
        )
        with self._warm_lock:
            self._warm_threads = [
                x for x in self._warm_threads if x.is_alive()
            ]
            self._warm_threads.append(t)
        t.start()
        if self.mesh is not None and self.mesh.is_multiprocess:
            t.join()
        return t

    def law_device_ready(self, law: str) -> bool:
        """Whether ``law``'s windows can expand on the device: always, here
        (the expansion is a table gather in plain torch, nothing compiles).
        Kept for the streaming scorer's callers."""
        return True

    def warm_search_maps(self) -> None:
        """Eagerly build the derived per-view device data that searches
        otherwise build lazily on first use: the insertion-seq and
        context-id rows, and — by the configured :class:`MatchConfig` — the
        lattice value map (dialplan configuration) or K4/K5's sorted index
        (every other), with the uint8 map of the dialplan prefilter or, in
        the aligned configuration, the bound maps wherever the prefilter's
        gate would admit the view. A restored serving store otherwise pays
        the build on the next request. Already-built maps cost nothing,
        and a view updated after a mutation carries the maps of the view
        before it. On a mesh, every shard's maps, each on its device."""
        mc = self.config.match
        lattice_mode = mc.coefs == 1 and mc.trunc_coef1 and not mc.aligned
        # the tolerance real requests run at (a negative one means the
        # default), so the gates below build what the first search uses
        tol = mc.tolerance if mc.tolerance >= 0 else DEF_SEARCH_TOLERANCE
        store = self.store
        with self._on_device():
            for view in store.search_views():
                store.seq_for(view)
                store.ctx_ids_for(view)
                lattice_pf = lattice_mode and self._lattice_pf_ok(view, tol)
                big = (self._prefilter_rows(view) or 0) > (
                    2 * match_kernels.PREFILTER_K)
                for part in [s.view for s in view.shards] or [view]:
                    if view.shards:
                        store.ctx_ids_for(part)
                    if lattice_mode:
                        store.value_map_for(part)
                        if lattice_pf:
                            store.value_map_q_for(part)
                    else:
                        store.match_index_for(part)
                        if (mc.aligned and big and not view.segments
                                and bound_tol_ok(mc.coefs, tol)):
                            store.bound_maps_for(part, mc.coefs)

    def save(self) -> None:
        self._require_owner()
        self.store.save(self.checkpoint_dir)

    def close(self) -> None:
        """fp_term equivalent (fp_handler.c:92-108): checkpoint and unlock."""
        # stop and drain any background warm-up first: a daemon thread in
        # the middle of a device call during interpreter teardown can
        # abort the process
        self._warm_stop.set()
        with self._warm_lock:
            threads = list(self._warm_threads)
        for t in threads:
            if t.is_alive():
                t.join(timeout=30)
        try:
            if self.lock.held:
                self.save()
        finally:
            self.lock.release()

    def __enter__(self) -> "Tiresias":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- context / audio CRUD (fp_handler.h:15-26) -------------------- #

    def create_context(self, name: str, directory: str = "") -> None:
        self.store.create_context(name, directory)

    def delete_context(self, name: str) -> bool:
        return self.store.delete_context(name)

    def get_contexts(self) -> list[dict]:
        return self.store.get_contexts_all()

    def get_audios(self, context: str) -> list[AudioEntry]:
        return self.store.get_audios_by_context(context)

    def get_audio(self, uuid: str) -> AudioEntry | None:
        return self.store.get_audio(uuid)

    def delete_audio(self, uuid: str) -> bool:
        return self.store.delete_audio(uuid)

    def add_audio_file(self, context: str, path: str) -> SyncReport:
        """Fingerprint + store one file (fp_craete_audio_list_info [sic],
        fp_handler.h:25, fp_handler.c:161-197)."""
        with self._on_device():
            return ingest_files(
                self.store, context, [path], self.config.dsp,
                device=self.device, mesh=self._ingest_mesh(),
            )

    def add_audio_pcm(
        self,
        context: str,
        name: str,
        pcm: np.ndarray,
        samplerate: int,
        file_hash: str | None = None,
        wire_law: str | None = None,
    ) -> AudioEntry | None:
        """Direct-PCM ingest; ``wire_law`` takes raw G.711 codes (uint8)."""
        if wire_law is not None:
            pcm = g711_decode(pcm, wire_law)
        pcm, samplerate = ensure_samplerate(
            np.asarray(pcm), samplerate, self.config.dsp.samplerate
        )
        fp = fingerprint_signal(
            np.asarray(pcm), samplerate, self.config.dsp, device=self.device
        )
        if file_hash is None:
            file_hash = hashlib.md5(
                np.ascontiguousarray(pcm, dtype=np.float32).tobytes()
            ).hexdigest()
        return self.store.add_audio(name, context, fp, file_hash)

    # compat alias preserving the reference's misspelled symbol (PARITY.md D6)
    fp_craete_audio_list_info = add_audio_file

    # ---- search (fp_search_fingerprint_info, fp_handler.c:207-408) ---- #

    def search_pcm(
        self,
        context: str | None,
        pcm: np.ndarray,
        samplerate: int,
        coefs: int | None = None,
        tolerance: float | None = None,
        freq_ignore_low: int = -1,
        freq_ignore_high: int = -1,
        filter_context: bool = False,
        trunc_coef1: bool | None = None,
        aligned: bool | None = None,
        wire_law: str | None = None,
        min_margin: float | None = None,
    ) -> SearchResult:
        """Search one PCM signal; returns the TIR* result. Like the
        reference, the scan covers ALL contexts unless
        ``filter_context=True`` (PARITY.md D7)."""
        return self.search_pcm_batch(
            context, [np.asarray(pcm)], samplerate, coefs=coefs,
            tolerance=tolerance, freq_ignore_low=freq_ignore_low,
            freq_ignore_high=freq_ignore_high, filter_context=filter_context,
            trunc_coef1=trunc_coef1, aligned=aligned, wire_law=wire_law,
            min_margin=min_margin,
        )[0]

    def search_pcm_batch(
        self,
        context: str | None,
        pcms: list[np.ndarray],
        samplerate: int,
        coefs: int | None = None,
        tolerance: float | None = None,
        freq_ignore_low: int = -1,
        freq_ignore_high: int = -1,
        filter_context: bool = False,
        trunc_coef1: bool | None = None,
        aligned: bool | None = None,
        wire_law: str | None = None,
        min_margin: float | None = None,
    ) -> list[SearchResult]:
        """Batched search — many queries in one device pass.
        ``wire_law`` ("ulaw"/"alaw") marks raw G.711 codes, expanded on the
        device. ``min_margin`` > 0 (default ``MatchConfig.min_margin``)
        accepts a winner only when ``(v1 - v2) >= min_margin * v1``, v2
        the runner-up audio's votes (the noise operating point)."""
        if not pcms:
            return []
        with phase("search.match"):
            with span("search.prepare"):
                coefs, tolerance, lo, hi, trunc_coef1, aligned, mm = (
                    self._resolve_search(
                        coefs, tolerance, freq_ignore_low, freq_ignore_high,
                        trunc_coef1, aligned, min_margin,
                    )
                )
                # one snapshot: a follow swap must not split it
                store = self.store
                ctx_id = self._ctx_filter_id(store, context, filter_context)
                padded, n_valid, rate, law, n_frames = self._pad_queries(
                    pcms, samplerate, wire_law
                )
            with self._on_device():
                qfp = fingerprint_padded_batch(
                    padded, rate, self.config.dsp, law=law, n_valid=n_valid,
                    device=self.device,
                )
                results = self._match(
                    qfp, n_frames, tolerance, lo, hi, ctx_id, coefs=coefs,
                    trunc_coef1=trunc_coef1, aligned=aligned, min_margin=mm,
                    store=store,
                )
            metrics.add("search.queries", len(pcms))
        return results

    def _pad_queries(
        self, pcms: list[np.ndarray], samplerate: int, wire_law: str | None
    ) -> tuple[np.ndarray, np.ndarray | None, int, str | None, np.ndarray]:
        """A query batch's host side: ``(padded [B, S], n_valid [B] or
        None, samplerate, wire_law, n_frames [B])`` after resampling to
        the configured rate. int16, float32 and G.711 codes stay as they
        are and expand on the device."""
        pcms, samplerate, wire_law = self._resample_queries(
            [np.asarray(p) for p in pcms], samplerate, wire_law
        )
        padded, n_frames = pad_frames_bucket(
            pcms, self.config.dsp.hop_size, law=wire_law
        )
        n_valid = (
            np.array([len(p) for p in pcms], np.int32)
            if wire_law is not None else None
        )
        return padded, n_valid, samplerate, wire_law, n_frames

    def _query_fingerprints(
        self, pcms: list[np.ndarray], samplerate: int, wire_law: str | None
    ) -> tuple[torch.Tensor, np.ndarray]:
        """Query batch -> (``qfp [B, F, C]`` on the engine's device, frame
        counts); K1/K2 by the routing rule of ``fingerprint_padded_batch``."""
        with span("search.prepare"):
            padded, n_valid, rate, law, n_frames = self._pad_queries(
                pcms, samplerate, wire_law
            )
        qfp = fingerprint_padded_batch(
            padded, rate, self.config.dsp, law=law, n_valid=n_valid,
            device=self.device,
        )
        return qfp, n_frames

    def _view_votes(
        self, store: FingerprintStore, qfp: torch.Tensor,
        n_frames: np.ndarray, tolerance: float, freq_ignore_low: int,
        freq_ignore_high: int, ctx_id: int | None, coefs: int,
        trunc_coef1: bool, aligned: bool, top: int = 1,
        prefilter: bool = True,
    ):
        """The per-view vote computation every search entry point shares:
        returns ``votes_of(view) -> [B, A_pad] int32``. Lattice votes (K3')
        for the dialplan configuration, K4/K5 over the view's fingerprints
        otherwise, with an auto-split audio's segment columns summed into
        its first column (D15, additive), then the context filter (votes of
        rows outside ``ctx_id`` become 0).

        Where its gate admits a view, the certified prefilter of the mode
        (PARITY.md D17/D19/D20) computes the votes instead: exact in every
        row that can reach the caller's top ``top`` (1; 2 for a margin
        search; k for a ranked listing) when every query certifies, and
        otherwise the full scan above runs. ``prefilter=False`` always
        takes the full scan (every row's exact votes).

        On a mesh each cell computes its shard's votes for its slice of the
        batch and the blocks are gathered to ``[B, A_pad]`` in global row
        order; the segment merge and the context filter run on the gathered
        votes (an auto-split audio's rows may lie in several shards)."""
        with span("search.votes"):
            mesh = store.mesh
            f = int(qfp.shape[1])
            dialplan = coefs == 1 and trunc_coef1 and not aligned
            if dialplan:
                band_lo, band_hi = band_thresholds(
                    freq_ignore_low, freq_ignore_high
                )
                nf = torch.from_numpy(np.asarray(n_frames, np.int64)).to(
                    self.device)
                valid = (torch.arange(f, device=self.device)[None, :]
                         < nf[:, None])
                q0 = qfp[..., 0].contiguous()
            else:
                q, active, use2 = prepare_query(
                    qfp, n_frames, freq_ignore_low, freq_ignore_high,
                    trunc_coef1,
                )
                vote = (match_votes_fused_aligned if aligned
                        else match_votes_fused)

        def votes_of(view) -> torch.Tensor:
            with span("search.votes"):
                votes = None
                if dialplan:
                    if prefilter and self._lattice_pf_ok(view, tolerance, top):
                        with span("search.prefilter"):
                            votes = self._lattice_prefiltered(
                                store, view, q0, valid, tolerance, band_lo,
                                band_hi, ctx_id, top,
                            )
                    if votes is None and mesh is None:
                        votes = lattice_votes(
                            store.value_map_for(view), q0, valid, tolerance,
                            band_lo, band_hi,
                        )
                    elif votes is None:
                        votes = sharded_lattice_votes(
                            mesh, store.sharded(view, store.value_map_for), q0,
                            valid, tolerance, band_lo, band_hi,
                        )
                else:
                    if prefilter and self._strict_pf_ok(view, coefs, tolerance,
                                                        top, aligned):
                        with span("search.prefilter"):
                            votes = self._aligned_prefiltered(
                                store, view, q, active, use2, coefs,
                                tolerance, ctx_id, top, aligned,
                            )
                    if votes is None and mesh is None:
                        votes = vote(view.db, q, active, use2, tolerance,
                                     coefs, index=store.match_index_for(view))
                    elif votes is None:
                        votes = sharded_votes_kernels(
                            mesh, store.sharded(view, lambda s: s.db), q,
                            active, use2, tolerance, coefs, aligned,
                            index=store.sharded(view, store.match_index_for),
                        )
                    votes = self._merge_segments(store, view, votes)
                if ctx_id is not None:
                    keep = store.ctx_ids_for(view) == ctx_id
                    votes = torch.where(keep[None, :], votes, 0)
                return votes

        return votes_of

    def _compute_votes(
        self,
        context: str | None,
        pcms: list[np.ndarray],
        samplerate: int,
        coefs: int | None,
        tolerance: float | None,
        freq_ignore_low: int,
        freq_ignore_high: int,
        filter_context: bool,
        trunc_coef1: bool | None,
        aligned: bool | None = None,
        prefilter: bool = True,
        wire_law: str | None = None,
        prefilter_top: int = 1,
    ) -> tuple[np.ndarray, list[AudioEntry], np.ndarray]:
        """(votes ``[B, A]`` int32, view-ordered entries, n_frames ``[B]``)
        on the host: every view's :meth:`_view_votes` cut to its audios and
        concatenated, as the JAX engine's ``_compute_votes`` returns them.

        ``prefilter=False`` takes the full scans (every audio's exact
        votes, for top-k listings); ``prefilter_top`` widens a certificate
        to an exact top-N (a margin needs a certified runner-up: a
        candidate-only second best would understate it)."""
        coefs, tolerance, lo, hi, trunc_coef1, aligned, _ = (
            self._resolve_search(
                coefs, tolerance, freq_ignore_low, freq_ignore_high,
                trunc_coef1, aligned, 0.0,
            )
        )
        store = self.store
        ctx_id = self._ctx_filter_id(store, context, filter_context)
        views = store.search_views()
        with phase("search.match"), self._on_device():
            qfp, n_frames = self._query_fingerprints(
                pcms, samplerate, wire_law
            )
            votes_of = self._view_votes(
                store, qfp, n_frames, tolerance, lo, hi, ctx_id, coefs,
                trunc_coef1, aligned, top=prefilter_top, prefilter=prefilter,
            )
            with self._collectives():
                parts = [votes_of(view)[:, : view.n_audios]
                         for view in views]
            votes = (torch.cat(parts, 1).to(torch.int32).cpu().numpy()
                     if parts else np.zeros((len(pcms), 0), np.int32))
        metrics.add("search.queries", len(pcms))
        return votes, [e for v in views for e in v.entries], np.asarray(
            n_frames)

    # ---- certified prefilters (PARITY.md D17/D19/D20) ----------------- #

    def _pf_allowed(self, view, mode: str) -> bool:
        """The adaptive gate, per (view ``gen``, mode): 8 consecutive
        certificate misses switch the prefilter off for that view; a
        certified result, or a mutation (new views, new gens), re-arms it."""
        with self._pf_lock:
            return self._pf_misses.get((view.gen, mode), 0) < 8

    def _pf_note(self, view, mode: str, certified: bool) -> None:
        """Feed a prefiltered search's certificate back into the gate. A
        miss re-inserts its key, so insertion order is least recently
        noted and the 32-key bound evicts stale gens, never a live view's
        streak. Searches run on several threads, hence the lock."""
        key = (view.gen, mode)
        with self._pf_lock:
            if certified:
                self._pf_misses.pop(key, None)
            else:
                self._pf_misses[key] = self._pf_misses.pop(key, 0) + 1
                while len(self._pf_misses) > 32:
                    self._pf_misses.pop(next(iter(self._pf_misses)))
        if not certified:
            metrics.add("search.prefilter_fallbacks", 1)

    def _prefilter_rows(self, view) -> int | None:
        """The rows a prefilter selects among: the view's, or on a mesh its
        shard's (None when the shards would not be equal: disjoint columns
        need exact shard rows)."""
        if self.mesh is None:
            return view.rows
        n_db = self.mesh.shape["db"]
        return None if view.rows % n_db else view.rows // n_db

    def _lattice_pf_ok(self, view, tolerance: float, top: int = 1) -> bool:
        """Gate of the dialplan prefilter: the selection must be real
        (rows > 2k, per shard on a mesh), the listing must fit the
        candidates, the tolerance must stay below the uint8 saturation, and
        the adaptive gate must allow it."""
        k = match_lattice.LATTICE_PREFILTER_K
        rows = self._prefilter_rows(view)
        return self._pf_gate(
            rows is not None and top <= k and rows > 2 * k
            and bound_tol_ok(None, tolerance)
            and self._pf_allowed(view, "lattice")
        )

    def _strict_pf_ok(self, view, coefs: int, tolerance: float, top: int,
                      aligned: bool) -> bool:
        """Gate of the strict/aligned prefilter, as :meth:`_lattice_pf_ok`
        with the bound maps' saturation per coefficient."""
        k = match_kernels.PREFILTER_K
        rows = self._prefilter_rows(view)
        return self._pf_gate(
            rows is not None and top <= k and rows > 2 * k
            and bound_tol_ok(coefs, tolerance)
            and self._pf_allowed(view, "aligned" if aligned else "bag")
        )

    @staticmethod
    def _pf_gate(admit: bool) -> bool:
        """Count a gate's answer for one view search."""
        metrics.add("search.prefilter_admitted" if admit
                    else "search.prefilter_refused", 1)
        return admit

    def _lattice_prefiltered(self, store, view, q0, valid, tolerance: float,
                             band_lo: float, band_hi: float,
                             ctx_id: int | None, top: int):
        """Certified dialplan votes ``[B, A_pad]`` of one view, or None when
        any query's certificate fails (the caller full-scans). One ``[B]``
        readback (``[B, n_db]`` on a mesh: every shard must certify).
        Auto-split audios need no bail-out: the map min-combines their
        segment rows into one exact row."""
        if store.mesh is not None:
            votes, cert = sharded_lattice_prefiltered(
                store.mesh, store.sharded(view, store.value_map_for),
                store.sharded(view, store.value_map_q_for), q0, valid,
                tolerance, band_lo, band_hi, top=top,
                ctx_ids=(None if ctx_id is None
                         else store.sharded(view, store.ctx_ids_for)),
                ctx_id=ctx_id,
            )
        else:
            votes, cert = lattice_prefiltered_votes(
                store.value_map_for(view), store.value_map_q_for(view), q0,
                valid, tolerance, band_lo, band_hi, top=top,
                ctx_ids=None if ctx_id is None else store.ctx_ids_for(view),
                ctx_id=ctx_id,
            )
        certified = bool(cert.all())
        self._pf_note(view, "lattice", certified)
        return votes if certified else None

    def _aligned_prefiltered(self, store, view, q, active, use2, coefs: int,
                             tolerance: float, ctx_id: int | None, top: int,
                             aligned: bool):
        """Certified aligned (or, ``aligned=False``, strict bag) votes of
        one view, or None when any query's certificate fails or the view
        holds auto-split audios (their per-segment bounds cannot certify a
        summed winner, D15): the caller full-scans. One ``[B]`` readback
        (``[B, n_db]`` on a mesh: every shard must certify)."""
        if view.segments:
            return None
        if store.mesh is not None:
            specs, maps = store.sharded_bound_maps(view, coefs)
            votes, cert = sharded_aligned_prefiltered(
                store.mesh, store.sharded(view, lambda part: part.db), maps,
                q, active, use2, tolerance, specs, coefs,
                ctx_ids=(None if ctx_id is None
                         else store.sharded(view, store.ctx_ids_for)),
                ctx_id=ctx_id, top=top, k=match_kernels.PREFILTER_K,
                aligned=aligned,
                index=store.sharded(view, store.match_index_for),
            )
        else:
            specs, maps = store.bound_maps_for(view, coefs)
            votes, cert = aligned_prefiltered_votes(
                view.db, maps, q, active, use2, tolerance, specs=specs,
                coefs=coefs, k=match_kernels.PREFILTER_K,
                ctx_ids=None if ctx_id is None else store.ctx_ids_for(view),
                ctx_id=ctx_id, top=top, aligned=aligned,
                index=store.match_index_for(view),
            )
        certified = bool(cert.all())
        self._pf_note(view, "aligned" if aligned else "bag", certified)
        return votes if certified else None

    def _match(
        self, qfp: torch.Tensor, n_frames: np.ndarray, tolerance: float,
        freq_ignore_low: int, freq_ignore_high: int,
        ctx_id: int | None = None, coefs: int = 1, trunc_coef1: bool = True,
        aligned: bool = False, min_margin: float = 0.0,
        store: FingerprintStore | None = None,
    ) -> list[SearchResult]:
        """The match stage from query fingerprints ``qfp [B, F, C]`` (on the
        engine's device) to TIR* results, with one readback.

        Per view: :meth:`_view_votes`, then the top-1 with the D5 tiebreak
        and, when ``min_margin`` > 0, the best votes outside the winning
        column. A single-view store keeps the lowest ROW among the max
        votes (row order is insertion order within a tier); a multi-view
        store reduces each view to (votes, lowest insertion seq, row) and
        combines views by (votes desc, seq asc). The runner-up audio's
        votes are the maximum of the winning view's second best and every
        other view's best. ``store`` is the caller's snapshot (default: the
        current store); its views are read once."""
        store = self.store if store is None else store
        views = store.search_views()
        b = int(qfp.shape[0])
        if not views:
            return [
                SearchResult(STATUS_NOTFOUND, int(n_frames[i]), 0)
                for i in range(b)
            ]
        margin = min_margin > 0.0
        # a margin needs the runner-up audio exact too
        votes_of = self._view_votes(
            store, qfp, n_frames, tolerance, freq_ignore_low,
            freq_ignore_high, ctx_id, coefs, trunc_coef1, aligned,
            top=2 if margin else 1,
        )
        per_view = []
        with self._collectives():
            for view in views:
                votes = votes_of(view)
                with span("search.rank"):
                    per_view.append(self._top1_stats(
                        store, view, votes, len(views) == 1, margin))
        with span("search.readback"):
            got = torch.stack(per_view).cpu().numpy()  # the one readback
            # the device tensors go here, inside a span: their frees are
            # host time too
            del votes, per_view, votes_of
        with span("search.results"):
            if len(views) == 1:
                win = np.zeros(b, np.int64)
            else:
                # maximize votes, then minimize the (globally unique) seq
                order = np.lexsort((got[:, 1, :], -got[:, 0, :]), axis=0)
                win = order[0]
            results: list[SearchResult] = []
            for i in range(b):
                v = int(win[i])
                count = int(got[v, 0, i])
                fc = int(n_frames[i])
                if count <= 0 or (
                    margin and count - self._runner_up(got[:, :, i], v)
                    < min_margin * count
                ):
                    # no votes, or the runner-up audio is too close to call
                    results.append(SearchResult(STATUS_NOTFOUND, fc, 0))
                else:
                    entry = views[v].entries[int(got[v, 2, i])]
                    results.append(self._found(entry, fc, count))
        return results

    def _top1_stats(self, store, view, votes: torch.Tensor, alone: bool,
                    margin: bool) -> torch.Tensor:
        """One view's ``[3, B]`` int64 (votes, key, row) of each query's
        top-1 by the D5 tiebreak, and with ``margin`` a fourth row: the best
        votes outside that row. The key is the row where the view is
        ``alone``, else its insertion seq."""
        cols = torch.arange(votes.shape[1], device=self.device)
        key = cols if alone else store.seq_for(view)
        m, k, col = top1_by_key(votes, key)
        stats = [m.to(torch.int64), k, col]
        if margin:
            rest = torch.where(cols[None, :] == col[:, None], -1, votes)
            stats.append(rest.max(dim=1).values.to(torch.int64))
        return torch.stack(stats)

    @staticmethod
    def _merge_segments(store, view, votes: torch.Tensor) -> torch.Tensor:
        """Fold each auto-split audio's per-segment vote columns into its
        first column and zero the rest (PARITY.md D15, additive; the
        lattice path needs none: its map min-combines segment rows)."""
        followers, heads = store.segment_rows_for(view)
        if followers.numel() == 0:
            return votes
        votes = votes.index_add(1, heads, votes[:, followers])
        votes[:, followers] = 0
        return votes

    @staticmethod
    def _runner_up(stats: np.ndarray, win: int) -> int:
        """The best votes of any audio but the winner, from per-view
        ``stats [V, 4]`` = (votes, key, row, best outside that row)."""
        others = [stats[u, 0] for u in range(len(stats)) if u != win]
        return max(0, int(stats[win, 3]), *(int(x) for x in others))

    def search_pcm_topk(
        self,
        context: str | None,
        pcm: np.ndarray,
        samplerate: int,
        k: int = 5,
        coefs: int | None = None,
        tolerance: float | None = None,
        freq_ignore_low: int = -1,
        freq_ignore_high: int = -1,
        filter_context: bool = False,
        trunc_coef1: bool | None = None,
        aligned: bool | None = None,
        wire_law: str | None = None,
        min_margin: float | None = None,
    ) -> list[SearchResult]:
        """Ranked top-k candidates for one query (documented extension —
        the reference returns only the top-1 row, fp_handler.c:367-373),
        by (votes desc, insertion order asc — D5). Only audios with at
        least one vote appear. ``min_margin`` does not apply — a ranked
        listing SHOWS the margins; rejecting it here keeps a
        gate-configured caller from assuming the table was filtered.

        Each view's exact top-k is taken on the device and one ``[V, 3,
        k]`` tensor (votes, insertion seq, row) is read back; the k*V
        candidates merge on the host."""
        if min_margin:
            raise ValueError(
                "min_margin does not apply to ranked listings (the table "
                "shows every candidate; apply acceptance to the top-1 "
                "search instead)"
            )
        k = int(k)
        coefs, tolerance, lo, hi, trunc_coef1, aligned, _ = (
            self._resolve_search(
                coefs, tolerance, freq_ignore_low, freq_ignore_high,
                trunc_coef1, aligned, 0.0,
            )
        )
        store = self.store
        ctx_id = self._ctx_filter_id(store, context, filter_context)
        views = store.search_views()
        if not views or k < 1:
            return []
        with phase("search.match"), self._on_device():
            qfp, n_frames = self._query_fingerprints(
                [np.asarray(pcm)], samplerate, wire_law
            )
            # a certified top-k listing holds every row that reaches the
            # view's k-th best score, with its exact votes
            votes_of = self._view_votes(
                store, qfp, n_frames, tolerance, lo, hi, ctx_id, coefs,
                trunc_coef1, aligned, top=k,
            )
            with self._collectives():
                got = torch.stack([
                    topk_by_row(votes_of(view)[0], store.seq_for(view), k)
                    for view in views
                ])
            got = got.cpu().numpy()  # the one readback, [V, 3, k]
        metrics.add("search.queries", 1)
        fc = int(n_frames[0])
        # (-votes, seq, view, row): sorting IS the D5 order, seqs are unique
        cands = sorted(
            (-int(got[v, 0, j]), int(got[v, 1, j]), v, int(got[v, 2, j]))
            for v in range(len(views))
            for j in range(got.shape[2])
            if got[v, 0, j] > 0
        )
        return [
            self._found(views[v].entries[row], fc, -negv)
            for negv, _seq, v, row in cands[:k]
        ]

    def search_file(
        self,
        context: str | None,
        path: str,
        coefs: int | None = None,
        tolerance: float | None = None,
        freq_ignore_low: int = -1,
        freq_ignore_high: int = -1,
        filter_context: bool = False,
        trunc_coef1: bool | None = None,
        aligned: bool | None = None,
        min_margin: float | None = None,
    ) -> SearchResult:
        """fp_search_fingerprint_info over a file on disk (fp_handler.h:27-34)."""
        pcm, samplerate = read_audio(path)
        return self.search_pcm(
            context, pcm, samplerate, coefs=coefs, tolerance=tolerance,
            freq_ignore_low=freq_ignore_low,
            freq_ignore_high=freq_ignore_high, filter_context=filter_context,
            trunc_coef1=trunc_coef1, aligned=aligned, min_margin=min_margin,
        )

    @staticmethod
    def _ctx_filter_id(
        store: FingerprintStore, context: str | None, filter_context: bool
    ) -> int | None:
        """Device keep key of a filtered search, or None for the reference's
        scan-everything behavior (context=None keeps D7 even when asked)."""
        if not filter_context or context is None:
            return None
        return store.ctx_id_for(context)

    def _resolve_search(
        self,
        coefs: int | None,
        tolerance: float | None,
        freq_ignore_low: int,
        freq_ignore_high: int,
        trunc_coef1: bool | None,
        aligned: bool | None,
        min_margin: float | None,
    ) -> tuple[int, float, int, int, bool, bool, float]:
        """Config defaults and clamps shared by every search entry point
        (fp_handler.c:247-256; -1 band args = unspecified). Returns
        (coefs, tolerance, freq_ignore_low, freq_ignore_high, trunc_coef1,
        aligned, min_margin)."""
        mc: MatchConfig = self.config.match
        coefs = mc.coefs if coefs is None else coefs
        trunc_coef1 = mc.trunc_coef1 if trunc_coef1 is None else trunc_coef1
        aligned = mc.aligned if aligned is None else aligned
        mm = float(mc.min_margin if min_margin is None else min_margin)
        tolerance = mc.tolerance if tolerance is None else tolerance
        if freq_ignore_low < 0:
            freq_ignore_low = mc.freq_ignore_low
        if freq_ignore_high < 0:
            freq_ignore_high = mc.freq_ignore_high
        if tolerance < 0:
            tolerance = DEF_SEARCH_TOLERANCE  # fp_handler.c:252-256
        if coefs < 1 or coefs > self.config.dsp.n_coefs:
            raise ValueError(
                f"coefs must be in [1, {self.config.dsp.n_coefs}] "
                "(fp_handler.c:247-250)"
            )
        if not 0.0 <= mm < 1.0:
            raise ValueError(f"min_margin must be in [0, 1), got {mm}")
        return (int(coefs), float(tolerance), freq_ignore_low,
                freq_ignore_high, bool(trunc_coef1), bool(aligned), mm)

    def _resample_queries(
        self, pcms: list[np.ndarray], samplerate: int,
        law: str | None = None,
    ) -> tuple[list[np.ndarray], int, str | None]:
        """Force the configured analysis rate when set (DspConfig.samplerate
        > 0). G.711 batches that need resampling expand on the host first
        and continue as linear PCM."""
        target = self.config.dsp.samplerate
        if target > 0 and int(samplerate) != target:
            if law is not None:
                pcms = [g711_decode(p, law) for p in pcms]
                law = None
            pcms = [ensure_samplerate(p, samplerate, target)[0] for p in pcms]
            samplerate = target
        return pcms, int(samplerate), law

    # ---- hashing helpers (fp_generate_hash / fp_generate_uuid) --------- #

    @staticmethod
    def generate_hash(path: str) -> str:
        return file_md5(path)

    @staticmethod
    def generate_uuid() -> str:
        return generate_uuid()

    @staticmethod
    def _found(e: AudioEntry, frame_count: int, match_count: int) -> SearchResult:
        return SearchResult(
            status=STATUS_FOUND, frame_count=frame_count,
            match_count=match_count, uuid=e.uuid, name=e.name,
            context=e.context, hash=e.hash,
        )
