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
acceptance) and are read back once. Ranked listings and mesh sharding raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading

import numpy as np
import torch

from tiresias_tpu_torch.config import (
    DEF_SEARCH_TOLERANCE,
    MatchConfig,
    TiresiasConfig,
)
from tiresias_tpu_torch.utils.audio import ensure_samplerate, read_audio
from tiresias_tpu_torch.utils.g711 import decode as g711_decode
from tiresias_tpu_torch.utils.locking import DataDirLock, DataDirLocked
from tiresias_tpu_torch.utils.logging import get_logger
from tiresias_tpu_torch.engine.sync import (
    SyncReport,
    sync_all,
    sync_context_audio,
)
from tiresias_tpu_torch.ops.match import prepare_query
from tiresias_tpu_torch.ops.match_kernels import (
    match_votes_fused,
    match_votes_fused_aligned,
)
from tiresias_tpu_torch.ops.match_lattice import band_thresholds, lattice_votes
from tiresias_tpu_torch.ops.mfcc import (
    fingerprint_padded_batch,
    fingerprint_signal,
    pad_frames_bucket,
)
from tiresias_tpu_torch.store.fingerprint_store import (
    AudioEntry,
    FingerprintStore,
)
from tiresias_tpu_torch.utils.device import resolve_device
from tiresias_tpu_torch.utils.tracing import metrics, phase

log = get_logger(__name__)

# TIRSTATUS values (reference application_handler.c:168-193)
STATUS_FOUND = "FOUND"
STATUS_NOTFOUND = "NOTFOUND"

# ROADMAP.md items that port what the engine does not serve yet
_ROADMAP_RANKED = "ROADMAP.md 1.12 (ranked and top-k search)"
_ROADMAP_MESH = "ROADMAP.md 1.13 (sharding over NCCL)"


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
        read-only engine, False is read-only by choice."""
        if mesh is not None:
            raise NotImplementedError(f"mesh sharding: {_ROADMAP_MESH}")
        self.device = resolve_device(device)
        self.config = config or TiresiasConfig()
        self._sync_mutex = threading.Lock()
        self.lock = DataDirLock(self.config.expanded_data_dir)
        if exclusive is not False:
            try:
                self.lock.acquire()
            except DataDirLocked as exc:
                if exclusive:
                    raise
                log.warning("engine is read-only: %s", exc)
        try:
            self.checkpoint_dir = os.path.join(
                self.config.expanded_data_dir, "checkpoint"
            )
            dsp = self.config.dsp
            if restore:
                self.store = FingerprintStore.load(
                    self.checkpoint_dir, n_coefs=dsp.n_coefs,
                    coef_weights=dsp.coef_weights, device=self.device,
                )
            else:
                self.store = FingerprintStore(
                    dsp.n_coefs, dsp.coef_weights, self.device
                )
            for ctx in self.config.contexts:
                self.store.create_context(ctx.name, ctx.directory)
        except BaseException:
            # a failed construction must not leave the data-dir lock held
            self.lock.release()
            raise

    # ---- lifecycle ---------------------------------------------------- #

    def _require_owner(self) -> None:
        if not self.lock.held:
            raise DataDirLocked(
                self.config.expanded_data_dir, self.lock.owner_info()
            )

    def sync(self) -> SyncReport:
        """Reconcile store with config + filesystem (app_tiresias.c:230-358),
        checkpointing after each changed context."""
        self._require_owner()
        with self._sync_mutex, phase("engine.sync"):
            return sync_all(
                self.store, self.config, self.checkpoint_dir, self.device
            )

    def sync_context(self, context: str) -> SyncReport:
        """Re-sync one context's directory, then checkpoint."""
        self._require_owner()
        ctx = self.store.get_context(context)
        if ctx is None or not ctx["directory"]:
            raise ValueError(f"unknown context {context!r}")
        with self._sync_mutex, phase("engine.sync"):
            report = sync_context_audio(
                self.store, context, ctx["directory"], self.config.dsp,
                self.device,
            )
            self.save()
            return report

    def save(self) -> None:
        self._require_owner()
        self.store.save(self.checkpoint_dir)

    def close(self) -> None:
        """fp_term equivalent (fp_handler.c:92-108): checkpoint and unlock."""
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
        coefs, tolerance, lo, hi, trunc_coef1, aligned, mm = (
            self._resolve_search(
                coefs, tolerance, freq_ignore_low, freq_ignore_high,
                trunc_coef1, aligned, min_margin,
            )
        )
        ctx_id = self._ctx_filter_id(context, filter_context)
        pcms, samplerate, wire_law = self._resample_queries(
            [np.asarray(p) for p in pcms], samplerate, wire_law
        )
        with phase("search.match"):
            padded, n_frames = pad_frames_bucket(
                pcms, self.config.dsp.hop_size, law=wire_law
            )
            n_valid = (
                np.array([len(p) for p in pcms], np.int32)
                if wire_law is not None else None
            )
            qfp = fingerprint_padded_batch(
                padded, samplerate, self.config.dsp, law=wire_law,
                n_valid=n_valid, device=self.device,
            )
            results = self._match(
                qfp, n_frames, tolerance, lo, hi, ctx_id, coefs=coefs,
                trunc_coef1=trunc_coef1, aligned=aligned, min_margin=mm,
            )
        metrics.add("search.queries", len(pcms))
        return results

    def _match(
        self, qfp: torch.Tensor, n_frames: np.ndarray, tolerance: float,
        freq_ignore_low: int, freq_ignore_high: int,
        ctx_id: int | None = None, coefs: int = 1, trunc_coef1: bool = True,
        aligned: bool = False, min_margin: float = 0.0,
    ) -> list[SearchResult]:
        """The match stage from query fingerprints ``qfp [B, F, C]`` (on the
        engine's device) to TIR* results, with one readback.

        Per view: votes — lattice votes (K3') for the dialplan
        configuration, K4/K5 over the view's fingerprints otherwise, with
        an auto-split audio's segment columns summed into its first column
        (D15, additive) — then the context filter, then the top-1 with the
        D5 tiebreak and, when ``min_margin`` > 0, the best votes outside
        the winning column. A single-view store keeps the lowest ROW among
        the max votes (row order is insertion order within a tier); a
        multi-view store reduces each view to (votes, lowest insertion seq,
        row) and combines views by (votes desc, seq asc). The runner-up
        audio's votes are the maximum of the winning view's second best
        and every other view's best."""
        views = self.store.search_views()
        b, f = int(qfp.shape[0]), int(qfp.shape[1])
        if not views:
            return [
                SearchResult(STATUS_NOTFOUND, int(n_frames[i]), 0)
                for i in range(b)
            ]
        dialplan = coefs == 1 and trunc_coef1 and not aligned
        if dialplan:
            band_lo, band_hi = band_thresholds(
                freq_ignore_low, freq_ignore_high
            )
            nf = torch.from_numpy(np.asarray(n_frames, np.int64)).to(
                self.device)
            valid = torch.arange(f, device=self.device)[None, :] < nf[:, None]
            q0 = qfp[..., 0].contiguous()
        else:
            q, active, use2 = prepare_query(
                qfp, n_frames, freq_ignore_low, freq_ignore_high, trunc_coef1
            )
            vote = match_votes_fused_aligned if aligned else match_votes_fused
        margin = min_margin > 0.0
        per_view = []
        for view in views:
            if dialplan:
                votes = lattice_votes(
                    self.store.value_map_for(view), q0, valid, tolerance,
                    band_lo, band_hi,
                )
            else:
                votes = self._merge_segments(
                    view, vote(view.db, q, active, use2, tolerance, coefs)
                )
            if ctx_id is not None:
                keep = self.store.ctx_ids_for(view) == ctx_id
                votes = torch.where(keep[None, :], votes, 0)
            cols = torch.arange(votes.shape[1], device=self.device)
            key = cols if len(views) == 1 else self.store.seq_for(view)
            m, k, col = top1_by_key(votes, key)
            stats = [m.to(torch.int64), k, col]
            if margin:
                rest = torch.where(cols[None, :] == col[:, None], -1, votes)
                stats.append(rest.max(dim=1).values.to(torch.int64))
            per_view.append(torch.stack(stats))
        got = torch.stack(per_view).cpu().numpy()  # the one readback
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

    def _merge_segments(self, view, votes: torch.Tensor) -> torch.Tensor:
        """Fold each auto-split audio's per-segment vote columns into its
        first column and zero the rest (PARITY.md D15, additive; the
        lattice path needs none: its map min-combines segment rows)."""
        followers, heads = self.store.segment_rows_for(view)
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

    def search_pcm_topk(self, *args, **kwargs) -> list[SearchResult]:
        raise NotImplementedError(f"search_pcm_topk: {_ROADMAP_RANKED}")

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

    def _ctx_filter_id(
        self, context: str | None, filter_context: bool
    ) -> int | None:
        """Device keep key of a filtered search, or None for the reference's
        scan-everything behavior (context=None keeps D7 even when asked)."""
        if not filter_context or context is None:
            return None
        return self.store.ctx_id_for(context)

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

    @staticmethod
    def _found(e: AudioEntry, frame_count: int, match_count: int) -> SearchResult:
        return SearchResult(
            status=STATUS_FOUND, frame_count=frame_count,
            match_count=match_count, uuid=e.uuid, name=e.name,
            context=e.context, hash=e.hash,
        )
