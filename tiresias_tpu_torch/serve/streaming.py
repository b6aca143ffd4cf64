"""Streaming recognition: many concurrent channels, batched scoring.

Batched rebuild of the ``Tiresias()`` dialplan application's runtime
(application_handler.c:66-312; port of ``tiresias_tpu.serve.streaming``):
where the reference
records each channel to a temp WAV on its own Asterisk thread and then runs
one per-call SQL search (``record_voice`` loop :248-312, search :180), here
each channel pushes PCM into an in-memory buffer and all channels that have
reached their recognition duration are scored **together** in one batched
device pass — the design that sustains 128+ concurrent 8 kHz streams
(BASELINE configs #3/#5). No temp-file round trip (a reference artifact,
SURVEY.md §3.2).

Reference semantics kept:
  * default duration 3000 ms (application_handler.c:60);
  * per-call overrides of tolerance/coefs/band args (:81-137);
  * hangup before the duration elapses → ``TIRSTATUS=HANGUP``, **no search**
    (:165-176, record_voice returns 0 on NULL frame :281-287);
  * the search runs with the engine's match defaults (dialplan: coefs=1).

Extension (documented): ``continuous=True`` keeps a sliding window per
channel and re-scores every ``duration_ms`` hop instead of closing after
the first result.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable

import numpy as np

from tiresias_tpu_torch.api.engine import (
    STATUS_HANGUP,
    STATUS_NOTFOUND,
    SearchResult,
    Tiresias,
)
from tiresias_tpu_torch.config import DEF_DURATION_MS
from tiresias_tpu_torch.utils.logging import get_logger
from tiresias_tpu_torch.utils.tracing import metrics, phase, span

log = get_logger(__name__)

# Robustness bounds for untrusted callers (the TCP protocol). The reference
# has no such bounds — its recording loop is naturally capped by wall-clock
# real time (one frame per ast_waitfor tick); a socket client can push audio
# arbitrarily faster than real time, so buffering must be explicit.
MAX_DURATION_MS = 600_000  # 10 min — longest recognition window
# Per-channel buffered-sample cap: a full window plus generous slack for
# faster-than-real-time feeds (file streaming) and continuous-mode history.
# A push that would exceed it raises — the caller answers a clean error.
MAX_BUFFER_SLACK_S = 30


def _to_bool(value, name: str) -> bool | None:
    """Coerce untrusted (e.g. JSON text protocol) booleans strictly."""
    if value is None or isinstance(value, bool):
        return value
    if isinstance(value, (int, float)) and value in (0, 1):
        return bool(value)
    if isinstance(value, str):
        low = value.strip().lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off", ""):
            return False
    raise ValueError(f"{name} must be a boolean, got {value!r}")


def _drop_front(chunks: list, n: int) -> list:
    """The chunk list minus its first ``n`` samples — views only, no
    sample is ever copied (the scorer's slide must be cheap under the
    global lock)."""
    out: list = []
    for i, c in enumerate(chunks):
        if n >= len(c):
            n -= len(c)
            continue
        out.append(c[n:] if n else c)
        out.extend(chunks[i + 1:])
        break
    return out


def _head_concat(chunks: list, need: int) -> np.ndarray:
    """The first ``need`` samples of a chunk list as one array — copies
    exactly ``need`` samples (not the whole buffer) and runs OUTSIDE the
    recognizer lock.

    Chunks keep the dtype they were pushed with: a pure-int16 channel
    (raw telephony, the TCP protocol's wire format) yields an int16
    window, which the engine ships to the device as-is — half the H2D
    bytes and half the host buffering of an eager float conversion. The
    device-side ``s * (1/32768)`` scaling is bit-identical to host-side
    ``astype(float32)/32768`` (both exact for int16 values), so results
    cannot differ. A channel that mixed dtypes gets its int16 parts
    promoted with the same exact scaling before the concat — a plain
    ``np.concatenate`` would promote WITHOUT the 1/32768 factor."""
    parts: list = []
    got = 0
    for c in chunks:
        if got >= need:
            break
        take = c if got + len(c) <= need else c[: need - got]
        parts.append(take)
        got += len(take)
    if not parts:
        return np.zeros(0, np.float32)
    if len(parts) == 1:
        return parts[0]
    if any(p.dtype != parts[0].dtype for p in parts):
        parts = [
            p.astype(np.float32) / 32768.0 if p.dtype == np.int16 else p
            for p in parts
        ]
    return np.concatenate(parts)


@dataclasses.dataclass
class ChannelState:
    """One live stream (the per-call state the reference keeps on its
    channel thread's stack)."""

    channel_id: str
    context: str | None
    duration_ms: int
    samplerate: int
    tolerance: float | None
    coefs: int | None
    freq_ignore_low: int
    freq_ignore_high: int
    trunc_coef1: bool | None
    aligned: bool | None
    min_margin: float | None  # margin acceptance (None = config)
    filter_context: bool
    continuous: bool
    law: str | None  # G.711 wire law ("ulaw"/"alaw"); None = linear PCM
    hop_ms: int | None  # continuous mode: slide step (None = tumbling)
    on_result: Callable[[str, SearchResult], None] | None
    chunks: list[np.ndarray] = dataclasses.field(default_factory=list)
    buffered: int = 0  # samples currently buffered
    skip_debt: int = 0  # samples still to discard (hop_ms > duration_ms)
    windows_taken: int = 0  # monotone per-channel window counter
    closed: bool = False

    @property
    def needed_samples(self) -> int:
        return int(self.samplerate * self.duration_ms / 1000)

    @property
    def hop_samples(self) -> int:
        if self.hop_ms is None:
            return self.needed_samples  # tumbling windows
        return max(1, int(self.samplerate * self.hop_ms / 1000))

    @property
    def max_buffered(self) -> int:
        """Per-channel buffered-sample bound: two full windows plus slack
        — room for faster-than-real-time feeds between scorer ticks without
        letting one client buffer unbounded memory."""
        return 2 * self.needed_samples + MAX_BUFFER_SLACK_S * self.samplerate


class StreamingRecognizer:
    """Batched sliding-window scorer over many concurrent channels."""

    def __init__(self, engine: Tiresias, samplerate: int = 8000) -> None:
        self.engine = engine
        self.samplerate = samplerate
        self._lock = threading.Lock()
        self._channels: dict[str, ChannelState] = {}

    # ------------------------------------------------------------------ #
    # channel lifecycle (≈ dialplan app invocation / hangup)
    # ------------------------------------------------------------------ #

    def open(
        self,
        channel_id: str,
        context: str | None = None,
        duration_ms: int = DEF_DURATION_MS,
        tolerance: float | None = None,
        coefs: int | None = None,
        freq_ignore_low: int = -1,
        freq_ignore_high: int = -1,
        trunc_coef1: bool | None = None,
        aligned: bool | None = None,
        filter_context: bool = False,
        continuous: bool = False,
        law: str | None = None,
        hop_ms: int | None = None,
        min_margin: float | None = None,
        on_result: Callable[[str, SearchResult], None] | None = None,
    ) -> None:
        """Start recognizing a channel — the ``Tiresias(context,duration,
        tolerance,low,high)`` argument contract
        (application_handler.c:81-137).

        ``continuous=True`` keeps the channel open and re-scores windows;
        ``hop_ms`` makes those windows overlap (slide by hop instead of a
        full duration — e.g. duration 3000/hop 500 re-scores the last 3 s
        every 0.5 s of new audio).

        All numeric arguments are validated/coerced HERE so a bad value from
        an untrusted source (e.g. the TCP protocol) raises at open time — a
        clean per-request error — instead of poisoning the shared scorer
        loop later."""
        duration_ms = int(duration_ms)
        if duration_ms <= 0:
            duration_ms = DEF_DURATION_MS
        if duration_ms > MAX_DURATION_MS:
            raise ValueError(
                f"duration_ms {duration_ms} exceeds the maximum "
                f"{MAX_DURATION_MS} (bound on per-channel buffering)"
            )
        if hop_ms is not None:
            hop_ms = int(hop_ms)
            if hop_ms <= 0:
                raise ValueError("hop_ms must be positive")
        if tolerance is not None:
            tolerance = float(tolerance)
        if min_margin is not None:
            min_margin = float(min_margin)
            if not 0.0 <= min_margin < 1.0:
                raise ValueError("min_margin must be in [0, 1)")
        if coefs is not None:
            coefs = int(coefs)
            n_coefs = self.engine.config.dsp.n_coefs
            if coefs < 1 or coefs > n_coefs:
                raise ValueError(
                    f"coefs must be in [1, {n_coefs}] (fp_handler.c:247-250)"
                )
        freq_ignore_low = int(freq_ignore_low)
        freq_ignore_high = int(freq_ignore_high)
        trunc_coef1 = _to_bool(trunc_coef1, "trunc_coef1")
        aligned = _to_bool(aligned, "aligned")
        if law is not None:
            from tiresias_tpu_torch.utils.g711 import G711_LAWS

            if law not in G711_LAWS:
                raise ValueError(
                    f"unknown wire law {law!r} (expected one of {G711_LAWS})"
                )
        filter_context = bool(_to_bool(filter_context, "filter_context"))
        continuous = bool(_to_bool(continuous, "continuous"))
        state = ChannelState(
            channel_id=channel_id,
            context=context,
            duration_ms=duration_ms,
            samplerate=self.samplerate,
            tolerance=tolerance,
            coefs=coefs,
            freq_ignore_low=freq_ignore_low,
            freq_ignore_high=freq_ignore_high,
            trunc_coef1=trunc_coef1,
            aligned=aligned,
            min_margin=min_margin,
            filter_context=filter_context,
            continuous=continuous,
            law=law,
            hop_ms=hop_ms,
            on_result=on_result,
        )
        with self._lock:
            live = self._channels.get(channel_id)
            if live is not None and not live.closed:
                # silently replacing a live channel would discard its
                # buffered audio with no error — the caller must hang up
                # first (a reconnect race is a real client bug to surface)
                raise ValueError(f"channel {channel_id!r} is already open")
            self._channels[channel_id] = state

    def push(self, channel_id: str, pcm: np.ndarray) -> bool:
        """Feed PCM (float32 [-1,1]) — the ast_read frame loop
        (application_handler.c:264-302, voice frames).

        Returns True when the channel now buffers at least one COMPLETE
        window: the TCP server uses this to wake its scorer immediately
        instead of waiting out the remainder of the 20 ms tick (the tick
        stays as the fallback pace for everything else)."""
        with self._lock:
            state = self._channels.get(channel_id)
            if state is None or state.closed:
                return False
            pcm = np.asarray(pcm).ravel()
            if state.law is not None:
                # G.711 channel: raw trunk bytes, ONE byte per sample, kept
                # undecoded to the device (ops/mfcc.to_float_pcm does the
                # 256-entry expansion there). Any other dtype is a
                # client format bug — reject loudly, don't guess.
                if pcm.dtype != np.uint8:
                    raise ValueError(
                        f"channel opened with law={state.law!r} expects "
                        f"uint8 G.711 codes, got {pcm.dtype}"
                    )
                if pcm.flags.writeable:
                    pcm = pcm.copy()
            elif pcm.dtype == np.uint8:
                raise ValueError(
                    "uint8 PCM on a linear channel (open the channel with "
                    "a G.711 format to send trunk bytes)"
                )
            elif pcm.dtype == np.int16:
                # raw telephony samples stay int16 all the way to the
                # device (half the H2D bytes and buffer RAM); the device
                # applies aubio's 1/32768 source scaling, bit-identical to
                # a host-side conversion (ops/mfcc.to_float_pcm).
                # Buffering by reference is
                # only safe when the caller cannot mutate the array later
                # (the TCP server's frombuffer-over-bytes frames) — a
                # writable input is copied, or a caller reusing one frame
                # buffer would alias every buffered chunk to its LAST
                # contents (the float path's astype always copied).
                if pcm.flags.writeable:
                    pcm = pcm.copy()
            else:
                pcm = pcm.astype(np.float32)
                if not np.isfinite(pcm).all():
                    # NaN/Inf frames would collapse to floor fingerprints
                    # that spuriously match silence; drop, don't poison
                    log.warning("dropped non-finite frame on %s", channel_id)
                    return False
            if state.skip_debt > 0:
                # still discarding toward the next window (hop > duration)
                take = min(state.skip_debt, len(pcm))
                state.skip_debt -= take
                pcm = pcm[take:]
                if not len(pcm):
                    return False
            if state.buffered + len(pcm) > state.max_buffered:
                raise ValueError(
                    f"channel buffer overflow: {state.buffered + len(pcm)} "
                    f"samples exceeds the {state.max_buffered}-sample bound "
                    "(client is pushing far ahead of scoring)"
                )
            state.chunks.append(pcm)
            state.buffered += len(pcm)
            return state.buffered >= state.needed_samples

    def hangup(
        self, channel_id: str, flush: bool = True
    ) -> SearchResult | None:
        """Channel died. Mid-recording → HANGUP status, no search
        (application_handler.c:165-176).

        With ``flush`` (default), a channel whose buffer already holds a
        FULL window is scored, not discarded: the reference searches as
        soon as ``duration`` is reached, so a hangup op racing the next
        scorer tick (client sends the last frame then hangs up
        immediately) must not turn a complete recording into ``HANGUP``.
        Pass ``flush=False`` when there is nobody left to deliver to (e.g.
        the socket already dropped) — the buffered audio is discarded
        without paying for a search. Returns None when the channel is
        unknown — including when the scorer already took its window; that
        in-flight search still delivers through the normal result path."""
        with self._lock:
            state = self._channels.pop(channel_id, None)
            window = None
            if (
                flush
                and state is not None
                and not state.closed
                and state.buffered >= state.needed_samples
            ):
                # pointer snapshot only; the O(samples) copy happens
                # below, outside the lock (same rule as _take_ready)
                window = state.chunks
        if window is not None:
            window = _head_concat(window, state.needed_samples)
        if state is None or state.closed:
            return None
        if window is not None:
            try:
                with span("serve.hangup_flush_search"):
                    result = self.engine.search_pcm(
                        state.context,
                        window,
                        self.samplerate,
                        coefs=state.coefs,
                        tolerance=state.tolerance,
                        freq_ignore_low=state.freq_ignore_low,
                        freq_ignore_high=state.freq_ignore_high,
                        filter_context=state.filter_context,
                        trunc_coef1=state.trunc_coef1,
                        aligned=state.aligned,
                        wire_law=state.law,
                        min_margin=state.min_margin,
                    )
            except Exception:  # noqa: BLE001 - same degradation as a tick
                log.exception("hangup flush search failed for %s", channel_id)
                metrics.add("serve.search_errors", 1)
                result = SearchResult(
                    status=STATUS_NOTFOUND, frame_count=0, match_count=0
                )
            result = dataclasses.replace(result, window=state.windows_taken)
            metrics.add("serve.windows_scored", 1)
        else:
            result = SearchResult(
                status=STATUS_HANGUP,
                frame_count=0,
                match_count=0,
                window=state.windows_taken,
            )
        if state.on_result:
            state.on_result(channel_id, result)
        return result

    def close(self, channel_id: str) -> None:
        with self._lock:
            self._channels.pop(channel_id, None)

    @property
    def n_channels(self) -> int:
        with self._lock:
            return len(self._channels)

    def is_open(self, channel_id: str) -> bool:
        with self._lock:
            state = self._channels.get(channel_id)
            return state is not None and not state.closed

    def has_ready(self) -> bool:
        """Whether any channel currently buffers a COMPLETE window — the
        server's scorer gates its passes on this (O(channels) pointer
        reads under the lock; the same predicate ``_take_ready`` uses, so
        a True here is exactly \"the next pass will take work\")."""
        with self._lock:
            return any(
                not s.closed and s.buffered >= s.needed_samples
                for s in self._channels.values()
            )

    # ------------------------------------------------------------------ #
    # batched scoring
    # ------------------------------------------------------------------ #

    def _take_ready(self) -> list[tuple[ChannelState, np.ndarray, int]]:
        """(state, window, window_index) per channel with a full window.

        The lock protects only O(chunks) POINTER work — snapshotting each
        ready channel's chunk list and sliding it by hop via views. The
        O(samples) concatenation happens OUTSIDE the lock: pushes arrive
        on the asyncio event loop, and copying ~12 MB for 128 ready 3 s
        channels under the global lock would stall every connection's IO
        for the duration of each scorer tick."""
        taken: list[tuple[ChannelState, list, int]] = []
        with self._lock:
            for state in list(self._channels.values()):
                need = state.needed_samples
                if state.buffered < need or state.closed:
                    continue
                chunks = state.chunks
                if state.continuous:
                    # slide by hop: keep duration−hop samples of history
                    # for overlapping windows; when hop exceeds what's
                    # buffered, carry the shortfall as debt so window
                    # spacing stays exactly one hop regardless of scorer
                    # timing. _drop_front slices views, it never copies.
                    hop = state.hop_samples
                    state.skip_debt += max(0, hop - state.buffered)
                    state.chunks = _drop_front(chunks, hop)
                    state.buffered = max(0, state.buffered - hop)
                else:
                    state.closed = True
                    del self._channels[state.channel_id]
                state.windows_taken += 1
                taken.append((state, chunks, state.windows_taken - 1))
        return [
            (state, _head_concat(chunks, state.needed_samples), idx)
            for state, chunks, idx in taken
        ]

    def process_ready(self) -> dict[str, SearchResult]:
        """Score every channel that has a full window — ONE batched device
        pass for all of them (grouped by identical search parameters so each
        group is a single ``search_pcm_batch`` call)."""
        ready = self._take_ready()
        if not ready:
            return {}
        groups: dict[tuple, list[tuple[ChannelState, np.ndarray, int]]] = {}
        for state, pcm, window in ready:
            key = (
                state.context,
                state.tolerance,
                state.coefs,
                state.freq_ignore_low,
                state.freq_ignore_high,
                state.trunc_coef1,
                state.aligned,
                state.filter_context,
                state.law,
                state.min_margin,
            )
            groups.setdefault(key, []).append((state, pcm, window))

        results: dict[str, SearchResult] = {}
        for key, items in groups.items():
            (context, tolerance, coefs, lo, hi, trunc, aligned, filt,
             law, min_margin) = key
            # the group goes to the engine as it is: eager PyTorch has no
            # per-shape programs, so no batch is padded to a bucket, and a
            # channel's result does not depend on who shares its pass
            pcms = [pcm for _, pcm, _ in items]
            try:
                with phase("serve.batch_search"):
                    batch_results = self.engine.search_pcm_batch(
                        context,
                        pcms,
                        self.samplerate,
                        coefs=coefs,
                        tolerance=tolerance,
                        freq_ignore_low=lo,
                        freq_ignore_high=hi,
                        filter_context=filt,
                        trunc_coef1=trunc,
                        aligned=aligned,
                        wire_law=law,
                        min_margin=min_margin,
                    )
            except Exception:  # noqa: BLE001
                # per-group error isolation: a failing search degrades those
                # channels to NOTFOUND, like the reference's failure path
                # (application_handler.c:171-176) —
                # other groups and future windows are unaffected.
                log.exception("batch search failed for %d channels", len(items))
                metrics.add("serve.search_errors", len(items))
                batch_results = [
                    SearchResult(status=STATUS_NOTFOUND, frame_count=0, match_count=0)
                ] * len(items)
            for (state, _, window), result in zip(items, batch_results):
                # stamp the per-channel window index: pipelined score
                # passes may complete out of order, and the counter lets
                # consumers (the TCP protocol includes it) reorder
                result = dataclasses.replace(result, window=window)
                results[state.channel_id] = result
                if state.on_result:
                    state.on_result(state.channel_id, result)
        metrics.add("serve.windows_scored", len(ready))
        return results
