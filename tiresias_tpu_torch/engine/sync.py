"""Catalog <-> config <-> filesystem sync and batched ingest (port of
``tiresias_tpu.engine.sync``).

Reconciliation follows the reference's init-time flow
(reference app_tiresias.c:230-551): contexts absent from config
are deleted with their audios, audios whose MD5 left the directory are
deleted, new files are fingerprinted and added with MD5 dedupe.

Ingest is a three-stage pipeline: a bounded window of host threads decodes
and hashes files; full device batches are enqueued asynchronously on the
CUDA stream (:func:`tiresias_tpu_torch.ops.mfcc.fingerprint_signals_async`,
pinned non-blocking uploads); the readback and store write of batch *k* run
while batch *k+1* executes and later files decode. Batches are uniform in
(samplerate, wire format): 16-bit PCM ships as int16 and G.711 WAVs as their
raw uint8 codes, both expanded on the device. With a single-process ``mesh``
each batch is split evenly over every cell of the mesh
(:func:`tiresias_tpu_torch.parallel.sharding.sharded_fingerprint`).
"""

from __future__ import annotations

import dataclasses
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from itertools import islice

import numpy as np
import torch

from tiresias_tpu_torch.config import DspConfig, TiresiasConfig
from tiresias_tpu_torch.utils.audio import (
    ensure_samplerate,
    read_audio,
    read_wav_g711,
    read_wav_i16,
)
from tiresias_tpu_torch.utils.g711 import decode as g711_decode
from tiresias_tpu_torch.utils.hashing import file_md5
from tiresias_tpu_torch.utils.logging import get_logger
from tiresias_tpu_torch.ops.mfcc import (
    fingerprint_signals_async,
    mask_fingerprints,
    pad_frames_bucket,
)
from tiresias_tpu_torch.parallel.sharding import sharded_fingerprint
from tiresias_tpu_torch.store.fingerprint_store import FingerprintStore
from tiresias_tpu_torch.utils.device import resolve_device
from tiresias_tpu_torch.utils.tracing import span

log = get_logger(__name__)

# Max signals fingerprinted per device batch.
INGEST_BATCH = 512
# Frame bucket of ingest batches (finer than the search side's 128: a 3 s
# clip of 94 frames ships 2% padding instead of 36%).
INGEST_FRAME_MULTIPLE = 32
# Peak padded samples per device batch (64 clips x 30 s @ 8 kHz): bounds
# host and device memory when a directory mixes hour-long files and clips.
MAX_BATCH_PADDED_SAMPLES = 64 * 30 * 8000
# Host decode/hash pool width (I/O + GIL-releasing work).
HOST_DECODE_THREADS = 8


def batch_exceeds(count: int, longest: int) -> bool:
    """Would a batch of ``count`` signals padded to ``longest`` samples
    exceed either ingest bound?"""
    return count > INGEST_BATCH or count * longest > MAX_BATCH_PADDED_SAMPLES


@dataclasses.dataclass
class SyncReport:
    created: int = 0
    deduped: int = 0
    deleted: int = 0
    failed: int = 0

    def __iadd__(self, other: "SyncReport") -> "SyncReport":
        self.created += other.created
        self.deduped += other.deduped
        self.deleted += other.deleted
        self.failed += other.failed
        return self


def scan_directory(directory: str) -> list[str] | None:
    """Sorted file names (app_tiresias.c:553-572); None when the directory
    is unreadable, so a transient mount failure never reads as empty (which
    would delete every audio of the context)."""
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        log.error("could not scan directory %s", directory)
        return None
    return [n for n in names if os.path.isfile(os.path.join(directory, n))]


def hash_directory(directory: str) -> dict[str, str] | None:
    """{path: md5} for every readable file; None when unreadable."""
    names = scan_directory(directory)
    if names is None:
        return None
    paths = [os.path.join(directory, n) for n in names]
    out: dict[str, str] = {}
    with ThreadPoolExecutor(max_workers=HOST_DECODE_THREADS) as pool:
        for path, future in [(p, pool.submit(file_md5, p)) for p in paths]:
            try:
                out[path] = future.result()
            except OSError:
                continue
    return out


def delete_removed_audio(
    store: FingerprintStore,
    context: str,
    directory: str,
    disk_hashes: set[str] | None = None,
) -> int:
    """Delete entries whose MD5 no longer matches any file on disk
    (app_tiresias.c:431-551). An unreadable directory deletes nothing."""
    if disk_hashes is None:
        hashes = hash_directory(directory)
        if hashes is None:
            return 0
        disk_hashes = set(hashes.values())
    stale = [
        e for e in store.get_audios_by_context(context)
        if e.hash not in disk_hashes
    ]
    deleted = store.delete_audios(e.uuid for e in stale)
    for entry in stale:
        log.info("deleted stale audio %s (%s)", entry.name, entry.uuid)
    return deleted


def _load_one(path: str, known_hashes: dict[str, str] | None, dsp: DspConfig):
    """Decode + hash one file on a pool thread: 16-bit PCM stays int16,
    G.711 WAVs stay raw uint8 codes (unless they need resampling),
    anything else decodes to float."""
    digest = (known_hashes or {}).get(path) or file_md5(path)
    law = None
    decoded = read_wav_i16(path)
    if decoded is not None:
        pcm, samplerate = decoded
    else:
        g711 = read_wav_g711(path)
        if g711 is not None:
            pcm, samplerate, law = g711
        else:
            pcm, samplerate = read_audio(path)
    if law is not None and dsp.samplerate > 0 and int(samplerate) != int(
        dsp.samplerate
    ):
        pcm, law = g711_decode(pcm, law), None  # companded bytes can't filter
    pcm, samplerate = ensure_samplerate(pcm, samplerate, dsp.samplerate)
    return path, digest, pcm, samplerate, law


def ingest_files(
    store: FingerprintStore,
    context: str,
    paths: list[str],
    dsp: DspConfig | None = None,
    known_hashes: dict[str, str] | None = None,
    device: torch.device | str = "cuda",
    mesh=None,
) -> SyncReport:
    """Fingerprint new files in device batches and add them to the store.

    Dedupe is by (context, file MD5) (fp_handler.c:494-507); undecodable
    files are skipped and counted (app_tiresias.c:415-419). Paths are
    decoded in file-size order so batches pack near-uniform lengths.

    ``mesh``: a single-process :class:`~tiresias_tpu_torch.parallel.Mesh`;
    each batch is then padded with empty signals to a multiple of its cells
    and fingerprinted data-parallel over every cell (the multi-device
    scale-out of the reference's one-file-at-a-time loop,
    fp_handler.c:604-652), gathered on the mesh's home device."""
    device = mesh.home if mesh is not None else resolve_device(device)
    dsp = dsp or DspConfig()
    report = SyncReport()
    inflight = None  # at most one enqueued-but-undrained batch

    def drain(batch) -> None:
        items, fp_dev, n_frames = batch
        fps = mask_fingerprints(fp_dev.cpu().numpy(), n_frames)
        for i, (path, digest, _) in enumerate(items):
            entry = store.add_audio(
                name=os.path.basename(path), context=context,
                fingerprint=fps[i, : int(n_frames[i])], file_hash=digest,
            )
            if entry is None:
                report.deduped += 1
            else:
                report.created += 1
                log.info("ingested %s as %s", path, entry.uuid)

    def dispatch(samplerate: int, law: str | None, items: list) -> None:
        nonlocal inflight
        pcms = [pcm for _, _, pcm in items]
        with span("ingest.fingerprint_batch"):
            if mesh is None:
                fp_dev, n_frames = fingerprint_signals_async(
                    pcms, samplerate, dsp,
                    bucket_multiple=INGEST_FRAME_MULTIPLE, law=law,
                    device=device,
                )
            else:
                # the batch splits evenly over the mesh: drain reads only
                # the items' rows
                pcms += [np.zeros(0, pcms[0].dtype)] * (
                    -len(pcms) % mesh.size)
                padded, n_frames = pad_frames_bucket(
                    pcms, dsp.hop_size, INGEST_FRAME_MULTIPLE, law=law)
                n_valid = (np.array([len(p) for p in pcms], np.int32)
                           if law is not None else None)
                fp_dev = sharded_fingerprint(
                    mesh, padded, samplerate, dsp, law=law, n_valid=n_valid)
        prev, inflight = inflight, (items, fp_dev, n_frames)
        if prev is not None:
            drain(prev)

    def size_of(p: str) -> int:
        try:
            return os.path.getsize(p)
        except OSError:
            return 0

    buckets: dict[tuple[int, str | None], list] = {}
    seen: set[tuple[str, str]] = set()
    # bounded decode window: at most 2x the pool width of decoded signals
    # alive at once, however large the directory
    path_iter = iter(sorted(paths, key=size_of))
    with ThreadPoolExecutor(max_workers=HOST_DECODE_THREADS) as pool:
        pending = deque(
            pool.submit(_load_one, p, known_hashes, dsp)
            for p in islice(path_iter, 2 * HOST_DECODE_THREADS)
        )
        while pending:
            future = pending.popleft()
            nxt = next(path_iter, None)
            if nxt is not None:
                pending.append(pool.submit(_load_one, nxt, known_hashes, dsp))
            try:
                path, digest, pcm, samplerate, law = future.result()
            except Exception:  # noqa: BLE001 - any unreadable file is skipped
                log.warning("could not decode a file", exc_info=True)
                report.failed += 1
                continue
            del future  # the Future would otherwise pin the decoded signal
            if (context, digest) in seen or store.find_by_hash(context, digest):
                report.deduped += 1
                continue
            if len(pcm) == 0:
                log.warning("empty audio %s", path)
                report.failed += 1
                continue
            if pcm.dtype not in (np.int16, np.uint8) and not np.isfinite(
                pcm
            ).all():
                log.warning("non-finite samples in %s", path)
                report.failed += 1
                continue
            seen.add((context, digest))
            key = (int(samplerate), law)
            items = buckets.setdefault(key, [])
            if items and batch_exceeds(
                len(items) + 1, max(len(pcm), *(len(it[2]) for it in items))
            ):
                dispatch(key[0], key[1], items)
                items = buckets[key] = []
            items.append((path, digest, pcm))
    for (samplerate, law), items in buckets.items():
        if items:
            dispatch(samplerate, law, items)
    if inflight is not None:
        drain(inflight)
    return report


def sync_context_audio(
    store: FingerprintStore,
    context: str,
    directory: str,
    dsp: DspConfig | None = None,
    device: torch.device | str = "cuda",
    mesh=None,
) -> SyncReport:
    """delete-removed + create-new for one context (app_tiresias.c:324-358).
    A cold context skips the separate MD5 pass: ingest hashes each file on
    the decode pool instead. ``mesh``: as :func:`ingest_files`."""
    device = mesh.home if mesh is not None else resolve_device(device)
    report = SyncReport()
    if not store.get_audios_by_context(context):
        names = scan_directory(directory)
        if names is None:
            return report  # unreadable directory: a no-op, never a delete
        paths = [os.path.join(directory, n) for n in names]
        report += ingest_files(store, context, paths, dsp, None, device,
                               mesh)
        return report
    hashes = hash_directory(directory)
    if hashes is None:
        return report
    report.deleted = delete_removed_audio(
        store, context, directory, set(hashes.values())
    )
    report += ingest_files(store, context, list(hashes), dsp, hashes, device,
                           mesh)
    return report


def sync_contexts(store: FingerprintStore, config: TiresiasConfig) -> None:
    """Reconcile the store's contexts with config (app_tiresias.c:230-321)."""
    configured = {c.name: c.directory for c in config.contexts}
    for ctx in store.get_contexts_all():
        if ctx["name"] not in configured:
            store.delete_context(ctx["name"])
            log.info("deleted context %s (absent from config)", ctx["name"])
    for name, directory in configured.items():
        store.create_context(name, directory)


def sync_all(
    store: FingerprintStore,
    config: TiresiasConfig,
    checkpoint_dir: str | None = None,
    device: torch.device | str = "cuda",
    mesh=None,
) -> SyncReport:
    """Full init-time sync: contexts, then per-context audio, checkpointing
    after each context that changed (PARITY.md D2). ``mesh``: as
    :func:`ingest_files`."""
    device = mesh.home if mesh is not None else resolve_device(device)
    sync_contexts(store, config)
    total = SyncReport()
    for ctx in config.contexts:
        with span("sync.context"):
            report = sync_context_audio(
                store, ctx.name, ctx.directory, config.dsp, device, mesh
            )
        total += report
        if checkpoint_dir and (report.created or report.deleted):
            store.save(checkpoint_dir)
    return total
