"""``tiresias-torch`` command-line admin surface (port of
``tiresias_tpu.cli``: same tables, exit codes and proxy-to-a-live-server
behaviour, plus ``--device``).

Mirrors the reference's four Asterisk CLI commands
(cli_handler.c:26-31) with identical table layouts
(``%-36.36s %-70.70s`` for contexts, ``%-36.36s %-45.45s %-36.36s %-36.36s``
for audios — cli_handler.c:78,132) and result messages (:185,223), plus the
operations the reference only exposes implicitly (directory ingest happens
at module load; search only via dialplan):

    tiresias show contexts
    tiresias show audios <context>
    tiresias remove audio <uuid>
    tiresias remove context <name>
    tiresias create [<context>]        # directory sync/ingest
    tiresias search <context> <wav>... # one-shot (or batched) recognition

Config comes from ``--config tiresias.conf`` (same INI schema as
configuration.rst) or defaults. Commands that build an engine run on
``--device`` (default ``cuda``, which raises without a card; ``cpu`` runs
the kernels' plain PyTorch versions).
"""

from __future__ import annotations

import argparse
import os
import sys

from tiresias_tpu_torch.config import TiresiasConfig, load_config


DEFAULT_CONFIG_PATHS = (
    "./tiresias.conf",
    "~/.tiresias_tpu/tiresias.conf",
    # the reference's own location (configuration.rst)
    "/etc/asterisk/tiresias.conf",
)


def _find_config() -> str | None:
    for path in DEFAULT_CONFIG_PATHS:
        expanded = os.path.expanduser(path)
        if os.path.exists(expanded):
            return expanded
    return None


def _config(args) -> TiresiasConfig:
    path = args.config or _find_config()
    return load_config(path) if path else TiresiasConfig()


def _engine(args, exclusive: bool | None = None) -> "Tiresias":
    from tiresias_tpu_torch.api import Tiresias

    return Tiresias(_config(args), exclusive=exclusive, device=args.device)


def _proxy(config: TiresiasConfig):
    """AdminClient for the live server owning this data dir, or None.

    A running ``tiresias serve`` owns the data directory; admin commands
    must execute against ITS store (reference live-CLI semantics,
    cli_handler.c:26-31), never against a second
    engine racing its checkpoints."""
    from tiresias_tpu_torch.serve.admin import connect_for_data_dir

    return connect_for_data_dir(config.expanded_data_dir)


def _locked_msg(exc) -> int:
    print(
        f"Data directory is owned by a live process and no admin server "
        f"answered: {exc}",
        file=sys.stderr,
    )
    return 1


def _catalog_metadata(config: TiresiasConfig) -> dict:
    """Catalog-only read for the offline listing commands: contexts and
    entries WITHOUT deserializing the fingerprint tiers (a multi-GB
    checkpoint would otherwise load just to print a table).

    Config-declared contexts are merged in (config wins on directory),
    exactly as engine construction does (store.create_context after
    restore) — a configured-but-not-yet-ingested context must list with
    an empty table, not 'Could not find context info.'"""
    import os as _os

    from tiresias_tpu_torch.store.fingerprint_store import FingerprintStore

    meta = FingerprintStore.read_catalog_metadata(
        _os.path.join(config.expanded_data_dir, "checkpoint")
    ) or {"contexts": {}, "entries": []}
    for ctx in config.contexts:
        meta["contexts"][ctx.name] = ctx.directory
    return meta


def cmd_show_contexts(args) -> int:
    config = _config(args)
    proxy = _proxy(config)
    rows = None
    if proxy is not None:
        from tiresias_tpu_torch.serve.admin import AdminError

        try:
            with proxy:
                rows = proxy.admin("show_contexts")["contexts"]
        except AdminError as exc:
            # a server that refuses op=admin from this peer must not make
            # a read-only listing fail: fall back to the offline read
            if getattr(exc, "code", None) != "not_permitted":
                return _proxy_failed(exc)
        except Exception as exc:  # noqa: BLE001 - proxy I/O failure
            return _proxy_failed(exc)
    if rows is None:
        contexts = _catalog_metadata(config)["contexts"]
        rows = [{"name": n, "directory": d} for n, d in contexts.items()]
    print("%-36.36s %-70.70s" % ("Name", "Directory"))
    for ctx in rows:
        print("%-36.36s %-70.70s" % (ctx["name"], ctx["directory"]))
    return 0


def _proxy_failed(exc) -> int:
    print(f"Admin request to the running server failed: {exc}", file=sys.stderr)
    return 1


def cmd_show_audios(args) -> int:
    config = _config(args)
    proxy = _proxy(config)
    offline = proxy is None
    rows: list | None = None
    if proxy is not None:
        from tiresias_tpu_torch.serve.admin import AdminError

        try:
            with proxy:
                try:
                    rows = proxy.admin("show_audios", context=args.context)["audios"]
                except AdminError as exc:
                    code = getattr(exc, "code", None)
                    if code == "not_permitted":
                        # read-only listing must not fail on an admin-gated
                        # server: fall back to the offline catalog read
                        offline = True
                    elif code != "unknown_context":
                        # only an unknown context maps to the reference's
                        # "Could not find context info." — authorization or
                        # server-side failures say what actually happened
                        print(f"Admin request failed: {exc}", file=sys.stderr)
                        return 1
        except Exception as exc:  # noqa: BLE001 - proxy I/O failure
            return _proxy_failed(exc)
    if offline:
        meta = _catalog_metadata(config)
        rows = (
            None
            if args.context not in meta["contexts"]
            else [
                {"uuid": e["uuid"], "name": e["name"],
                 "context": e["context"], "hash": e["hash"]}
                for e in meta["entries"]
                if e["context"] == args.context
            ]
        )
    if rows is None:
        # cli_handler.c:128
        print(f"Could not find context info. context[{args.context}]")
        return 1
    print(
        "%-36.36s %-45.45s %-36.36s %-36.36s" % ("Uuid", "Name", "Context", "Hash")
    )
    for a in rows:
        print(
            "%-36.36s %-45.45s %-36.36s %-36.36s"
            % (a["uuid"], a["name"], a["context"], a["hash"])
        )
    return 0


def cmd_remove_audio(args) -> int:
    from tiresias_tpu_torch.utils.locking import DataDirLocked

    config = _config(args)
    proxy = _proxy(config)
    if proxy is not None:
        try:
            with proxy:
                ok = proxy.admin("remove_audio", uuid=args.uuid).get("removed")
        except Exception as exc:  # noqa: BLE001 - proxy I/O failure
            return _proxy_failed(exc)
    else:
        try:
            eng = _engine(args, exclusive=True)
        except DataDirLocked as exc:
            return _locked_msg(exc)
        try:
            ok = eng.delete_audio(args.uuid)
            if ok:
                eng.save()
        finally:
            eng.lock.release()  # free the data dir for the next command
    if not ok:
        print(f"Could not remove the audio info. uuid[{args.uuid}]")
        return 1
    print(f"Removed the audio info. uuid[{args.uuid}]")  # cli_handler.c:185
    return 0


def cmd_remove_context(args) -> int:
    from tiresias_tpu_torch.utils.locking import DataDirLocked

    config = _config(args)
    proxy = _proxy(config)
    if proxy is not None:
        try:
            with proxy:
                ok = proxy.admin("remove_context", context=args.name).get("removed")
        except Exception as exc:  # noqa: BLE001 - proxy I/O failure
            return _proxy_failed(exc)
    else:
        try:
            eng = _engine(args, exclusive=True)
        except DataDirLocked as exc:
            return _locked_msg(exc)
        try:
            ok = eng.delete_context(args.name)
            if ok:
                eng.save()
        finally:
            eng.lock.release()
    if not ok:
        print(f"Could not remove the context info. context[{args.name}]")
        return 1
    print(f"Removed the context info. context[{args.name}]")  # cli_handler.c:223
    return 0


def cmd_create(args) -> int:
    """Directory sync — the init_audio path the reference runs at module
    load (app_tiresias.c:324-358)."""
    from tiresias_tpu_torch.utils.locking import DataDirLocked

    config = _config(args)
    proxy = _proxy(config)
    if proxy is not None:
        from tiresias_tpu_torch.serve.admin import AdminError

        try:
            with proxy:
                try:
                    r = proxy.admin(
                        "sync",
                        **({"context": args.context} if args.context else {}),
                    )["sync"]
                except AdminError as exc:
                    if (
                        args.context
                        and getattr(exc, "code", None) == "unknown_context"
                    ):
                        print(
                            f"Could not find context info. context[{args.context}]"
                        )
                    else:
                        print("Sync failed on the running server.")
                    print(str(exc), file=sys.stderr)
                    return 1
        except Exception as exc:  # noqa: BLE001 - proxy I/O failure
            return _proxy_failed(exc)
        from types import SimpleNamespace

        report = SimpleNamespace(**r)
    else:
        try:
            eng = _engine(args, exclusive=True)
        except DataDirLocked as exc:
            return _locked_msg(exc)
        try:
            if args.context:
                try:
                    report = eng.sync_context(args.context)
                except ValueError:
                    print(f"Could not find context info. context[{args.context}]")
                    return 1
            else:
                report = eng.sync()
        finally:
            eng.lock.release()
    print(
        f"Sync complete. created[{report.created}] deduped[{report.deduped}] "
        f"deleted[{report.deleted}] failed[{report.failed}]"
    )
    return 0


def cmd_search(args) -> int:
    kwargs = dict(
        coefs=args.coefs,
        tolerance=args.tolerance,
        freq_ignore_low=args.freq_ignore_low,
        freq_ignore_high=args.freq_ignore_high,
        filter_context=args.filter_context,
        trunc_coef1=None if args.exact is None else not args.exact,
        min_margin=getattr(args, "min_margin", None),
    )
    files = args.file if isinstance(args.file, list) else [args.file]
    if len(files) > 1:
        if args.top is not None:
            print("--top supports a single file", file=sys.stderr)
            return 1
        return _search_many(args, files, kwargs)
    args.file = files[0]
    config = _config(args)
    # a RUNNING server answers one-shot searches (and --top listings)
    # against its live store (the dialplan app's operational model — the
    # reference searches inside the owning module process) without this
    # process paying a cold engine restore of the whole checkpoint
    proxy = _proxy(config)
    if proxy is not None:
        from tiresias_tpu_torch.serve.admin import AdminError

        rc = None
        try:
            with proxy:
                rc = _search_via_server(proxy, args, kwargs)
        except AdminError as exc:
            if getattr(exc, "code", None) != "not_permitted":
                return _proxy_failed(exc)
            # admin-gated server: fall through to the offline engine
        except Exception as exc:  # noqa: BLE001 - proxy I/O failure
            return _proxy_failed(exc)
        if rc is not None:
            return rc
    # read-only: a one-shot recognition must work alongside a live server
    eng = _engine(args, exclusive=False)
    if args.top is not None:  # any explicit --top N prints the ranked table
        from tiresias_tpu_torch.utils.audio import read_audio

        pcm, sr = read_audio(args.file)
        ranked = eng.search_pcm_topk(args.context, pcm, sr, k=args.top, **kwargs)
        return _print_ranked([
            (r.uuid, r.name, r.match_count, r.confidence) for r in ranked
        ])
    res = eng.search_file(args.context, args.file, **kwargs)
    for key, value in res.to_channel_vars().items():
        print(f"{key}={value}")
    print(f"CONFIDENCE={res.confidence:.4f}")
    return 0 if res.found else 2


def cmd_stats(args) -> int:
    """Operational snapshot: the RUNNING server's stats op when one owns
    the data dir (channels, audios, checkpoint generation, search p50),
    else a catalog-metadata summary — never a full store load."""
    config = _config(args)
    proxy = _proxy(config)
    if proxy is not None:
        try:
            with proxy:
                stats = proxy.request({"op": "stats"})["stats"]
        except Exception as exc:  # noqa: BLE001 - proxy I/O failure
            return _proxy_failed(exc)
        for key in ("channels", "audios", "generation", "owner",
                    "search_p50_ms"):
            print(f"{key}: {stats.get(key)}")
        return 0
    meta = _catalog_metadata(config)
    print(
        f"no running server; checkpoint generation {meta.get('gen', 0)}: "
        f"{len(meta['entries'])} audios in {len(meta['contexts'])} contexts"
    )
    return 0


def _reload_config_fn(args):
    """Reload callback bound to the conf path resolved at startup:
    missing file → raise (the server keeps its current config); started
    with no conf at all → None (reload just re-syncs)."""
    path = args.config or _find_config()
    if path is None:
        return None

    def reload_config():
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"conf file {path!r} (resolved at startup) is gone; "
                "refusing to reload into an empty config"
            )
        return load_config(path)

    return reload_config


def cmd_serve(args) -> int:
    from tiresias_tpu_torch.serve.server import run_server
    from tiresias_tpu_torch.utils.locking import DataDirLocked

    # validate BEFORE the engine restore + warmup — RecognitionServer
    # would reject it only after all that work
    if args.watch is not None and args.watch <= 0:
        print("serve: --watch must be positive seconds", file=sys.stderr)
        return 2
    if args.follow is not None and args.follow <= 0:
        print("serve: --follow must be positive seconds", file=sys.stderr)
        return 2
    if args.replica and args.watch is not None:
        print("serve: --watch needs ownership; replicas use --follow",
              file=sys.stderr)
        return 2
    if args.follow is not None and not args.replica:
        print("serve: --follow requires --replica", file=sys.stderr)
        return 2
    warm_laws = _warm_laws(args, "serve")
    if warm_laws is None:
        return 2
    if args.replica:
        # read-only replica by choice (never touches the lock): the OWNER
        # (another `tiresias serve` or the ingest CLI) mutates and
        # checkpoints; this process serves reads and follows committed
        # generations
        eng = _engine(args, exclusive=False)
    else:
        try:
            # the server must OWN the data dir: it checkpoints mutations
            eng = _engine(args, exclusive=True)
        except DataDirLocked as exc:
            return _locked_msg(exc)
        eng.sync()
    run_server(
        eng, host=args.host, port=args.port, samplerate=args.samplerate,
        max_channels=args.max_channels, admin=args.admin,
        watch_interval=args.watch, follow_interval=args.follow,
        warm_laws=warm_laws,
        # SIGHUP / admin 'reload' re-parse the conf file resolved AT
        # STARTUP. Re-resolving the search path at reload time would (a)
        # silently switch conf if a higher-priority file appeared, and
        # (b) worse: if the file disappeared, fall back to an EMPTY
        # default config whose sync would delete every context — a
        # missing file must fail the reload, not wipe the store.
        reload_config=_reload_config_fn(args),
    )
    return 0


def _warm_laws(args, command: str) -> tuple[str, ...] | None:
    """G.711 laws of ``--wire-formats`` (None, after a message, when the
    list names an unknown format)."""
    from tiresias_tpu_torch.utils.g711 import WIRE_FORMATS

    fmts = [f.strip() for f in args.wire_formats.split(",") if f.strip()]
    bad = [f for f in fmts if f not in WIRE_FORMATS]
    if bad:
        print(
            f"{command}: unknown --wire-formats {bad} (choose from "
            f"{', '.join(WIRE_FORMATS)})", file=sys.stderr,
        )
        return None
    return tuple(f for f in fmts if f != "l16")


def cmd_warmup(args) -> int:
    """Take a serving config's first-use costs now and report the bill:
    build the CUDA kernel library into its build directory (the one cost
    that outlives this process — a later server on the same checkout loads
    the built library instead of compiling it), then run the searches and
    build the maps a server start would, so their time is known before
    traffic cutover."""
    import time as _time

    from tiresias_tpu_torch.serve.server import warmup_batch_sizes
    from tiresias_tpu_torch.utils import build

    warm_laws = _warm_laws(args, "warmup")
    if warm_laws is None:
        return 2
    # read-only: warmup only searches; it can run next to a live server
    eng = _engine(args, exclusive=False)
    sizes = warmup_batch_sizes(args.max_channels)
    print(
        f"warming batch sizes {sizes} x {2 + len(warm_laws)} wire dtypes "
        f"(+ search maps) at {args.samplerate} Hz / {args.duration_ms} ms "
        f"on {eng.device}; kernel build directory {build.build_dir()}",
        flush=True,
    )
    t0 = _time.perf_counter()
    eng.warmup(
        samplerate=args.samplerate, duration_ms=args.duration_ms,
        batch_sizes=sizes, laws=warm_laws,
    )
    total = _time.perf_counter() - t0
    built = build.build_seconds()
    print(
        f"warmup complete in {total:.1f}s (kernel library build + load: "
        + ("none on the CPU" if built is None else f"{built:.1f}s") + ")",
        flush=True,
    )
    eng.close()
    return 0


def cmd_fsck(args) -> int:
    """Offline checkpoint integrity check (store.fsck_checkpoint) — the
    ops safety net the reference's single SQLite file never had."""
    import os as _os

    from tiresias_tpu_torch.store.fingerprint_store import fsck_checkpoint

    config = _config(args)
    directory = _os.path.join(config.expanded_data_dir, "checkpoint")
    if not _os.path.isdir(directory):
        print(f"no checkpoint at {directory}")
        return 1
    from tiresias_tpu_torch.utils.locking import DataDirLock, read_server_info

    info = read_server_info(config.expanded_data_dir)
    if info is None:
        # non-server owners too (an offline ingest mid-save): lockfile
        # content persists while held; a stale crashed-owner file has a
        # dead pid and is ignored
        owner = DataDirLock(config.expanded_data_dir).owner_info()
        if owner:
            try:
                _os.kill(int(owner.get("pid", -1)), 0)
                info = owner
            except (OSError, ValueError, TypeError):
                info = None
    if info:
        # a live owner rotates generations and GCs superseded segment
        # files WHILE we read: a healthy store can transiently look
        # corrupt. Diagnose anyway (read-only), but say so.
        print(
            f"WARNING: data dir is owned by a live process "
            f"(pid {info.get('pid')}); save rotations during this check "
            "can report transient missing/unreadable segments — prefer "
            "a quiesced copy for a definitive verdict",
            file=sys.stderr,
        )
    report = fsck_checkpoint(
        directory, deep=args.deep, n_coefs=config.dsp.n_coefs
    )
    for label in ("current", "bak"):
        gen = report["generations"].get(label)
        if gen is None:
            print(f"{label:8s} absent")
            continue
        if gen["ok"]:
            tiers = gen.get("tiers", {})
            rows = sum(t["rows"] for t in tiers.values())
            dead = sum(t["dead"] for t in tiers.values())
            print(
                f"{label:8s} OK   v{gen['version']} gen={gen['gen']} "
                f"entries={gen['entries']} contexts={gen['contexts']} "
                f"tiers={len(tiers)} rows={rows} dead={dead}"
            )
        else:
            print(f"{label:8s} BAD  {'; '.join(gen['errors'][:4])}")
    orphans = report["orphans"]
    if orphans["count"]:
        print(
            f"orphans  {orphans['count']} unreferenced segment files "
            f"({orphans['bytes'] / 2**20:.1f} MiB — crash debris, "
            "reclaimed by the next save rotation)"
        )
    if args.deep:
        d = report["deep"]
        if d["ok"]:
            print(
                f"deep     OK   full restore: gen={d['gen']} "
                f"entries={d['entries']} contexts={d['contexts']}"
            )
        else:
            print(f"deep     BAD  {d.get('error')}")
    print("checkpoint OK" if report["ok"] else "checkpoint NOT OK")
    return 0 if report["ok"] else 1


def cmd_reload(args) -> int:
    """Live config reload on the running server (`kill -HUP` equivalent
    over the admin protocol). The reference declines reload outright —
    unload/load required (app_tiresias.c:608-614)."""
    config = _config(args)
    proxy = _proxy(config)
    if proxy is None:
        print(
            "reload: no running server owns this data dir (offline, the "
            "next start picks the conf up; to ingest now use "
            "`tiresias create`)",
            file=sys.stderr,
        )
        return 1
    from tiresias_tpu_torch.serve.admin import AdminError

    try:
        with proxy:
            try:
                r = proxy.admin("reload")
            except AdminError as exc:
                print(f"reload failed on the running server: {exc}",
                      file=sys.stderr)
                return 1
    except Exception as exc:  # noqa: BLE001 - proxy I/O failure
        return _proxy_failed(exc)
    rep = r.get("sync", {})
    print(
        f"Reloaded. contexts[{', '.join(r.get('contexts', []))}] "
        f"created[{rep.get('created', 0)}] deleted[{rep.get('deleted', 0)}]"
    )
    return 0


def cmd_bench(args) -> int:
    print(
        "bench: the port has no benchmark harness yet (ROADMAP.md item 8); "
        "chip_smoke.py measures the port on the card",
        file=sys.stderr,
    )
    return 1


def _search_many(args, files, kwargs) -> int:
    """Batched recognition over many files in one table.

    Extension over the reference (its dialplan app recognizes one
    recording at a time, application_handler.c:151-164);
    all files sharing a samplerate go through the store in ONE batched
    device pass (`search_pcm_batch`), which is where the device's batch
    throughput shows up at the CLI. A RUNNING server answers instead from
    its LIVE store (same proxy rule as the single-file path — an offline
    engine would miss un-checkpointed live audios); otherwise a read-only
    engine serves the batch alongside any server. Exit code: 1 if any
    file was unreadable, else 2 if any was NOTFOUND, else 0."""
    from tiresias_tpu_torch.utils.audio import read_audio

    proxy = _proxy(_config(args))
    if proxy is not None:
        from tiresias_tpu_torch.serve.admin import AdminError

        rc = None
        try:
            with proxy:
                rc = _search_many_via_server(proxy, args, files, kwargs)
        except AdminError as exc:
            if getattr(exc, "code", None) != "not_permitted":
                return _proxy_failed(exc)
            # admin-gated server: fall through to the offline engine
        except Exception as exc:  # noqa: BLE001 - proxy I/O failure
            return _proxy_failed(exc)
        if rc is not None:
            return rc
    eng = _engine(args, exclusive=False)
    errors: dict[int, str] = {}
    by_rate: dict[int, list[tuple[int, "object"]]] = {}
    for i, path in enumerate(files):
        try:
            pcm, sr = read_audio(path)
        except (OSError, ValueError) as exc:
            errors[i] = str(exc)
            continue
        by_rate.setdefault(int(sr), []).append((i, pcm))
    results: dict[int, "object"] = {}
    for sr, items in sorted(by_rate.items()):
        batch = eng.search_pcm_batch(
            args.context, [p for _, p in items], sr, **kwargs
        )
        for (i, _), res in zip(items, batch):
            results[i] = res

    def row_for(i):
        r = results[i]
        return r.found, r.name, r.match_count, r.frame_count, r.confidence

    return _print_search_table(files, errors, row_for)


def _print_search_table(files, errors, row_for) -> int:
    """The multi-file result table + exit code — ONE implementation so the
    proxied and offline variants of ``tiresias search`` cannot drift.
    ``row_for(i) -> (found, name, votes, frames, confidence)`` for every
    index not in ``errors``."""
    print("%-30.30s %-9s %-45.45s %-7s %-7s %-10s" % (
        "File", "Status", "Name", "Votes", "Frames", "Confidence"))
    missed = False
    for i, path in enumerate(files):
        base = os.path.basename(path)
        if i in errors:
            print("%-30.30s %-9s %s" % (base, "ERROR", errors[i]))
            continue
        found, name, votes, frames, confidence = row_for(i)
        print("%-30.30s %-9s %-45.45s %-7d %-7d %-10.4f" % (
            base,
            "FOUND" if found else "NOTFOUND",
            name if found else "-",
            votes,
            frames,
            confidence,
        ))
        missed = missed or not found
    if errors:
        return 1
    return 2 if missed else 0


def _pcm_wire_query(pcm, sr) -> dict | None:
    """One query payload for the admin ``search`` op, or None when it
    exceeds the protocol line bound (caller falls back offline).

    float32 on the wire: quantizing to int16 here could flip frames
    sitting within quantization error of the tolerance band, making the
    proxied search differ from the offline one for >16-bit sources."""
    import base64

    import numpy as np

    from tiresias_tpu_torch.serve.server import MAX_LINE_BYTES

    body = base64.b64encode(np.asarray(pcm, dtype="<f4").tobytes()).decode()
    if len(body) > MAX_LINE_BYTES - 4096:
        return None
    return {"pcm": body, "dtype": "f32", "samplerate": int(sr)}


def _wire_row(result: dict):
    """Table row from an admin-search reply payload (TIR* dict)."""
    return (
        result.get("TIRSTATUS") == "FOUND",
        result.get("TIRFILENAME", "-"),
        int(result.get("TIRMATCHCOUNT", 0)),
        int(result.get("TIRFRAMECOUNT", 0)),
        float(result.get("CONFIDENCE", 0.0)),
    )


def _search_many_via_server(proxy, args, files, kwargs) -> int | None:
    """The multi-file table answered from the RUNNING server's live store.

    ONE admin round trip carrying every query; the server runs one batched
    device pass per samplerate (the same design as the offline path), so
    the table costs one RTT instead of one per file. Returns None — caller
    falls back to the offline batched engine — when the combined payload
    exceeds the protocol line bound, so the whole table always answers
    from ONE store view (mixing live and checkpoint answers per row would
    be incoherent)."""
    from tiresias_tpu_torch.serve.server import MAX_LINE_BYTES
    from tiresias_tpu_torch.utils.audio import read_audio

    queries: dict[int, dict] = {}
    errors: dict[int, str] = {}
    total = 0
    for i, path in enumerate(files):
        try:
            pcm, sr = read_audio(path)
        except (OSError, ValueError) as exc:
            errors[i] = str(exc)
            continue
        q = _pcm_wire_query(pcm, sr)
        if q is None:
            return None  # oversized for the protocol — offline serves all
        total += len(q["pcm"]) + 256  # + per-query JSON framing slack
        if total > MAX_LINE_BYTES - 4096:
            return None  # the COMBINED request is one protocol line
        queries[i] = q
    answers: dict[int, dict] = {}
    if queries:
        req = {"context": args.context, "queries": list(queries.values())}
        req.update({k: v for k, v in kwargs.items() if v is not None})
        results = proxy.admin("search", **req)["results"]
        answers = dict(zip(queries.keys(), results))
    return _print_search_table(
        files, errors, lambda i: _wire_row(answers[i])
    )


def _print_ranked(rows) -> int:
    """Ranked --top table from (uuid, name, votes, confidence) rows —
    shared by the offline engine and the live-server proxy."""
    if not rows:
        print("TIRSTATUS=NOTFOUND")
        return 2
    print("%-4s %-36.36s %-45.45s %-10s %-10s" % (
        "Rank", "Uuid", "Name", "Votes", "Confidence"))
    for rank, (uuid, name, votes, conf) in enumerate(rows, 1):
        print("%-4d %-36.36s %-45.45s %-10d %-10.4f" % (
            rank, uuid, name, int(votes), float(conf)))
    return 0


def _search_via_server(proxy, args, kwargs) -> int:
    """One-shot recognition (or --top listing) proxied to the live
    server's store."""
    from tiresias_tpu_torch.utils.audio import read_audio

    try:
        pcm, sr = read_audio(args.file)
    except (OSError, ValueError) as exc:
        # a local decode problem must not read as "the server failed"
        print(f"cannot read {args.file}: {exc}", file=sys.stderr)
        return 1
    payload = _pcm_wire_query(pcm, sr)
    if payload is None:
        return None  # too big for one protocol line — offline path serves it
    payload["context"] = args.context
    payload.update({k: v for k, v in kwargs.items() if v is not None})
    if args.top is not None:
        if args.top > 1024:
            return None  # beyond the protocol cap — offline path serves it
        payload["top"] = args.top
        ranked = proxy.admin("search", **payload).get("ranked")
        if ranked is None:
            # a server predating the 'top' op answered with a plain
            # result — serve the listing offline instead of crashing
            return None
        return _print_ranked([
            (p.get("TIRFILEUUID", ""), p.get("TIRFILENAME", ""),
             p.get("TIRMATCHCOUNT", 0), p.get("CONFIDENCE", 0.0))
            for p in ranked
        ])
    result = proxy.admin("search", **payload)["result"]
    for key, value in result.items():
        print(f"{key}={value}")
    return 0 if result.get("TIRSTATUS") == "FOUND" else 2


def _top_n(value: str) -> int:
    n = int(value)
    if n < 1:
        # reject instead of silently falling back to the single-result
        # path — a typo like `--top -5` must not masquerade as success
        raise argparse.ArgumentTypeError("N must be a positive integer")
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tiresias-torch",
        description="audio fingerprinting and recognition (PyTorch/CUDA)",
    )
    from tiresias_tpu_torch import __version__

    p.add_argument("-c", "--config", help="tiresias.conf-style INI file "
                   f"(default: first of {', '.join(DEFAULT_CONFIG_PATHS)})")
    p.add_argument("--version", action="version", version=f"tiresias-tpu {__version__}")
    p.add_argument(
        "--profile",
        metavar="DIR",
        help="capture a torch.profiler trace of the command into "
        "DIR/trace.json (Chrome trace format)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="device of every engine the command builds: cuda (default; "
        "raises without a card) or cpu (plain PyTorch versions of the "
        "kernels)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    show = sub.add_parser("show", help="list contexts or audios")
    show_sub = show.add_subparsers(dest="what", required=True)
    show_sub.add_parser("contexts").set_defaults(func=cmd_show_contexts)
    sa = show_sub.add_parser("audios")
    sa.add_argument("context")
    sa.set_defaults(func=cmd_show_audios)

    rm = sub.add_parser("remove", help="remove an audio or context")
    rm_sub = rm.add_subparsers(dest="what", required=True)
    ra = rm_sub.add_parser("audio")
    ra.add_argument("uuid")
    ra.set_defaults(func=cmd_remove_audio)
    rc = rm_sub.add_parser("context")
    rc.add_argument("name")
    rc.set_defaults(func=cmd_remove_context)

    cr = sub.add_parser("create", help="ingest configured directories")
    cr.add_argument("context", nargs="?")
    cr.set_defaults(func=cmd_create)

    se = sub.add_parser("search", help="recognize one or more WAV files")
    se.add_argument("context")
    se.add_argument(
        "file",
        nargs="+",
        help="audio file(s); multiple files are recognized in one batched "
        "device pass and printed as a table",
    )
    se.add_argument("--coefs", type=int, default=None)
    se.add_argument("--tolerance", type=float, default=None)
    se.add_argument("--freq-ignore-low", type=int, default=-1)
    se.add_argument("--freq-ignore-high", type=int, default=-1)
    se.add_argument(
        "--filter-context",
        action="store_true",
        help="restrict the scan to the named context (the reference scans "
        "all contexts — PARITY.md D7)",
    )
    se.add_argument(
        "--top",
        type=_top_n,
        default=None,
        metavar="N",
        help="print a ranked table of the top-N candidates instead of the "
        "single TIR* result (extension; the reference returns top-1 only)",
    )
    se.add_argument(
        "--exact",
        action="store_true",
        default=None,
        help="disable the reference's integer truncation of max1 for "
        "small-tolerance recognition (PARITY.md D8)",
    )
    se.add_argument(
        "--min-margin",
        type=float,
        default=None,
        metavar="M",
        help="accept only when the winner's votes beat the runner-up "
        "audio's by this fraction (the noise operating point; "
        "docs/performance.md)",
    )
    se.set_defaults(func=cmd_search)

    fs = sub.add_parser(
        "fsck",
        help="verify checkpoint integrity offline (catalog, segment "
        "shapes, dead rows, orphans); --deep performs a full restore",
    )
    fs.add_argument("--deep", action="store_true",
                    help="additionally run the exact restore a server "
                    "startup would (loads every segment)")
    fs.set_defaults(func=cmd_fsck)

    rl = sub.add_parser(
        "reload",
        help="re-parse the conf file and re-sync the RUNNING server "
        "(same as kill -HUP on it); DSP/data_dir changes are rejected",
    )
    rl.set_defaults(func=cmd_reload)

    be = sub.add_parser(
        "bench", help="not ported yet (ROADMAP.md item 8); returns 1"
    )
    be.add_argument("--section", default=None, help="ignored")
    be.set_defaults(func=cmd_bench)

    st = sub.add_parser(
        "stats", help="running server's stats, or a checkpoint summary"
    )
    st.set_defaults(func=cmd_stats)

    wu = sub.add_parser(
        "warmup",
        help="build the kernel library and run a server start's warm-up "
        "searches and map builds, reporting their time (run before "
        "traffic cutover / after upgrades)",
    )
    wu.add_argument("--samplerate", type=int, default=8000)
    wu.add_argument("--duration-ms", type=int, default=3000,
                    dest="duration_ms")
    wu.add_argument("--max-channels", type=int, default=128,
                    dest="max_channels")
    wu.add_argument(
        "--wire-formats", default="", dest="wire_formats", metavar="LIST",
        help="comma-separated G.711 formats to warm alongside l16",
    )
    wu.set_defaults(func=cmd_warmup)

    sv = sub.add_parser("serve", help="run the TCP recognition service")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8517)
    sv.add_argument("--samplerate", type=int, default=8000)
    sv.add_argument(
        "--admin", choices=("local", "any", "off"), default="local",
        help="who may send op=admin mutations: loopback peers only "
        "(default), any peer, or nobody",
    )
    sv.add_argument(
        "--max-channels", type=int, default=128, dest="max_channels",
        help="cap on concurrently open channels; the warm-up before "
        "accepting connections searches at this batch size",
    )
    sv.add_argument(
        "--watch", type=float, default=None, metavar="SECONDS",
        help="re-sync the media directories against the live store every "
        "SECONDS (the reference only syncs at module load; watch mode "
        "picks up added/removed files without a restart)",
    )
    sv.add_argument(
        "--wire-formats", default="", dest="wire_formats", metavar="LIST",
        help="comma-separated wire formats to warm alongside l16 "
        "(e.g. 'ulaw' or 'ulaw,alaw'): channels opened with a G.711 "
        "format send raw trunk bytes — one byte per sample, decoded on "
        "device; un-warmed formats still work but upload their table on "
        "the first window",
    )
    sv.add_argument(
        "--replica", action="store_true",
        help="serve READ-ONLY from the checkpoint without taking data-dir "
        "ownership (scale out reads next to an owning server/ingest)",
    )
    sv.add_argument(
        "--follow", type=float, default=None, metavar="SECONDS",
        help="with --replica: poll the owner's checkpoint every SECONDS "
        "and swap in newer generations",
    )
    sv.set_defaults(func=cmd_serve)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command != "serve":
        # behave like a well-mannered unix tool when piped into head etc. —
        # but NOT for the TCP server, where Python's default ignore lets
        # socket writes raise catchable BrokenPipeError instead of SIGPIPE
        # killing the process when a client disconnects uncleanly
        try:
            import signal

            signal.signal(signal.SIGPIPE, signal.SIG_DFL)
        except (ImportError, ValueError, AttributeError):
            pass  # non-unix or non-main thread
    if args.profile:
        # host + device trace of the whole command
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(args.profile, exist_ok=True)
        with profile(activities=activities) as prof:
            rc = args.func(args)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        print(f"Profile trace written to {args.profile}", file=sys.stderr)
        return rc
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
