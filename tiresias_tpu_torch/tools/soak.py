"""Production-style soak test: many live TCP clients against the port's
``RecognitionServer``.

N concurrent socket clients stream real-time-paced 20 ms frames of a known
corpus tone into the server, each on a continuous window, and every scored
window is checked against the clip the client is actually playing.

Run (defaults: 128 channels, 60 s, 3 s window / 1.5 s hop, on ``cuda``):

    python -m tiresias_tpu_torch.tools.soak [--channels 128] [--seconds 60]
        [--hop-ms 1500] [--mutate] [--hostile] [--device cpu]

Prints one summary line:

    soak: <windows> windows, <correct_pct>% correct, <rate>/s sustained,
    <errors> errors

and a memory-trend line (``soak-mem: ... — flat|GROWING``: the server
process's RSS and the device's allocated bytes, median of the second half
against the first). The client fleet runs in a process of its own.
Exits 0 when there were no errors, more than 95% of the windows were
correct and memory stayed flat.

The corpus is synthetic tones, so correctness is unambiguous: a window is
"correct" when TIRSTATUS=FOUND names the client's own clip. The loop over a
pure tone is seamless, so any miss is real. :func:`run_soak` drives a fleet
against any engine (``python3 chip_smoke.py`` hands it a 10,000-track
catalog with the tones added).
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import ctypes
import json
import os
import queue
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from tiresias_tpu_torch.api import Tiresias
from tiresias_tpu_torch.config import MatchConfig, TiresiasConfig
from tiresias_tpu_torch.serve.server import (
    MAX_LINE_BYTES,
    RecognitionServer,
    warmup_batch_sizes,
)
from tiresias_tpu_torch.utils.audio import float_to_i16, synth_tone, write_wav
from tiresias_tpu_torch.utils.g711 import decode as g711_decode
from tiresias_tpu_torch.utils.g711 import encode as g711_encode
from tiresias_tpu_torch.utils.tracing import metrics

SR = 8000
FRAME_MS = 20
N_CLIPS = 16
FLEET_CHANNELS = 32  # client channels per fleet process
# strict recognition (PARITY.md D8): two coefficients, no truncation
SOAK_MATCH = MatchConfig(coefs=2, tolerance=0.01, trunc_coef1=False)


def tone_i16(clip: int) -> np.ndarray:
    """The int16 samples of corpus clip ``clip``: 3 s of a pure tone."""
    return float_to_i16(synth_tone(250 + 130 * clip, 3.0, SR))


def add_tones(eng: Tiresias, wire: str = "l16") -> None:
    """Add the 16 corpus tones to context ``m`` (created here)."""
    eng.create_context("m")
    for i in range(N_CLIPS):
        i16 = tone_i16(i)
        if wire != "l16":
            # a G.711 deployment's catalog is built from trunk recordings:
            # store the companded clip so wire queries self-match at the
            # strict tolerance (pure tones differ by less than companding
            # noise otherwise)
            i16 = g711_decode(g711_encode(i16, wire), wire)
        eng.add_audio_pcm("m", f"tone{i}", i16.astype(np.float32) / 32768.0,
                          SR)


def build_engine(device: str = "cuda", wire: str = "l16") -> Tiresias:
    """A fresh engine in a temporary data directory holding the tones."""
    eng = Tiresias(
        TiresiasConfig(
            match=SOAK_MATCH,
            data_dir=tempfile.mkdtemp(prefix="tir_soak"),
        ),
        restore=False,
        device=device,
    )
    add_tones(eng, wire)
    return eng


def client(
    port: int,
    channel: int,
    clip: int,
    seconds: float,
    duration_ms: int,
    hop_ms: int,
    stats: dict,
    lock: threading.Lock,
    wire: str = "l16",
) -> None:
    i16 = tone_i16(clip).astype("<i2")
    if wire != "l16":
        # G.711 trunk bytes on the wire; the server expands them on the
        # device, the accounting below is unchanged
        i16 = g711_encode(i16, wire)
    frame = SR * FRAME_MS // 1000
    expected = f"tone{clip}"

    try:
        with socket.create_connection(("127.0.0.1", port), timeout=30.0) as s:
            f = s.makefile("rw", encoding="utf-8", newline="\n")
            f.write(json.dumps({
                "op": "open", "channel": f"c{channel}", "context": "m",
                "duration_ms": duration_ms, "continuous": True,
                "hop_ms": hop_ms, "format": wire,
            }) + "\n")
            f.flush()
            assert json.loads(f.readline()).get("opened")

            done = time.monotonic() + seconds
            results: list[dict] = []

            def reader():
                try:
                    for line in f:
                        msg = json.loads(line)
                        if "result" in msg:
                            results.append(msg["result"])
                except (OSError, ValueError):
                    pass

            rt = threading.Thread(target=reader, daemon=True)
            rt.start()
            off = 0
            next_t = time.monotonic()
            while time.monotonic() < done:
                chunk = np.take(  # seamless loop over the clip
                    i16, range(off, off + frame), mode="wrap"
                )
                off = (off + frame) % len(i16)
                f.write(json.dumps({
                    "op": "pcm", "channel": f"c{channel}",
                    "pcm": base64.b64encode(chunk.tobytes()).decode(),
                }) + "\n")
                f.flush()
                next_t += FRAME_MS / 1000
                delay = next_t - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
            n_before = len(results)
            f.write(json.dumps({"op": "hangup", "channel": f"c{channel}"}) + "\n")
            f.flush()
            # the hangup always answers (a flush result or the HANGUP ack):
            # wait for it, or under load every client's last window drops
            deadline = time.monotonic() + 10
            while len(results) <= n_before and time.monotonic() < deadline:
                time.sleep(0.05)
            time.sleep(0.5)  # stragglers from still-in-flight passes
        # the final hangup answers HANGUP when the last window is still
        # partial: contract behavior, not a scored window
        results = [r for r in results if r.get("TIRSTATUS") != "HANGUP"]
        correct = sum(
            1 for r in results
            if r.get("TIRSTATUS") == "FOUND" and r.get("TIRFILENAME") == expected
        )
        if stats.get("debug"):
            for r in results:
                if r.get("TIRFILENAME") != expected:
                    print(
                        f"MISS ch{channel} want={expected} got="
                        f"{r.get('TIRSTATUS')}/{r.get('TIRFILENAME')} "
                        f"{r.get('TIRMATCHCOUNT')}/{r.get('TIRFRAMECOUNT')}",
                        file=sys.stderr,
                    )
        with lock:
            stats["windows"] += len(results)
            stats["correct"] += correct
            for r in results:
                if r.get("TIRFILENAME") != expected:
                    stats["misses"].append(
                        (expected, r.get("TIRSTATUS"), r.get("TIRFILENAME"),
                         r.get("TIRMATCHCOUNT"), r.get("TIRFRAMECOUNT")))
    except Exception as exc:  # noqa: BLE001 - a failed client is an error stat
        with lock:
            stats["errors"] += 1
        print(f"client {channel} failed: {exc}", file=sys.stderr)


def _fix_mmap_threshold(nbytes: int = 128 * 1024) -> None:
    """Keep glibc's mmap threshold at its initial 128 KB
    (``mallopt(M_MMAP_THRESHOLD)``): every C-heap block of that size or
    more gets its own mapping, which a free returns to the OS. By default
    glibc raises the threshold to the size of the last mapped block freed
    and keeps later blocks of that size on its heaps; with the server's
    threads freeing tensors of a few MB (every "device" tensor on the
    CPU), the heaps fragment and RSS creeps though nothing stays live,
    which the memory check would read as a leak."""
    try:
        ctypes.CDLL(None).mallopt(-3, nbytes)  # M_MMAP_THRESHOLD
    except (AttributeError, OSError):  # not glibc
        pass


def _rss_mb() -> float:
    with open("/proc/self/status") as fh:
        for ln in fh:
            if ln.startswith("VmRSS:"):
                return float(ln.split()[1]) / 1024.0
    return 0.0


def _hbm_mb(device: torch.device) -> float:
    """The device's allocated MB (the caching allocator's live tensors);
    0 on the CPU."""
    if device.type != "cuda":
        return 0.0
    return float(torch.cuda.memory_allocated(device)) / 2**20


def mem_sampler(
    stop: threading.Event, samples: list, device: torch.device,
    period: float = 10.0,
) -> None:
    """Record (t, host RSS MB, device MB) every ``period`` s for the soak's
    memory-trend check (flat memory under sustained load and live
    mutation)."""
    t0 = time.monotonic()
    while not stop.is_set():
        samples.append((time.monotonic() - t0, _rss_mb(), _hbm_mb(device)))
        stop.wait(period)
    samples.append((time.monotonic() - t0, _rss_mb(), _hbm_mb(device)))


def mutator(
    port: int,
    mut_dir: str,
    seconds: float,
    stats: dict,
    lock: threading.Lock,
    period: float = 20.0,
) -> None:
    """Live admin-plane mutation under load: every ``period`` s, ingest a
    new clip into context ``mut`` by a per-context sync, remove the
    previous cycle's clip on odd cycles (file + admin remove_audio), save
    every 3rd cycle and compact every 5th. The store's device views churn
    (new gens, re-armed prefilter gates) while the client fleet keeps
    recognizing on the untouched context."""
    n = ok = fail = 0
    fail_reasons: list = []
    deadline = time.monotonic() + seconds
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=30.0) as s:
            f = s.makefile("rw", encoding="utf-8", newline="\n")

            def admin(**msg):
                f.write(json.dumps({"op": "admin", **msg}) + "\n")
                f.flush()
                return json.loads(f.readline())

            while time.monotonic() < deadline:
                path = os.path.join(mut_dir, f"m{n}.wav")
                # unique content per cycle: odd clips persist with their
                # hashes, and a palette that wraps would reproduce an old
                # hash, which sync dedupes (created=0)
                tone = synth_tone(2400 + 31 * (n % 40), 2.0, SR)
                tone += 1e-4 * np.random.default_rng(n).standard_normal(
                    len(tone)
                ).astype(np.float32)
                write_wav(path, tone, SR)
                r = admin(cmd="sync", context="mut")
                created = r.get("admin", {}).get("sync", {}).get("created")
                ok += created == 1
                if created != 1:
                    fail += 1
                    fail_reasons.append(f"cycle {n} sync: {r}")
                if n % 2:  # remove the previous cycle's clip, live
                    rows = admin(cmd="show_audios", context="mut")
                    rows = rows.get("admin", {}).get("audios", [])
                    victim = next(
                        (r for r in rows
                         if f"m{n - 1}.wav" in str(r.get("name", ""))
                         or str(r.get("name", "")) == f"m{n - 1}"),
                        None,
                    )
                    if victim:
                        os.unlink(os.path.join(mut_dir, f"m{n - 1}.wav"))
                        rm = admin(cmd="remove_audio", uuid=victim["uuid"])
                        removed = rm.get("admin", {}).get("removed")
                        ok += removed is True
                        if removed is not True:
                            fail += 1
                            fail_reasons.append(f"cycle {n} remove: {rm}")
                if n % 3 == 2:
                    r = admin(cmd="save")
                    good = r.get("admin", {}).get("saved") is True
                    ok += good
                    if not good:
                        fail += 1
                        fail_reasons.append(f"cycle {n} save: {r}")
                if n % 5 == 4:
                    r = admin(cmd="compact")
                    good = r.get("admin", {}).get("compacted") is True
                    ok += good
                    if not good:
                        fail += 1
                        fail_reasons.append(f"cycle {n} compact: {r}")
                n += 1
                wake = time.monotonic() + period
                while time.monotonic() < min(wake, deadline):
                    time.sleep(0.5)
        print(
            f"mutator: {n} cycles, {ok} admin mutations ok, {fail} failed "
            "(live sync/remove/save/compact under full client load)",
            file=sys.stderr,
        )
        for reason in fail_reasons[:5]:
            print(f"mutator fail: {reason}", file=sys.stderr)
        with lock:
            stats["mutations"] = ok
            stats["mutator_cycles"] = n
            stats["errors"] += fail
    except Exception as exc:  # noqa: BLE001 - a dead mutator is an error stat
        with lock:
            stats["errors"] += 1
        print(f"mutator failed: {exc}", file=sys.stderr)


def hostile_client(port: int, stats: dict, lock: threading.Lock) -> None:
    """Abusive client exercising every protocol bound: an over-cap
    duration, an unknown-channel hangup, a buffer-overflow push, and an
    over-limit line. Success = clean per-request errors (or a dropped
    connection for the unresyncable over-limit line) while everyone else
    keeps being served."""
    ok = 0
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=30.0) as s:
            f = s.makefile("rw", encoding="utf-8", newline="\n")
            f.write(json.dumps({"op": "open", "channel": "h", "context": "m",
                                "duration_ms": 86_400_000}) + "\n")
            f.flush()
            ok += "error" in json.loads(f.readline())
            f.write(json.dumps({"op": "hangup", "channel": "ghost"}) + "\n")
            f.flush()
            ok += "error" in json.loads(f.readline())
            f.write(json.dumps({"op": "open", "channel": "h", "context": "m",
                                "duration_ms": 1000}) + "\n")
            f.flush()
            ok += json.loads(f.readline()).get("opened", False)
            giant = base64.b64encode(
                np.zeros(60 * SR, dtype="<i2").tobytes()
            ).decode()
            f.write(json.dumps({"op": "pcm", "channel": "h",
                                "pcm": giant}) + "\n")
            f.flush()
            ok += "overflow" in json.loads(f.readline()).get("error", "")
        with socket.create_connection(("127.0.0.1", port), timeout=30.0) as s:
            f = s.makefile("rw", encoding="utf-8", newline="\n")
            f.write('{"op": "pcm", "channel": "h", "pcm": "')
            f.write("A" * (MAX_LINE_BYTES + 1024))
            f.write('"}\n')
            f.flush()
            ok += json.loads(f.readline()) == {"error": "line too long"}
            ok += f.readline() == ""  # the server dropped the connection
        if ok != 6:
            raise RuntimeError(f"hostile client: only {ok}/6 bounds held")
        print("hostile client: all 6 protocol bounds held", file=sys.stderr)
    except Exception as exc:  # noqa: BLE001
        with lock:
            stats["errors"] += 1
        print(f"hostile client failed: {exc}", file=sys.stderr)


def mem_trend(samples: list) -> tuple[bool, str]:
    """(flat, the ``soak-mem:`` line) from the sampler's records. The first
    sample holds the warm-up's allocations and is left out; the rest is
    split in halves, and each of host RSS and device MB is flat when the
    second half's median is at most 1.15 x the first's + 64 MB."""
    if len(samples) < 4:
        return True, (
            f"soak-mem: only {len(samples)} samples (run too short for a "
            "trend) — flat by default"
        )
    body = samples[1:]
    half = len(body) // 2
    rss_a = float(np.median([s[1] for s in body[:half]]))
    rss_b = float(np.median([s[1] for s in body[half:]]))
    dev_a = float(np.median([s[2] for s in body[:half]]))
    dev_b = float(np.median([s[2] for s in body[half:]]))
    flat = rss_b <= rss_a * 1.15 + 64 and dev_b <= dev_a * 1.15 + 64
    return flat, (
        f"soak-mem: RSS median {rss_a:.0f} -> {rss_b:.0f} MB, "
        f"HBM {dev_a:.0f} -> {dev_b:.0f} MB over {samples[-1][0]:.0f}s "
        f"({len(samples)} samples) — {'flat' if flat else 'GROWING'}"
    )


def _start_server(eng: Tiresias, max_channels: int) -> tuple:
    """A RecognitionServer on port 0, its event loop on a daemon thread.
    Returns (server, its loop)."""
    holder: dict = {}
    started = threading.Event()

    def runner():
        async def amain():
            srv = RecognitionServer(eng, port=0, samplerate=SR,
                                    max_channels=max_channels)
            await srv.start()
            holder["server"] = srv
            holder["loop"] = asyncio.get_running_loop()
            started.set()
            try:
                await srv.serve_forever()
            except asyncio.CancelledError:
                pass

        asyncio.run(amain())

    threading.Thread(target=runner, daemon=True).start()
    if not started.wait(60):
        raise RuntimeError("the soak's server did not start")
    return holder["server"], holder["loop"]


def fleet(
    port: int,
    channels: int,
    seconds: float,
    duration_ms: int,
    hop_ms: int,
    wire: str = "l16",
    mutate_dir: str | None = None,
    mutate_period: float = 20.0,
    hostile: bool = False,
    debug: bool = False,
    first: int = 0,
) -> dict:
    """The client fleet against the server on ``port``: ``channels``
    real-time clients from channel ``first`` on (clip ``i % 16`` on channel
    ``i``), the hostile client and the mutator, each on a thread of its
    own, for ``seconds``. Returns the counts (``windows``, ``correct``,
    ``errors``, ``misses``, and with the mutator ``mutations`` and
    ``mutator_cycles``)."""
    stats = {"windows": 0, "correct": 0, "errors": 0, "misses": [],
             "debug": debug}
    lock = threading.Lock()
    threads = [
        threading.Thread(
            target=client,
            args=(port, i, i % N_CLIPS, seconds, duration_ms, hop_ms,
                  stats, lock, wire),
            daemon=True,
        )
        for i in range(first, first + channels)
    ]
    if hostile:
        threads.append(threading.Thread(
            target=hostile_client, args=(port, stats, lock), daemon=True,
        ))
    if mutate_dir is not None:
        threads.append(threading.Thread(
            target=mutator,
            args=(port, mutate_dir, seconds, stats, lock, mutate_period),
            daemon=True,
        ))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stats.pop("debug")
    return stats


def _fleet_stdio() -> None:
    """The fleet's own process: reads :func:`fleet`'s keyword arguments as
    one JSON line, says "ready", runs the fleet on "go" and prints its
    counts as one JSON line."""
    kwargs = json.loads(sys.stdin.readline())
    print("ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        return
    try:
        out = fleet(**kwargs)
    except Exception as exc:  # noqa: BLE001 - reported by the parent
        out = {"failed": repr(exc)}
    print(json.dumps(out), flush=True)


def _start_fleet(kwargs: dict) -> tuple:
    """Start :func:`_fleet_stdio` in a new interpreter (the package found
    where this one was imported from). Returns (process, a queue of its
    stdout lines)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH", "")) if p))
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "from tiresias_tpu_torch.tools.soak import _fleet_stdio; "
         "_fleet_stdio()"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env,
    )
    lines: queue.Queue = queue.Queue()

    def read():
        for line in proc.stdout:
            lines.put(line.strip())
        lines.put(None)

    threading.Thread(target=read, daemon=True).start()
    proc.stdin.write(json.dumps(kwargs) + "\n")
    proc.stdin.flush()
    return proc, lines


def _next_line(lines: queue.Queue, timeout: float, what: str) -> str:
    try:
        line = lines.get(timeout=timeout)
    except queue.Empty:
        line = None
    if line is None:
        raise RuntimeError(f"the soak's client fleet {what}")
    return line


def run_soak(
    eng: Tiresias,
    channels: int = 128,
    seconds: float = 60.0,
    duration_ms: int = 3000,
    hop_ms: int = 1500,
    wire: str = "l16",
    mutate_dir: str | None = None,
    mutate_period: float = 20.0,
    hostile: bool = False,
    debug: bool = False,
    on_fleet_start=None,
) -> dict:
    """Warm ``eng`` at the window's shape, serve it on port 0 and drive the
    client :func:`fleet` against it for ``seconds``: ``channels`` real-time
    clients, the hostile client, and, when ``mutate_dir`` is given, the
    mutator on context ``mut`` (created here over that directory). ``eng``
    must hold the tones in context ``m`` (:func:`add_tones`).

    The fleet runs in processes of its own (up to 32 channels each), as a
    PBX's channels do: in the server's process its threads (two per
    channel) would take the interpreter lock from the server's score
    passes, and the soak would measure the load generator. The server
    process's C heap maps every block of 128 KB or more on its own
    (:func:`_fix_mmap_threshold`), so the memory check reads live memory,
    not glibc's heap fragmentation. ``on_fleet_start`` (no arguments) is
    called once the engine is warm, the server up and the fleet's process
    ready, just before the clients start.

    Returns the fleet's counts (``windows``, ``correct``, ``errors``,
    ``mutations``, ``misses``: expected, status, name, votes, frames of
    each wrong window), ``pct``, ``rate`` (windows/s), ``elapsed`` s, the
    server process's memory samples and verdict (``mem_flat``),
    ``match_ms`` (the ``search.match`` time of every score pass during the
    fleet's run: the process's records of that phase are cleared when it
    starts), the two summary lines (``summary``, ``mem_line``) and ``ok``,
    the tool's pass rule."""
    _fix_mmap_threshold()
    if mutate_dir is not None:
        eng.create_context("mut", mutate_dir)
    for b in warmup_batch_sizes(channels):
        eng.warmup(
            samplerate=SR, batch_sizes=(b,), duration_ms=duration_ms,
            laws=() if wire == "l16" else (wire,),
        )
    # the fleet and the hostile client both need slots
    server, loop = _start_server(eng, channels + 8)
    mem_stop = threading.Event()
    mem_samples: list = []
    mem_thread = threading.Thread(
        target=mem_sampler,
        args=(mem_stop, mem_samples, eng.device,
              max(1.0, min(10.0, seconds / 8))),
        daemon=True,
    )
    n_procs = max(1, -(-channels // FLEET_CHANNELS))
    fleets = [
        _start_fleet(dict(
            port=server.port, first=k * channels // n_procs,
            channels=(k + 1) * channels // n_procs - k * channels // n_procs,
            seconds=seconds, duration_ms=duration_ms, hop_ms=hop_ms,
            wire=wire, mutate_dir=mutate_dir if k == 0 else None,
            mutate_period=mutate_period, hostile=hostile and k == 0,
            debug=debug))
        for k in range(n_procs)
    ]
    try:
        for _, lines in fleets:
            if _next_line(lines, 120, "did not start") != "ready":
                raise RuntimeError("the soak's client fleet did not start")
        metrics.clear("search.match")
        if on_fleet_start is not None:
            on_fleet_start()
        t0 = time.monotonic()
        mem_thread.start()
        for proc, _ in fleets:
            proc.stdin.write("go\n")
            proc.stdin.flush()
        stats = {"windows": 0, "correct": 0, "errors": 0, "misses": []}
        for _, lines in fleets:
            part = json.loads(_next_line(lines, seconds + 300,
                                         "did not finish"))
            if "failed" in part:
                raise RuntimeError(f"the soak's client fleet failed: "
                                   f"{part['failed']}")
            for key in ("windows", "correct", "errors", "misses"):
                stats[key] += part.pop(key)
            stats.update(part)  # the mutator's counts
        elapsed = time.monotonic() - t0
        match_ms = [1e3 * x for x in
                    metrics.snapshot()["timings"].get("search.match", [])]
        mem_stop.set()
        mem_thread.join(timeout=5)
    finally:
        mem_stop.set()
        for proc, _ in fleets:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        # stop after the fleet: server.stop() cancels serve_forever, which
        # ends the loop's asyncio.run and may cancel stop() itself mid-await
        # (a clean shutdown, not a failure)
        try:
            asyncio.run_coroutine_threadsafe(server.stop(), loop).result(
                timeout=30)
        except (TimeoutError, asyncio.CancelledError):
            pass
    pct = 100.0 * stats["correct"] / max(1, stats["windows"])
    rate = stats["windows"] / elapsed
    summary = (
        f"soak: {stats['windows']} windows, {pct:.1f}% correct, "
        f"{rate:.1f}/s sustained, {stats['errors']} errors "
        f"({channels} channels x {seconds:.0f}s, "
        f"{duration_ms} ms window / {hop_ms} ms hop"
        + (f", {stats.get('mutations', 0)} live mutations"
           if mutate_dir is not None else "")
        + ")"
    )
    mem_flat, mem_line = mem_trend(mem_samples)
    return {
        **stats, "mutations": stats.get("mutations", 0), "pct": pct,
        "rate": rate, "elapsed": elapsed, "match_ms": match_ms,
        "mem_samples": mem_samples,
        "mem_flat": mem_flat, "summary": summary, "mem_line": mem_line,
        "ok": stats["errors"] == 0 and pct > 95.0 and mem_flat,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tiresias_tpu_torch.tools.soak")
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--duration-ms", type=int, default=3000)
    ap.add_argument("--hop-ms", type=int, default=1500)
    ap.add_argument(
        "--wire", default="l16", choices=("l16", "ulaw", "alaw"),
        help="wire format every client speaks (G.711 trunk bytes halve "
        "the base64 payload and the upload; expanded on the device)",
    )
    ap.add_argument(
        "--hostile", action="store_true",
        help="run an abusive client alongside the fleet; it must get clean "
        "errors while everyone else keeps recognizing",
    )
    ap.add_argument(
        "--mutate", action="store_true",
        help="run a live admin mutator alongside the fleet: per-context "
        "sync ingest, remove, save, compact against the serving store",
    )
    ap.add_argument("--mutate-period", type=float, default=20.0)
    ap.add_argument("--debug", action="store_true")
    ap.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the engine runs (default cuda; raises without a card)",
    )
    args = ap.parse_args(argv)

    eng = build_engine(args.device, args.wire)
    out = run_soak(
        eng, args.channels, args.seconds, args.duration_ms, args.hop_ms,
        args.wire,
        mutate_dir=(tempfile.mkdtemp(prefix="tir_soak_mut")
                    if args.mutate else None),
        mutate_period=args.mutate_period, hostile=args.hostile,
        debug=args.debug,
    )
    print(out["summary"], flush=True)
    print(out["mem_line"], flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
