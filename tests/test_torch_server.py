"""The port's TCP recognition service (``tiresias_tpu_torch.serve.server``) on
the CPU: protocol round trips over real sockets, each test under its own
deadline so a hang fails one test and not the run."""

import asyncio
import base64
import json
import threading
import time

import signal

import numpy as np
import pytest
import torch

from tiresias_tpu_torch.api import Tiresias
from tiresias_tpu_torch.config import MatchConfig, TiresiasConfig
from tiresias_tpu_torch.serve.server import RecognitionServer
from tiresias_tpu_torch.utils.audio import synth_tone

torch.set_num_threads(2)

SR = 8000
TEST_DEADLINE_S = 180


@pytest.fixture(autouse=True)
def deadline():
    """Every test here talks to sockets or event loops: one that hangs is
    cut by SIGALRM after TEST_DEADLINE_S and fails alone."""

    def on_alarm(signum, frame):
        raise TimeoutError(f"test exceeded {TEST_DEADLINE_S} s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(TEST_DEADLINE_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    eng = Tiresias(
        TiresiasConfig(
            match=MatchConfig(coefs=2, tolerance=0.01, trunc_coef1=False),
            data_dir=str(tmp_path_factory.mktemp("srv")),
        ),
        restore=False, device="cpu",
    )
    eng.create_context("m")
    for i in range(4):
        # store the int16-quantized signal: DB audio and live queries pass
        # through the same 16-bit PCM path in production, and for sparse
        # spectra (pure tones) quantization noise dominates the empty mel
        # bands (PARITY.md §2 noise-floor note) — both sides must quantize
        pcm = synth_tone(300 + 200 * i, 2.0, SR)
        i16 = np.clip(np.round(pcm * 32768.0), -32768, 32767).astype(np.int16)
        eng.add_audio_pcm("m", f"tone{i}", i16.astype(np.float32) / 32768.0, SR)
    return eng


@pytest.fixture()
def server(engine):
    """RecognitionServer on an ephemeral port, its loop on a daemon thread."""
    started = threading.Event()
    holder = {}

    def runner():
        async def main():
            srv = RecognitionServer(engine, port=0, samplerate=SR)
            await srv.start()
            holder["server"] = srv
            holder["loop"] = asyncio.get_running_loop()
            started.set()
            try:
                await srv.serve_forever()
            except asyncio.CancelledError:
                pass

        asyncio.run(main())

    thread = threading.Thread(target=runner, daemon=True)
    thread.start()
    assert started.wait(10)
    yield holder["server"]
    loop = holder["loop"]
    asyncio.run_coroutine_threadsafe(holder["server"].stop(), loop)


def _pcm_b64(pcm: np.ndarray) -> str:
    i16 = np.clip(np.round(pcm * 32768.0), -32768, 32767).astype("<i2")
    return base64.b64encode(i16.tobytes()).decode()


def _talk(port, messages, expect_lines, timeout=30.0):
    import socket

    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        f = s.makefile("rw")
        for m in messages:
            f.write(json.dumps(m) + "\n")
        f.flush()
        for _ in range(expect_lines):
            out.append(json.loads(f.readline()))
    return out


class TestProtocol:
    def test_open_push_result(self, server):
        pcm = synth_tone(700, 1.2, SR)  # tone2
        msgs = [
            {"op": "open", "channel": "c1", "context": "m", "duration_ms": 1000},
            {"op": "pcm", "channel": "c1", "pcm": _pcm_b64(pcm)},
        ]
        replies = _talk(server.port, msgs, expect_lines=2)
        assert replies[0] == {"channel": "c1", "opened": True}
        result = replies[1]
        assert result["channel"] == "c1"
        assert result["result"]["TIRSTATUS"] == "FOUND"
        assert result["result"]["TIRFILENAME"] == "tone2"
        assert float(result["result"]["CONFIDENCE"]) > 0.9

    def test_hangup_before_duration(self, server):
        msgs = [
            {"op": "open", "channel": "x", "context": "m", "duration_ms": 3000},
            {"op": "pcm", "channel": "x", "pcm": _pcm_b64(synth_tone(300, 0.2, SR))},
            {"op": "hangup", "channel": "x"},
        ]
        replies = _talk(server.port, msgs, expect_lines=2)
        assert replies[1]["result"]["TIRSTATUS"] == "HANGUP"

    def test_bad_request_isolated(self, server):
        import socket

        with socket.create_connection(("127.0.0.1", server.port), timeout=30) as s:
            f = s.makefile("rw")
            f.write("this is not json\n")
            f.write(json.dumps({"op": "frobnicate", "channel": "y"}) + "\n")
            f.write(
                json.dumps(
                    {"op": "open", "channel": "y", "context": "m",
                     "duration_ms": 500}
                ) + "\n"
            )
            f.flush()
            r1 = json.loads(f.readline())
            r2 = json.loads(f.readline())
            r3 = json.loads(f.readline())
        assert "error" in r1 and "error" in r2
        assert r3 == {"channel": "y", "opened": True}

    def test_continuous_channel_gets_multiple_results(self, server):
        # the writer must survive the first result
        import socket

        pcm = synth_tone(700, 1.5, SR)
        with socket.create_connection(("127.0.0.1", server.port), timeout=30) as s:
            f = s.makefile("rw")
            f.write(json.dumps(
                {"op": "open", "channel": "cont", "context": "m",
                 "duration_ms": 500, "continuous": True}) + "\n")
            f.write(json.dumps(
                {"op": "pcm", "channel": "cont", "pcm": _pcm_b64(pcm)}) + "\n")
            f.flush()
            assert json.loads(f.readline())["opened"]
            first = json.loads(f.readline())
            second = json.loads(f.readline())
            assert first["result"]["TIRSTATUS"] == "FOUND"
            assert second["result"]["TIRSTATUS"] == "FOUND"
            f.write(json.dumps({"op": "hangup", "channel": "cont"}) + "\n")
            f.flush()

    def test_malformed_pcm_isolated(self, server):
        # bad base64 / missing pcm answers an error and
        # the connection (and its other channels) keeps working
        import socket

        with socket.create_connection(("127.0.0.1", server.port), timeout=30) as s:
            f = s.makefile("rw")
            f.write(json.dumps({"op": "pcm", "channel": "x"}) + "\n")  # no pcm
            f.write(json.dumps(
                {"op": "pcm", "channel": "x", "pcm": "!!!notbase64"}) + "\n")
            f.write(json.dumps(
                {"op": "open", "channel": "ok", "context": "m",
                 "duration_ms": 400}) + "\n")
            f.write(json.dumps(
                {"op": "pcm", "channel": "ok",
                 "pcm": _pcm_b64(synth_tone(300, 0.5, SR))}) + "\n")
            f.flush()
            r1 = json.loads(f.readline())
            r2 = json.loads(f.readline())
            r3 = json.loads(f.readline())
            r4 = json.loads(f.readline())
        assert "error" in r1 and "error" in r2
        assert r3 == {"channel": "ok", "opened": True}
        assert r4["result"]["TIRSTATUS"] == "FOUND"

    def test_echo_op(self, server):
        """Liveness/RTT probe: inline reply, no scorer, no device —
        the TCP-floor term of a latency decomposition."""
        replies = _talk(server.port, [{"op": "echo", "payload": "ping"}], 1)
        assert replies[0] == {"echo": "ping"}
        replies = _talk(server.port, [{"op": "echo"}], 1)
        assert replies[0] == {"echo": ""}

    def test_stats_op(self, server):
        replies = _talk(server.port, [{"op": "stats", "channel": ""}], 1)
        stats = replies[0]["stats"]
        assert stats["audios"] == 4
        assert "counters" in stats and "channels" in stats
        # generation/owner let an operator confirm replica catch-up
        assert stats["generation"] >= 0 and stats["owner"] in (True, False)

    def test_two_clients_same_channel_name(self, server):
        pcm_a = synth_tone(300, 0.7, SR)  # tone0
        pcm_b = synth_tone(900, 0.7, SR)  # tone3
        import socket

        conns = []
        for pcm in (pcm_a, pcm_b):
            s = socket.create_connection(("127.0.0.1", server.port), timeout=30)
            f = s.makefile("rw")
            f.write(json.dumps(
                {"op": "open", "channel": "dup", "context": "m",
                 "duration_ms": 500}) + "\n")
            f.write(json.dumps(
                {"op": "pcm", "channel": "dup", "pcm": _pcm_b64(pcm)}) + "\n")
            f.flush()
            conns.append((s, f))
        names = []
        for s, f in conns:
            assert json.loads(f.readline())["opened"]
            names.append(json.loads(f.readline())["result"]["TIRFILENAME"])
            s.close()
        assert names == ["tone0", "tone3"]  # connection-scoped channels


class TestWarmupBatchSizes:
    def test_covers_every_scorer_bucket(self):
        """The scorer pads no batch to a bucket here, so run_server warms
        one query and a full house — not every power of two."""
        from tiresias_tpu_torch.serve.server import warmup_batch_sizes

        assert warmup_batch_sizes(128) == (1, 128)
        assert warmup_batch_sizes(1) == (1,)
        assert warmup_batch_sizes(100) == (1, 100)


class TestHangupRaces:
    def test_last_frame_then_hangup_gets_result(self, server):
        """Client sends a full window then hangs up immediately: whichever
        side wins (the 20 ms scorer tick or the hangup op), a real result
        must arrive — never silence, never HANGUP."""
        for trial in range(4):
            pcm = synth_tone(500, 1.0, SR)  # tone1, exactly one window
            msgs = [
                {"op": "open", "channel": f"r{trial}", "context": "m",
                 "duration_ms": 1000},
                {"op": "pcm", "channel": f"r{trial}", "pcm": _pcm_b64(pcm)},
                {"op": "hangup", "channel": f"r{trial}"},
            ]
            replies = _talk(server.port, msgs, expect_lines=2, timeout=30.0)
            assert replies[1]["result"]["TIRSTATUS"] == "FOUND", replies
            assert replies[1]["result"]["TIRFILENAME"] == "tone1"

    def test_scorer_wins_interleaving_still_delivers(self, server, monkeypatch):
        """Force the scorer-takes-the-window-first interleaving by slowing
        process_ready: the hangup op must not pop the writer out from under
        the in-flight search."""
        import time as _time

        rec = server.recognizer
        real = rec.process_ready

        def slow_process_ready():
            out = real()
            if out:
                _time.sleep(0.3)  # hold the result while the hangup lands
            return out

        monkeypatch.setattr(rec, "process_ready", slow_process_ready)
        import socket

        pcm = synth_tone(700, 1.0, SR)  # tone2
        with socket.create_connection(("127.0.0.1", server.port), timeout=30.0) as s:
            f = s.makefile("rw")
            f.write(json.dumps({"op": "open", "channel": "sw", "context": "m",
                                "duration_ms": 1000}) + "\n")
            f.write(json.dumps({"op": "pcm", "channel": "sw",
                                "pcm": _pcm_b64(pcm)}) + "\n")
            f.flush()
            assert json.loads(f.readline())["opened"] is True
            _time.sleep(0.15)  # let the scorer tick take the window
            f.write(json.dumps({"op": "hangup", "channel": "sw"}) + "\n")
            f.flush()
            result = json.loads(f.readline())
            assert result["result"]["TIRSTATUS"] == "FOUND", result
            assert result["result"]["TIRFILENAME"] == "tone2"


class TestProtocolBounds:
    """Robustness bounds on untrusted clients ."""

    def test_duration_cap_rejected(self, server):
        replies = _talk(
            server.port,
            [{"op": "open", "channel": "big", "context": "m",
              "duration_ms": 3_600_000}],
            expect_lines=1,
        )
        assert "error" in replies[0]
        assert "duration_ms" in replies[0]["error"]

    def test_buffer_overflow_rejected_connection_survives(self, server):
        import socket

        # duration 1000 ms -> cap = 2*8000 + 30*8000 = 256000 samples;
        # one 40 s push (320000 samples) must be rejected outright
        big = _pcm_b64(np.zeros(40 * SR, dtype=np.float32))
        with socket.create_connection(("127.0.0.1", server.port), timeout=30) as s:
            f = s.makefile("rw")
            f.write(json.dumps({"op": "open", "channel": "ov", "context": "m",
                                "duration_ms": 1000, "continuous": True,
                                "hop_ms": 500}) + "\n")
            f.flush()
            assert json.loads(f.readline())["opened"] is True
            f.write(json.dumps({"op": "pcm", "channel": "ov", "pcm": big}) + "\n")
            f.flush()
            reply = json.loads(f.readline())
            assert "error" in reply and "overflow" in reply["error"]
            # the connection is still usable after the rejected push
            f.write(json.dumps({"op": "open", "channel": "ok", "context": "m",
                                "duration_ms": 500}) + "\n")
            f.flush()
            assert json.loads(f.readline()) == {"channel": "ok", "opened": True}

    def test_unknown_channel_hangup_answers(self, server):
        replies = _talk(
            server.port,
            [{"op": "hangup", "channel": "never-opened"}],
            expect_lines=1,
        )
        assert "error" in replies[0]
        assert "unknown channel" in replies[0]["error"]

    def test_hangup_releases_writer_mapping(self, server):
        """Per-call channels on a LONG-LIVED connection must not leak
        writer/epoch entries: the deferred post-hangup release frees them
        once in-flight score passes drain."""
        import socket

        with socket.create_connection(("127.0.0.1", server.port), timeout=30) as s:
            f = s.makefile("rw")
            for i in range(5):
                f.write(json.dumps({"op": "open", "channel": f"call-{i}",
                                    "context": "m", "duration_ms": 3000})
                        + "\n")
                f.write(json.dumps({"op": "hangup", "channel": f"call-{i}"})
                        + "\n")
                f.flush()
                assert json.loads(f.readline())["opened"] is True
                assert (
                    json.loads(f.readline())["result"]["TIRSTATUS"] == "HANGUP"
                )
            # the connection stays up; the per-call entries drain away
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                if not server._writers and not server._chan_epoch:
                    break
                time.sleep(0.05)
            assert not server._writers, server._writers
            assert not server._chan_epoch, server._chan_epoch

    def test_line_too_long_answers_and_closes(self, server):
        import socket

        from tiresias_tpu_torch.serve.server import MAX_LINE_BYTES

        with socket.create_connection(("127.0.0.1", server.port), timeout=30) as s:
            f = s.makefile("rw")
            try:
                f.write('{"op": "pcm", "channel": "x", "pcm": "')
                f.write("A" * (MAX_LINE_BYTES + 1024))
                f.write('"}\n')
                f.flush()
            except (BrokenPipeError, ConnectionResetError):
                return  # server already dropped us: the bound held
            try:
                line = f.readline()
            except (ConnectionResetError, OSError):
                return  # RST wiped the queue mid-close: the bound held
            if line:  # the polite path: one error reply, then closed
                assert json.loads(line) == {"error": "line too long"}
                try:
                    assert f.readline() == ""
                except (ConnectionResetError, OSError):
                    pass  # RST landed after the reply: still closed
            # empty line == connection closed without the reply being
            # readable — the server closing with our unread bytes in
            # flight RSTs, which can clear the receive queue first; the
            # bound was still enforced (nothing else was processed)


class TestWindowOrdering:
    def test_results_carry_window_index(self, server):
        """Pipelined score passes may complete out of order; every result
        carries the per-channel window counter so clients can reorder."""
        import socket

        pcm = synth_tone(700, 1.1, SR)
        with socket.create_connection(("127.0.0.1", server.port), timeout=30) as s:
            f = s.makefile("rw")
            f.write(json.dumps({"op": "open", "channel": "w", "context": "m",
                                "duration_ms": 500, "continuous": True}) + "\n")
            f.flush()
            assert json.loads(f.readline())["opened"] is True
            f.write(json.dumps({"op": "pcm", "channel": "w",
                                "pcm": _pcm_b64(pcm)}) + "\n")
            f.flush()
            windows = [json.loads(f.readline())["window"] for _ in range(2)]
        assert sorted(windows) == [0, 1]


class TestWatchMode:
    def test_watch_syncs_added_and_removed_files(self, tmp_path):
        """A server started with watch_interval picks up files dropped
        into (and removed from) the media directory without a restart —
        the live-sync capability the reference lacks (it only syncs at
        module load, app_tiresias.c:66-123)."""
        import os
        import time

        from tiresias_tpu_torch.config import ContextConfig
        from tiresias_tpu_torch.utils.audio import write_wav

        media = tmp_path / "media"
        media.mkdir()
        eng = Tiresias(
            TiresiasConfig(
                contexts=(ContextConfig("m", str(media)),),
                data_dir=str(tmp_path / "data"),
            ),
            restore=False, device="cpu",
        )
        eng.sync()
        assert eng.get_audios("m") == []

        started = threading.Event()
        holder = {}

        def runner():
            async def main():
                srv = RecognitionServer(
                    eng, port=0, samplerate=SR, watch_interval=0.2
                )
                await srv.start()
                holder["server"] = srv
                holder["loop"] = asyncio.get_running_loop()
                started.set()
                try:
                    await srv.serve_forever()
                except asyncio.CancelledError:
                    pass

            asyncio.run(main())

        thread = threading.Thread(target=runner, daemon=True)
        thread.start()
        assert started.wait(10)
        try:
            wav = media / "late.wav"
            write_wav(str(wav), synth_tone(440, 1.0, SR), SR)

            def wait_for(pred, timeout=30.0):
                deadline = time.monotonic() + timeout
                while time.monotonic() < deadline:
                    if pred():
                        return True
                    time.sleep(0.1)
                return False

            assert wait_for(
                lambda: [a.name for a in eng.get_audios("m")] == ["late.wav"]
            )
            os.unlink(wav)
            assert wait_for(lambda: eng.get_audios("m") == [])
        finally:
            asyncio.run_coroutine_threadsafe(
                holder["server"].stop(), holder["loop"]
            ).result(10)
            eng.close()

    def test_invalid_watch_interval_rejected(self, engine):
        with pytest.raises(ValueError, match="watch_interval"):
            RecognitionServer(engine, port=0, watch_interval=0)


class TestGracefulShutdown:
    def test_sigterm_closes_engine_and_releases_lock(self, tmp_path):
        """`tiresias serve` on SIGTERM must stop, checkpoint, clear
        server.json, and release the data-dir lock (the reference's
        unload-time term() sequence, app_tiresias.c:125-149)."""
        import os
        import signal
        import subprocess
        import sys
        import time

        from tiresias_tpu_torch.config import ContextConfig
        from tiresias_tpu_torch.utils.audio import synth_tone, write_wav

        media = tmp_path / "media"
        media.mkdir()
        write_wav(str(media / "a.wav"), synth_tone(440, 1.0, SR), SR)
        data = tmp_path / "data"
        conf = tmp_path / "t.conf"
        conf.write_text(
            f"[global]\ndata_dir={data}\n\n[m]\ndirectory={media}\n"
        )
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        proc = subprocess.Popen(
            [sys.executable, "-m", "tiresias_tpu_torch.cli", "-c", str(conf),
             "--device", "cpu", "serve", "--port", "0", "--max-channels", "1"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        try:
            import selectors

            sel = selectors.DefaultSelector()
            sel.register(proc.stdout, selectors.EVENT_READ)
            deadline = time.monotonic() + 120
            line = ""
            while time.monotonic() < deadline:
                # deadline-aware read: a silent child must not block the
                # suite on readline() past the deadline
                if not sel.select(timeout=deadline - time.monotonic()):
                    break
                line = proc.stdout.readline()
                if not line or "tiresias serving on" in line:
                    break
            sel.close()
            assert "tiresias serving on" in line, "server never came up"
            assert (data / "server.json").exists()
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
        assert not (data / "server.json").exists()
        # lock released: a fresh exclusive engine must acquire instantly
        eng = Tiresias(
            TiresiasConfig(data_dir=str(data)), exclusive=True, device="cpu"
        )
        assert [a.name for a in eng.get_audios("m")] == ["a.wav"]
        eng.close()


class _FakeTransport:
    def __init__(self):
        self.aborted = False

    def abort(self):
        self.aborted = True


class _FakeWriter:
    """StreamWriter stand-in for driving server internals deterministically."""

    def __init__(self, hang_drain=False):
        self.lines = []
        self.hang_drain = hang_drain
        self.transport = _FakeTransport()

    def write(self, data: bytes):
        self.lines.append(json.loads(data))

    async def drain(self):
        if self.hang_drain:
            await asyncio.Event().wait()  # a peer that never reads

    def is_closing(self):
        return False


class TestServeHardening:
    """Serve-layer hardening: capacity cap, duplicate open,
    read-only admin, hangup keeps in-flight delivery, drain timeout."""

    def test_channel_capacity_enforced(self, engine):
        started = threading.Event()
        holder = {}

        def runner():
            async def main():
                srv = RecognitionServer(
                    engine, port=0, samplerate=SR, max_channels=2
                )
                await srv.start()
                holder["server"], holder["loop"] = (
                    srv, asyncio.get_running_loop()
                )
                started.set()
                try:
                    await srv.serve_forever()
                except asyncio.CancelledError:
                    pass

            asyncio.run(main())

        threading.Thread(target=runner, daemon=True).start()
        assert started.wait(10)
        try:
            msgs = [
                {"op": "open", "channel": f"c{i}", "context": "m",
                 "duration_ms": 3000}
                for i in range(3)
            ]
            # ONE connection throughout: the hangup must target a channel
            # THIS connection opened (ids are connection-scoped), and the
            # freed slot must be observable while the connection still
            # holds its other channel
            msgs += [
                {"op": "hangup", "channel": "c0"},
                {"op": "open", "channel": "c3", "context": "m",
                 "duration_ms": 3000},
            ]
            replies = _talk(holder["server"].port, msgs, expect_lines=5)
            assert replies[0]["opened"] and replies[1]["opened"]
            assert replies[2].get("code") == "at_capacity"
            # hangup mid-recording delivers a HANGUP result...
            assert replies[3]["result"]["TIRSTATUS"] == "HANGUP"
            # ...and ACTUALLY freed a slot: the next open succeeds
            assert replies[4] == {"channel": "c3", "opened": True}
        finally:
            asyncio.run_coroutine_threadsafe(
                holder["server"].stop(), holder["loop"]
            ).result(10)

    def test_duplicate_open_rejected(self, server):
        replies = _talk(
            server.port,
            [{"op": "open", "channel": "dup", "context": "m",
              "duration_ms": 3000},
             {"op": "open", "channel": "dup", "context": "m",
              "duration_ms": 3000}],
            expect_lines=2,
        )
        assert replies[0]["opened"] is True
        assert "already open" in replies[1]["error"]

    def test_admin_readonly_server_rejects_mutations(self, tmp_path):
        """A server over a read-only engine (another process owns the data
        dir) must refuse admin mutations BEFORE touching its in-memory
        store — a half-applied delete would silently diverge it from what
        the owner serves."""
        cfg = TiresiasConfig(
            match=MatchConfig(coefs=2, tolerance=0.01, trunc_coef1=False),
            data_dir=str(tmp_path),
        )
        owner = Tiresias(cfg, restore=False, device="cpu")
        assert owner.lock.held
        ro = Tiresias(cfg, restore=False, device="cpu")  # lock taken -> degrades readonly
        assert not ro.lock.held
        ro.create_context("m")  # in-memory only
        ro.add_audio_pcm("m", "t0", synth_tone(440, 1.0, SR), SR)
        uuid = ro.get_audios("m")[0].uuid

        async def drive():
            srv = RecognitionServer(ro, port=0, samplerate=SR)
            reply = await srv._dispatch_admin(
                {"cmd": "remove_audio", "uuid": uuid}
            )
            assert reply.get("code") == "read_only", reply
            # reads still work on a read-only replica
            reply = await srv._dispatch_admin({"cmd": "show_contexts"})
            assert [c["name"] for c in reply["admin"]["contexts"]] == ["m"]

        asyncio.run(drive())
        assert [a.name for a in ro.get_audios("m")] == ["t0"]  # unmutated
        ro.close()
        owner.close()

    def test_hangup_keeps_writer_for_inflight_window(self, engine):
        """Hangup must not release the writer/opened bookkeeping: an
        earlier window of the channel may still be inside a batched pass,
        and its result must reach the still-connected client."""
        from tiresias_tpu_torch.api.engine import SearchResult

        async def drive():
            srv = RecognitionServer(engine, port=0, samplerate=SR)
            fake = _FakeWriter()
            opened = set()

            def cid(channel):
                return f"7|{channel}"

            await srv._dispatch_op(
                "open", "c1",
                {"op": "open", "channel": "c1", "context": "m",
                 "duration_ms": 3000, "continuous": True, "hop_ms": 500},
                cid, opened, fake, True,
            )
            assert fake.lines[-1]["opened"] is True
            # partial buffer -> hangup flushes a HANGUP result (not None)
            srv.recognizer.push(cid("c1"), synth_tone(440, 1.0, SR))
            await srv._dispatch_op(
                "hangup", "c1", {"op": "hangup", "channel": "c1"},
                cid, opened, fake, True,
            )
            assert fake.lines[-1]["result"]["TIRSTATUS"] == "HANGUP"
            # FIXED bookkeeping: writer and opened survive the hangup so a
            # late in-flight window can still deliver
            assert cid("c1") in srv._writers and cid("c1") in opened
            late = SearchResult(
                status="FOUND", frame_count=93, match_count=90,
                uuid="u", name="tone1", context="m", hash="h", window=0,
            )
            await srv._send_result(cid("c1"), late)
            assert fake.lines[-1]["result"]["TIRFILENAME"] == "tone1"
            # a SECOND in-flight window also delivers — the first delivery
            # must not have popped the writer
            import dataclasses

            await srv._send_result(
                cid("c1"), dataclasses.replace(late, window=1)
            )
            assert fake.lines[-1]["window"] == 1
            # the hangup's deferred release (scheduled behind the passes
            # in flight at hangup time — none here) frees the bookkeeping
            await asyncio.gather(*srv._cleanups)
            assert cid("c1") not in srv._writers and cid("c1") not in opened

        asyncio.run(drive())

    def test_unresponsive_client_cannot_wedge_scorer(self, engine, monkeypatch):
        """A peer that stops reading must not park the shared score pass on
        writer.drain() forever — the connection is aborted instead."""
        import tiresias_tpu_torch.serve.server as server_mod
        from tiresias_tpu_torch.api.engine import SearchResult

        monkeypatch.setattr(server_mod, "DRAIN_TIMEOUT_S", 0.05)

        async def drive():
            srv = RecognitionServer(engine, port=0, samplerate=SR)
            srv.recognizer.open("9|c1", context="m", duration_ms=3000,
                                continuous=True)
            fake = _FakeWriter(hang_drain=True)
            srv._writers["9|c1"] = fake
            result = SearchResult(
                status="NOTFOUND", frame_count=93, match_count=0, window=0
            )
            await asyncio.wait_for(srv._send_result("9|c1", result), 5)
            assert fake.transport.aborted
            srv.recognizer.hangup("9|c1", flush=False)

        asyncio.run(drive())


# ---- the admin plane, top-k and follow mode over real sockets ---------- #


import contextlib  # noqa: E402


@contextlib.contextmanager
def _running(engine, **kwargs):
    """A RecognitionServer for ``engine`` on an ephemeral port, its event
    loop on a daemon thread; stopped on exit."""
    started = threading.Event()
    holder = {}

    def runner():
        async def main():
            srv = RecognitionServer(engine, port=0, samplerate=SR, **kwargs)
            await srv.start()
            holder["server"], holder["loop"] = srv, asyncio.get_running_loop()
            started.set()
            try:
                await srv.serve_forever()
            except asyncio.CancelledError:
                pass

        asyncio.run(main())

    threading.Thread(target=runner, daemon=True).start()
    assert started.wait(10)
    try:
        yield holder["server"]
    finally:
        asyncio.run_coroutine_threadsafe(
            holder["server"].stop(), holder["loop"]
        ).result(20)


def _admin(port, cmd, **fields):
    (reply,) = _talk(port, [{"op": "admin", "cmd": cmd, **fields}], 1)
    return reply


def _tone_i16(freq, seconds=1.0):
    pcm = synth_tone(freq, seconds, SR)
    return np.clip(np.round(pcm * 32768.0), -32768, 32767).astype("<i2")


def _b64(arr):
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


class TestAdminSearch:
    def test_single_query_in_every_dtype(self, server, engine):
        from tiresias_tpu_torch.utils.g711 import decode, encode

        i16 = _tone_i16(700)
        f32 = i16.astype("<f4") / 32768.0
        want = engine.search_pcm("m", i16, SR).to_channel_vars()
        assert want["TIRFILENAME"] == "tone2"
        for dtype, payload in (("i16", i16), ("f32", f32), (None, i16)):
            fields = {"pcm": _b64(payload), "context": "m"}
            if dtype:
                fields["dtype"] = dtype
            got = _admin(server.port, "search", **fields)["admin"]["result"]
            assert float(got.pop("CONFIDENCE")) > 0.9
            assert got == want
        for law in ("ulaw", "alaw"):
            codes = encode(f32, law)
            got = _admin(server.port, "search", pcm=_b64(codes), dtype=law,
                         context="m", tolerance=1.0, coefs=1,
                         trunc_coef1=True)["admin"]["result"]
            direct = engine.search_pcm(
                "m", decode(codes, law), SR, tolerance=1.0, coefs=1,
                trunc_coef1=True).to_channel_vars()
            got.pop("CONFIDENCE")
            assert got == direct
        bad = _admin(server.port, "search", pcm=_b64(i16), dtype="gsm")
        assert bad["code"] == "bad_request" and "gsm" in bad["error"]

    def test_queries_batch_equals_direct_batch_search(self, server, engine):
        windows = [_tone_i16(300 + 200 * (i % 4), 0.8) for i in range(8)]
        windows[5] = _tone_i16(2600, 0.8)  # no such tone stored
        reply = _admin(
            server.port, "search", context="m",
            queries=[{"pcm": _b64(w)} for w in windows],
        )["admin"]["results"]
        direct = engine.search_pcm_batch("m", windows, SR)
        assert len(reply) == 8
        for got, want in zip(reply, direct):
            assert got.pop("CONFIDENCE") == f"{want.confidence:.4f}"
            assert got == want.to_channel_vars()
        assert [r["TIRSTATUS"] for r in reply].count("FOUND") == 7
        # two samplerates in one request: one pass per rate, answers in
        # request order
        mixed = _admin(
            server.port, "search", context="m",
            queries=[{"pcm": _b64(windows[0])},
                     {"pcm": _b64(synth_tone(500, 0.8, 16000).astype("<f4")),
                      "dtype": "f32", "samplerate": 16000},
                     {"pcm": _b64(windows[2])}],
        )["admin"]["results"]
        assert [m.get("TIRFILENAME") for m in (mixed[0], mixed[2])] == [
            "tone0", "tone2"]
        for bad in ([], "x", None):
            fields = {} if bad is None else {"queries": bad}
            reply = _admin(server.port, "search", **fields)
            assert "error" in reply

    @pytest.mark.parametrize("mode", [
        {"coefs": 1, "trunc_coef1": True, "tolerance": 1.0},
        {"coefs": 2, "trunc_coef1": False, "aligned": True, "tolerance": 0.1},
    ], ids=["dialplan", "aligned"])
    def test_top_listing_equals_search_pcm_topk(self, server, engine, mode):
        i16 = _tone_i16(500)
        ranked = _admin(server.port, "search", pcm=_b64(i16), context="m",
                        top=3, **mode)["admin"]["ranked"]
        direct = engine.search_pcm_topk("m", i16, SR, k=3, **mode)
        assert 1 <= len(direct) <= 3 and len(ranked) == len(direct)
        for got, want in zip(ranked, direct):
            assert got.pop("CONFIDENCE") == f"{want.confidence:.4f}"
            assert got == want.to_channel_vars()
        if "aligned" in mode:
            assert ranked[0]["TIRFILENAME"] == "tone1"

    def test_top_is_validated_before_the_pcm_is_decoded(self, server):
        for top in (0, 1025, "3", True, 2.5):
            reply = _admin(server.port, "search", pcm="!!notbase64", top=top)
            assert reply["code"] == "bad_request" and "top" in reply["error"]
        reply = _admin(server.port, "search", top=2,
                       queries=[{"pcm": _b64(_tone_i16(300))}])
        assert "single query" in reply["error"]
        reply = _admin(server.port, "search", pcm=_b64(_tone_i16(300)),
                       top=2, min_margin=0.2)
        assert "min_margin" in reply["error"]  # a bad request, not a crash

    def test_unknown_cmd_and_admin_off(self, server, engine):
        assert "unknown admin cmd" in _admin(server.port, "frob")["error"]
        with _running(engine, admin="off") as srv:
            reply = _admin(srv.port, "show_contexts")
            assert reply["code"] == "not_permitted"
        with pytest.raises(ValueError, match="admin"):
            RecognitionServer(engine, port=0, admin="everyone")


class TestAdminMutations:
    @pytest.fixture()
    def owner(self, tmp_path):
        """An owning engine over a media directory of four tones."""
        from tiresias_tpu_torch.config import ContextConfig
        from tiresias_tpu_torch.utils.audio import write_wav

        media = tmp_path / "media"
        media.mkdir()
        for i in range(4):
            write_wav(str(media / f"tone{i}.wav"),
                      synth_tone(300 + 200 * i, 2.0, SR), SR)
        cfg = TiresiasConfig(
            match=MatchConfig(coefs=2, tolerance=0.01, trunc_coef1=False),
            contexts=(ContextConfig("m", str(media)),),
            data_dir=str(tmp_path / "data"),
        )
        eng = Tiresias(cfg, device="cpu")
        assert eng.sync().created == 4
        yield eng, media, cfg
        if eng.lock.held:
            eng.close()

    def test_listing_remove_compact_save_stats(self, owner):
        eng, media, cfg = owner
        with _running(eng) as srv:
            contexts = _admin(srv.port, "show_contexts")["admin"]["contexts"]
            assert contexts == [{"name": "m", "directory": str(media)}]
            rows = _admin(srv.port, "show_audios", context="m")["admin"]["audios"]
            assert sorted(r["name"] for r in rows) == [
                f"tone{i}.wav" for i in range(4)]
            assert set(rows[0]) == {"uuid", "name", "context", "hash"}
            assert _admin(srv.port, "show_audios",
                          context="nope")["code"] == "unknown_context"
            query = {"pcm": _b64(_tone_i16(700)), "context": "m"}
            found = _admin(srv.port, "search", **query)["admin"]["result"]
            assert found["TIRFILENAME"] == "tone2.wav"
            gen = _talk(srv.port, [{"op": "stats"}], 1)[0]["stats"]["generation"]
            removed = _admin(srv.port, "remove_audio",
                             uuid=found["TIRFILEUUID"])
            assert removed == {"admin": {"removed": True}}
            again = _admin(srv.port, "remove_audio", uuid=found["TIRFILEUUID"])
            assert again == {"admin": {"removed": False}}
            gone = _admin(srv.port, "search", **query)["admin"]["result"]
            assert gone.get("TIRFILENAME") != "tone2.wav"
            (view,) = eng.store.search_views()
            assert view.dead_rows  # a tombstone, below the compaction bar
            assert _admin(srv.port, "compact") == {"admin": {"compacted": True}}
            (view,) = eng.store.search_views()
            assert not view.dead_rows and view.n_audios == 3
            assert view.match_index is not None  # re-warmed for the config
            assert _admin(srv.port, "save") == {"admin": {"saved": True}}
            stats = _talk(srv.port, [{"op": "stats"}], 1)[0]["stats"]
            assert stats["audios"] == 3 and stats["owner"] is True
            assert stats["generation"] > gen
            assert stats["search_p50_ms"] > 0
            assert stats["counters"]["search.queries"] >= 2
        # what the server checkpointed is what a fresh engine restores
        eng.close()
        fresh = Tiresias(cfg, device="cpu")
        assert sorted(a.name for a in fresh.get_audios("m")) == [
            "tone0.wav", "tone1.wav", "tone3.wav"]
        fresh.close()

    def test_sync_reload_and_remove_context(self, owner, tmp_path):
        from tiresias_tpu_torch.config import ContextConfig
        from tiresias_tpu_torch.utils.audio import write_wav

        eng, media, cfg = owner
        extra = tmp_path / "extra"
        extra.mkdir()
        write_wav(str(extra / "e.wav"), synth_tone(1500, 1.0, SR), SR)
        new_cfg = {"cfg": TiresiasConfig(
            match=cfg.match, data_dir=cfg.data_dir,
            contexts=(*cfg.contexts, ContextConfig("x", str(extra))),
        )}

        def reload_config():
            if new_cfg["cfg"] is None:
                raise FileNotFoundError("conf gone")
            return new_cfg["cfg"]

        with _running(eng, reload_config=reload_config) as srv:
            write_wav(str(media / "late.wav"), synth_tone(1100, 1.0, SR), SR)
            sync = _admin(srv.port, "sync", context="m")["admin"]["sync"]
            assert sync == {"created": 1, "deduped": 4, "deleted": 0,
                            "failed": 0}
            assert _admin(srv.port, "sync",
                          context="nope")["code"] == "unknown_context"
            assert _admin(srv.port, "sync")["admin"]["sync"]["created"] == 0
            reply = _admin(srv.port, "reload")["admin"]
            assert reply["reloaded"] and reply["contexts"] == ["m", "x"]
            assert reply["sync"]["created"] == 1
            new_cfg["cfg"] = None  # the conf file vanished
            failed = _admin(srv.port, "reload")
            assert failed["code"] == "bad_config"
            assert [c.name for c in eng.config.contexts] == ["m", "x"]
            assert _admin(srv.port, "remove_context",
                          context="x") == {"admin": {"removed": True}}
            assert _admin(srv.port, "remove_context",
                          context="x") == {"admin": {"removed": False}}
            names = [c["name"] for c in _admin(
                srv.port, "show_contexts")["admin"]["contexts"]]
            assert names == ["m"]

    def test_replica_server_follows_the_owner(self, owner):
        eng, media, cfg = owner
        replica = Tiresias(cfg, exclusive=False, device="cpu")
        with pytest.raises(ValueError, match="follow"):
            RecognitionServer(eng, port=0, follow_interval=0.1)  # an owner
        with pytest.raises(ValueError, match="exclusive"):
            RecognitionServer(replica, port=0, follow_interval=0.1,
                              watch_interval=1.0)
        with _running(replica, follow_interval=0.1) as srv:
            assert not (srv.engine.lock.held)
            stats = _talk(srv.port, [{"op": "stats"}], 1)[0]["stats"]
            assert stats["audios"] == 4 and stats["owner"] is False
            assert _admin(srv.port, "save")["code"] == "read_only"
            eng.add_audio_pcm("m", "fresh", _tone_i16(1900, 2.0), SR)
            eng.save()
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and len(replica.store) != 5:
                time.sleep(0.05)
            assert len(replica.store) == 5
            found = _admin(srv.port, "search", pcm=_b64(_tone_i16(1900)),
                           context="m")["admin"]["result"]
            assert found["TIRFILENAME"] == "fresh"
            stats = _talk(srv.port, [{"op": "stats"}], 1)[0]["stats"]
            assert stats["generation"] == eng.store._save_gen
        from tiresias_tpu_torch.utils.tracing import metrics

        counters = metrics.snapshot()["counters"]
        assert counters.get("serve.follow_errors", 0) == 0
        replica.close()


class TestStreamsOverSockets:
    def test_channels_equal_the_direct_batch_search(self, server, engine):
        """16 channels on one connection, fed in 20 ms pcm ops as int16 and
        as u-law codes: every TIR* equals search_pcm_batch on the same
        windows."""
        import socket

        from tiresias_tpu_torch.utils.g711 import encode

        n = 16
        windows = [_tone_i16(300 + 200 * (i % 4), 0.5) for i in range(n)]
        codes = [encode(w.astype(np.float32) / 32768.0, "ulaw")
                 for w in windows[:4]]
        results = {}
        with socket.create_connection(("127.0.0.1", server.port),
                                      timeout=60) as s:
            f = s.makefile("rw")
            for i in range(n):
                f.write(json.dumps({"op": "open", "channel": f"c{i}",
                                    "context": "m", "duration_ms": 500}) + "\n")
            for i in range(4):
                f.write(json.dumps({"op": "open", "channel": f"u{i}",
                                    "context": "m", "duration_ms": 500,
                                    "format": "ulaw", "coefs": 1,
                                    "trunc_coef1": True,
                                    "tolerance": 1.0}) + "\n")
            f.flush()
            for _ in range(n + 4):
                assert json.loads(f.readline())["opened"] is True
            for off in range(0, SR // 2, 160):
                for i in range(n):
                    f.write(json.dumps({
                        "op": "pcm", "channel": f"c{i}",
                        "pcm": _b64(windows[i][off : off + 160])}) + "\n")
                for i in range(4):
                    f.write(json.dumps({
                        "op": "pcm", "channel": f"u{i}",
                        "pcm": _b64(codes[i][off : off + 160])}) + "\n")
            f.flush()
            for _ in range(n + 4):
                msg = json.loads(f.readline())
                assert msg["window"] == 0
                msg["result"].pop("CONFIDENCE")
                results[msg["channel"]] = msg["result"]
        direct = engine.search_pcm_batch("m", windows, SR)
        for i, want in enumerate(direct):
            assert results[f"c{i}"] == want.to_channel_vars()
            assert results[f"c{i}"]["TIRFILENAME"] == f"tone{i % 4}"
        direct = engine.search_pcm_batch(
            "m", codes, SR, wire_law="ulaw", coefs=1, trunc_coef1=True,
            tolerance=1.0)
        for i, want in enumerate(direct):
            assert results[f"u{i}"] == want.to_channel_vars()
        bad = _talk(server.port, [{"op": "open", "channel": "g",
                                   "format": "gsm"}], 1)[0]
        assert "unknown format" in bad["error"]
