"""The port's CLI (``tiresias_tpu_torch.cli``) with ``--device cpu``:
reference command/table parity, the create/search verbs, and byte-equal
output against the JAX package's CLI on the same data directory.

Table formats and messages mirror cli_handler.c:78,132,185,223 and the
transcripts in cli_operation.rst.
"""

import os

import pytest
import torch

from tiresias_tpu_torch import cli
from tiresias_tpu_torch.utils.audio import synth_tone, write_wav

torch.set_num_threads(2)

SR = 8000


@pytest.fixture()
def env(tmp_path):
    directory = tmp_path / "media"
    directory.mkdir()
    for i in range(3):
        write_wav(str(directory / f"t{i}.wav"), synth_tone(300 + 150 * i, 0.8, SR), SR)
    conf = tmp_path / "tiresias.conf"
    conf.write_text(
        "[global]\n"
        "tolerance=0.01\n"
        "coefs=2\n"
        "trunc_coef1=no\n"
        f"data_dir={tmp_path / 'data'}\n"
        "\n"
        "[media]\n"
        f"directory={directory}\n"
    )
    return {"conf": str(conf), "dir": str(directory)}


def run(capsys, *argv):
    rc = cli.main(["--device", "cpu", *argv])
    return rc, capsys.readouterr().out


class TestCli:
    def test_create_and_show(self, env, capsys):
        rc, out = run(capsys, "-c", env["conf"], "create")
        assert rc == 0 and "created[3]" in out

        rc, out = run(capsys, "-c", env["conf"], "show", "contexts")
        assert rc == 0
        lines = out.splitlines()
        assert lines[0].startswith("Name")
        assert any(line.startswith("media") for line in lines[1:])
        # reference column width: name padded to 36 (cli_handler.c:78)
        assert lines[1][:36].strip() == "media"

        rc, out = run(capsys, "-c", env["conf"], "show", "audios", "media")
        assert rc == 0
        lines = out.splitlines()
        assert lines[0].split() == ["Uuid", "Name", "Context", "Hash"]
        assert len(lines) == 4  # header + 3 audios
        # column offsets: 36+1, 45+1, 36+1 (cli_handler.c:132)
        assert lines[1][37:82].strip() == "t0.wav"

    def test_show_audios_unknown_context(self, env, capsys):
        rc, out = run(capsys, "-c", env["conf"], "show", "audios", "nope")
        assert rc == 1 and "Could not find context info. context[nope]" in out

    def test_search_found(self, env, capsys):
        run(capsys, "-c", env["conf"], "create")
        rc, out = run(
            capsys, "-c", env["conf"], "search", "media",
            os.path.join(env["dir"], "t1.wav"),
        )
        assert rc == 0
        vars_ = dict(line.split("=", 1) for line in out.strip().splitlines())
        assert vars_["TIRSTATUS"] == "FOUND"
        assert vars_["TIRFILENAME"] == "t1.wav"
        assert float(vars_["CONFIDENCE"]) == 1.0

    def test_search_many_table(self, env, capsys):
        run(capsys, "-c", env["conf"], "create")
        rc, out = run(
            capsys, "-c", env["conf"], "search", "media",
            os.path.join(env["dir"], "t2.wav"),
            os.path.join(env["dir"], "t0.wav"),
            os.path.join(env["dir"], "t1.wav"),
        )
        assert rc == 0
        lines = out.splitlines()
        assert lines[0].split() == [
            "File", "Status", "Name", "Votes", "Frames", "Confidence"]
        # rows keep the argument order and each file self-matches
        for row, name in zip(lines[1:], ("t2.wav", "t0.wav", "t1.wav")):
            cols = row.split()
            assert cols[0] == name and cols[1] == "FOUND" and cols[2] == name

    def test_search_many_notfound_and_error_codes(self, env, capsys, tmp_path):
        run(capsys, "-c", env["conf"], "create")
        from tiresias_tpu_torch.utils.audio import synth_tone, write_wav

        alien = tmp_path / "alien.wav"
        write_wav(str(alien), synth_tone(2600, 0.8, SR), SR)
        rc, out = run(
            capsys, "-c", env["conf"], "search", "media",
            os.path.join(env["dir"], "t0.wav"), str(alien),
        )
        assert rc == 2  # one NOTFOUND row
        rows = out.splitlines()[1:]
        assert rows[0].split()[1] == "FOUND"
        assert rows[1].split()[:3] == ["alien.wav", "NOTFOUND", "-"]

        rc, out = run(
            capsys, "-c", env["conf"], "search", "media",
            os.path.join(env["dir"], "t0.wav"), str(tmp_path / "missing.wav"),
        )
        assert rc == 1  # unreadable file wins the exit code
        assert "ERROR" in out

    def test_search_many_rejects_top(self, env, capsys):
        run(capsys, "-c", env["conf"], "create")
        rc = cli.main([
            "--device", "cpu", "-c", env["conf"], "search", "media",
            os.path.join(env["dir"], "t0.wav"),
            os.path.join(env["dir"], "t1.wav"),
            "--top", "3",
        ])
        captured = capsys.readouterr()
        assert rc == 1 and "--top supports a single file" in captured.err

    def test_search_topk_table(self, env, capsys):
        run(capsys, "-c", env["conf"], "create")
        rc, out = run(
            capsys, "-c", env["conf"], "search", "media",
            os.path.join(env["dir"], "t0.wav"), "--top", "3", "--tolerance", "1.0",
        )
        assert rc == 0
        lines = out.splitlines()
        assert lines[0].split() == ["Rank", "Uuid", "Name", "Votes", "Confidence"]
        assert len(lines) >= 2 and lines[1].startswith("1")

    def test_remove_audio_and_context(self, env, capsys):
        run(capsys, "-c", env["conf"], "create")
        _, out = run(capsys, "-c", env["conf"], "show", "audios", "media")
        uuid = out.splitlines()[1].split()[0]

        rc, out = run(capsys, "-c", env["conf"], "remove", "audio", uuid)
        assert rc == 0 and out.strip() == f"Removed the audio info. uuid[{uuid}]"

        rc, out = run(capsys, "-c", env["conf"], "remove", "audio", uuid)
        assert rc == 1 and "Could not remove the audio info" in out

        rc, out = run(capsys, "-c", env["conf"], "remove", "context", "media")
        assert rc == 0 and out.strip() == "Removed the context info. context[media]"
        # NOTE: a context named in the config is re-created on the next
        # engine init (the reference does the same at module load,
        # app_tiresias.c:279-315), so a repeat remove also succeeds — but
        # its audios stay gone.
        _, out = run(capsys, "-c", env["conf"], "show", "audios", "media")
        assert len(out.splitlines()) == 1  # header only

    def test_remove_unknown_context(self, env, capsys):
        rc, out = run(capsys, "-c", env["conf"], "remove", "context", "ghost")
        assert rc == 1 and "Could not remove the context info" in out

    def test_create_named_unknown_context(self, env, capsys):
        rc, out = run(capsys, "-c", env["conf"], "create", "nope")
        assert rc == 1 and "Could not find context info" in out


def test_serve_watch_validated_before_engine_work(capsys):
    """--watch 0 must fail fast (exit 2), before the engine restore and
    the warmup ever start."""
    assert cli.main(["--device", "cpu", "serve", "--watch", "0"]) == 2
    assert "--watch" in capsys.readouterr().err


class TestCliCatalogReads:
    def test_show_is_catalog_only(self, env, capsys, monkeypatch):
        """Listings must read catalog metadata, never deserialize the
        fingerprint tiers (a multi-GB checkpoint just to print a table)."""
        run(capsys, "-c", env["conf"], "create")
        from tiresias_tpu_torch.store.fingerprint_store import FingerprintStore

        def boom(*a, **k):
            raise AssertionError("full store load in a read-only listing")

        monkeypatch.setattr(FingerprintStore, "load", staticmethod(boom))
        rc, out = run(capsys, "-c", env["conf"], "show", "contexts")
        assert rc == 0 and any(
            line.startswith("media") for line in out.splitlines()
        )
        rc, out = run(capsys, "-c", env["conf"], "show", "audios", "media")
        assert rc == 0 and len(out.splitlines()) == 4  # header + 3
        rc, out = run(capsys, "-c", env["conf"], "show", "audios", "ghost")
        assert rc == 1 and "Could not find context info" in out

    def test_top_zero_and_negative_rejected(self, env, capsys):
        with pytest.raises(SystemExit):
            cli.main(["--device", "cpu", "-c", env["conf"], "search",
                      "media", "x.wav",
                      "--top", "0"])
        assert "positive integer" in capsys.readouterr().err
        with pytest.raises(SystemExit):
            cli.main(["--device", "cpu", "-c", env["conf"], "search",
                      "media", "x.wav",
                      "--top=-3"])


class TestShowBeforeFirstCheckpoint:
    def test_configured_context_lists_before_ingest(self, env, capsys):
        """A configured-but-never-ingested data dir must list its
        contexts (empty audio table, rc 0) — the catalog-only read merges
        config contexts exactly like engine construction does."""
        rc, out = run(capsys, "-c", env["conf"], "show", "contexts")
        assert rc == 0
        assert any(line.startswith("media") for line in out.splitlines())
        rc, out = run(capsys, "-c", env["conf"], "show", "audios", "media")
        assert rc == 0 and len(out.splitlines()) == 1  # header only


class TestStatsCommand:
    def test_offline_stats_summary(self, env, capsys):
        rc, out = run(capsys, "-c", env["conf"], "stats")
        assert rc == 0 and "no running server" in out
        assert "0 audios in 1 contexts" in out
        run(capsys, "-c", env["conf"], "create")
        rc, out = run(capsys, "-c", env["conf"], "stats")
        assert rc == 0 and "3 audios in 1 contexts" in out


class TestWarmupCommand:
    def test_warmup_reports_programs_and_runs(self, env, capsys):
        """`warmup` runs a server start's searches and map builds and
        reports the bill — the operator's pre-cutover cold-start tool. On
        the CPU there is no kernel library to build."""
        run(capsys, "-c", env["conf"], "create")
        rc, out = run(
            capsys, "-c", env["conf"], "warmup", "--max-channels", "2",
            "--wire-formats", "ulaw",
        )
        assert rc == 0
        assert "batch sizes (1, 2) x 3 wire dtypes" in out
        assert "kernel build directory" in out and "none on the CPU" in out
        assert "warmup complete" in out

    def test_warmup_rejects_unknown_wire_format(self, env, capsys):
        rc, _ = run(
            capsys, "-c", env["conf"], "warmup", "--wire-formats", "gsm",
        )
        assert rc == 2


# ---- byte-equal output against the JAX package's CLI ------------------- #


@pytest.fixture
def jax_query_fp(monkeypatch):
    """The port fingerprints its queries with the JAX function, so both
    CLIs vote equal query fingerprints against the one checkpoint."""
    import numpy as np

    from tiresias_tpu.ops.mfcc_jax import fingerprint_padded_batch as jax_fp
    from tiresias_tpu_torch.api import engine as tengine

    def fp(padded, samplerate, dsp, law=None, n_valid=None, device="cpu"):
        out = jax_fp(padded, samplerate, dsp, law=law, n_valid=n_valid)
        return torch.from_numpy(np.array(out)).to(device)

    monkeypatch.setattr(tengine, "fingerprint_padded_batch", fp)


def _both(capsys, *argv):
    from tiresias_tpu import cli as jcli

    jrc = jcli.main(list(argv))
    jout = capsys.readouterr().out
    trc, tout = run(capsys, *argv)
    return (jrc, jout), (trc, tout)


class TestOutputEqualsJaxCli:
    def test_listings_and_searches_byte_equal(self, env, capsys, tmp_path,
                                              jax_query_fp):
        from tiresias_tpu import cli as jcli

        assert jcli.main(["-c", env["conf"], "create"]) == 0
        capsys.readouterr()
        files = [os.path.join(env["dir"], f"t{i}.wav") for i in (2, 0, 1)]
        alien = tmp_path / "alien.wav"
        write_wav(str(alien), synth_tone(2600, 0.8, SR), SR)
        cases = [
            ("show", "contexts"),
            ("show", "audios", "media"),
            ("show", "audios", "nope"),
            ("stats",),
            ("search", "media", files[0]),
            ("search", "media", files[1], "--filter-context"),
            ("search", "media", str(alien)),
            ("search", "media", *files, str(alien)),
            ("search", "media", files[0], "--top", "3", "--tolerance", "1.0"),
            ("search", "media", files[1], "--top", "2", "--coefs", "1",
             "--tolerance", "1.0"),
            ("search", "media", str(alien), "--top", "5"),
            ("fsck", "--deep"),
        ]
        for argv in cases:
            want, got = _both(capsys, "-c", env["conf"], *argv)
            assert got == want, argv
            assert got[1], argv
        # the table of the ranked search really ranked something
        _, (rc, out) = _both(capsys, "-c", env["conf"], *cases[8])
        lines = out.splitlines()
        assert rc == 0 and len(lines) == 4 and lines[1].split()[0] == "1"

    def test_port_created_store_lists_in_the_jax_cli(self, env, capsys):
        """The other direction: what the port's ``create`` checkpoints, the
        JAX CLI lists byte for byte, and ``remove`` messages are equal."""
        rc, out = run(capsys, "-c", env["conf"], "create")
        assert rc == 0 and "created[3]" in out
        for argv in (("show", "contexts"), ("show", "audios", "media"),
                     ("stats",), ("fsck",)):
            want, got = _both(capsys, "-c", env["conf"], *argv)
            assert got == want, argv
        uuid = got = None
        _, out = run(capsys, "-c", env["conf"], "show", "audios", "media")
        uuid = out.splitlines()[1].split()[0]
        rc, out = run(capsys, "-c", env["conf"], "remove", "audio", uuid)
        assert rc == 0
        want, got = _both(capsys, "-c", env["conf"], "remove", "audio", uuid)
        assert got == want and got[0] == 1  # already gone, in both
        want, got = _both(capsys, "-c", env["conf"], "show", "audios", "media")
        assert got == want and len(got[1].splitlines()) == 3


class TestProxyToLiveServer:
    def test_cli_answers_from_the_running_server(self, env, capsys):
        """With a server owning the data directory the CLI proxies: the
        listing, search, --top, create and remove run against ITS store."""
        import asyncio
        import threading

        from tiresias_tpu_torch.api import Tiresias
        from tiresias_tpu_torch.config import load_config
        from tiresias_tpu_torch.serve.server import RecognitionServer

        eng = Tiresias(load_config(env["conf"]), device="cpu")
        assert eng.sync().created == 3
        started, holder = threading.Event(), {}

        def runner():
            async def main():
                srv = RecognitionServer(eng, port=0, samplerate=SR)
                await srv.start()
                holder["srv"], holder["loop"] = srv, asyncio.get_running_loop()
                started.set()
                try:
                    await srv.serve_forever()
                except asyncio.CancelledError:
                    pass

            asyncio.run(main())

        threading.Thread(target=runner, daemon=True).start()
        assert started.wait(10)
        try:
            # an audio that exists only in the live store, never saved
            live = eng.add_audio_pcm("media", "live-only",
                                     synth_tone(1900, 0.8, SR), SR)
            rc, out = run(capsys, "-c", env["conf"], "show", "audios", "media")
            assert rc == 0 and "live-only" in out
            q = os.path.join(env["dir"], "..", "q.wav")
            write_wav(q, synth_tone(1900, 0.8, SR), SR)
            rc, out = run(capsys, "-c", env["conf"], "search", "media", q)
            assert rc == 0 and "TIRFILENAME=live-only" in out
            rc, out = run(capsys, "-c", env["conf"], "search", "media", q,
                          "--top", "2", "--tolerance", "1.0")
            assert rc == 0 and out.splitlines()[0].startswith("Rank")
            rc, out = run(capsys, "-c", env["conf"], "search", "media", q,
                          os.path.join(env["dir"], "t0.wav"))
            assert rc == 0 and out.splitlines()[1].split()[2] == "live-only"
            rc, out = run(capsys, "-c", env["conf"], "stats")
            assert rc == 0 and "audios: 4" in out and "owner: True" in out
            rc, out = run(capsys, "-c", env["conf"], "create", "media")
            assert rc == 0 and "deleted[1]" in out  # not on disk: synced away
            rc, out = run(capsys, "-c", env["conf"], "remove", "audio",
                          live.uuid)
            assert rc == 1 and "Could not remove" in out
            rc, out = run(capsys, "-c", env["conf"], "reload")
            assert rc == 0 and out.startswith("Reloaded. contexts[media]")
        finally:
            asyncio.run_coroutine_threadsafe(
                holder["srv"].stop(), holder["loop"]).result(20)
            eng.close()
        rc = cli.main(["--device", "cpu", "-c", env["conf"], "reload"])
        assert rc == 1 and "no running server" in capsys.readouterr().err
