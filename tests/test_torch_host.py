"""The port stands alone: it imports nothing of the JAX package, its copies
of the host modules behave as the originals do, and its entry points run on
the card unless the caller names the CPU.

The copies (``tiresias_tpu_torch.config``, ``utils.{audio, g711, hashing,
locking, logging, native}``, ``ops.{dct, melbank, windows}``) are held to
``tiresias_tpu``'s modules field by field and bit for bit.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

from tiresias_tpu import config as jcfg
from tiresias_tpu.ops import dct as jdct
from tiresias_tpu.ops import melbank as jmel
from tiresias_tpu.ops import reference_dsp as jref
from tiresias_tpu.ops import windows as jwin
from tiresias_tpu.utils import g711 as jg711
from tiresias_tpu.utils import hashing as jhash
from tiresias_tpu_torch import config as tcfg
from tiresias_tpu_torch.ops import dct as tdct
from tiresias_tpu_torch.ops import melbank as tmel
from tiresias_tpu_torch.ops import mfcc as tmfcc
from tiresias_tpu_torch.ops import mfcc_kernels as tmk
from tiresias_tpu_torch.ops import windows as twin
from tiresias_tpu_torch.utils import g711 as tg711
from tiresias_tpu_torch.utils import hashing as thash

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources() -> list[str]:
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "tiresias_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path: str) -> set[str]:
    """Every module an ``import`` or ``from ... import`` names anywhere in
    the file, function bodies included."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO)
)
def test_port_source_imports_no_jax_package(path):
    bad = sorted(
        m for m in _imported_modules(path)
        if m.split(".")[0] in ("tiresias_tpu", "jax", "jaxlib")
    )
    assert not bad, bad


def test_ast_scan_sees_lazy_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("def f():\n    from tiresias_tpu.utils import g711\n"
                   "    import tiresias_tpu.config\n")
    assert _imported_modules(str(src)) == {"tiresias_tpu.utils",
                                           "tiresias_tpu.config"}


@pytest.mark.parametrize(
    "name", ["DspConfig", "MatchConfig", "ContextConfig", "TiresiasConfig"]
)
def test_config_dataclasses_equal_jax(name):
    ours, ref = getattr(tcfg, name), getattr(jcfg, name)
    assert [(f.name, f.default, f.type) for f in dataclasses.fields(ours)] == [
        (f.name, f.default, f.type) for f in dataclasses.fields(ref)]
    assert ours.__dataclass_params__.frozen == ref.__dataclass_params__.frozen


def test_config_constants_equal_jax():
    for key in ("DEF_HOP_SIZE", "DEF_BUF_SIZE", "DEF_SAMPLERATE",
                "DEF_N_FILTERS", "DEF_N_COEFS", "DEF_SEARCH_TOLERANCE",
                "DEF_DURATION_MS", "GLOBAL_SECTION", "NOISE20_COEF_WEIGHTS"):
        assert getattr(tcfg, key) == getattr(jcfg, key), key
    assert dataclasses.asdict(tcfg.TiresiasConfig()) == dataclasses.asdict(
        jcfg.TiresiasConfig())
    # the lru_caches of ops/mfcc_kernels.py key on the DspConfig
    assert hash(tcfg.DspConfig()) == hash(tcfg.DspConfig(256, 512))


@pytest.mark.parametrize("kwargs", [
    {"hop_size": 0}, {"buf_size": 500}, {"n_coefs": 0}, {"n_coefs": 41},
    {"coef_weights": (1.0,)}, {"coef_weights": (1.0, -1.0)},
    {"coef_weights": [1, 2]},
])
def test_dsp_validation_equals_jax(kwargs):
    def outcome(cls):
        try:
            return "ok", dataclasses.asdict(cls(**kwargs))
        except ValueError as exc:
            return "ValueError", str(exc)

    assert outcome(tcfg.DspConfig) == outcome(jcfg.DspConfig)


@pytest.mark.parametrize("margin", [0.0, 0.5, 1.0, -0.1])
def test_match_validation_equals_jax(margin):
    def outcome(cls):
        try:
            return "ok", dataclasses.asdict(cls(min_margin=margin))
        except ValueError as exc:
            return "ValueError", str(exc)

    assert outcome(tcfg.MatchConfig) == outcome(jcfg.MatchConfig)


def test_load_config_equals_jax(tmp_path):
    conf = tmp_path / "tiresias.conf"
    conf.write_text(
        "[global]\ntolerance = 0.25\ncoefs = 2\ntrunc_coef1 = no\n"
        "aligned = yes\nmin_margin = 0.2\nn_coefs = 8\n"
        "coef_weights = noise20\ndata_dir = /data/t\nunknown = 1\n"
        "[media]\ndirectory = /srv/100%tones\n[orphan]\nfoo = bar\n"
    )
    ours, ref = tcfg.load_config(str(conf)), jcfg.load_config(str(conf))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.contexts == (tcfg.ContextConfig("media", "/srv/100%tones"),)
    with pytest.raises(FileNotFoundError):
        tcfg.load_config(str(tmp_path / "missing.conf"))


@pytest.mark.parametrize("sr", [8000, 16000, 44100])
@pytest.mark.parametrize("buf", [64, 480, 512, 1024, 4096])
def test_dsp_tables_bitwise_equal_jax(buf, sr):
    np.testing.assert_array_equal(tmel.mel_filterbank(40, buf, sr),
                                  jmel.mel_filterbank(40, buf, sr))
    for dtype in (np.float32, np.float64):
        np.testing.assert_array_equal(twin.hanningz(buf, dtype),
                                      jwin.hanningz(buf, dtype))
        np.testing.assert_array_equal(twin.get_window("hanning", buf, dtype),
                                      jwin.get_window("hanning", buf, dtype))


@pytest.mark.parametrize("n_coefs", [1, 2, 8, 13, 40])
def test_dct_matrix_bitwise_equal_jax(n_coefs):
    np.testing.assert_array_equal(tdct.dct_matrix(40, n_coefs),
                                  jdct.dct_matrix(40, n_coefs))


@pytest.mark.parametrize("law", ["ulaw", "alaw"])
def test_g711_tables_bitwise_equal_jax(law):
    np.testing.assert_array_equal(tg711.decode_table(law),
                                  jg711.decode_table(law))
    assert tg711.SILENCE_BYTE[law] == jg711.SILENCE_BYTE[law]
    pcm = np.linspace(-1.0, 1.0, 4001, dtype=np.float32)
    np.testing.assert_array_equal(tg711.encode(pcm, law),
                                  jg711.encode(pcm, law))
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(tg711.decode(codes, law),
                                  jg711.decode(codes, law))


def test_hashing_equals_jax(tmp_path):
    path = tmp_path / "x.bin"
    path.write_bytes(bytes(range(256)) * 1000)
    assert thash.file_md5(str(path)) == jhash.file_md5(str(path))


def test_n_frames_for_and_floor_equal_jax():
    for hop in (1, 160, 240, 256):
        for n in range(0, 3 * hop + 2):
            assert tmfcc.n_frames_for(n, hop) == jref.n_frames_for(n, hop)
    assert tmk.VERY_SMALL_NUMBER == jref.VERY_SMALL_NUMBER


def _entry_points(tmp_path):
    from tiresias_tpu_torch.api import Tiresias
    from tiresias_tpu_torch.engine import sync
    from tiresias_tpu_torch.store.fingerprint_store import FingerprintStore

    media = tmp_path / "m"
    media.mkdir(exist_ok=True)
    cfg = tcfg.TiresiasConfig(
        contexts=(tcfg.ContextConfig("media", str(media)),),
        data_dir=str(tmp_path / "d"))
    store = FingerprintStore(device="cpu")
    store.create_context("media", str(media))
    pcm = np.zeros(2048, np.float32)
    padded, _ = tmfcc.pad_frames_bucket([pcm], 256)
    from tiresias_tpu_torch import cli
    from tiresias_tpu_torch.serve.server import run_server
    from tiresias_tpu_torch.utils.audio import write_wav

    conf = tmp_path / "t.conf"
    conf.write_text(f"[global]\ndata_dir={tmp_path / 'd'}\n\n[media]\n"
                    f"directory={media}\n")
    wav = str(tmp_path / "q.wav")
    write_wav(wav, pcm, 8000)

    def run_cli(*argv):
        return lambda: cli.main(["-c", str(conf), *argv])

    return {
        "Tiresias.warmup": lambda: Tiresias(cfg).warmup(),
        "run_server": lambda: run_server(Tiresias(cfg), port=0),
        "cli create": run_cli("create"),
        "cli search": run_cli("search", "media", wav),
        "cli search --top": run_cli("search", "media", wav, "--top", "3"),
        "cli remove audio": run_cli("remove", "audio", "no-such-uuid"),
        "cli warmup": run_cli("warmup"),
        "cli serve": run_cli("serve", "--port", "0"),
        "cli serve --replica": run_cli("serve", "--port", "0", "--replica"),
        "Tiresias": lambda: Tiresias(cfg),
        "FingerprintStore": lambda: FingerprintStore(),
        "FingerprintStore.load": lambda: FingerprintStore.load(
            str(tmp_path / "ckpt")),
        "ingest_files": lambda: sync.ingest_files(store, "media", []),
        "sync_context_audio": lambda: sync.sync_context_audio(
            store, "media", str(media)),
        "sync_all": lambda: sync.sync_all(store, cfg),
        "fingerprint_padded_batch": lambda: tmfcc.fingerprint_padded_batch(
            padded, 8000),
        "fingerprint_signals_async": lambda: tmfcc.fingerprint_signals_async(
            [pcm], 8000),
        "fingerprint_signals": lambda: tmfcc.fingerprint_signals([pcm], 8000),
        "fingerprint_signal": lambda: tmfcc.fingerprint_signal(pcm, 8000),
    }


@pytest.mark.parametrize("name", [
    "Tiresias", "FingerprintStore", "FingerprintStore.load", "ingest_files",
    "sync_context_audio", "sync_all", "fingerprint_padded_batch",
    "fingerprint_signals_async", "fingerprint_signals", "fingerprint_signal",
    "Tiresias.warmup", "run_server", "cli create", "cli search",
    "cli search --top", "cli remove audio", "cli warmup", "cli serve",
    "cli serve --replica",
])
def test_entry_point_defaults_to_cuda(name, tmp_path, monkeypatch):
    """Without a card, an entry point called without ``device`` raises:
    its default is ``cuda`` and nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _entry_points(tmp_path)[name]
    with pytest.raises(RuntimeError, match="device='cuda'"):
        call()


def test_host_only_cli_commands_need_no_card(tmp_path, monkeypatch, capsys):
    """Listings, stats and fsck read the catalog on the host and build no
    engine: they answer whatever ``--device`` says."""
    from tiresias_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = tmp_path / "t.conf"
    conf.write_text(f"[global]\ndata_dir={tmp_path / 'd'}\n\n[media]\n"
                    f"directory={tmp_path}\n")
    assert cli.main(["-c", str(conf), "show", "contexts"]) == 0
    assert cli.main(["-c", str(conf), "show", "audios", "media"]) == 0
    assert cli.main(["-c", str(conf), "stats"]) == 0
    assert cli.main(["-c", str(conf), "fsck"]) == 1  # no checkpoint yet
    assert cli.main(["-c", str(conf), "bench"]) == 1  # not ported: says so
    assert "ROADMAP" in capsys.readouterr().err


def test_profiles_equal_jax():
    from tiresias_tpu import profiles as jprof
    from tiresias_tpu_torch import profiles as tprof

    names = [n for n in dir(jprof) if n.isupper()]
    assert names and names == [n for n in dir(tprof) if n.isupper()]
    for n in names:
        ours, ref = getattr(tprof, n), getattr(jprof, n)
        if dataclasses.is_dataclass(ref):
            assert dataclasses.asdict(ours) == dataclasses.asdict(ref), n
        elif isinstance(ref, dict):
            assert {k: repr(v) for k, v in ours.items()} == {
                k: repr(v) for k, v in ref.items()}, n
        else:
            assert repr(ours) == repr(ref), n


def test_serve_and_cli_import_neither_jax_nor_the_jax_package():
    """conftest imports jax in this process, so the check runs in a fresh
    interpreter."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import tiresias_tpu_torch.serve.server, tiresias_tpu_torch.cli\n"
        "import tiresias_tpu_torch.serve.admin, tiresias_tpu_torch.profiles\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'tiresias_tpu' or "
        "m.startswith('tiresias_tpu.'))\n"
        "assert not bad, bad\nprint('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
