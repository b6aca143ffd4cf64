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
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "examples", "quickstart_torch.py")]
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
    from tiresias_tpu_torch import bench, cli
    from tiresias_tpu_torch.serve.server import run_server
    from tiresias_tpu_torch.tools import accuracy_study, margin_study, soak
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
        "cli bench": run_cli("bench"),
        "cli bench --section": run_cli("bench", "--section", "search"),
        "bench --section": lambda: bench.main(["--section", "search"]),
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
        "tools.soak": lambda: soak.main(["--channels", "1"]),
        "tools.soak.build_engine": soak.build_engine,
        "tools.accuracy_study": lambda: accuracy_study.main(["2", "1"]),
        "tools.margin_study": lambda: margin_study.main(["--tracks", "2"]),
        "tools.margin_study --weighted": lambda: margin_study.main(
            ["--weighted", "--tracks", "2"]),
    }


@pytest.mark.parametrize("name", [
    "Tiresias", "FingerprintStore", "FingerprintStore.load", "ingest_files",
    "sync_context_audio", "sync_all", "fingerprint_padded_batch",
    "fingerprint_signals_async", "fingerprint_signals", "fingerprint_signal",
    "Tiresias.warmup", "run_server", "cli create", "cli search",
    "cli search --top", "cli remove audio", "cli warmup", "cli serve",
    "cli serve --replica", "cli bench", "cli bench --section",
    "bench --section", "tools.soak", "tools.soak.build_engine",
    "tools.accuracy_study", "tools.margin_study",
    "tools.margin_study --weighted",
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
    capsys.readouterr()
    # an unknown bench section lists the names and returns 2 before any
    # device is needed, as the JAX CLI does
    assert cli.main(["-c", str(conf), "bench", "--section", "nope"]) == 2
    err = capsys.readouterr().err
    assert "--section needs one of: fingerprint, search" in err
    assert "coldstart" in err


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


# ---- utils/timing: the arithmetic of a profile's reading (no card) ------ #


def _records(per_call: dict, reps: int, us: dict, lost: dict | None = None):
    """A synthetic profile: ``per_call[name]`` records a call of ``us[name]``
    microseconds each over ``reps`` calls, the first ``lost[name]`` of each
    name missing (CUPTI loses a profile's first records)."""
    out = []
    for name, n in per_call.items():
        out += [(name, us[name])] * (n * reps - (lost or {}).get(name, 0))
    return out


def test_profile_reading_of_a_whole_profile():
    from tiresias_tpu_torch.utils import timing

    recs = _records({"k_a": 1, "k_b": 2}, 20, {"k_a": 10.0, "k_b": 3.0})
    per, scaled = timing.profile_reading(recs, 20)
    assert scaled == [] and per[""] == pytest.approx(0.016)
    per, _ = timing.profile_reading(recs, 20, names=("k_a", "k_b"))
    assert per == pytest.approx({"k_a": 0.010, "k_b": 0.006})


def test_profile_reading_scales_lost_records_by_the_counters():
    """Records lost from two kernels: each reads as its mean record time
    times its launches a call (the counters'); the reading equals the
    whole profile's where every record of a kernel takes the same time."""
    from tiresias_tpu_torch.utils import timing

    calls = {"k_a": 1, "k_b": 2, "k_c": 3}
    us = {"k_a": 10.0, "k_b": 3.0, "k_c": 1.5}
    whole, _ = timing.profile_reading(_records(calls, 20, us), 20)
    lost = {"k_a": 3, "k_b": 25, "k_c": 2}  # k_b lost more than a call
    per, scaled = timing.profile_reading(_records(calls, 20, us, lost), 20,
                                         per_call=calls)
    assert sorted(scaled) == ["k_a", "k_b", "k_c"]
    assert per[""] == pytest.approx(whole[""])


def test_profile_reading_without_a_counter_takes_the_fewest_launches():
    """A kernel no counter names (plain torch, a memset) reads with the
    fewest whole launches a call its records allow: right while it lost
    less than a call's worth of records, low past that."""
    from tiresias_tpu_torch.utils import timing

    us = {"k_b": 3.0}
    per, scaled = timing.profile_reading(
        _records({"k_b": 2}, 20, us, {"k_b": 1}), 20)
    assert scaled == ["k_b"] and per[""] == pytest.approx(0.006)
    per, _ = timing.profile_reading(
        _records({"k_b": 2}, 20, us, {"k_b": 21}), 20)
    assert per[""] == pytest.approx(0.003)


def test_launches_per_call_from_the_counters():
    """The counters' launches over the profile give each kernel name the
    table (build.KERNEL_NAMES) links to them, where they are a whole number
    a call; K3''s counter names both of its kernels."""
    from tiresias_tpu_torch.utils import build, timing

    before = dict.fromkeys(build.LAUNCHES, 0)
    after = dict(before, lattice_votes=20, select_candidates=21,
                 match_votes=40, match_votes_cand_per_item=20)
    names = {"void lattice_planes_kernel(int const*)",
             "void lattice_votes_kernel<1, float>(float const*)",
             "void (anonymous namespace)::kb_select_kernel<false>(int*)",
             "void (anonymous namespace)::match_votes_kernel<false>(float)",
             "void (anonymous namespace)::match_votes_kernel<true>(float)",
             "void at::native::vectorized_elementwise_kernel<4>(int)"}
    got = timing.launches_per_call(names, before, after, 20)
    assert got == {
        "void lattice_planes_kernel(int const*)": 1,
        "void lattice_votes_kernel<1, float>(float const*)": 1,
        "void (anonymous namespace)::match_votes_kernel<false>(float)": 2,
        "void (anonymous namespace)::match_votes_kernel<true>(float)": 1}


def test_launches_per_call_adds_every_counter_of_a_kernel(monkeypatch):
    """A kernel that two counters launch (a template both run) has the sum
    of their launches a call, and none where that sum is no whole number
    a call."""
    from tiresias_tpu_torch.utils import build, timing

    monkeypatch.setattr(build, "KERNEL_NAMES", {
        "one": ("shared_kernel<false,",), "two": ("shared_kernel<false,",),
        "three": ("other_kernel",)})
    before = {"one": 0, "two": 0, "three": 0}
    names = {"void shared_kernel<false, 1>(int)", "void other_kernel(int)"}
    got = timing.launches_per_call(names, before,
                                   {"one": 20, "two": 40, "three": 30}, 20)
    assert got == {"void shared_kernel<false, 1>(int)": 3}


def test_kernel_names_cover_every_counter_and_kernel():
    """Every launch counter names its kernels, and every __global__ kernel
    of csrc/ is named by one counter."""
    import re

    from tiresias_tpu_torch.utils import build

    assert set(build.KERNEL_NAMES) == set(build.LAUNCHES)
    parts = [(c, p) for c, ps in build.KERNEL_NAMES.items() for p in ps]
    src = "".join(open(os.path.join(build.CSRC, f)).read()
                  for f in build.SOURCES)
    kernels = set(re.findall(r"__global__ void (?:__launch_bounds__\([^)]*"
                             r"\)\s*)?(\w+)\(", src))
    assert len(kernels) >= 20
    for k in kernels:
        owners = {c for c, p in parts if p.split("<")[0] == k}
        assert owners, k


def test_kernel_names_cover_every_instantiation():
    """Each instantiation of a kernel template that csrc/ launches (its
    template arguments written out, e.g. ``<true, 2>``) is named by a
    counter, so the profiler's name of every launch links to its count."""
    import re

    from tiresias_tpu_torch.utils import build

    parts = [p for ps in build.KERNEL_NAMES.values() for p in ps]
    src = "".join(open(os.path.join(build.CSRC, f)).read()
                  for f in build.SOURCES)
    kernels = set(re.findall(r"__global__ void (?:__launch_bounds__\([^)]*"
                             r"\)\s*)?(\w+)\(", src))
    found = set()
    for k, args in re.findall(r"(\w+)<([\w\s,]+)>", src):
        if k in kernels and re.fullmatch(r"[\s,0-9]*(?:true|false)?[\s,0-9"
                                         r"a-z]*", args):
            name = f"{k}<{', '.join(a.strip() for a in args.split(','))}>"
            found.add(name)
            assert any(name.startswith(p) for p in parts
                       if "<" in p or p == k), name
    assert "match_votes_aligned_bits_kernel_ws<1, false>" in found
    assert "match_votes_aligned_bits_kernel_ws<3, true>" in found


def test_ctypes_signatures_match_the_entry_points():
    """Every ``extern "C"`` entry point of csrc/ has a ctypes signature of
    its own parameters, kind for kind (pointer, int, float)."""
    import ctypes
    import re

    from tiresias_tpu_torch.utils import build

    src = "".join(open(os.path.join(build.CSRC, f)).read()
                  for f in build.SOURCES)
    kind = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_float: "F"}
    seen = set()
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        ps = [p.strip() for p in params.split(",") if p.strip()]
        got = "".join("P" if "*" in p else "F" if p.startswith("float")
                      else "I" for p in ps)
        assert got == "".join(kind[t] for t in build._SIGNATURES[name]), name
        seen.add(name)
    assert seen == set(build._SIGNATURES)


def test_profiler_loss_accountant_splits_device_ms_time():
    """tools/profiler_loss's Accountant on stand-ins for a tree's timing
    module and chip_smoke: a device_ms call that profiles three times and
    falls back to CUDA events counts two further profiles and a fallback;
    a direct events_ms call, a fresh-process check and each [time] line are
    counted apart."""
    import time
    import types

    from tiresias_tpu_torch.tools.profiler_loss import Accountant

    class Profile:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    timing = types.SimpleNamespace(CLOCKS=[], profile=Profile)

    def events_ms(fn, reps=20):
        time.sleep(0.01)
        return 1.0

    def device_ms(fn, reps=20):
        for _ in range(3 if fn() else 1):
            with timing.profile(activities=()):
                pass
        if fn():
            timing.CLOCKS.append("events")
            return timing.events_ms(fn, reps)
        timing.CLOCKS.append("profiler")
        return 0.5

    timing.events_ms, timing.device_ms = events_ms, device_ms
    said = []
    cs = types.SimpleNamespace(say=said.append, device_ms=device_ms,
                               events_ms=events_ms,
                               select_kernels_fresh=lambda shapes: shapes)
    acct = Accountant(timing, cs)
    cs.device_ms(lambda: False)
    cs.device_ms(lambda: True)
    cs.events_ms(None)
    cs.say("[time] a done at 1.0 s")
    cs.select_kernels_fresh([1])
    got = acct.totals()
    assert (got["device_ms_calls"], got["profiles"], got["further_profiles"],
            got["events_fallbacks"], got["events_direct_calls"],
            got["fresh_processes_calls"]) == (2, 4, 2, 1, 1, 1)
    assert got["events_fallback_s"] >= 0.01 and got["events_direct_s"] >= 0.01
    assert said == ["[time] a done at 1.0 s"]
    assert acct.phases[0][1]["fresh_processes_calls"] == 0
