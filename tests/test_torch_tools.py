"""The port's tools and quickstart against the JAX package's, on the CPU.

- The soak (``python -m tiresias_tpu_torch.tools.soak --device cpu``) passes
  the JAX soak test's assertions (tests/test_soak_tool.py), without
  importing ``jax``.
- The accuracy study prints the JAX tool's table, row for row, on the same
  numpy corpus.
- ``Tiresias._compute_votes`` is int32-equal to the JAX engine's in the
  dialplan, bag and aligned modes, with a context filter and a G.711 wire
  law, both engines holding the same stored fingerprints and fingerprinting
  their queries with the JAX function; the margin study's statistics agree
  with a direct numpy computation on those votes.
- The store's read accessors equal JAX's; the quickstart finds its file.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tiresias_tpu.api import Tiresias as JaxTiresias
from tiresias_tpu.config import DspConfig as JaxDsp
from tiresias_tpu.config import TiresiasConfig as JaxConfig
from tiresias_tpu.ops.mfcc_jax import fingerprint_padded_batch as jax_fp
from tiresias_tpu.store import fingerprint_store as jfs
from tiresias_tpu_torch.api import Tiresias
from tiresias_tpu_torch.api import engine as tengine
from tiresias_tpu_torch.config import DspConfig, TiresiasConfig
from tiresias_tpu_torch.store import fingerprint_store as tfs
from tiresias_tpu_torch.tools import margin_study
from tiresias_tpu_torch.utils.audio import float_to_i16
from tiresias_tpu_torch.utils.g711 import encode

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 8000

# runs a module or a script as ``python -m`` / ``python path`` does, then
# names every module of jax or the JAX package the run imported
_RUNNER = (
    "import runpy, sys\n"
    "sys.argv = sys.argv[1:]\n"
    "rc = 0\n"
    "try:\n"
    "    if sys.argv[0].endswith('.py'):\n"
    "        runpy.run_path(sys.argv[0], run_name='__main__')\n"
    "    else:\n"
    "        runpy.run_module(sys.argv[0], run_name='__main__',"
    " alter_sys=True)\n"
    "except SystemExit as exc:\n"
    "    rc = exc.code or 0\n"
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'jaxlib', 'tiresias_tpu'))\n"
    "print('IMPORTED', bad, flush=True)\n"
    "sys.exit(rc)\n"
)


def _env(**extra) -> dict:
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p)
    return env


def _run_module(module: str, *args: str, timeout: float = 300):
    """``python -m module args`` (or ``python module args`` for a script)
    in a fresh interpreter, which must import nothing of JAX."""
    proc = subprocess.run(
        [sys.executable, "-c", _RUNNER, module, *args],
        capture_output=True, text=True, timeout=timeout, env=_env(),
        cwd=REPO,
    )
    assert "IMPORTED []" in proc.stdout, proc.stdout + proc.stderr
    return proc


# ---- the soak ---------------------------------------------------------- #


def test_soak_small_run_all_correct():
    proc = _run_module("tiresias_tpu_torch.tools.soak", "--device", "cpu",
                       "--channels", "4", "--seconds", "6", timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = [l for l in proc.stdout.splitlines() if l.startswith("soak:")][-1]
    assert "100.0% correct" in line, line
    assert "0 errors" in line, line


def test_soak_with_live_mutation_and_mem_trend():
    """--mutate runs the admin-plane mutator (sync ingest / remove / save /
    compact against the live store) while the fleet recognizes: 100%
    correct, at least one sync + remove cycle, a flat memory trend."""
    proc = _run_module("tiresias_tpu_torch.tools.soak", "--device", "cpu",
                       "--channels", "4", "--seconds", "12", "--mutate",
                       "--mutate-period", "3", timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = [l for l in proc.stdout.splitlines() if l.startswith("soak:")][-1]
    assert "100.0% correct" in line and "0 errors" in line, line
    assert "live mutations" in line, line
    n_mut = int(line.split(" live mutations")[0].rsplit(" ", 1)[-1])
    assert n_mut >= 2, line
    mem = [l for l in proc.stdout.splitlines() if l.startswith("soak-mem:")]
    assert mem and "flat" in mem[-1], mem


def test_soak_mem_trend_rule():
    """JAX's rule on both series: the second half's median at most 1.15 x
    the first's + 64 MB, the first sample (warm-up) left out."""
    from tiresias_tpu_torch.tools.soak import mem_trend

    flat = [(t, 500.0 + (900.0 if t == 0 else 0.0), 2000.0)
            for t in range(9)]
    assert mem_trend(flat)[0] and mem_trend(flat)[1].endswith("— flat")
    grow_dev = [(t, 500.0, 2000.0 + 200.0 * t) for t in range(9)]
    assert not mem_trend(grow_dev)[0]
    assert mem_trend(grow_dev)[1].endswith("— GROWING")
    assert mem_trend(grow_dev[:3])[0]  # too short for a trend


# ---- the studies and the quickstart ------------------------------------ #


def _table(out: str) -> list[str]:
    return [l for l in out.splitlines() if " exact " in l]


def test_accuracy_study_table_equals_jax():
    port = _run_module("tiresias_tpu_torch.tools.accuracy_study", "20", "8",
                       "--device", "cpu", timeout=600)
    assert port.returncode == 0, port.stdout + port.stderr
    ref = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "accuracy_study.py"),
         "20", "8"],
        capture_output=True, text=True, timeout=600,
        env=_env(JAX_PLATFORMS="cpu"), cwd=REPO,
    )
    assert ref.returncode == 0, ref.stdout + ref.stderr
    want = _table(ref.stdout)
    assert len(want) == 13
    assert _table(port.stdout) == want


@pytest.mark.parametrize("weighted", [False, True])
def test_margin_study_runs(weighted):
    args = (["--weighted", "--tracks", "64"] if weighted else
            ["--tracks", "64", "--queries", "8", "--impostors", "4"])
    proc = _run_module("tiresias_tpu_torch.tools.margin_study", *args,
                       "--device", "cpu", timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "corpus ready: 64 tracks" in proc.stdout
    if weighted:
        assert proc.stdout.count("  tol ") == 8  # 3 scalar + 5 weighted
    else:
        for tol in margin_study.TOLS:
            assert f"== tol {tol} ==  correct-top1 " in proc.stdout
        assert "== stability 0.2 vs 0.3 ==" in proc.stdout


def test_quickstart_finds_its_file():
    script = os.path.join(REPO, "examples", "quickstart_torch.py")
    proc = _run_module(script, "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "file search: FOUND prompt2.wav" in proc.stdout
    assert "audios: ['prompt0.wav'" in proc.stdout


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_quickstart_defaults_to_cuda():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "quickstart_torch.py")],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=REPO,
    )
    assert proc.returncode != 0
    assert "device='cuda'" in proc.stderr


# ---- _compute_votes against the JAX engine ----------------------------- #


@pytest.fixture
def jax_query_fp(monkeypatch):
    """The port fingerprints its queries with the JAX function, so both
    engines vote bitwise-equal query fingerprints against bitwise-equal
    stored ones (the port's own fingerprints are held to JAX's within their
    float32 bound in test_torch_mfcc.py)."""

    def fp(padded, samplerate, dsp, law=None, n_valid=None, device="cpu"):
        out = jax_fp(padded, samplerate, dsp, law=law, n_valid=n_valid)
        return torch.from_numpy(np.array(out)).to(device)

    monkeypatch.setattr(tengine, "fingerprint_padded_batch", fp)


N_CLIPS = 64


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """Both engines over one numpy corpus (the margin study's speech-like
    clips, 2 s, DspConfig(n_coefs=8)) fingerprinted once by the JAX
    function: clips 0-47 in context "c", 48-63 in "d"; the queries are
    1.5 s excerpts, the same at 20 dB SNR, and impostors."""
    rng = np.random.default_rng(21)
    clips = margin_study.speechlike_batch(rng, N_CLIPS, 2.0)
    fps = np.array(jax_fp(clips, SR, JaxDsp(n_coefs=8)))
    root = tmp_path_factory.mktemp("study")
    jeng = JaxTiresias(JaxConfig(dsp=JaxDsp(n_coefs=8),
                                 data_dir=str(root / "j")), restore=False)
    teng = Tiresias(TiresiasConfig(dsp=DspConfig(n_coefs=8),
                                   data_dir=str(root / "t")),
                    restore=False, device="cpu")
    for eng in (jeng, teng):
        for c in ("c", "d"):
            eng.create_context(c)
        for i in range(N_CLIPS):
            eng.store.add_audio(f"clip{i}", "c" if i < 48 else "d", fps[i],
                                f"h{i}", uuid=f"u{i:03d}")
    picks = rng.choice(N_CLIPS, 12, replace=False)
    excerpts, truth = [], []
    for i in picks:
        off = 256 * int(rng.integers(0, 8))
        excerpts.append(clips[i][off : off + 11776])
        truth.append(f"clip{i}")
    noisy = [margin_study.add_noise(rng, q, 20.0) for q in excerpts]
    impostors = list(margin_study.speechlike_batch(rng, 6, 1.5))
    yield jeng, teng, excerpts + noisy + impostors, truth
    jeng.close()
    teng.close()


VOTE_MODES = {
    "dialplan": dict(coefs=1, trunc_coef1=True, aligned=False, tol=0.001),
    "dialplan_wide": dict(coefs=1, trunc_coef1=True, aligned=False, tol=1.0),
    "bag": dict(coefs=2, trunc_coef1=False, aligned=False, tol=0.3),
    "aligned": dict(coefs=8, trunc_coef1=False, aligned=True, tol=0.3),
}


def _votes_both(study, ctx, filt, coefs, trunc_coef1, aligned, tol,
                wire=None, top=1, queries=None):
    jeng, teng, qs, _ = study
    qs = qs if queries is None else queries
    if wire is not None:
        qs = [encode(float_to_i16(q), wire) for q in qs]
    args = (ctx, qs, SR, coefs, tol, -1, -1, filt, trunc_coef1, aligned)
    kw = dict(prefilter=True, wire_law=wire, prefilter_top=top)
    return jeng._compute_votes(*args, **kw), teng._compute_votes(*args, **kw)


def _assert_votes_equal(want, got):
    (wv, we, wn), (gv, ge, gn) = want, got
    assert gv.dtype == np.int32 and gv.shape == wv.shape
    np.testing.assert_array_equal(gv, np.asarray(wv))
    assert [e.uuid for e in ge] == [e.uuid for e in we]
    np.testing.assert_array_equal(gn, np.asarray(wn))


@pytest.mark.parametrize("ctx,filt", [(None, False), ("d", True)])
@pytest.mark.parametrize("mode", sorted(VOTE_MODES))
def test_compute_votes_equals_jax(study, jax_query_fp, mode, ctx, filt):
    want, got = _votes_both(study, ctx, filt, **VOTE_MODES[mode])
    _assert_votes_equal(want, got)
    votes = got[0]
    assert votes.max() > 0
    if filt:  # only context "d"'s columns vote
        assert not votes[:, :48].any()


@pytest.mark.parametrize("mode", ["dialplan_wide", "aligned"])
def test_compute_votes_wire_law_equals_jax(study, jax_query_fp, mode):
    want, got = _votes_both(study, None, False, wire="ulaw",
                            **VOTE_MODES[mode])
    _assert_votes_equal(want, got)


@pytest.mark.parametrize("tol", [0.1, 0.3, 0.45])
def test_margin_study_votes_and_stats(study, jax_query_fp, tol):
    """The margin study's call (aligned, coefs 8, certificate at the top 2)
    int32-equal to JAX's, and its statistics equal to numpy's directly."""
    want, got = _votes_both(study, "c", False, 8, False, True, tol, top=2)
    _assert_votes_equal(want, got)
    votes, entries, n_frames = got
    names = [e.name for e in entries]
    truth = study[3]
    n_true = len(truth)
    st = margin_study.query_stats(votes[:n_true], names, n_frames[:n_true],
                                  truth)
    # direct numpy: the winner is the lowest column among the maxima
    v = votes[:n_true].astype(np.int64)
    w = v.argmax(axis=1)
    v1 = v.max(axis=1)
    rest = v.copy()
    rest[np.arange(n_true), w] = -1
    v2 = np.maximum(rest.max(axis=1), 0)
    np.testing.assert_array_equal(st["w"], w)
    np.testing.assert_array_equal(st["v1"], v1)
    np.testing.assert_array_equal(st["v2"], v2)
    np.testing.assert_allclose(
        st["m"], np.where(v1 > 0, (v1 - v2) / np.maximum(v1, 1), 0.0))
    np.testing.assert_allclose(st["conf"], v1 / n_frames[:n_true])
    sd = v.std(axis=1)
    np.testing.assert_allclose(
        st["z"], np.where(sd > 0, (v1 - v.mean(axis=1)) / np.where(
            sd > 0, sd, 1), 0.0))
    np.testing.assert_array_equal(
        st["correct"], (np.array(names)[w] == np.array(truth)) & (v1 > 0))
    assert st["correct"].sum() >= n_true // 2  # the excerpts are found
    imp = margin_study.query_stats(votes[n_true:], names, n_frames[n_true:])
    assert "correct" not in imp
    lines = margin_study.tolerance_lines(tol, st, imp)
    assert lines[0] == (f"\n== tol {tol} ==  correct-top1 "
                        f"{st['correct'].sum()}/{n_true}")
    joint = lines[3].split()  # c >= 0, m >= 0: every correct | every query
    assert joint[1] == f"{st['correct'].sum()}|{len(imp['m'])}"


def test_compute_votes_without_prefilter_keeps_every_row(study,
                                                          jax_query_fp):
    """``prefilter=False`` is the full scan in both engines."""
    jeng, teng, qs, _ = study
    args = (None, qs[:4], SR, 1, 1.0, -1, -1, False, True, False)
    _assert_votes_equal(jeng._compute_votes(*args, prefilter=False),
                        teng._compute_votes(*args, prefilter=False))


# ---- the store's read accessors ---------------------------------------- #


def test_store_accessors_equal_jax():
    rng = np.random.default_rng(31)
    stores = (jfs.FingerprintStore(n_coefs=2),
              tfs.FingerprintStore(n_coefs=2, device="cpu"))
    for s in stores:
        s.create_context("a")
        s.create_context("b")
        assert s.frame_cap == 0 and s.view_entries() == []
    for i, n in enumerate((40, 300, 90, 200, 7)):
        fp = rng.normal(-25.0, 15.0, (n, 2)).astype(np.float32)
        for s in stores:
            s.add_audio(f"x{i}", "ab"[i % 2], fp, f"h{i}", uuid=f"u{i}")

    def state(s):
        return ([e.uuid for e in s.view_entries()], s.frame_cap,
                [None if f is None else f.tolist()
                 for f in (s.context_filter(c) for c in ("a", "b", None))])

    want = state(stores[0])
    assert state(stores[1]) == want
    assert want[1] == 512 and want[0][:3] == ["u0", "u2", "u4"]
    for s in stores:  # the top tier's audios gone: the cap drops
        s.delete_audios(["u1", "u3"])
    want = state(stores[0])
    assert state(stores[1]) == want and want[1] == 128
