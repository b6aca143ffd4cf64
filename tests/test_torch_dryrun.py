"""The port's dry run (``tiresias_tpu_torch/dryrun.py``) against the JAX
package's (``__graft_entry__.py``) on the same inputs.

``entry()``: the example arguments equal JAX's bit for bit, the fingerprints
agree within PARITY.md section 2's float32 bound, and votes and (best,
count) are int-exact when both matchers get JAX's fingerprints. The served
search and the sharded ingest with its checkpoint restore: JAX's run on a
(4, 2) mesh of ``tests/conftest.py``'s 8 virtual CPU devices, the port's on
``make_mesh(4, 2, devices=["cpu"] * 8)``; their returned strings are equal
where the port's queries are fingerprinted by the JAX function (fixture
``jax_query_fp``), and name and status are equal with the port's own
fingerprints. JAX's pieces run once each, in module-scoped fixtures.
"""

import re

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_dry
from tiresias_tpu.config import DspConfig as JaxDspConfig
from tiresias_tpu.ops import match_jax
from tiresias_tpu.ops.mfcc_jax import _fingerprint_padded, dsp_constants
from tiresias_tpu.ops.mfcc_jax import fingerprint_padded_batch as jax_fp
from tiresias_tpu.parallel import make_mesh as jax_make_mesh
from tiresias_tpu_torch import dryrun
from tiresias_tpu_torch.api import engine as tengine
from tiresias_tpu_torch.parallel import make_mesh

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)

torch.set_num_threads(2)

# the float32 bound between two fingerprint chains (PARITY.md section 2,
# tests/test_torch_mfcc.py)
FP_ATOL = 0.02


@pytest.fixture(scope="module")
def no_cache(tmp_path_factory):
    """JAX's entry() and engines write no compilation cache directory, and
    JAX's served search makes its data directory under this module's
    temporary directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TIRESIAS_NO_COMPILE_CACHE", "1")
        mp.setattr("tempfile.tempdir", str(tmp_path_factory.mktemp("dry")))
        yield


@pytest.fixture(scope="module")
def jax_entry(no_cache):
    """JAX's entry step, once: its example arguments, its fingerprints, its
    votes and its (best, count)."""
    fn, args = jax_dry.entry()
    pcm, db, mask = args
    dsp = JaxDspConfig()
    window, mel, dct = dsp_constants(dsp, dryrun.SR)
    fp = np.array(_fingerprint_padded(pcm, window, mel, dct, dsp.hop_size,
                                       dsp.buf_size))
    q, active, use2 = match_jax.prepare_query(fp, None)
    votes = np.asarray(match_jax.match_votes(db, mask, q, active, use2,
                                             np.float32(1.0), coefs=2))
    best, count = (np.asarray(x) for x in jax.jit(fn)(*args))
    return {"args": args, "fp": fp, "votes": votes, "best": best,
            "count": count}


@pytest.fixture(scope="module")
def jax_mesh_runs(no_cache):
    """JAX's served search and sharded ingest on a (4, 2) mesh, once."""
    mesh = jax_make_mesh(4, 2)
    return {"served": jax_dry._dryrun_served_search(mesh),
            "ingest": jax_dry._dryrun_sharded_ingest(mesh)}


@pytest.fixture
def jax_query_fp(monkeypatch):
    """The port fingerprints its queries with the JAX function (as in
    tests/test_torch_engine_mesh.py), so both engines vote the same
    query floats."""

    def fp(padded, samplerate, dsp, law=None, n_valid=None, device="cpu"):
        out = jax_fp(padded, samplerate, dsp, law=law, n_valid=n_valid)
        return torch.from_numpy(np.array(out)).to(device)

    monkeypatch.setattr(tengine, "fingerprint_padded_batch", fp)


def _mesh():
    return make_mesh(4, 2, devices=["cpu"] * 8)


def _name(summary: str) -> str:
    return re.fullmatch(r"ok\(name=([^,]+),votes=\d+/\d+\)", summary)[1]


@pytest.mark.parametrize("kw", [
    {},  # entry()'s example arguments
    {"n_audios": 16, "b": 16, "n_samples": 2048},  # dryrun_multichip(8)'s
])
def test_example_data_equals_jax_bitwise(kw):
    got, want = dryrun._example_data(**kw), jax_dry._example_data(**kw)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def test_entry_example_args_are_jax_entrys(jax_entry):
    _, args = dryrun.entry("cpu")
    for g, w in zip(args, jax_entry["args"], strict=True):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_entry_fingerprints_within_float32_bound(jax_entry):
    pcm = jax_entry["args"][0]
    got = dryrun.fingerprint_padded_batch(pcm, dryrun.SR, dryrun.DspConfig(),
                                          device="cpu")
    assert got.shape == jax_entry["fp"].shape
    np.testing.assert_allclose(got.numpy(), jax_entry["fp"], atol=FP_ATOL,
                               rtol=0)


def test_entry_votes_exact_on_jax_fingerprints(jax_entry):
    _, db, mask = jax_entry["args"]
    votes = dryrun.entry_votes(torch.from_numpy(jax_entry["fp"]), db, mask)
    assert votes.dtype == torch.int32
    np.testing.assert_array_equal(votes.numpy(), jax_entry["votes"])
    assert jax_entry["votes"].max() > 0  # the step votes somewhere


def test_entry_step_top1_exact_on_jax_fingerprints(jax_entry, monkeypatch):
    monkeypatch.setattr(dryrun, "fingerprint_padded_batch",
                        lambda pcm, sr, dsp, device: torch.from_numpy(
                            jax_entry["fp"]).to(device))
    fn, args = dryrun.entry("cpu")
    best, count = fn(*args)
    np.testing.assert_array_equal(best.numpy(), jax_entry["best"])
    np.testing.assert_array_equal(count.numpy(), jax_entry["count"])


def test_entry_step_on_its_own_fingerprints(jax_entry):
    fn, args = dryrun.entry("cpu")
    best, count = fn(*args)
    assert best.shape == count.shape == jax_entry["best"].shape
    assert best.dtype == torch.int32


def test_served_search_equals_jax(jax_mesh_runs, jax_query_fp):
    assert dryrun._dryrun_served_search(_mesh()) == jax_mesh_runs["served"]


def test_served_search_own_fingerprints_names_jaxs(jax_mesh_runs):
    got = dryrun._dryrun_served_search(_mesh())
    assert _name(got) == _name(jax_mesh_runs["served"]) == "t2"


def test_sharded_ingest_equals_jax(jax_mesh_runs, jax_query_fp):
    assert (dryrun._dryrun_sharded_ingest(_mesh())
            == jax_mesh_runs["ingest"])


def test_sharded_ingest_own_fingerprints_names_jaxs(jax_mesh_runs):
    created, restored = dryrun._dryrun_sharded_ingest(_mesh())
    want_created, want_restored = jax_mesh_runs["ingest"]
    assert created == want_created == "ok(created=16)"
    assert _name(restored) == _name(want_restored) == "m3.wav"


def test_pieces_run_inside_the_callers_hook():
    seen = []

    class Hook:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            seen.append(("enter", self.name))

        def __exit__(self, *exc):
            seen.append(("exit", self.name))

    dryrun._dryrun_sharded_ingest(_mesh(), Hook)
    assert seen == [("enter", "sharded_ingest"), ("exit", "sharded_ingest"),
                    ("enter", "mesh_checkpoint"),
                    ("exit", "mesh_checkpoint")]


def test_main_on_cpu_prints_both_ok_lines(capsys):
    assert dryrun.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "entry ok: [(4,), (4,)]"
    assert lines[1].startswith("dryrun_multichip ok: ")
    for key in ("served_search", "sharded_ingest", "mesh_checkpoint"):
        assert f'"{key}": "ok(' in lines[1]
