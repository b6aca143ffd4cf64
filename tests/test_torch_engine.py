"""The PyTorch port's dialplan slice end to end, against the JAX package.

The JAX engine syncs a directory of WAVs and checkpoints; the port restores
that checkpoint (so both hold bitwise the same stored fingerprints) and:

  * from the SAME query fingerprint arrays, the port's match stage gives
    the same TIR* as the reference oracle ``match_ref.search_reference``
    and the JAX lattice matcher — exactly;
  * from PCM, status and name agree with the JAX engine, and match counts
    differ by at most the number of query frames whose coef-0 value lies
    within 1e-3 of an integer (the only place the float32 DFT-as-matmul
    and FFT fingerprints can disagree after truncation).

All port engines here run with ``device="cpu"`` (the kernels' plain twins).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tiresias_tpu.api import Tiresias as JaxTiresias
from tiresias_tpu.api.engine import parse_dialplan_args as jax_parse
from tiresias_tpu.config import ContextConfig, MatchConfig, TiresiasConfig
from tiresias_tpu.ops import match_lattice as jml
from tiresias_tpu.ops.match_ref import search_reference
from tiresias_tpu.ops.mfcc_jax import fingerprint_padded_batch as jax_fp
from tiresias_tpu.utils.audio import float_to_i16, read_wav_i16, write_wav
from tiresias_tpu.utils.g711 import encode
from tiresias_tpu_torch.api import SearchResult, Tiresias, parse_dialplan_args
from tiresias_tpu_torch.ops.mfcc import pad_frames_bucket

torch.set_num_threads(2)

SR = 8000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _speechlike(rng, seconds):
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f0 = rng.uniform(90, 220)
    vib = 1.0 + 0.03 * np.sin(2 * np.pi * rng.uniform(3, 7) * t)
    sig = sum(
        rng.uniform(0.2, 1.0) / h
        * (1.0 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.5, 3) * t))
        * np.sin(2 * np.pi * f0 * h * vib * t)
        for h in range(1, 9)
    )
    sig = sig + 0.02 * rng.standard_normal(n)
    return (0.3 * sig / np.abs(sig).max()).astype(np.float32)


# 5 short clips (tier 128) + 3 of 6-8 s (tier 256): the longest member pads
# the one ingest batch to 256 frames, so it takes the framed-kernel route
LENGTHS = {"single": (2.0, 2.5, 3.0, 3.5, 4.0),
           "multi": (2.0, 2.5, 3.0, 3.5, 4.0, 6.0, 7.0, 8.0)}


def _write_corpus(directory, lengths, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    for i, s in enumerate(lengths):
        write_wav(os.path.join(directory, f"t{i:02d}.wav"),
                  _speechlike(rng, s), SR)


def _cfg(media, data, tol=0.001):
    return TiresiasConfig(
        contexts=(ContextConfig("media", str(media)),), data_dir=str(data),
        match=MatchConfig(tolerance=tol),
    )


@pytest.fixture(scope="module", params=sorted(LENGTHS))
def synced(request, tmp_path_factory):
    """A JAX-synced checkpoint plus both engines restored from it."""
    root = tmp_path_factory.mktemp(request.param)
    media, data = root / "media", root / "data"
    _write_corpus(media, LENGTHS[request.param], seed=len(request.param))
    jeng = JaxTiresias(_cfg(media, data))
    assert jeng.sync().created == len(LENGTHS[request.param])
    jeng.close()
    jeng = JaxTiresias(_cfg(media, data), exclusive=False)
    teng = Tiresias(_cfg(media, data), exclusive=False, device="cpu")
    return request.param, media, jeng, teng


def _queries(media, rng):
    """Hop-aligned 3 s (or shorter) excerpts of every stored track, one
    silence and one noise query."""
    out = []
    for name in sorted(os.listdir(media)):
        pcm, _ = read_wav_i16(os.path.join(media, name))
        start = 256 * int(rng.integers(0, max(1, (len(pcm) - 24000) // 256)))
        out.append(pcm[start : start + 24000])
    out.append(np.zeros(24000, np.int16))
    out.append(float_to_i16(0.2 * rng.standard_normal(24000)))
    return out


def _oracle(jeng, qfp, n_frames, tol):
    """Reference TIR* from the oracle over the catalog in insertion order
    (its lowest-index argmax IS the D5 tiebreak)."""
    entries = jeng.store.entries
    db = [jeng.store.get_fingerprint(e.uuid) for e in entries]
    out = []
    for q, nf in zip(qfp, n_frames):
        ref = search_reference(db, q[:nf], coefs=1, tolerance=tol)
        if ref.best_index is None:
            out.append(("NOTFOUND", nf, 0, None))
        else:
            out.append(("FOUND", nf, ref.match_count,
                        entries[ref.best_index].name))
    return out


def _tir(results):
    return [(r.status, r.frame_count, r.match_count, r.name) for r in results]


@pytest.mark.parametrize("tol", [0.001, 1.0])
def test_match_stage_identical_tir_from_same_fingerprints(synced, tol):
    kind, media, jeng, teng = synced
    rng = np.random.default_rng(1)
    padded, n_frames = pad_frames_bucket(_queries(media, rng), 256)
    qfp = np.asarray(jax_fp(padded, SR, jeng.config.dsp))
    got = _tir(teng._match(torch.from_numpy(qfp.copy()), n_frames, tol, -1, -1))
    assert got == _oracle(jeng, qfp, n_frames, tol)
    if kind == "single":
        # the JAX lattice matcher on the same arrays: same rows, same votes
        (view,) = jeng.store.search_views()
        best, count, _ = jml.search_lattice(
            jeng.store.value_map_for(view), qfp, n_frames, tol
        )
        names = [view.entries[b].name if c > 0 else None
                 for b, c in zip(np.asarray(best), np.asarray(count))]
        assert [g[3] for g in got] == names
        assert [g[2] for g in got] == [int(c) for c in np.asarray(count)]


@pytest.mark.parametrize("tol", [0.5, 1.0])
def test_pcm_search_agrees_with_jax_engine(synced, tol):
    _, media, jeng, teng = synced
    rng = np.random.default_rng(2)
    queries = _queries(media, rng)
    want = jeng.search_pcm_batch(None, queries, SR, tolerance=tol)
    got = teng.search_pcm_batch(None, queries, SR, tolerance=tol)
    padded, n_frames = pad_frames_bucket(queries, 256)
    q0 = np.asarray(jax_fp(padded, SR, jeng.config.dsp))[..., 0]
    for i, (w, g) in enumerate(zip(want, got)):
        near = np.abs(q0[i, : n_frames[i]] - np.round(q0[i, : n_frames[i]]))
        assert (g.status, g.name, g.frame_count) == (
            w.status, w.name, w.frame_count)
        assert abs(g.match_count - w.match_count) <= int((near < 1e-3).sum())
    # at a unit tolerance every excerpt is FOUND with all its votes but the
    # t0 half-frame (whose zeros precede the excerpt); one-coefficient bag
    # voting may rank an earlier-inserted track equal (the D5 tiebreak)
    if tol == 1.0:
        for r in got[: len(os.listdir(media))]:
            assert r.found and r.match_count >= r.frame_count - 1


def test_single_query_batch_and_file_paths_agree(synced):
    _, media, _, teng = synced
    rng = np.random.default_rng(3)
    queries = _queries(media, rng)[:3]
    batch = teng.search_pcm_batch(None, queries, SR, tolerance=1.0)
    singles = [teng.search_pcm(None, q, SR, tolerance=1.0) for q in queries]
    assert _tir(batch) == _tir(singles)
    path = os.path.join(media, sorted(os.listdir(media))[0])
    res = teng.search_file("media", path, tolerance=1.0)
    assert res.found and res.name == os.path.basename(path)
    assert res.match_count >= res.frame_count - 1


def test_wire_law_search_equals_linear(synced):
    _, media, _, teng = synced
    rng = np.random.default_rng(4)
    lin = [q.astype(np.float32) / 32768 for q in _queries(media, rng)[:3]]
    codes = [encode(q, "ulaw") for q in lin]
    from tiresias_tpu.utils.g711 import decode

    assert _tir(teng.search_pcm_batch(None, codes, SR, tolerance=1.0,
                                      wire_law="ulaw")) == _tir(
        teng.search_pcm_batch(None, [decode(c, "ulaw") for c in codes], SR,
                              tolerance=1.0))


def test_filter_context(synced):
    _, media, _, teng = synced
    rng = np.random.default_rng(5)
    q = _queries(media, rng)[0]
    assert teng.search_pcm("media", q, SR, tolerance=1.0,
                           filter_context=True).found
    assert not teng.search_pcm("other", q, SR, tolerance=1.0,
                               filter_context=True).found
    # context=None keeps the reference's scan-everything behavior (D7)
    assert teng.search_pcm(None, q, SR, tolerance=1.0,
                           filter_context=True).found


def test_port_sync_matches_jax_sync(tmp_path):
    media = tmp_path / "media"
    _write_corpus(media, (1.0, 3.0, 8.0), seed=9)
    (media / "empty.wav").write_bytes(b"")
    (media / "junk.wav").write_bytes(b"not a wav")
    jeng = JaxTiresias(_cfg(media, tmp_path / "j"))
    teng = Tiresias(_cfg(media, tmp_path / "t"), device="cpu")
    jrep, trep = jeng.sync(), teng.sync()
    assert (trep.created, trep.failed, trep.deduped) == (
        jrep.created, jrep.failed, jrep.deduped)
    key = sorted((e.name, e.hash, e.n_frames) for e in jeng.store.get_audios_by_context("media"))
    assert sorted(
        (e.name, e.hash, e.n_frames) for e in teng.store.get_audios_by_context("media")
    ) == key
    # re-sync is a no-op; removing a file deletes its entry
    assert teng.sync().created == 0
    assert teng.sync_context("media").created == 0
    with pytest.raises(ValueError):
        teng.sync_context("nope")
    os.unlink(media / "t00.wav")
    assert teng.sync().deleted == 1
    teng.close()
    jeng.close()
    restored = Tiresias(_cfg(media, tmp_path / "t"), device="cpu")
    assert sorted(e.name for e in restored.store.get_audios_by_context("media")) == [
        "t01.wav", "t02.wav"]
    restored.close()


def test_add_audio_pcm_then_search(tmp_path):
    rng = np.random.default_rng(6)
    eng = Tiresias(_cfg(tmp_path / "m", tmp_path / "d"), device="cpu")
    sig = _speechlike(rng, 5.0)
    e = eng.add_audio_pcm("media", "direct", sig, SR)
    assert eng.add_audio_pcm("media", "again", sig, SR) is None  # md5 dedupe
    res = eng.search_pcm(None, sig[:24000], SR, tolerance=1.0)
    assert res.found and res.uuid == e.uuid
    assert res.to_channel_vars()["TIRFILENAME"] == "direct"
    eng.close()


def test_empty_store_is_notfound(tmp_path):
    rng = np.random.default_rng(7)
    eng = Tiresias(_cfg(tmp_path / "m", tmp_path / "d"), device="cpu")
    eng.add_audio_pcm("media", "x", _speechlike(rng, 2.0), SR)
    eng.close()
    # restore=False starts empty even over an existing checkpoint
    eng = Tiresias(_cfg(tmp_path / "m", tmp_path / "d"), device="cpu",
                   restore=False, exclusive=False)
    res = eng.search_pcm(None, np.zeros(8000, np.float32), SR)
    assert (res.status, res.frame_count, res.match_count) == ("NOTFOUND", 32, 0)


@pytest.mark.parametrize(
    "kwargs",
    [
        {"coefs": 2},
        {"trunc_coef1": False},
        {"aligned": True},
        {"min_margin": 0.2},
    ],
)
def test_configurations_outside_the_slice_raise(tmp_path, kwargs):
    eng = Tiresias(_cfg(tmp_path / "m", tmp_path / "d"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.search_pcm(None, np.zeros(4000, np.float32), SR, **kwargs)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.search_pcm_topk(None, np.zeros(4000, np.float32), SR)
    eng.close()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Tiresias(_cfg(tmp_path / "m", tmp_path / "d"), device="cpu",
                 mesh=object())


def test_cuda_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Tiresias(_cfg(tmp_path / "m", tmp_path / "d"))
    # the failed construction released the data-dir lock
    Tiresias(_cfg(tmp_path / "m", tmp_path / "d"), device="cpu",
             exclusive=True).close()


@pytest.mark.parametrize(
    "args", ["ctx", "ctx,2000", "ctx,,0.5", "ctx,3000,1.0,200,3000", "ctx,,,,"]
)
def test_dialplan_args_and_result_contract(args):
    assert parse_dialplan_args(args) == jax_parse(args)
    r = SearchResult("FOUND", 94, 90, "u", "n", "c", "h")
    from tiresias_tpu.api.engine import SearchResult as JaxResult

    j = JaxResult("FOUND", 94, 90, "u", "n", "c", "h")
    assert r.to_channel_vars() == j.to_channel_vars()
    assert r.confidence == j.confidence


def test_port_never_imports_jax(tmp_path):
    """conftest imports jax in this process, so the check runs in a fresh
    interpreter: sync, save, restore and search on the CPU."""
    code = f"""
import sys, os
import numpy as np
from tiresias_tpu_torch.api import Tiresias
from tiresias_tpu.config import ContextConfig, TiresiasConfig
from tiresias_tpu.utils.audio import synth_tone, write_wav
media = {str(tmp_path / "m")!r}
os.makedirs(media)
write_wav(os.path.join(media, "a.wav"), synth_tone(440, 1.0, 8000), 8000)
cfg = TiresiasConfig(contexts=(ContextConfig("media", media),),
                     data_dir={str(tmp_path / "d")!r})
eng = Tiresias(cfg, device="cpu")
assert eng.sync().created == 1
eng.close()
eng = Tiresias(cfg, device="cpu")
res = eng.search_file("media", os.path.join(media, "a.wav"), tolerance=1.0)
assert res.found and res.name == "a.wav", res
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
