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
import shutil
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
from tiresias_tpu.store import fingerprint_store as jfs
from tiresias_tpu.utils.audio import (
    float_to_i16,
    read_wav_i16,
    synth_chirp,
    write_wav,
)
from tiresias_tpu.utils.g711 import encode
from tiresias_tpu_torch.api import SearchResult, Tiresias, parse_dialplan_args
from tiresias_tpu_torch.api import engine as tengine
from tiresias_tpu_torch.ops.mfcc import pad_frames_bucket
from tiresias_tpu_torch.store import fingerprint_store as tfs

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


def test_configurations_outside_the_slice_raise(tmp_path):
    # a mesh of the wrong type or name raises (the meshed engine's own
    # tests are tests/test_torch_engine_mesh.py)
    for bad in (object(), "everywhere"):
        with pytest.raises((TypeError, ValueError), match="mesh"):
            Tiresias(_cfg(tmp_path / "m", tmp_path / "d"), device="cpu",
                     mesh=bad)
    # the failed construction released the data-dir lock
    eng = Tiresias(_cfg(tmp_path / "m", tmp_path / "d"), device="cpu",
                   exclusive=True)
    # ranked listings are served (the parity cases are below): an empty
    # store lists nothing, and margin acceptance does not apply to a table
    assert eng.search_pcm_topk(None, np.zeros(4000, np.float32), SR) == []
    with pytest.raises(ValueError, match="min_margin"):
        eng.search_pcm_topk(None, np.zeros(4000, np.float32), SR,
                            min_margin=0.2)
    eng.close()


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


# ---- every search configuration against the JAX engine ---------------- #

# Two contexts per corpus; "promo" repeats media's first track, so the same
# audio lives in two contexts: a D5 tie across contexts, and an ambiguous
# winner for margin acceptance. "multi" spans tiers 128 and 256 (two views).
DUAL = {"single": ((2.0, 2.5, 3.0, 3.5), (3.0, 4.0)),
        "multi": ((2.0, 3.0, 6.0), (3.5, 7.0, 8.0))}

# coefs x truncation x bag/aligned x margin: every combination
MODES = [
    {"coefs": c, "trunc_coef1": tr, "aligned": al, "min_margin": mm}
    for c in (1, 2) for tr in (True, False) for al in (False, True)
    for mm in (0.0, 0.2)
]
# the dialplan configuration, the strict bag search (D8) and the aligned
# search (D9)
NAMED = {
    "dialplan": {"coefs": 1},
    "strict": {"coefs": 2, "trunc_coef1": False},
    "aligned": {"coefs": 2, "trunc_coef1": False, "aligned": True},
}


def _mode_id(m):
    return (f"c{m['coefs']}-{'trunc' if m['trunc_coef1'] else 'raw'}-"
            f"{'aligned' if m['aligned'] else 'bag'}-mm{m['min_margin']}")


def _tol(mode):
    """Unit tolerance where q0 is truncated (a truncated value lies within
    1 of its frame), 0.1 for raw values."""
    return 1.0 if mode.get("trunc_coef1", True) else 0.1


def _dual_cfg(root):
    return TiresiasConfig(
        contexts=(ContextConfig("media", str(root / "media")),
                  ContextConfig("promo", str(root / "promo"))),
        data_dir=str(root / "data"),
    )


@pytest.fixture(scope="module", params=sorted(DUAL))
def dual(request, tmp_path_factory):
    """Both engines on one two-context corpus the JAX engine synced (the
    port restores its checkpoint: bitwise the same stored fingerprints)."""
    root = tmp_path_factory.mktemp("dual_" + request.param)
    media, promo = DUAL[request.param]
    _write_corpus(root / "media", media, seed=11)
    _write_corpus(root / "promo", promo, seed=12)
    shutil.copy(root / "media" / "t00.wav", root / "promo" / "dup.wav")
    jeng = JaxTiresias(_dual_cfg(root))
    assert jeng.sync().created == len(media) + len(promo) + 1
    jeng.close()
    jeng = JaxTiresias(_dual_cfg(root), exclusive=False)
    teng = Tiresias(_dual_cfg(root), exclusive=False, device="cpu")
    return root, jeng, teng


@pytest.fixture
def jax_query_fp(monkeypatch):
    """The port fingerprints its queries with the JAX function, so both
    engines vote bitwise-equal query fingerprints against bitwise-equal
    stored ones and their TIR* must be equal exactly. (The port's own
    fingerprints are held to JAX's within their float32 bound in
    test_torch_mfcc.py; at tolerances near a value's spacing that bound can
    move a vote, which would hide what these tests check.)"""

    def fp(padded, samplerate, dsp, law=None, n_valid=None, device="cpu"):
        out = jax_fp(padded, samplerate, dsp, law=law, n_valid=n_valid)
        return torch.from_numpy(np.array(out)).to(device)

    monkeypatch.setattr(tengine, "fingerprint_padded_batch", fp)


def _dual_queries(root, rng):
    return (_queries(root / "media", rng)[:-2]
            + _queries(root / "promo", rng))


def _vars(results):
    return [r.to_channel_vars() for r in results]


@pytest.mark.parametrize("mode", MODES, ids=_mode_id)
def test_search_modes_equal_jax_engine(dual, jax_query_fp, mode):
    root, jeng, teng = dual
    queries = _dual_queries(root, np.random.default_rng(8))
    for ctx, filt in ((None, False), ("media", True), ("promo", True)):
        kw = dict(tolerance=_tol(mode), filter_context=filt, **mode)
        want = jeng.search_pcm_batch(ctx, queries, SR, **kw)
        got = teng.search_pcm_batch(ctx, queries, SR, **kw)
        assert _vars(got) == _vars(want), (ctx, filt)
        if not filt and not mode["min_margin"]:
            # a real comparison: the excerpts are found
            assert sum(r.found for r in got) >= len(queries) // 2


@pytest.mark.parametrize("name", sorted(NAMED))
def test_margin_rejects_the_track_stored_twice(dual, jax_query_fp, name):
    root, jeng, teng = dual
    mode = NAMED[name]
    dup = read_wav_i16(str(root / "promo" / "dup.wav"))[0][256:24256]
    other = read_wav_i16(str(root / "media" / "t01.wav"))[0][256:24256]
    kw = dict(tolerance=_tol(mode), **mode)
    plain = teng.search_pcm_batch(None, [dup, other], SR, **kw)
    gated = teng.search_pcm_batch(None, [dup, other], SR, min_margin=0.2,
                                  **kw)
    want = jeng.search_pcm_batch(None, [dup, other], SR, min_margin=0.2,
                                 **kw)
    assert _vars(gated) == _vars(want)
    # D5: the media copy was inserted first; with a margin the promo copy's
    # equal votes make the answer ambiguous
    assert plain[0].found and plain[0].context == "media"
    assert plain[0].name == "t00.wav" and not gated[0].found
    if name == "aligned":  # bag votes barely discriminate this corpus
        assert gated[1].found and gated[1].name == "t01.wav"


@pytest.mark.parametrize("name", sorted(NAMED))
def test_deleted_audio_is_never_found(tmp_path, jax_query_fp, name):
    """A delete below the compaction threshold leaves a tombstoned row in
    its view: the vote kernels read values only, so the row must hold
    PAD_VALUE, or its stale fingerprint would still be FOUND."""
    mode = NAMED[name]
    media = tmp_path / "media"
    _write_corpus(media, (2.0, 3.0, 6.0, 2.5), seed=13)
    cfg = _cfg(media, tmp_path / "data")
    jeng = JaxTiresias(cfg)
    jeng.sync()
    jeng.close()
    jeng = JaxTiresias(cfg, exclusive=False)
    teng = Tiresias(cfg, exclusive=False, device="cpu")
    queries = _queries(media, np.random.default_rng(9))
    kw = dict(tolerance=_tol(mode), **mode)
    before = teng.search_pcm_batch(None, queries, SR, **kw)
    assert before[0].found and before[0].name == "t00.wav"
    (gone,) = [e for e in teng.store.entries if e.name == "t00.wav"]
    assert jeng.store.delete_audio(gone.uuid)
    assert teng.store.delete_audio(gone.uuid)
    got = teng.search_pcm_batch(None, queries, SR, **kw)
    assert _vars(got) == _vars(jeng.search_pcm_batch(None, queries, SR, **kw))
    assert all(r.name != "t00.wav" for r in got)
    assert any(v.dead_rows for v in teng.store.search_views())


@pytest.mark.parametrize("name", sorted(NAMED))
def test_autosplit_votes_equal_jax(tmp_path, monkeypatch, jax_query_fp,
                                   name):
    """Audios longer than the top tier (patched to 128 frames in both
    stores) split into segment rows of one entry. The kernel path sums the
    segments' votes into the first row (D15, additive), the lattice path
    min-combines their map rows; both must give the JAX engine's TIR*."""
    monkeypatch.setattr(jfs, "MAX_TIER_FRAMES", 128)
    monkeypatch.setattr(tfs, "MAX_TIER_FRAMES", 128)
    cfg = TiresiasConfig(data_dir=str(tmp_path))
    jeng = JaxTiresias(cfg, restore=False)
    jeng.create_context("c")
    long_pcm = synth_chirp(200, 1800, 15.0, SR)
    short_pcm = synth_chirp(900, 300, 4.0, SR)
    e_long = jeng.add_audio_pcm("c", "long", long_pcm, SR)
    jeng.add_audio_pcm("c", "short", short_pcm, SR)
    jeng.close()
    jeng = JaxTiresias(cfg, exclusive=False)
    teng = Tiresias(cfg, exclusive=False, device="cpu")
    (view,) = teng.store.search_views()
    assert max(len(g) for g in view.segments) == 4
    # excerpts across the segment boundaries at frames 128 and 256
    queries = [long_pcm[3 * SR : 6 * SR], long_pcm[7 * SR : 10 * SR],
               short_pcm[: 2 * SR]]
    mode = NAMED[name]
    kw = dict(tolerance=_tol(mode), **mode)
    got = teng.search_pcm_batch("c", queries, SR, **kw)
    assert _vars(got) == _vars(jeng.search_pcm_batch("c", queries, SR, **kw))
    if name != "dialplan":  # one truncated coefficient: both chirps tie
        assert got[0].found and got[0].uuid == e_long.uuid


def test_port_never_imports_jax(tmp_path):
    """conftest imports jax in this process, so the check runs in a fresh
    interpreter: sync, save, restore, and the dialplan, strict bag and
    aligned (with margin) searches on the CPU. Neither jax nor any module
    of the JAX package may be loaded after them."""
    code = f"""
import sys, os
import numpy as np
from tiresias_tpu_torch.api import Tiresias
from tiresias_tpu_torch.config import ContextConfig, TiresiasConfig
from tiresias_tpu_torch.utils.audio import synth_tone, write_wav
media = {str(tmp_path / "m")!r}
os.makedirs(media)
write_wav(os.path.join(media, "a.wav"), synth_tone(440, 1.0, 8000), 8000)
cfg = TiresiasConfig(contexts=(ContextConfig("media", media),),
                     data_dir={str(tmp_path / "d")!r})
eng = Tiresias(cfg, device="cpu")
assert eng.sync().created == 1
eng.close()
eng = Tiresias(cfg, device="cpu")
path = os.path.join(media, "a.wav")
res = eng.search_file("media", path, tolerance=1.0)
assert res.found and res.name == "a.wav", res
for kw in ({{}}, {{"aligned": True, "min_margin": 0.2}}):
    res = eng.search_file("media", path, coefs=2, tolerance=0.1,
                          trunc_coef1=False, **kw)
    assert res.found and res.name == "a.wav", (kw, res)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
bad = sorted(m for m in sys.modules
             if m == "tiresias_tpu" or m.startswith("tiresias_tpu."))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


# ---- ranked top-k against the JAX engine ------------------------------- #


def _ranked(results):
    return [(r.name, r.context, r.uuid, r.match_count, r.frame_count)
            for r in results]


@pytest.mark.parametrize("k", [1, 5, 64])
@pytest.mark.parametrize("name", sorted(NAMED))
def test_topk_equals_jax_engine(dual, jax_query_fp, name, k):
    """Votes, order and names of the ranked listing, exactly: one and two
    views, with and without the context filter, k below and above the
    number of audios. "promo" repeats media's first track, so every
    listing that holds it has a tie the insertion order must break."""
    root, jeng, teng = dual
    mode = NAMED[name]
    queries = _dual_queries(root, np.random.default_rng(10))
    listed = 0
    for q in queries:
        for ctx, filt in ((None, False), ("media", True), ("promo", True)):
            kw = dict(k=k, tolerance=_tol(mode), filter_context=filt, **mode)
            want = jeng.search_pcm_topk(ctx, q, SR, **kw)
            got = teng.search_pcm_topk(ctx, q, SR, **kw)
            assert _ranked(got) == _ranked(want), (ctx, filt)
            assert all(r.found and r.match_count > 0 for r in got)
            assert len(got) <= k
            listed += len(got)
            if filt:
                assert {r.context for r in got} <= {ctx}
    assert listed >= len(queries)  # a real comparison


@pytest.mark.parametrize("name", sorted(NAMED))
def test_topk_head_is_the_top1_search(dual, jax_query_fp, name):
    root, _, teng = dual
    mode = NAMED[name]
    kw = dict(tolerance=_tol(mode), **mode)
    for q in _dual_queries(root, np.random.default_rng(11)):
        top1 = teng.search_pcm(None, q, SR, **kw)
        ranked = teng.search_pcm_topk(None, q, SR, k=3, **kw)
        if top1.found:
            assert ranked[0].to_channel_vars() == top1.to_channel_vars()
        else:
            assert ranked == []


@pytest.mark.parametrize("name", sorted(NAMED))
def test_topk_ties_rank_in_insertion_order(tmp_path, jax_query_fp, name):
    """Ten audios hold the same track under different names, between and
    after other tracks, in two tiers' worth of company: their votes tie,
    and the listing must hold them in insertion order whatever order
    ``torch.topk`` gives equal values."""
    mode = NAMED[name]
    rng = np.random.default_rng(12)
    cfg = TiresiasConfig(data_dir=str(tmp_path))
    jeng = JaxTiresias(cfg, restore=False)
    jeng.create_context("c")
    track = _speechlike(rng, 3.5)
    order = []
    for i in range(14):
        if i % 4 == 3:
            nm, pcm = f"other{i}", _speechlike(rng, (3.0, 7.0)[i % 8 == 3])
        else:
            nm, pcm = f"copy{i:02d}", track
        assert jeng.add_audio_pcm("c", nm, pcm, SR, file_hash=f"h{i}")
        order.append(nm)
    jeng.close()
    jeng = JaxTiresias(cfg, exclusive=False)
    teng = Tiresias(cfg, exclusive=False, device="cpu")
    copies = [n for n in order if n.startswith("copy")]
    assert len(copies) >= 8
    q = float_to_i16(track)[256 : 256 + 24000]
    kw = dict(tolerance=_tol(mode), **mode)
    for k in (1, 5, 8, len(order), 100):
        want = jeng.search_pcm_topk("c", q, SR, k=k, **kw)
        got = teng.search_pcm_topk("c", q, SR, k=k, **kw)
        assert _ranked(got) == _ranked(want)
        tied = [r for r in got if r.match_count == got[0].match_count]
        ranks = [order.index(r.name) for r in tied]
        assert ranks == sorted(ranks) and len(tied) >= min(k, len(copies))
        if name == "aligned":  # bag votes barely tell these tracks apart
            assert [r.name for r in tied] == copies[: len(tied)]
    assert teng.search_pcm("c", q, SR, **kw).name == copies[0]
    views = teng.store.search_views()
    assert len(views) == 2 and views[0].n_audios >= 8


@pytest.mark.parametrize("name", sorted(NAMED))
def test_topk_autosplit_equals_jax(tmp_path, monkeypatch, jax_query_fp, name):
    """With auto-split audios the JAX engine ranks full votes on the host;
    the port keeps its one device-ranked path (segment columns merged
    before the ranking). Both listings must be equal."""
    monkeypatch.setattr(jfs, "MAX_TIER_FRAMES", 128)
    monkeypatch.setattr(tfs, "MAX_TIER_FRAMES", 128)
    cfg = TiresiasConfig(data_dir=str(tmp_path))
    jeng = JaxTiresias(cfg, restore=False)
    jeng.create_context("c")
    long_pcm = synth_chirp(200, 1800, 15.0, SR)
    jeng.add_audio_pcm("c", "short0", synth_chirp(900, 300, 4.0, SR), SR)
    jeng.add_audio_pcm("c", "long", long_pcm, SR)
    jeng.add_audio_pcm("c", "long-again", long_pcm, SR, file_hash="again")
    jeng.add_audio_pcm("c", "short1", synth_chirp(400, 1200, 3.0, SR), SR)
    jeng.close()
    jeng = JaxTiresias(cfg, exclusive=False)
    teng = Tiresias(cfg, exclusive=False, device="cpu")
    assert any(v.segments for v in teng.store.search_views())
    mode = NAMED[name]
    kw = dict(tolerance=_tol(mode), **mode)
    for q in (long_pcm[3 * SR : 6 * SR], long_pcm[7 * SR : 10 * SR]):
        for k in (1, 2, 10):
            want = jeng.search_pcm_topk("c", q, SR, k=k, **kw)
            got = teng.search_pcm_topk("c", q, SR, k=k, **kw)
            assert _ranked(got) == _ranked(want) and got
    if name != "dialplan":
        assert [r.name for r in got[:2]] == ["long", "long-again"]


def test_topk_by_row_does_not_rest_on_topk_tie_order():
    votes = torch.tensor([3, 7, 7, 0, 7, 3, 7, 7, 7, 7, 7, 1], dtype=torch.int32)
    seq = torch.arange(100, 112)
    got = tengine.topk_by_row(votes, seq, 5)
    assert got[0].tolist() == [7, 7, 7, 7, 7]
    assert got[2].tolist() == [1, 2, 4, 6, 7] and got[1].tolist() == [
        101, 102, 104, 106, 107]
    wide = tengine.topk_by_row(votes, seq, 20)  # k above the rows: padded
    assert wide.shape == (3, 20) and wide[0, 12:].sum() == 0
    assert wide[2, :12].tolist() == [1, 2, 4, 6, 7, 8, 9, 10, 0, 5, 11, 3]


# ---- admin, reload and follow against the JAX engine ------------------- #


def _catalog(eng):
    return sorted(
        (c["name"], c["directory"]) for c in eng.get_contexts()
    ), sorted(
        (e.name, e.context, e.hash, e.n_frames)
        for c in eng.get_contexts() for e in eng.get_audios(c["name"])
    )


def _report(r):
    return (r.created, r.deduped, r.deleted, r.failed)


def test_crud_reload_follow_sequence_equals_jax(tmp_path, jax_query_fp):
    """The same admin sequence through both engines, each on its own data
    directory over the same media: equal reports and catalogs at every
    step, checkpoints the other package loads, and equal TIR* from them."""
    _write_corpus(tmp_path / "media", (2.0, 3.0, 6.0), seed=21)
    _write_corpus(tmp_path / "promo", (2.5, 4.0), seed=22)
    _write_corpus(tmp_path / "extra", (3.5,), seed=23)
    _write_corpus(tmp_path / "loose", (3.0,), seed=24)

    def cfg(data, contexts=("media", "promo"), **dsp):
        from tiresias_tpu.config import DspConfig

        return TiresiasConfig(
            contexts=tuple(ContextConfig(c, str(tmp_path / c))
                           for c in contexts),
            data_dir=str(tmp_path / data), dsp=DspConfig(**dsp),
        )

    jeng = JaxTiresias(cfg("j"))
    teng = Tiresias(cfg("t"), device="cpu")
    engines = (jeng, teng)

    def both(step):
        want, got = (step(e) for e in engines)
        assert _catalog(teng) == _catalog(jeng)
        return want, got

    want, got = both(lambda e: _report(e.sync()))
    assert got == want == (5, 0, 0, 0)
    loose = str(tmp_path / "loose" / "t00.wav")
    want, got = both(lambda e: _report(e.add_audio_file("media", loose)))
    assert got == want == (1, 0, 0, 0)
    want, got = both(lambda e: _report(e.add_audio_file("media", loose)))
    assert got == want == (0, 1, 0, 0)  # md5 dedupe
    assert teng.generate_hash(loose) == jeng.generate_hash(loose)
    assert len(teng.generate_uuid()) == len(jeng.generate_uuid()) == 36

    def drop(e):
        (victim,) = [a for a in e.get_audios("media") if a.name == "t01.wav"]
        assert e.get_audio(victim.uuid) is victim
        return e.delete_audio(victim.uuid), e.delete_audio(victim.uuid)

    assert both(drop) == ((True, False), (True, False))
    assert both(lambda e: (e.delete_context("promo"),
                           e.delete_context("ghost"))) == (
        (True, False), (True, False))
    assert [c["name"] for c in teng.get_contexts()] == ["media"]

    # reload under a changed context list: promo stays gone, extra arrives,
    # t01.wav comes back from disk and the loose file (no longer on disk in
    # media's directory) goes
    want, got = both(lambda e: _report(e.reload(cfg(
        "j" if e is jeng else "t", ("media", "extra")))))
    assert got == want and got[0] == 2 and got[2] == 1
    assert [c.name for c in teng.config.contexts] == ["media", "extra"]

    # a changed DSP chain, or another data_dir, is refused and the old
    # config keeps serving
    for bad in (lambda d: cfg(d, ("media",), n_filters=32),
                lambda d: cfg(d + "-elsewhere", ("media",))):
        for e, d in ((jeng, "j"), (teng, "t")):
            before = e.config
            with pytest.raises(ValueError, match="reload cannot change"):
                e.reload(bad(d))
            assert e.config is before
    both(lambda e: None)

    # a sync that fails restores the old config too
    def failing_reload(e, monkeypatch_target):
        before = e.config
        orig = e.sync
        e.sync = lambda: (_ for _ in ()).throw(OSError("disk"))
        try:
            with pytest.raises(OSError):
                e.reload(cfg("j" if e is jeng else "t", ("media",)))
        finally:
            e.sync = orig
        assert e.config is before

    for e in engines:
        failing_reload(e, None)

    # follow: the owner never swaps; a replica swaps once per generation
    for e in engines:
        e.save()
        assert e.refresh_from_checkpoint() is False
    jrep = JaxTiresias(cfg("j", ("media", "extra")), exclusive=False)
    trep = Tiresias(cfg("t", ("media", "extra")), exclusive=False,
                    device="cpu")
    for rep in (jrep, trep):
        assert rep.refresh_from_checkpoint() is False  # nothing new yet
    both(lambda e: _report(e.add_audio_file("extra", loose)))
    for rep in (jrep, trep):
        assert rep.refresh_from_checkpoint() is False  # not saved yet
    for e in engines:
        e.save()
    for rep, e in ((jrep, jeng), (trep, teng)):
        old_store = rep.store
        assert rep.refresh_from_checkpoint() is True
        assert rep.store is not old_store
        assert rep.refresh_from_checkpoint() is False
        assert _catalog(rep) == _catalog(e)
    assert _catalog(trep) == _catalog(jrep)
    with pytest.raises(Exception, match="owned|locked|lock"):
        trep.save()  # a replica never writes
    for e in engines:
        e.close()

    # each package loads the other's checkpoint, and from bitwise-equal
    # stored fingerprints the TIR* are equal exactly
    jx = JaxTiresias(cfg("t", ("media", "extra")), exclusive=False)
    tx = Tiresias(cfg("j", ("media", "extra")), exclusive=False, device="cpu")
    assert _catalog(jx) == _catalog(trep) and _catalog(tx) == _catalog(jrep)
    queries = _queries(tmp_path / "media", np.random.default_rng(25))
    for mode in NAMED.values():
        kw = dict(tolerance=_tol(mode), **mode)
        for j, t in ((jx, trep), (jrep, tx)):
            assert _vars(t.search_pcm_batch(None, queries, SR, **kw)) == _vars(
                j.search_pcm_batch(None, queries, SR, **kw))
    assert trep.search_pcm(None, queries[0], SR, tolerance=1.0).found


def test_replica_refresh_survives_a_torn_checkpoint(tmp_path):
    """An unreadable checkpoint keeps the replica on its current store,
    and a .bak fallback is not re-read on every poll."""
    rng = np.random.default_rng(26)
    cfg = _cfg(tmp_path / "m", tmp_path / "d")
    owner = Tiresias(cfg, device="cpu")
    owner.add_audio_pcm("media", "one", _speechlike(rng, 3.0), SR)
    owner.save()
    rep = Tiresias(cfg, exclusive=False, device="cpu")
    owner.add_audio_pcm("media", "two", _speechlike(rng, 3.0), SR)
    owner.save()
    cat = tmp_path / "d" / "checkpoint" / "catalog.json"
    good = cat.read_text()
    cat.write_text("{torn")
    store = rep.store
    assert rep.refresh_from_checkpoint() is False and rep.store is store
    cat.write_text(good)
    assert rep.refresh_from_checkpoint() is True
    assert [e.name for e in rep.get_audios("media")] == ["one", "two"]
    # a replica started on the .bak generation has SEEN the damaged current
    # one (its JSON parses, its segment is gone)
    import json

    current = json.loads(good)
    for segs in current["tiers"].values():
        for fname, _ in segs:
            os.unlink(tmp_path / "d" / "checkpoint" / fname)
    late = Tiresias(cfg, exclusive=False, device="cpu")
    assert [e.name for e in late.get_audios("media")] == ["one"]
    assert late.store._seen_gen == current["gen"]
    store = late.store
    assert late.refresh_from_checkpoint() is False and late.store is store
    owner.lock.release()


def test_warmup_builds_the_configured_maps(tmp_path):
    rng = np.random.default_rng(27)
    for match, built, absent in (
        (MatchConfig(), "value_map", "match_index"),
        (MatchConfig(coefs=2, trunc_coef1=False, aligned=True, tolerance=0.1),
         "match_index", "value_map"),
    ):
        cfg = TiresiasConfig(data_dir=str(tmp_path / built), match=match)
        eng = Tiresias(cfg, device="cpu")
        eng.create_context("c")
        eng.add_audio_pcm("c", "short", _speechlike(rng, 3.0), SR)
        eng.add_audio_pcm("c", "long", _speechlike(rng, 7.0), SR)
        thread = eng.warmup_async(laws=("ulaw", "alaw"))
        views = eng.store.search_views()
        assert len(views) == 2
        for v in views:
            assert getattr(v, built) is not None and getattr(v, absent) is None
            assert v.seq_dev is not None and v.ctx_dev is not None
        assert all(eng.law_device_ready(law) for law in ("ulaw", "alaw"))
        eng.close()  # joins the background warm thread
        assert not thread.is_alive()
        eng = Tiresias(cfg, device="cpu")
        eng.warmup(batch_sizes=(1, 3), laws=("ulaw",))
        assert all(getattr(v, built) is not None
                   for v in eng.store.search_views())
        eng.close()
