"""Version 1 and 2 checkpoints in the port's store against the JAX store.

A v1 checkpoint is ``catalog.json`` plus one ``fingerprints.npz`` holding a
dense ``matrix`` in global insertion order; a v2 one holds a ``tier_<t>``
matrix per tier, rows in tier insertion order (an auto-split audio on
consecutive rows of the top tier). The layouts are written here by hand,
loaded by ``tiresias_tpu.store.FingerprintStore`` and by the port's, and
held equal: entries, fingerprints, every view tensor bitwise, the catalog
metadata and the fsck reports; the first save writes version 4 and keeps
the legacy ``.bak`` pair as JAX keeps it; both engines give the same TIR*
on the restored store.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from tiresias_tpu.api import Tiresias as JaxTiresias
from tiresias_tpu.config import TiresiasConfig as JaxConfig
from tiresias_tpu.ops.mfcc_jax import fingerprint_padded_batch as jax_fp
from tiresias_tpu.store import fingerprint_store as jfs
from tiresias_tpu.utils.audio import synth_chirp
from tiresias_tpu_torch.api import Tiresias
from tiresias_tpu_torch.api import engine as tengine
from tiresias_tpu_torch.config import TiresiasConfig
from tiresias_tpu_torch.store import fingerprint_store as tfs

torch.set_num_threads(2)

PAD = -1e6
N_COEFS = 2


def _fp(rng, n, c=N_COEFS):
    return rng.normal(-25.0, 15.0, (n, c)).astype(np.float32)


def _entry(i: int, n_frames: int, ctx: str = "a") -> dict:
    return {"uuid": f"u{i:03d}", "name": f"n{i}.wav", "context": ctx,
            "hash": f"h{i}", "n_frames": int(n_frames)}


def _write(directory, version: int, entries: list, fps: list,
           suffix: str = "", n_rows: int | None = None,
           extra_rows: int = 0) -> None:
    """A legacy generation by hand: the catalog and its npz (``n_rows``
    cuts a v1 matrix to a torn row count; ``extra_rows`` appends rows no
    entry references to every v2 tier, a deleted audio's rows)."""
    catalog = {"version": version, "n_coefs": N_COEFS,
               "contexts": {"a": "/dir/a", "b": "/dir/b"},
               "entries": entries}
    (directory / ("catalog.json" + suffix)).write_text(json.dumps(catalog))
    if version == 1:
        t_max = max(e["n_frames"] for e in entries)
        matrix = np.full((len(entries), t_max, N_COEFS), PAD, np.float32)
        for i, fp in enumerate(fps):
            matrix[i, : fp.shape[0]] = fp
        arrays = {"matrix": matrix[:n_rows] if n_rows is not None
                  else matrix}
    else:
        rows: dict[int, list] = {}
        for e, fp in zip(entries, fps):
            segs = jfs.split_frames(e["n_frames"])
            t = (jfs.MAX_TIER_FRAMES if len(segs) > 1
                 else jfs.tier_for(e["n_frames"]))
            off = 0
            for n in segs:
                rows.setdefault(t, []).append(fp[off : off + n])
                off += n
        arrays = {}
        for t, chunks in rows.items():
            m = np.full((len(chunks) + extra_rows, t, N_COEFS), PAD,
                        np.float32)
            for r, c in enumerate(chunks):
                m[r, : c.shape[0]] = c
            if extra_rows:
                m[len(chunks):, :5] = 3.0  # a dead audio's frames
            arrays[f"tier_{t}"] = m
    # a file handle: np.savez_compressed appends ".npz" to a path
    with open(directory / ("fingerprints.npz" + suffix), "wb") as f:
        np.savez_compressed(f, **arrays)


def _corpus(rng, lengths, ctxs=("a", "b")):
    entries = [_entry(i, n, ctxs[i % len(ctxs)])
               for i, n in enumerate(lengths)]
    return entries, [_fp(rng, n) for n in lengths]


CASES = {
    "v1_one_tier": (1, (40, 90, 128, 7)),
    "v1_two_tiers": (1, (100, 200, 50, 250, 128)),
    "v2_one_tier": (2, (40, 90, 128, 7)),
    "v2_two_tiers": (2, (100, 200, 50, 250, 129, 256)),
    "v2_autosplit": (2, (60, 300, 90, 256, 20)),
    "v1_autosplit": (1, (60, 300, 90)),
    "v2_dead_row": (2, (100, 200, 50)),
}


def _make(directory, case: str, monkeypatch, seed: int = 3) -> None:
    version, lengths = CASES[case]
    if "autosplit" in case:
        # audios past 128 frames split into 128-frame segment rows, in both
        # packages (the real top tier holds ~2.1M frames)
        monkeypatch.setattr(jfs, "MAX_TIER_FRAMES", 128)
        monkeypatch.setattr(tfs, "MAX_TIER_FRAMES", 128)
    entries, fps = _corpus(np.random.default_rng(seed), lengths)
    _write(directory, version, entries, fps,
           extra_rows=2 if case == "v2_dead_row" else 0)


def _load_both(directory):
    return (jfs.FingerprintStore.load(str(directory), n_coefs=N_COEFS),
            tfs.FingerprintStore.load(str(directory), n_coefs=N_COEFS,
                                      device="cpu"))


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_same_store(j, t) -> None:
    """Entries, contexts, fingerprints and every view tensor, bitwise."""
    key = [(e.uuid, e.name, e.context, e.hash, e.n_frames, e.seq)
           for e in j.entries]
    assert [(e.uuid, e.name, e.context, e.hash, e.n_frames, e.seq)
            for e in t.entries] == key
    assert t.contexts == j.contexts
    assert (t._restored_gen, t._seen_gen, t._save_dir) == (
        j._restored_gen, j._seen_gen, j._save_dir)
    for e in j.entries:
        np.testing.assert_array_equal(
            _bits(t.get_fingerprint(e.uuid)), _bits(j.get_fingerprint(e.uuid)))
    jviews, tviews = j.search_views(), t.search_views()
    assert [v.tier_frames for v in tviews] == [v.tier_frames for v in jviews]
    for jv, tv in zip(jviews, tviews):
        assert (tv.n_audios, tv.dead_rows) == (jv.n_audios, jv.dead_rows)
        assert [e.uuid for e in tv.entries] == [e.uuid for e in jv.entries]
        assert tv.segments == jv.segments
        np.testing.assert_array_equal(_bits(tv.db.numpy()), _bits(jv.db))
        np.testing.assert_array_equal(tv.mask.numpy(), np.asarray(jv.mask))
        for name in ("value_map", "value_map_q"):
            np.testing.assert_array_equal(
                _bits(getattr(t, name + "_for")(tv).numpy()),
                _bits(getattr(j, name + "_for")(jv)), err_msg=name)
        jspecs, jmaps = j.bound_maps_for(jv, 2)
        tspecs, tmaps = t.bound_maps_for(tv, 2)
        assert tspecs == jspecs
        for jm, tm in zip(jmaps, tmaps):
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        n = tv.n_audios
        np.testing.assert_array_equal(t.seq_for(tv).numpy()[:n],
                                      np.asarray(j.seq_for(jv))[:n])
        np.testing.assert_array_equal(t.ctx_ids_for(tv).numpy()[:n],
                                      np.asarray(j.ctx_ids_for(jv))[:n])


@pytest.mark.parametrize("case", sorted(CASES))
def test_legacy_layout_loads_as_jax(tmp_path, monkeypatch, case):
    _make(tmp_path, case, monkeypatch)
    j, t = _load_both(tmp_path)
    assert len(t) == len(CASES[case][1])
    _assert_same_store(j, t)
    if "autosplit" in case:
        assert any(v.segments for v in t.search_views())
    # the views are built, and nothing on disk changed
    assert sorted(os.listdir(tmp_path)) == ["catalog.json",
                                            "fingerprints.npz"]


@pytest.mark.parametrize("bak_version", [1, 2])
def test_torn_v1_falls_back_to_bak(tmp_path, bak_version):
    """A v1 generation whose matrix row count differs from its catalog (a
    crash between the two renames) is corruption, not incompatibility: both
    stores load the ``.bak`` pair."""
    rng = np.random.default_rng(11)
    entries, fps = _corpus(rng, (40, 90, 200))
    _write(tmp_path, bak_version, entries[:2], fps[:2], suffix=".bak")
    _write(tmp_path, 1, entries, fps, n_rows=2)
    j, t = _load_both(tmp_path)
    assert [e.uuid for e in t.entries] == ["u000", "u001"]
    _assert_same_store(j, t)
    assert (tfs.FingerprintStore.read_catalog_metadata(str(tmp_path))
            == jfs.FingerprintStore.read_catalog_metadata(str(tmp_path)))
    # without the .bak pair nothing is readable
    os.unlink(tmp_path / "fingerprints.npz.bak")
    with pytest.raises(tfs.CheckpointUnreadable, match="row count mismatch"):
        tfs.FingerprintStore.load(str(tmp_path), n_coefs=N_COEFS,
                                  device="cpu")


@pytest.mark.parametrize("case", ["v1_two_tiers", "v2_two_tiers"])
def test_legacy_metadata_equals_jax(tmp_path, monkeypatch, case):
    _make(tmp_path, case, monkeypatch)
    want = jfs.FingerprintStore.read_catalog_metadata(str(tmp_path))
    got = tfs.FingerprintStore.read_catalog_metadata(str(tmp_path))
    assert got == want and got["gen"] == 0
    assert len(got["entries"]) == len(CASES[case][1])


def _fsck_both(directory, **kw):
    want = jfs.fsck_checkpoint(str(directory), **kw)
    got = tfs.fsck_checkpoint(str(directory), **kw)
    assert got == want
    return got


@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize("case", [
    "v1_clean", "v2_clean", "bak_npz_missing", "current_npz_missing",
    "v2_wrong_n_coefs",
])
def test_legacy_fsck_equals_jax(tmp_path, case, deep):
    rng = np.random.default_rng(12)
    entries, fps = _corpus(rng, (40, 200, 90))
    version = 1 if case == "v1_clean" else 2
    _write(tmp_path, version, entries[:2], fps[:2], suffix=".bak")
    _write(tmp_path, version, entries, fps)
    kw = {"deep": deep, "n_coefs": N_COEFS}
    if case == "bak_npz_missing":
        os.unlink(tmp_path / "fingerprints.npz.bak")
    elif case == "current_npz_missing":
        os.unlink(tmp_path / "fingerprints.npz")
    elif case == "v2_wrong_n_coefs":
        kw["n_coefs"] = 3
    report = _fsck_both(tmp_path, **kw)
    gens = report["generations"]
    assert gens["current"]["version"] == version
    assert report["ok"] == (case in ("v1_clean", "v2_clean",
                                     "bak_npz_missing"))
    if case == "bak_npz_missing":
        assert gens["bak"]["errors"] == [
            "legacy v2 fingerprints.npz.bak missing"]
    if case == "current_npz_missing":
        assert gens["current"]["errors"] == [
            "legacy v2 fingerprints.npz missing"]
        if deep:  # the restore a server would run falls back to .bak
            assert report["deep"]["ok"] and report["deep"]["entries"] == 2


@pytest.mark.parametrize("version", [1, 2])
def test_first_save_writes_v4_and_pairs_the_legacy_backup(tmp_path, version):
    """The first save over a legacy layout writes version 4, copies the
    matrix the rotating catalog references to ``fingerprints.npz.bak`` (a
    stale older ``.bak`` pair is replaced), and lays out the same files as
    the JAX store's save; the ``.bak`` pair then restores the last legacy
    state."""
    rng = np.random.default_rng(13)
    entries, fps = _corpus(rng, (40, 200, 90, 7))
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    # a stale .bak pair from an older generation (fewer rows)
    _write(legacy, version, entries[:1], fps[:1], suffix=".bak")
    _write(legacy, version, entries, fps)
    matrix = (legacy / "fingerprints.npz").read_bytes()
    dirs = {}
    for name, cls, kw in (("jax", jfs.FingerprintStore, {}),
                          ("port", tfs.FingerprintStore, {"device": "cpu"})):
        d = dirs[name] = tmp_path / name
        shutil.copytree(legacy, d)
        store = cls.load(str(d), n_coefs=N_COEFS, **kw)
        store.save(str(d))
    assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["jax"]))
    for name in ("catalog.json", "catalog.json.bak"):
        with open(dirs["port"] / name) as f, open(dirs["jax"] / name) as g:
            assert json.load(f) == json.load(g), name
    with open(dirs["port"] / "catalog.json") as f:
        assert json.load(f)["version"] == 4
    assert (dirs["port"] / "fingerprints.npz.bak").read_bytes() == matrix
    want = jfs.FingerprintStore.load(str(legacy), n_coefs=N_COEFS)
    # the v4 generation restores the legacy store
    _assert_same_store_entries(want, tfs.FingerprintStore.load(
        str(dirs["port"]), n_coefs=N_COEFS, device="cpu"))
    # a corrupt v4 generation falls back to the last legacy state
    (dirs["port"] / "catalog.json").write_text("{corrupt")
    (dirs["jax"] / "catalog.json").write_text("{corrupt")
    j = jfs.FingerprintStore.load(str(dirs["jax"]), n_coefs=N_COEFS)
    t = tfs.FingerprintStore.load(str(dirs["port"]), n_coefs=N_COEFS,
                                  device="cpu")
    assert len(t) == len(entries)
    _assert_same_store(j, t)
    _assert_same_store_entries(want, t)


def _assert_same_store_entries(want, got) -> None:
    assert [(e.uuid, e.n_frames) for e in got.entries] == [
        (e.uuid, e.n_frames) for e in want.entries]
    for e in want.entries:
        np.testing.assert_array_equal(got.get_fingerprint(e.uuid),
                                      want.get_fingerprint(e.uuid))


def test_second_save_of_an_upgraded_store_is_incremental(tmp_path):
    """After the upgrade the store saves like any v4 store: unchanged
    segments are kept, and the legacy matrix stays with the ``.bak``."""
    rng = np.random.default_rng(14)
    entries, fps = _corpus(rng, (40, 90))
    _write(tmp_path, 2, entries, fps)
    store = tfs.FingerprintStore.load(str(tmp_path), n_coefs=N_COEFS,
                                      device="cpu")
    store.save(str(tmp_path))
    first = sorted(n for n in os.listdir(tmp_path) if n.endswith(".npy"))
    store.add_audio("extra", "a", _fp(rng, 200), "hx")  # a new tier
    store.save(str(tmp_path))
    with open(tmp_path / "catalog.json.bak") as f:
        assert json.load(f)["version"] == 4
    segs = json.loads((tmp_path / "catalog.json").read_text())["tiers"]
    assert segs["128"][0][0] in first  # tier 128 unchanged: kept
    assert os.path.exists(tmp_path / "fingerprints.npz.bak")


# ---- both engines on a legacy store ------------------------------------ #

SR = 8000


@pytest.fixture
def jax_query_fp(monkeypatch):
    """The port fingerprints its queries with the JAX function, so both
    engines vote bitwise-equal query fingerprints against bitwise-equal
    stored ones and their TIR* must be equal exactly (the port's own
    fingerprints are held to JAX's within their float32 bound in
    test_torch_mfcc.py)."""

    def fp(padded, samplerate, dsp, law=None, n_valid=None, device="cpu"):
        out = jax_fp(padded, samplerate, dsp, law=law, n_valid=n_valid)
        return torch.from_numpy(np.array(out)).to(device)

    monkeypatch.setattr(tengine, "fingerprint_padded_batch", fp)


MODES = {
    "dialplan": dict(tolerance=1.0),
    "bag": dict(coefs=2, tolerance=0.3, trunc_coef1=False),
    "aligned": dict(coefs=2, tolerance=0.3, trunc_coef1=False, aligned=True),
}


@pytest.mark.parametrize("version", [1, 2])
def test_engines_agree_on_a_legacy_store(tmp_path, jax_query_fp, version):
    """Chirps fingerprinted by the JAX engine, written as a legacy layout,
    restored by both engines: the same TIR* in every mode, with and
    without the context filter."""
    src = JaxTiresias(JaxConfig(data_dir=str(tmp_path / "src")),
                      restore=False)
    for c in ("a", "b"):
        src.create_context(c)
    chirps = [synth_chirp(200 + 90 * i, 700 + 150 * i, (2.0, 5.0)[i % 2], SR)
              for i in range(8)]
    for i, pcm in enumerate(chirps):
        src.add_audio_pcm("ab"[i % 2], f"c{i}", pcm, SR)
    entries = [e.to_dict() for e in src.store.entries]
    fps = [src.store.get_fingerprint(e["uuid"]) for e in entries]
    roots = {}
    for name in ("jax", "port"):
        ckpt = tmp_path / name / "checkpoint"
        ckpt.mkdir(parents=True)
        _write(ckpt, version, entries, fps)
        roots[name] = str(tmp_path / name)
    jeng = JaxTiresias(JaxConfig(data_dir=roots["jax"]))
    teng = Tiresias(TiresiasConfig(data_dir=roots["port"]), device="cpu")
    try:
        rng = np.random.default_rng(5)
        queries = []
        for pcm in chirps:
            off = 256 * int(rng.integers(0, (len(pcm) - SR) // 256))
            queries.append(pcm[off : off + SR + 4096])
        queries.append(rng.normal(0, 0.1, SR).astype(np.float32))
        for name, kw in MODES.items():
            for ctx, filt in ((None, False), ("a", True)):
                want = jeng.search_pcm_batch(ctx, queries, SR,
                                             filter_context=filt, **kw)
                got = teng.search_pcm_batch(ctx, queries, SR,
                                            filter_context=filt, **kw)
                assert ([r.to_channel_vars() for r in got]
                        == [r.to_channel_vars() for r in want]), (name, ctx)
                if not filt:
                    assert sum(r.found for r in got) >= len(chirps) // 2
    finally:
        jeng.close()
        teng.close()
    # both closed engines upgraded their checkpoints to version 4
    for name in roots:
        with open(os.path.join(roots[name], "checkpoint", "catalog.json")) as f:
            assert json.load(f)["version"] == 4

