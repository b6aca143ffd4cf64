"""PyTorch port's fingerprint store vs the JAX package.

The version-4 checkpoint (``catalog.json`` + numpy segment files) is how
state crosses between the packages: a checkpoint written by
``tiresias_tpu`` must restore in the port with identical entries, matrices
and lattice value maps, and the reverse.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from tiresias_tpu.store.fingerprint_store import (
    FingerprintStore as JaxStore,
)
from tiresias_tpu_torch.store import fingerprint_store as tfs
from tiresias_tpu_torch.store.fingerprint_store import (
    CheckpointIncompatible,
    CheckpointUnreadable,
    FingerprintStore,
    split_frames,
    tier_for,
)

torch.set_num_threads(2)


def _fp(rng, n, c=2):
    return rng.normal(-25.0, 15.0, (n, c)).astype(np.float32)


def _populate(store, rng, n=24):
    """Audios across three tiers (128, 256, 1024 frames), two contexts, a
    duplicate hash, then two deletes (tombstones in the v4 'dead' list)."""
    store.create_context("a", "/dir/a")
    store.create_context("b", "/dir/b")
    added = []
    for i in range(n):
        nf = (40, 200, 700)[i % 3] + i
        e = store.add_audio(f"f{i}.wav", "ab"[i % 2], _fp(rng, nf), f"h{i}")
        added.append(e)
    store.add_audio("dup.wav", "a", _fp(rng, 50), "h0", dedupe=False)
    store.delete_audios([added[4].uuid, added[9].uuid])
    return added


def _entries(store):
    return [
        (e.uuid, e.name, e.context, e.hash, e.n_frames)
        for e in store.entries
    ]


def _maps_equal(jstore, tstore):
    jviews = jstore.search_views()
    tviews = tstore.search_views()
    assert [v.tier_frames for v in jviews] == [v.tier_frames for v in tviews]
    for jv, tv in zip(jviews, tviews):
        assert jv.n_audios == tv.n_audios
        assert [e.uuid for e in jv.entries] == [e.uuid for e in tv.entries]
        np.testing.assert_array_equal(
            tstore.value_map_for(tv).numpy(),
            np.asarray(jstore.value_map_for(jv)),
        )
        seqs = tstore.seq_for(tv).numpy()[: tv.n_audios]
        np.testing.assert_array_equal(
            seqs, np.asarray(jstore.seq_for(jv))[: jv.n_audios]
        )


def test_jax_checkpoint_restores_in_port(tmp_path):
    rng = np.random.default_rng(0)
    jstore = JaxStore(n_coefs=2)
    _populate(jstore, rng)
    jstore.save(str(tmp_path))
    jstore = JaxStore.load(str(tmp_path), n_coefs=2)
    tstore = FingerprintStore.load(str(tmp_path), n_coefs=2, device="cpu")
    assert _entries(tstore) == _entries(jstore)
    assert tstore.contexts == jstore.contexts
    for jdb, tdb in zip(jstore.host_db(), tstore.host_db()):
        np.testing.assert_array_equal(tdb, jdb)
    _maps_equal(jstore, tstore)


def test_port_checkpoint_restores_in_jax(tmp_path):
    rng = np.random.default_rng(1)
    tstore = FingerprintStore(n_coefs=2, device="cpu")
    _populate(tstore, rng)
    tstore.save(str(tmp_path))
    with open(tmp_path / "catalog.json") as f:
        cat = json.load(f)
    assert cat["version"] == 4 and cat["dead"]  # tombstones persisted
    jstore = JaxStore.load(str(tmp_path), n_coefs=2)
    tstore = FingerprintStore.load(str(tmp_path), n_coefs=2, device="cpu")
    assert _entries(jstore) == _entries(tstore)
    for jdb, tdb in zip(jstore.host_db(), tstore.host_db()):
        np.testing.assert_array_equal(tdb, jdb)
    _maps_equal(jstore, tstore)


def test_tombstoned_views_never_vote(tmp_path):
    rng = np.random.default_rng(2)
    jstore = JaxStore(n_coefs=2)
    tstore = FingerprintStore(n_coefs=2, device="cpu")
    for s in (jstore, tstore):
        s.create_context("a")
    fps = [_fp(rng, 60) for _ in range(5)]
    for i, fp in enumerate(fps):
        for s in (jstore, tstore):
            s.add_audio(f"x{i}", "a", fp, f"h{i}", uuid=f"u{i}")
    for s in (jstore, tstore):
        s.search_views()
        s.delete_audio("u2")
    _maps_equal(jstore, tstore)
    (view,) = tstore.search_views()
    assert 2 in view.dead_rows
    assert torch.isinf(tstore.value_map_for(view)[2]).all()
    assert tstore.ctx_ids_for(view)[2] == -1


@pytest.mark.parametrize("segmented", [False, True])
def test_dead_rows_hold_pad_value_like_jax(segmented, monkeypatch):
    """The vote kernels read values only: a tombstoned row's db must be
    PAD_VALUE (as the JAX view writes it) and its mask row all False; live
    rows keep their fingerprints. ``segmented`` deletes an auto-split
    audio (all its segment rows)."""
    if segmented:
        monkeypatch.setattr(tfs, "MAX_TIER_FRAMES", 128)
    rng = np.random.default_rng(3)
    store = FingerprintStore(n_coefs=2, device="cpu")
    store.create_context("a")
    lengths = (60, 300 if segmented else 90, 70)
    fps = [_fp(rng, n) for n in lengths]
    es = [store.add_audio(f"x{i}", "a", fp, f"h{i}")
          for i, fp in enumerate(fps)]
    store.search_views()
    assert store.delete_audio(es[1].uuid)
    (view,) = store.search_views()
    dead = sorted(view.dead_rows)
    assert dead == ([1, 2, 3] if segmented else [1])
    db, mask = view.db.numpy(), view.mask.numpy()
    assert (db[dead] == tfs.PAD_VALUE).all() and not mask[dead].any()
    live = [0, view.n_audios - 1]
    for row, fp in zip(live, (fps[0], fps[2])):
        np.testing.assert_array_equal(db[row, : len(fp)], fp)
        assert mask[row].sum() == len(fp)
    # the view updated row by row keeps the dead audio's segment group, as
    # the JAX store's does (its rows have no vote to merge); a full build
    # drops it
    followers, heads = store.segment_rows_for(view)
    want = ([2, 3], [1, 1]) if segmented else ([], [])
    assert (followers.tolist(), heads.tolist()) == want
    full = store._build_view(store._tiers[view.tier_frames], view.n_audios)
    assert full.segments == ()


def test_incremental_save_rewrites_only_dirty_segments(tmp_path, monkeypatch):
    monkeypatch.setattr(tfs, "SEGMENT_ROWS", 4)
    rng = np.random.default_rng(3)
    store = FingerprintStore(n_coefs=2, device="cpu")
    store.create_context("a")
    for i in range(9):
        store.add_audio(f"x{i}", "a", _fp(rng, 50), f"h{i}")
    store.save(str(tmp_path))
    before = set(os.listdir(tmp_path))
    store.add_audio("x9", "a", _fp(rng, 50), "h9")
    store.save(str(tmp_path))
    after = set(os.listdir(tmp_path))
    with open(tmp_path / "catalog.json") as f:
        segs = json.load(f)["tiers"]["128"]
    # the two full segments are reused, only the tail segment is new
    assert [s[1] for s in segs] == [4, 4, 2]
    assert segs[0][0] in before and segs[1][0] in before
    assert segs[2][0] in after - before
    restored = FingerprintStore.load(str(tmp_path), n_coefs=2, device="cpu")
    assert _entries(restored) == _entries(store)


def test_crud_dedupe_and_contexts():
    rng = np.random.default_rng(4)
    store = FingerprintStore(n_coefs=2, device="cpu")
    with pytest.raises(KeyError):
        store.add_audio("x", "nope", _fp(rng, 10), "h")
    store.create_context("a")
    store.create_context("b")
    e = store.add_audio("x", "a", _fp(rng, 10), "h")
    assert store.add_audio("y", "a", _fp(rng, 10), "h") is None  # dedupe
    assert store.find_by_hash("a", "h") is e
    f = store.add_audio("y", "b", _fp(rng, 300), "h")
    assert [x.name for x in store.get_audios_by_context("b")] == ["y"]
    assert store.get_fingerprint(f.uuid).shape == (300, 2)
    assert store.delete_context("b") and store.get_audio(f.uuid) is None
    assert store.delete_audio(e.uuid) and not store.delete_audio(e.uuid)
    assert store.find_by_hash("a", "h") is None and len(store) == 0


def test_compaction_keeps_order_and_maps():
    rng = np.random.default_rng(5)
    store = FingerprintStore(n_coefs=2, device="cpu")
    store.create_context("a")
    added = [store.add_audio(f"x{i}", "a", _fp(rng, 30), f"h{i}")
             for i in range(200)]
    store.delete_audios([e.uuid for e in added[:130]])  # past the threshold
    (view,) = store.search_views()
    assert view.n_audios == 70 and not view.dead_rows
    assert [e.name for e in view.entries] == [e.name for e in added[130:]]


def test_load_rejects_incompatible_and_unreadable(tmp_path):
    rng = np.random.default_rng(6)
    store = FingerprintStore(n_coefs=2, device="cpu")
    store.create_context("a")
    store.add_audio("x", "a", _fp(rng, 20), "h")
    store.save(str(tmp_path))
    with pytest.raises(CheckpointIncompatible):
        FingerprintStore.load(str(tmp_path), n_coefs=3, device="cpu")
    with pytest.raises(CheckpointIncompatible):
        FingerprintStore.load(str(tmp_path), n_coefs=2, coef_weights=(1, 2),
                              device="cpu")
    (tmp_path / "catalog.json").write_text("{torn")
    assert not (tmp_path / "catalog.json.bak").exists()
    with pytest.raises(CheckpointUnreadable):
        FingerprintStore.load(str(tmp_path), n_coefs=2, device="cpu")


def test_bak_generation_fallback(tmp_path):
    rng = np.random.default_rng(7)
    store = FingerprintStore(n_coefs=2, device="cpu")
    store.create_context("a")
    store.add_audio("x", "a", _fp(rng, 20), "h1")
    store.save(str(tmp_path))
    store.add_audio("y", "a", _fp(rng, 20), "h2")
    store.save(str(tmp_path))
    (tmp_path / "catalog.json").write_text("{torn")
    restored = FingerprintStore.load(str(tmp_path), n_coefs=2, device="cpu")
    assert [e.name for e in restored.entries] == ["x"]


@pytest.mark.parametrize("n", [1, 128, 129, 1000, 2**21])
def test_tiers_match_jax(n):
    from tiresias_tpu.store import fingerprint_store as jfs

    assert tier_for(n) == jfs.tier_for(n)
    assert split_frames(n) == jfs.split_frames(n)
    assert split_frames(2**21 + 5) == jfs.split_frames(2**21 + 5)


# ---- checkpoint fallback, metadata, compaction, fsck ------------------- #


def _two_generations(directory, seed=8, cls=None):
    """A store saved twice: generation 1 holds "x", generation 2 "x" and
    "y". Returns the segment files only the current catalog references."""
    rng = np.random.default_rng(seed)
    store = (cls(n_coefs=2) if cls is not None
             else FingerprintStore(n_coefs=2, device="cpu"))
    store.create_context("a", "/dir/a")
    store.add_audio("x", "a", _fp(rng, 20), "h1", uuid="ux")
    store.save(str(directory))
    store.add_audio("y", "a", _fp(rng, 20), "h2", uuid="uy")
    store.save(str(directory))

    def segs(name):
        with open(directory / name) as f:
            return {s[0] for t in json.load(f)["tiers"].values() for s in t}

    return sorted(segs("catalog.json") - segs("catalog.json.bak"))


def _load_both(directory):
    return (JaxStore.load(str(directory), n_coefs=2),
            FingerprintStore.load(str(directory), n_coefs=2, device="cpu"))


@pytest.mark.parametrize("damage", ["zero_bytes", "missing", "truncated"])
def test_damaged_segment_falls_back_to_bak_like_jax(tmp_path, damage):
    """A segment file that only the current catalog references is empty
    (np.load raises EOFError), gone or cut short: both packages restore
    generation 1 from ``.bak``."""
    current_only = _two_generations(tmp_path)
    assert current_only
    for name in current_only:
        path = tmp_path / name
        if damage == "missing":
            os.unlink(path)
        else:
            keep = 0 if damage == "zero_bytes" else os.path.getsize(path) // 2
            with open(path, "r+b") as f:
                f.truncate(keep)
    jstore, tstore = _load_both(tmp_path)
    assert [e.name for e in tstore.entries] == ["x"]
    assert _entries(tstore) == _entries(jstore)
    # the damaged current generation was observed: a follower does not
    # take it for news on every poll
    assert (tstore._restored_gen, tstore._seen_gen, tstore._save_gen) == (
        jstore._restored_gen, jstore._seen_gen, jstore._save_gen) == (1, 2, 0)


@pytest.mark.parametrize("text", ["[1, 2]", "null", '"tiers"', "{torn", "7"])
def test_non_dict_catalog_is_unreadable_not_a_crash(tmp_path, text):
    path = tmp_path / "catalog.json"
    path.write_text(text)
    assert FingerprintStore._referenced_segments(str(path)) == set()
    assert FingerprintStore._referenced_segments(
        str(tmp_path / "absent.json")) == set()
    assert tfs._read_catalog_gen(str(path)) == 0
    # the rotation guard asks only whether the JSON parses
    from tiresias_tpu.store import fingerprint_store as jfs

    assert tfs._readable_catalog(str(path)) == jfs._readable_catalog(str(path))
    assert tfs._readable_catalog(str(tmp_path)) is False  # a directory


def test_save_over_a_non_dict_bak_keeps_every_live_segment(tmp_path):
    """_gc_segments after a committed save must survive a ``.bak`` that
    parses to a list."""
    _two_generations(tmp_path)
    (tmp_path / "catalog.json.bak").write_text("[1, 2]")
    store = FingerprintStore.load(str(tmp_path), n_coefs=2, device="cpu")
    store.add_audio("z", "a", _fp(np.random.default_rng(0), 20), "h3")
    store.save(str(tmp_path))
    again = FingerprintStore.load(str(tmp_path), n_coefs=2, device="cpu")
    assert [e.name for e in again.entries] == ["x", "y", "z"]


def test_read_catalog_metadata_equals_jax(tmp_path):
    assert FingerprintStore.read_catalog_metadata(str(tmp_path)) is None
    _two_generations(tmp_path)
    want = JaxStore.read_catalog_metadata(str(tmp_path))
    got = FingerprintStore.read_catalog_metadata(str(tmp_path))
    assert got == want and got["gen"] == 2
    assert [e["name"] for e in got["entries"]] == ["x", "y"]
    (tmp_path / "catalog.json").write_text("{torn")
    got = FingerprintStore.read_catalog_metadata(str(tmp_path))
    assert got == JaxStore.read_catalog_metadata(str(tmp_path))
    assert got["gen"] == 1
    (tmp_path / "catalog.json.bak").write_text("[]")
    with pytest.raises(CheckpointUnreadable):
        FingerprintStore.read_catalog_metadata(str(tmp_path))


@pytest.mark.parametrize("version", [0, 5, None, "4"])
def test_other_checkpoint_versions_are_named_not_read(tmp_path, version):
    """The loader reads versions 1 to 4 (1 and 2 in
    test_torch_legacy_checkpoint.py); metadata and fsck report any other
    the same way, naming it (a string "4" is not version 4)."""
    _two_generations(tmp_path)
    with open(tmp_path / "catalog.json") as f:
        cat = json.load(f)
    cat["version"] = version
    (tmp_path / "catalog.json").write_text(json.dumps(cat))
    for read in (
        lambda: FingerprintStore.load(str(tmp_path), n_coefs=2, device="cpu"),
        lambda: FingerprintStore.read_catalog_metadata(str(tmp_path)),
    ):
        with pytest.raises(CheckpointIncompatible,
                           match=re.escape(f"version {version!r} ")):
            read()
    report = tfs.fsck_checkpoint(str(tmp_path), deep=True, n_coefs=2)
    assert not report["ok"] and not report["deep"]["ok"]
    named = f"version {version!r} "
    assert named in report["generations"]["current"]["errors"][0]
    assert named in report["deep"]["error"]


def test_store_compact_equals_jax():
    rng = np.random.default_rng(9)
    jstore = JaxStore(n_coefs=2)
    tstore = FingerprintStore(n_coefs=2, device="cpu")
    for s in (jstore, tstore):
        s.create_context("a")
    for i in range(12):
        fp = _fp(rng, (40, 200)[i % 2])
        for s in (jstore, tstore):
            s.add_audio(f"x{i}", "a", fp, f"h{i}", uuid=f"u{i}")
    for s in (jstore, tstore):
        s.search_views()
        s.delete_audios(["u1", "u4", "u5"])  # below the automatic threshold
    assert any(v.dead_rows for v in tstore.search_views())
    for s in (jstore, tstore):
        s.compact()
    views = tstore.search_views()
    assert not any(v.dead_rows for v in views)
    assert [v.n_audios for v in views] == [5, 4]
    _maps_equal(jstore, tstore)
    assert [e.uuid for e in tstore.iter_entries()] == [
        e.uuid for e in jstore.iter_entries()]
    got = tstore.iter_entries()
    got.clear()  # a snapshot, not the catalog
    assert len(tstore) == 9
    tstore.compact()  # nothing dead: views stay cached
    assert tstore.search_views() is views


def _fsck_both(directory, **kw):
    from tiresias_tpu.store.fingerprint_store import fsck_checkpoint as jfsck

    want = jfsck(str(directory), **kw)
    got = tfs.fsck_checkpoint(str(directory), **kw)
    assert got == want
    return got


@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize(
    "case", ["clean", "torn_catalog", "zero_segment", "orphans", "bad_dead",
             "tiers_scalar", "wrong_n_coefs"])
def test_fsck_report_equals_jax(tmp_path, case, deep):
    current_only = _two_generations(tmp_path)
    cat_path = tmp_path / "catalog.json"
    with open(cat_path) as f:
        cat = json.load(f)
    kw = {"deep": deep, "n_coefs": 2}
    if case == "torn_catalog":
        cat_path.write_text('{"version": 4, "entr')
    elif case == "zero_segment":
        (tmp_path / current_only[0]).write_bytes(b"")
    elif case == "orphans":
        np.save(tmp_path / "tier128_seg7.g9.npy", np.zeros((1, 128, 2), "f4"))
    elif case == "bad_dead":
        cat["dead"] = {"128": [99]}
        cat_path.write_text(json.dumps(cat))
    elif case == "tiers_scalar":
        cat["tiers"] = 3
        cat_path.write_text(json.dumps(cat))
    elif case == "wrong_n_coefs":
        kw["n_coefs"] = 3
    report = _fsck_both(tmp_path, **kw)
    assert report["ok"] == (case in ("clean", "orphans"))
    # an unreadable current catalog references nothing: its own segment
    # counts as debris too
    assert report["orphans"]["count"] == (
        1 if case in ("orphans", "torn_catalog", "tiers_scalar") else 0)
    if deep and case in ("torn_catalog", "zero_segment", "tiers_scalar"):
        # the restore a server would run falls back to generation 1
        assert report["deep"]["ok"] and report["deep"]["gen"] == 1


def test_fsck_without_configured_n_coefs(tmp_path):
    _two_generations(tmp_path)
    report = _fsck_both(tmp_path, deep=True)
    assert report["ok"] and report["deep"]["entries"] == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    assert not _fsck_both(empty, deep=True)["ok"]
