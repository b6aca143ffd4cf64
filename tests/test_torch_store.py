"""PyTorch port's fingerprint store vs the JAX package.

The version-4 checkpoint (``catalog.json`` + numpy segment files) is how
state crosses between the packages: a checkpoint written by
``tiresias_tpu`` must restore in the port with identical entries, matrices
and lattice value maps, and the reverse.
"""

import json
import os

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
    tstore = FingerprintStore.load(str(tmp_path), n_coefs=2)
    assert _entries(tstore) == _entries(jstore)
    assert tstore.contexts == jstore.contexts
    for jdb, tdb in zip(jstore.host_db(), tstore.host_db()):
        np.testing.assert_array_equal(tdb, jdb)
    _maps_equal(jstore, tstore)


def test_port_checkpoint_restores_in_jax(tmp_path):
    rng = np.random.default_rng(1)
    tstore = FingerprintStore(n_coefs=2)
    _populate(tstore, rng)
    tstore.save(str(tmp_path))
    with open(tmp_path / "catalog.json") as f:
        cat = json.load(f)
    assert cat["version"] == 4 and cat["dead"]  # tombstones persisted
    jstore = JaxStore.load(str(tmp_path), n_coefs=2)
    tstore = FingerprintStore.load(str(tmp_path), n_coefs=2)
    assert _entries(jstore) == _entries(tstore)
    for jdb, tdb in zip(jstore.host_db(), tstore.host_db()):
        np.testing.assert_array_equal(tdb, jdb)
    _maps_equal(jstore, tstore)


def test_tombstoned_views_never_vote(tmp_path):
    rng = np.random.default_rng(2)
    jstore = JaxStore(n_coefs=2)
    tstore = FingerprintStore(n_coefs=2)
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
    store = FingerprintStore(n_coefs=2)
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
    followers, heads = store.segment_rows_for(view)
    assert followers.numel() == heads.numel() == 0  # the split audio is gone


def test_incremental_save_rewrites_only_dirty_segments(tmp_path, monkeypatch):
    monkeypatch.setattr(tfs, "SEGMENT_ROWS", 4)
    rng = np.random.default_rng(3)
    store = FingerprintStore(n_coefs=2)
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
    restored = FingerprintStore.load(str(tmp_path), n_coefs=2)
    assert _entries(restored) == _entries(store)


def test_crud_dedupe_and_contexts():
    rng = np.random.default_rng(4)
    store = FingerprintStore(n_coefs=2)
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
    store = FingerprintStore(n_coefs=2)
    store.create_context("a")
    added = [store.add_audio(f"x{i}", "a", _fp(rng, 30), f"h{i}")
             for i in range(200)]
    store.delete_audios([e.uuid for e in added[:130]])  # past the threshold
    (view,) = store.search_views()
    assert view.n_audios == 70 and not view.dead_rows
    assert [e.name for e in view.entries] == [e.name for e in added[130:]]


def test_load_rejects_incompatible_and_unreadable(tmp_path):
    rng = np.random.default_rng(6)
    store = FingerprintStore(n_coefs=2)
    store.create_context("a")
    store.add_audio("x", "a", _fp(rng, 20), "h")
    store.save(str(tmp_path))
    with pytest.raises(CheckpointIncompatible):
        FingerprintStore.load(str(tmp_path), n_coefs=3)
    with pytest.raises(CheckpointIncompatible):
        FingerprintStore.load(str(tmp_path), n_coefs=2, coef_weights=(1, 2))
    (tmp_path / "catalog.json").write_text("{torn")
    assert not (tmp_path / "catalog.json.bak").exists()
    with pytest.raises(CheckpointUnreadable):
        FingerprintStore.load(str(tmp_path), n_coefs=2)


def test_bak_generation_fallback(tmp_path):
    rng = np.random.default_rng(7)
    store = FingerprintStore(n_coefs=2)
    store.create_context("a")
    store.add_audio("x", "a", _fp(rng, 20), "h1")
    store.save(str(tmp_path))
    store.add_audio("y", "a", _fp(rng, 20), "h2")
    store.save(str(tmp_path))
    (tmp_path / "catalog.json").write_text("{torn")
    restored = FingerprintStore.load(str(tmp_path), n_coefs=2)
    assert [e.name for e in restored.entries] == ["x"]


@pytest.mark.parametrize("n", [1, 128, 129, 1000, 2**21])
def test_tiers_match_jax(n):
    from tiresias_tpu.store import fingerprint_store as jfs

    assert tier_for(n) == jfs.tier_for(n)
    assert split_frames(n) == jfs.split_frames(n)
    assert split_frames(2**21 + 5) == jfs.split_frames(2**21 + 5)
