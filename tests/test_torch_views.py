"""Incremental device-view updates of the port's store against the JAX store.

A JAX ``FingerprintStore`` and the port's (``device="cpu"``) run the same
seeded mutation script, with every derived map warm before each step. After
every step both views must be equal (db, mask, the f32 lattice map, its
uint8 copy, the bound maps of coefs 2 and 3, the seqs, and the context ids
on live rows), the port's updated view must equal the port's full rebuild
bitwise (K4/K5's sorted index and the segment rows included), the port must
take the route the JAX store takes (a step JAX extends or masks runs with
the port's full build patched to raise), and the previous view's tensors
must be unchanged. Then both engines on a 33-track store, with candidate
budgets cut to 16 so the prefilters' gates admit its 128-row view, give
equal TIR* and top-k listings after appends and deletes, exactly.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from tiresias_tpu.api import Tiresias as JaxTiresias
from tiresias_tpu.config import ContextConfig, TiresiasConfig
from tiresias_tpu.ops.mfcc_jax import fingerprint_padded_batch as jax_fp
from tiresias_tpu.store import fingerprint_store as jfs
from tiresias_tpu.utils.audio import (
    read_wav_i16,
    synth_chirp,
    synth_tone,
    write_wav,
)
from tiresias_tpu_torch.api import Tiresias
from tiresias_tpu_torch.api import engine as tengine
from tiresias_tpu_torch.ops import match as tm
from tiresias_tpu_torch.ops import match_kernels as tk
from tiresias_tpu_torch.ops import match_lattice as tml
from tiresias_tpu_torch.store import fingerprint_store as tfs

torch.set_num_threads(2)

SR = 8000
N_COEFS = 3
BOUND_COEFS = (2, 3)  # keys (0, 1) and (1, 2)


# ---- store level ------------------------------------------------------- #


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A tensor's bit pattern, so NaN and -0.0 compare exactly."""
    if x.dtype == torch.float32:
        return x.contiguous().view(torch.int32)
    return x


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _tensors(view) -> dict:
    """Every tensor of a port view, by name, the segment rows included."""
    out = view.tensors()
    for i, x in enumerate(view.seg_dev or ()):
        out[f"seg[{i}]"] = x
    return out


def _warm_port(store, view) -> None:
    store.value_map_q_for(view)
    for c in BOUND_COEFS:
        store.bound_maps_for(view, c)
    store.match_index_for(view)
    store.seq_for(view)
    store.ctx_ids_for(view)
    store.segment_rows_for(view)


def _warm_jax(store, view) -> None:
    store.value_map_q_for(view)
    for c in BOUND_COEFS:
        store.bound_maps_for(view, c)
    store.seq_for(view)
    store.ctx_ids_for(view)


def _live(view) -> np.ndarray:
    return np.array([i not in view.dead_rows for i in range(view.n_audios)],
                    bool)


class Pair:
    """The same catalog in a JAX store and a port store, mutated alike."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.j = jfs.FingerprintStore(n_coefs=N_COEFS)
        self.t = tfs.FingerprintStore(n_coefs=N_COEFS, device="cpu")
        for s in (self.j, self.t):
            s.create_context("a")
            s.create_context("b")
        self.uuids: list[str] = []
        self.full_builds = {"jax": 0, "port": 0}
        self.forbid_full = False
        jput, tbuild = self.j._device_put, self.t._build_view

        def jax_put(*a, **k):
            self.full_builds["jax"] += 1
            return jput(*a, **k)

        def port_build(*a, **k):
            if self.forbid_full:
                raise AssertionError("the port rebuilt a view in full where "
                                     "the JAX store updates it")
            self.full_builds["port"] += 1
            return tbuild(*a, **k)

        self.j._device_put = jax_put
        self.t._build_view = port_build

    def add(self, n_frames: int, ctx: str = "a") -> str:
        fp = self.rng.normal(-25.0, 15.0, (n_frames, N_COEFS))
        fp[:, 1:] = self.rng.normal(0.0, 8.0, (n_frames, N_COEFS - 1))
        uuid = f"u{len(self.uuids):04d}"
        for s in (self.j, self.t):
            s.add_audio(uuid, ctx, fp.astype(np.float32), "h" + uuid,
                        uuid=uuid)
        self.uuids.append(uuid)
        return uuid

    def delete(self, *uuids: str) -> None:
        for s in (self.j, self.t):
            assert s.delete_audios(uuids) == len(uuids)

    def warm(self):
        """Build both stores' views and every derived map; returns the
        port's views and a clone of each of their tensors."""
        for v in self.j.search_views():
            _warm_jax(self.j, v)
        views = self.t.search_views()
        for v in views:
            _warm_port(self.t, v)
        return views, [{k: x.clone() for k, x in _tensors(v).items()}
                       for v in views]

    def full_rebuild(self) -> list:
        """The port's views built in full from the same store state, every
        derived map built from them (the store's cached views untouched)."""
        out = []
        for t in sorted(self.t._tiers):
            tier = self.t._tiers[t]
            if tier.entries:
                v = tfs.FingerprintStore._build_view(self.t, tier,
                                                     len(tier.entries))
                _warm_port(self.t, v)
                out.append(v)
        return out


def _check_views(pair: Pair) -> list:
    """The port's views against the JAX store's and a full rebuild."""
    jviews = pair.j.search_views()
    tviews = pair.t.search_views()
    assert [v.tier_frames for v in jviews] == [v.tier_frames for v in tviews]
    for jv, tv in zip(jviews, tviews):
        assert (jv.n_audios, jv.dead_rows) == (tv.n_audios, tv.dead_rows)
        assert [e.uuid for e in jv.entries] == [e.uuid for e in tv.entries]
        assert tuple(jv.row_frames) == tv.row_frames
        np.testing.assert_array_equal(tv.db.numpy(), np.asarray(jv.db))
        np.testing.assert_array_equal(tv.mask.numpy(), np.asarray(jv.mask))
        for name in ("value_map", "value_map_q"):
            want = np.asarray(getattr(pair.j, name + "_for")(jv))
            got = getattr(pair.t, name + "_for")(tv).numpy()
            np.testing.assert_array_equal(got, want, err_msg=name)
        for c in BOUND_COEFS:
            jspecs, jmaps = pair.j.bound_maps_for(jv, c)
            tspecs, tmaps = pair.t.bound_maps_for(tv, c)
            assert tspecs == jspecs
            for jm, tm in zip(jmaps, tmaps):
                np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        n = tv.n_audios
        np.testing.assert_array_equal(pair.t.seq_for(tv).numpy()[:n],
                                      np.asarray(pair.j.seq_for(jv))[:n])
        live = _live(tv)
        np.testing.assert_array_equal(
            pair.t.ctx_ids_for(tv).numpy()[:n][live],
            np.asarray(pair.j.ctx_ids_for(jv))[:n][live])
        # a deleted auto-split audio's group stays until a build drops it
        assert tv.segments == jv.segments
    for tv, fv in zip(tviews, pair.full_rebuild()):
        _warm_port(pair.t, tv)
        got, want = tv.tensors(), fv.tensors()
        assert got.keys() == want.keys()
        live = torch.from_numpy(_live(tv))
        for name in want:
            if name == "ctx_dev":  # a dead row keeps its id, as in JAX
                n = tv.n_audios
                assert _same(got[name][:n][live], want[name][:n][live])
                assert _same(got[name][n:], want[name][n:])
            else:
                assert _same(got[name], want[name]), name
        live_groups = tuple(g for g in tv.segments
                            if g[0] not in tv.dead_rows)
        assert live_groups == fv.segments
        pairs = [(r, g[0]) for g in tv.segments for r in g[1:]]
        followers, heads = pair.t.segment_rows_for(tv)
        assert [tuple(p) for p in zip(followers.tolist(),
                                      heads.tolist())] == pairs
    return tviews


def _step(pair: Pair, mutate, routes: list) -> list:
    """Warm the views, mutate, update, and hold everything. ``routes`` per
    tier of the new views: "same" (the view object kept), "inc" (updated
    row by row) or "full"."""
    old_views, before = pair.warm()
    old_by_tier = {v.tier_frames: v for v in old_views}
    pair.full_builds.update(jax=0, port=0)
    mutate()
    pair.j.search_views()
    pair.forbid_full = "full" not in routes
    try:
        views = pair.t.search_views()
    finally:
        pair.forbid_full = False
    n_full = routes.count("full")
    assert pair.full_builds == {"jax": n_full, "port": n_full}
    assert len(views) == len(routes)
    for v, route in zip(views, routes):
        old = old_by_tier.get(v.tier_frames)
        if route == "same":
            assert v is old
            continue
        assert v is not old and (old is None or v.gen != old.gen)
        # an updated view carries every derived tensor the old one had (the
        # segment rows are rebuilt lazily after an append); a full build
        # carries none
        carried = set(_tensors(v)) - {"db", "mask"}
        if route == "inc":
            had = set(before[old_views.index(old)]) - {"db", "mask"}
            assert carried >= {n for n in had if not n.startswith("seg")}
        else:
            assert not carried, (v.tier_frames, carried)
    # the previous views' tensors are unchanged
    for v, saved in zip(old_views, before):
        now = _tensors(v)
        for name, x in saved.items():
            assert _same(now[name], x), (v.tier_frames, name)
    return _check_views(pair)


def test_append_within_a_bucket():
    pair = Pair(1)
    for n in (40, 90, 128, 7, 60):
        pair.add(n)
    _check_views(pair)
    _step(pair, lambda: pair.add(100), ["inc"])
    _step(pair, lambda: [pair.add(n, "b") for n in (5, 128, 64)], ["inc"])


def test_append_across_a_bucket():
    pair = Pair(2)
    for i in range(127):
        pair.add(20 + i % 100)
    _step(pair, lambda: pair.add(50), ["inc"])  # 128 rows: the same bucket
    _step(pair, lambda: pair.add(60), ["full"])  # 129 rows: a new bucket
    _step(pair, lambda: pair.add(70), ["inc"])


def test_delete_and_delete_an_appended_row():
    pair = Pair(3)
    for n in (40, 90, 128, 7, 60, 33):
        pair.add(n)
    _step(pair, lambda: pair.delete(pair.uuids[1]), ["inc"])
    _step(pair, lambda: pair.delete(pair.uuids[0], pair.uuids[4]), ["inc"])
    _step(pair, lambda: pair.add(80), ["inc"])
    # the row the last update appended, masked off
    _step(pair, lambda: pair.delete(pair.uuids[-1]), ["inc"])


def test_append_and_delete_between_builds():
    """A row appended and tombstoned between two builds arrives dead; a
    delete below the view's rows and an append in one update."""
    pair = Pair(4)
    for n in (40, 90, 128, 7):
        pair.add(n)

    def mutate():
        pair.add(50)
        gone = pair.add(70, "b")
        pair.add(30)
        pair.delete(gone, pair.uuids[2])

    _step(pair, mutate, ["inc"])
    _step(pair, lambda: pair.add(12), ["inc"])


def test_autosplit_append_and_delete(monkeypatch):
    monkeypatch.setattr(jfs, "MAX_TIER_FRAMES", 128)
    monkeypatch.setattr(tfs, "MAX_TIER_FRAMES", 128)
    pair = Pair(5)
    for n in (40, 300, 90):
        pair.add(n)
    _step(pair, lambda: pair.add(333), ["inc"])  # three segment rows
    (view,) = pair.t.search_views()
    assert [len(g) for g in view.segments] == [3, 3]
    _step(pair, lambda: pair.add(20), ["inc"])
    _step(pair, lambda: pair.delete(pair.uuids[1]), ["inc"])
    (view,) = pair.t.search_views()
    assert [len(g) for g in view.segments] == [3, 3]  # the dead one kept
    _step(pair, lambda: pair.add(30), ["inc"])
    (view,) = pair.t.search_views()
    assert [len(g) for g in view.segments] == [3]  # dropped by the append


def test_delete_context():
    pair = Pair(6)
    for i in range(10):
        pair.add(30 + 9 * i, "ab"[i % 3 == 0])
    old = pair.t._views
    _step(pair, lambda: pair.t.delete_context("b") and pair.j.delete_context(
        "b"), ["inc"])
    assert pair.t._views is not old
    (view,) = pair.t.search_views()
    assert view.dead_rows == frozenset({0, 3, 6, 9})


def test_compaction_rebuilds_in_full():
    pair = Pair(7)
    for i in range(140):
        pair.add(10 + i % 50)
    # 128 dead rows of 140: past the waste threshold, the delete compacts
    _step(pair, lambda: pair.delete(*pair.uuids[:128]), ["full"])
    (view,) = pair.t.search_views()
    assert view.n_audios == 12 and not view.dead_rows
    _step(pair, lambda: pair.delete(pair.uuids[130]), ["inc"])
    # the admin's compact() too
    _step(pair, lambda: (pair.t.compact(), pair.j.compact()), ["full"])


def test_two_tiers_one_mutated():
    pair = Pair(8)
    for n in (40, 200, 90, 250, 128):
        pair.add(n)
    _step(pair, lambda: pair.add(180), ["same", "inc"])
    _step(pair, lambda: pair.delete(pair.uuids[0]), ["inc", "same"])
    # a new tier appears: built in full beside the kept ones
    _step(pair, lambda: pair.add(700), ["same", "same", "full"])


def test_a_failed_update_raises_and_keeps_the_views(monkeypatch):
    """No fallback: an update that fails raises, and the store keeps its
    previous views (the next call tries the update again)."""
    pair = Pair(9)
    for n in (40, 90):
        pair.add(n)
    old, _ = pair.warm()
    pair.add(50)

    def broken(*a, **k):
        raise RuntimeError("index build failed")

    monkeypatch.setattr(tfs, "build_match_index", broken)
    pair.forbid_full = True
    with pytest.raises(RuntimeError, match="index build failed"):
        pair.t.search_views()
    assert pair.t._views is old
    monkeypatch.undo()
    (view,) = pair.t.search_views()
    assert view.n_audios == 3 and view.match_index is not None
    pair.forbid_full = False
    _check_views(pair)


def test_a_later_tiers_failed_update_keeps_the_earlier_tiers_deletes(
        monkeypatch):
    """Two tiers: the first has a delete, the second's update raises. The
    first tier's pending tombstone survives the failed call, so the retry
    masks its row off and the deleted track gets no vote."""
    pair = Pair(10)
    for n in (40, 90, 200, 250):
        pair.add(n)
    old, _ = pair.warm()
    t_big = old[1].tier_frames
    gone = pair.uuids[0]
    fp = torch.from_numpy(pair.t.get_fingerprint(gone)[:30] + 0.02)
    pair.delete(gone)
    pair.add(180)  # into the second tier
    real = tfs.build_match_index

    def broken(db):
        if db.shape[1] == t_big:
            raise RuntimeError("index build failed")
        return real(db)

    monkeypatch.setattr(tfs, "build_match_index", broken)
    pair.forbid_full = True
    with pytest.raises(RuntimeError, match="index build failed"):
        pair.t.search_views()
    assert pair.t._views == old
    monkeypatch.undo()
    views = pair.t.search_views()
    assert 0 in views[0].dead_rows and not views[0].mask[0].any()
    pair.forbid_full = False
    _check_views(pair)
    qq, act, use2 = tm.prepare_query(fp[None], None, -1, -1,
                                     trunc_coef1=False)
    view = views[0]
    inf = float("inf")
    votes = {
        "K3'": tml.lattice_votes(view.value_map, torch.trunc(qq[..., 0]),
                                 act, 0.5, -inf, inf),
        "K4": tk.match_votes_fused(view.db, qq, act, use2, 0.1, 2,
                                   index=view.match_index),
        "K5": tk.match_votes_fused_aligned(view.db, qq, act, use2, 0.1, 2,
                                           index=view.match_index),
    }
    for name, v in votes.items():
        assert int(v[0, 0]) == 0, name


# ---- engines ------------------------------------------------------------ #


def _speechlike(rng, seconds):
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f0 = rng.uniform(90.0, 240.0)
    sig = sum(
        rng.uniform(0.2, 1.0) / h
        * (1.0 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.5, 3) * t))
        * np.sin(2 * np.pi * f0 * h * t)
        for h in range(1, 9)
    )
    sig = sig + 0.02 * rng.standard_normal(n)
    level = np.repeat(rng.uniform(0.5, 1.0, n // 800 + 1), 800)[:n]
    return (0.3 * level * sig / np.abs(sig).max()).astype(np.float32)


def _cfg(root):
    return TiresiasConfig(
        contexts=(ContextConfig("media", str(root / "media")),
                  ContextConfig("promo", str(root / "promo"))),
        data_dir=str(root / "data"),
    )


@pytest.fixture(scope="module")
def synced(tmp_path_factory):
    """24 + 8 speech-like tracks of 2-3.5 s in two contexts, "promo"
    repeating one media track (one 128-row view), synced by the JAX
    engine (each test restores its own pair of engines from it), and three
    tracks to append."""
    root = tmp_path_factory.mktemp("views")
    rng = np.random.default_rng(43)
    gains = iter(10.0 ** (rng.permutation(np.arange(32) * -2.0) / 20.0))
    for ctx, n in (("media", 24), ("promo", 8)):
        os.makedirs(root / ctx)
        for i in range(n):
            pcm = _speechlike(rng, rng.uniform(2.0, 3.5)) * next(gains)
            write_wav(str(root / ctx / f"{ctx}{i:02d}.wav"), pcm, SR)
    shutil.copy(root / "media" / "media03.wav", root / "promo" / "dup.wav")
    jeng = JaxTiresias(_cfg(root))
    assert jeng.sync().created == 33
    jeng.close()
    # tracks to append: a chirp and a tone, which no corpus track resembles
    # (a strict excerpt of them must win), and one more speech-like track
    extra = [0.5 * synth_chirp(300, 3000, 3.0, SR),
             0.3 * synth_tone(3100, 3.0, SR), _speechlike(rng, 3.0)]
    return root, extra


@pytest.fixture
def jax_query_fp(monkeypatch):
    """The port fingerprints its queries with the JAX function, so both
    engines vote bitwise-equal fingerprints (as in test_torch_engine.py)."""

    def fp(padded, samplerate, dsp, law=None, n_valid=None, device="cpu"):
        out = jax_fp(padded, samplerate, dsp, law=law, n_valid=n_valid)
        return torch.from_numpy(np.array(out)).to(device)

    monkeypatch.setattr(tengine, "fingerprint_padded_batch", fp)


@pytest.fixture
def small_budgets(monkeypatch):
    """Candidate budgets of 16 so a 128-row view crosses both size gates."""
    monkeypatch.setattr(tml, "LATTICE_PREFILTER_K", 16)
    monkeypatch.setattr(tk, "PREFILTER_K", 16)


ENGINE_MODES = {
    "dialplan": ({"coefs": 1}, 0.5),
    "bag": ({"coefs": 2, "trunc_coef1": False}, 0.1),
    "aligned": ({"coefs": 2, "trunc_coef1": False, "aligned": True}, 0.1),
    "margin": ({"coefs": 2, "trunc_coef1": False, "aligned": True,
                "min_margin": 0.2}, 0.1),
}


def _excerpt(pcm, rng):
    pcm = np.asarray(pcm)
    s = 256 * int(rng.integers(0, (len(pcm) - 12800) // 256))
    return pcm[s : s + 12800]


@pytest.mark.parametrize("name", sorted(ENGINE_MODES))
def test_engines_equal_after_appends_and_deletes(synced, jax_query_fp,
                                                 small_budgets, monkeypatch,
                                                 name):
    """TIR* (every mode, three context filters) and top-k listings of both
    engines after each mutation, exactly; the port updates its view row by
    row each time, its prefilter runs, an appended track is FOUND and a
    deleted one never is."""
    root, extra = synced
    mode, tol = ENGINE_MODES[name]
    jeng = JaxTiresias(_cfg(root), exclusive=False)
    teng = Tiresias(_cfg(root), exclusive=False, device="cpu")
    rng = np.random.default_rng(5)
    tracks = {}
    for ctx in ("media", "promo"):
        for fname in sorted(os.listdir(root / ctx))[::4]:
            tracks[fname] = read_wav_i16(str(root / ctx / fname))[0]
    seen = []
    note = teng._pf_note
    monkeypatch.setattr(teng, "_pf_note",
                        lambda v, m, c: seen.append(c) or note(v, m, c))
    builds = []
    real_build = teng.store._build_view
    monkeypatch.setattr(teng.store, "_build_view",
                        lambda *a: builds.append(1) or real_build(*a))

    def check(gone=()):
        queries = [_excerpt(p, rng) for p in tracks.values()]
        queries.append(np.zeros(12800, np.int16))
        for ctx, filt in ((None, False), ("media", True), ("promo", True)):
            kw = dict(tolerance=tol, filter_context=filt, **mode)
            want = jeng.search_pcm_batch(ctx, queries, SR, **kw)
            teng._pf_misses.clear()  # every search tries the prefilter
            got = teng.search_pcm_batch(ctx, queries, SR, **kw)
            assert [r.to_channel_vars() for r in got] == [
                r.to_channel_vars() for r in want], (ctx, filt)
            assert not any(r.name in gone for r in got)
        if name != "margin":
            kw = dict(k=3, tolerance=tol, **mode)
            for q in queries[-3:]:
                teng._pf_misses.clear()
                got = teng.search_pcm_topk(None, q, SR, **kw)
                want = jeng.search_pcm_topk(None, q, SR, **kw)
                assert [(r.name, r.context, r.match_count) for r in got] == [
                    (r.name, r.context, r.match_count) for r in want]
        return got

    check()
    assert len(builds) == 1
    # appends: two tracks, one per context
    for i, ctx in ((0, "media"), (1, "promo")):
        e = jeng.add_audio_pcm(ctx, f"new{i}.wav", extra[i], SR)
        teng.store.add_audio(e.name, ctx, jeng.store.get_fingerprint(e.uuid),
                             e.hash, uuid=e.uuid)
        tracks[e.name] = extra[i]
    check()
    if name != "dialplan":  # strict excerpts of appended tracks win (the
        # tone's bag votes tie with the chirp's, inserted first)
        got = teng.search_pcm_batch(
            None, [_excerpt(extra[i], rng) for i in (0, 1)], SR,
            tolerance=tol, **mode)
        assert got[0].name == "new0.wav"
        assert got[1].name in ("new0.wav", "new1.wav")
    # deletes: an original track and an appended one
    gone = ("media04.wav", "new1.wav")
    for fname in gone:
        (e,) = [e for e in teng.store.entries if e.name == fname]
        assert jeng.store.delete_audio(e.uuid)
        assert teng.store.delete_audio(e.uuid)
    check(gone)
    # an append and a delete between two searches
    e = jeng.add_audio_pcm("media", "new2.wav", extra[2], SR)
    teng.store.add_audio(e.name, "media", jeng.store.get_fingerprint(e.uuid),
                         e.hash, uuid=e.uuid)
    assert jeng.store.delete_audio(e.uuid) and teng.store.delete_audio(e.uuid)
    check(gone + ("new2.wav",))
    assert len(builds) == 1  # every update after the first was row by row
    assert seen  # the prefilter answered or fell back on updated views
    jeng.close()
    teng.close()


def test_a_delete_rearms_the_gate(tmp_path, small_budgets, monkeypatch):
    """24 copies of one tone tie beyond k=16 rows at tol 1.0: 8 misses shut
    the dialplan prefilter for the view; a delete (the view masked row by
    row: a new view, a new gen) reopens it, and a search with no mutation
    keeps the same view and its shut gate."""
    eng = Tiresias(TiresiasConfig(data_dir=str(tmp_path)), restore=False,
                   device="cpu")
    eng.create_context("c")
    tone = synth_tone(440, 1.0, SR)
    uuids = [eng.add_audio_pcm("c", f"dup{i}", tone * (1.0 + 1e-5 * i),
                               SR).uuid for i in range(24)]
    for _ in range(9):
        assert eng.search_pcm("c", tone, SR, tolerance=1.0).name == "dup0"
    (view,) = eng.store.search_views()
    assert not eng._lattice_pf_ok(view, 1.0)
    monkeypatch.setattr(eng.store, "_build_view", lambda *a: pytest.fail(
        "a delete rebuilt the view in full"))
    assert eng.delete_audio(uuids[0])
    (view2,) = eng.store.search_views()
    assert view2.gen != view.gen and view2.value_map is not None
    assert eng._lattice_pf_ok(view2, 1.0)
    assert eng.search_pcm("c", tone, SR, tolerance=1.0).name == "dup1"
    assert eng.store.search_views()[0] is view2
    eng.close()


def test_warm_maps_on_an_updated_view_build_nothing(tmp_path, monkeypatch):
    """warm_search_maps on a view updated row by row finds every map it
    builds already there."""
    eng = Tiresias(TiresiasConfig(data_dir=str(tmp_path)), restore=False,
                   device="cpu")
    eng.create_context("c")
    rng = np.random.default_rng(2)
    for i in range(3):
        eng.add_audio_pcm("c", f"t{i}", _speechlike(rng, 2.0), SR)
    eng.warm_search_maps()
    (old,) = eng.store.search_views()
    eng.add_audio_pcm("c", "t3", _speechlike(rng, 2.0), SR)
    (view,) = eng.store.search_views()
    assert view is not old and view.value_map is not None
    for fn in ("build_value_map", "quantize_value_map", "build_bound_maps",
               "build_match_index"):
        monkeypatch.setattr(tfs, fn, lambda *a, _fn=fn: pytest.fail(_fn))
    eng.warm_search_maps()
    assert eng.store.search_views()[0] is view
    eng.close()
