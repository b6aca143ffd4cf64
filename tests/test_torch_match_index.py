"""The sorted per-view index of K4/K5 (``ops/match_index.py``) on the CPU.

The index is held to numpy (sorted keys, live runs, what is left out), its
binary search to the dense float32 predicate ``|fl(d0 − q0)| <= tol``
exactly (edge values included), and the kernels' algorithm in plain torch
(:func:`votes_by_index_plain`) to the twin ``match.match_votes``, to
``match_jax.match_votes`` and to the Pallas kernels in interpret mode. The
CUDA kernels are held to the twin on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from tiresias_tpu.ops import match_jax
from tiresias_tpu.ops import match_pallas as mp
from tiresias_tpu_torch.ops import match as tm
from tiresias_tpu_torch.ops import match_index as mi
from tiresias_tpu_torch.ops.mfcc import PAD_VALUE
from tiresias_tpu_torch.store.fingerprint_store import FingerprintStore

torch.set_num_threads(2)


def _db(seed, a=24, t=256, c=4):
    """Ragged store-layout rows: PAD_VALUE past each end, row 5 empty, row
    6 tombstoned (all PAD), row 7 with every frame at one d0, NaN, ±inf and
    ±0.0 frames in row 8."""
    rng = np.random.default_rng(seed)
    db = rng.uniform(-30.0, 20.0, (a, t, c)).astype(np.float32)
    n = rng.integers(t // 2, t + 1, a)
    n[5] = 0
    db[np.arange(t)[None, :] >= n[:, None]] = PAD_VALUE
    db[6] = PAD_VALUE
    db[7, : n[7], 0] = 1.25
    db[8, 0:40:5, 0] = np.nan
    db[8, 1:40:5, 0] = np.inf
    db[8, 2:40:5, 0] = -np.inf
    db[8, 3:40:5, 0] = 0.0
    db[8, 4:40:5, 0] = -0.0
    return db


def _dense_band(d0_sorted, n_live, q, tol):
    """The dense predicate over each chunk's live run, in numpy float32."""
    with np.errstate(invalid="ignore"):
        x = np.abs(d0_sorted[None, None] - q[:, :, None, None, None])
        ok = x <= np.float32(tol)
    live = np.arange(d0_sorted.shape[-1]) < n_live[..., None]
    return ok & live[None, None]


@pytest.mark.parametrize("t,t_chunk", [(256, 2048), (256, 64), (200, 64)])
def test_index_sorts_live_frames_per_chunk(t, t_chunk):
    db = _db(1, t=t)
    idx = mi.build_match_index(torch.from_numpy(db), t_chunk)
    chunk = min(t_chunk, t)
    nc = -(-t // chunk)
    assert idx.chunk == chunk and idx.n_chunks == nc and idx.t_len == t
    assert idx.entries.shape == (db.shape[0], nc, chunk, 2)
    ent, pos = idx.entries.numpy(), idx.pos.numpy().astype(np.int64)
    n_live = idx.n_live.numpy()
    for a in range(db.shape[0]):
        for c in range(nc):
            frames = np.arange(c * chunk, min((c + 1) * chunk, t))
            d0 = db[a, frames, 0]
            live = frames[(d0 != PAD_VALUE) & ~np.isnan(d0)]
            n = n_live[a, c]
            assert n == len(live)
            keys = ent[a, c, :n, 0]
            assert (keys[1:] >= keys[:-1]).all()  # -inf ... +inf, no NaN
            t_abs = c * chunk + pos[a, c, :n]
            assert sorted(t_abs) == sorted(live)  # a permutation of them
            np.testing.assert_array_equal(keys, db[a, t_abs, 0])
            np.testing.assert_array_equal(ent[a, c, :n, 1], db[a, t_abs, 1])
            # stable: equal keys (bitwise: -0.0 sorts before +0.0) keep time
            # order
            bits = keys.view(np.int32)
            same = bits[1:] == bits[:-1]
            assert (np.diff(t_abs)[same] > 0).all()
            assert np.isnan(ent[a, c, n:]).all()
    assert (n_live[[5, 6]] == 0).all()  # empty and tombstoned rows
    assert n_live.sum() == ((db[..., 0] != PAD_VALUE)
                            & ~np.isnan(db[..., 0])).sum()
    keys8 = ent[8, 0, : n_live[8, 0], 0]
    assert np.isposinf(keys8).sum() == 8 and np.isneginf(keys8).sum() == 8
    assert not np.isnan(keys8).any()  # NaN frames are left out


def test_sort_keys_order_like_floats():
    v = np.array([-np.inf, -3e38, -1.0, -1e-45, -0.0, 0.0, 1e-45, 2.0, 3e38,
                  np.inf], np.float32)
    k = mi.sort_keys(torch.from_numpy(v)).numpy()
    assert (np.diff(k) > 0).all()


@pytest.mark.parametrize("tol", [0.0, 0.05, 1.0, 2e5, np.inf])
def test_band_bounds_equal_dense_predicate(tol):
    db = _db(2)
    rng = np.random.default_rng(3)
    q0 = rng.uniform(-31.0, 21.0, (3, 30)).astype(np.float32)
    q0[0, :8] = [np.inf, -np.inf, 0.0, -0.0, 1.25, np.nan, 1e-8, -3e38]
    q0[1, :6] = db[9, :6, 0]  # stored values themselves
    idx = mi.build_match_index(torch.from_numpy(db), 64)
    lo, hi = mi.band_bounds_plain(idx, torch.from_numpy(q0), tol)
    u = np.arange(idx.chunk)
    got = (u >= lo.numpy()[..., None]) & (u < hi.numpy()[..., None])
    want = _dense_band(idx.entries[..., 0].numpy(), idx.n_live.numpy(), q0,
                       tol)
    np.testing.assert_array_equal(got, want)
    if 0 < tol < 1e5:
        assert want.any() and not want.all()


def _edge_case(seed, n_q=400, tol=np.float32(0.1)):
    """Query values and stored values next to fl(q0 ± tol): found by a
    seeded search for d0 where ``d0 <= fl(q0 + tol)`` (or ``>= fl(q0 −
    tol)``) disagrees with ``|fl(d0 − q0)| <= tol``."""
    rng = np.random.default_rng(seed)
    qs = rng.uniform(-30.0, 20.0, n_q).astype(np.float32)
    rows, wrong = [], 0
    for q in qs:
        vals = []
        for edge, inside in ((np.float32(q + tol), lambda d, e: d <= e),
                             (np.float32(q - tol), lambda d, e: d >= e)):
            d = edge
            for _ in range(3):
                d = np.nextafter(d, np.float32(-np.inf))
            for _ in range(7):
                vals.append(d)
                wrong += inside(d, edge) != (np.abs(np.float32(d - q)) <= tol)
                d = np.nextafter(d, np.float32(np.inf))
        rows.append(vals)
    return qs, np.array(rows, np.float32), wrong


def test_band_bounds_exact_at_the_edges_where_searchsorted_is_not():
    tol = np.float32(0.1)
    qs, vals, wrong = _edge_case(4, tol=tol)
    assert wrong > 0  # fl(q0 ± tol) as the band's ends is wrong somewhere
    a, t = 50, vals.shape[1]
    db = np.full((a, t, 2), PAD_VALUE, np.float32)
    db[:, :, 0] = vals[:a]
    db[:, :, 1] = 0.0
    q0 = qs[:a].reshape(a, 1)
    idx = mi.build_match_index(torch.from_numpy(db))
    lo, hi = mi.band_bounds_plain(idx, torch.from_numpy(q0), float(tol))
    keys = idx.entries[..., 0].numpy()
    u = np.arange(idx.chunk)
    got = (u >= lo.numpy()[..., None]) & (u < hi.numpy()[..., None])
    want = _dense_band(keys, idx.n_live.numpy(), q0, tol)
    np.testing.assert_array_equal(got, want)
    # the same rows searched for fl(q0 - tol) and fl(q0 + tol)
    naive = np.zeros_like(want)
    for b in range(a):
        for r in range(a):
            k = keys[r, 0]
            lo_n = np.searchsorted(k, np.float32(q0[b, 0] - tol), "left")
            hi_n = np.searchsorted(k, np.float32(q0[b, 0] + tol), "right")
            naive[b, 0, r, 0, lo_n:hi_n] = True
    assert (naive != want).any()


BANDS = [(-1, -1), (1, 300)]


def _case(seed, t, f, c=4, a=40):
    db = _db(seed, a=a, t=t, c=c)
    rng = np.random.default_rng(seed + 1)
    q = np.stack([np.resize(db[9, 2:50], (f, c)),
                  np.resize(db[a - 3, :50], (f, c)),
                  rng.uniform(-30.0, 20.0, (f, c))]).astype(np.float32)
    q += rng.normal(0.0, 0.03, q.shape).astype(np.float32)
    q[0, 3, 0] = 1.25  # row 7's single value
    return db, q, np.array([f, f - 3, f - 9], np.int32)


@pytest.mark.parametrize("tol", [0.05, 1.0, 2e5])
@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("coefs", [1, 2, 4])
@pytest.mark.parametrize("t,t_chunk,f", [(128, 2048, 24), (256, 64, 24),
                                         (200, 64, 300)])
def test_votes_by_index_equal_twin_and_jax(t, t_chunk, f, coefs, aligned,
                                           tol):
    """One-chunk and multi-chunk (4 chunks, the last one ragged) tiers,
    24- and 300-frame queries, the band filter off and on."""
    db, q, n_frames = _case(coefs * 7 + t + f, t, f)
    mask = (db[..., 0] != PAD_VALUE) & ~np.isnan(db[..., 0])
    dbt = torch.from_numpy(db)
    idx = mi.build_match_index(dbt, t_chunk)
    for band in BANDS:
        jq, ja, ju = match_jax.prepare_query(q, n_frames, *band,
                                             trunc_coef1=False)
        tq, ta, tu = tm.prepare_query(torch.from_numpy(q), n_frames, *band,
                                      trunc_coef1=False)
        got = mi.votes_by_index_plain(idx, dbt, tq, ta, tu, tol, coefs,
                                      aligned)
        twin = tm.match_votes(dbt, torch.from_numpy(mask), tq, ta, tu, tol,
                              coefs=coefs, aligned=aligned)
        np.testing.assert_array_equal(got.numpy(), twin.numpy())
        want = np.asarray(match_jax.match_votes(
            db, mask, jq, ja, ju, tol, coefs=coefs, aligned=aligned))
        np.testing.assert_array_equal(got.numpy(), want)
        if tol < 1e5 and f == 24 and band == (1, 300):
            kernel = (mp.match_votes_pallas_aligned if aligned
                      else mp.match_votes_pallas)
            pal = np.asarray(kernel(np.where(np.isnan(db), PAD_VALUE, db), jq,
                                    ja, ju, tol, coefs=coefs,
                                    interpret=True))
            np.testing.assert_array_equal(got.numpy(), pal)
        assert (got[:, [5, 6]] == 0).all()
        if tol == 1.0 and band == (-1, -1):
            assert got[0, 9] > 0 and got[1, -3] > 0


def test_match_index_cached_per_view_and_rebuilt_on_mutation():
    st = FingerprintStore(n_coefs=2, device="cpu")
    st.create_context("media")
    rng = np.random.default_rng(6)
    entries = [st.add_audio(f"a{i}.wav", "media",
                            rng.uniform(-30, 20, (100 + 10 * i, 2)), f"h{i}")
               for i in range(3)]
    (view,) = st.search_views()
    idx = st.match_index_for(view)
    assert st.match_index_for(view) is idx
    assert idx.n_live[:3, 0].tolist() == [100, 110, 120]
    assert (idx.n_live[3:] == 0).all()  # padding rows
    st.add_audio("a3.wav", "media", rng.uniform(-30, 20, (90, 2)), "h3")
    (view2,) = st.search_views()
    idx2 = st.match_index_for(view2)
    assert idx2 is not idx and idx2.n_live[3, 0] == 90
    st.delete_audio(entries[1].uuid)
    (view3,) = st.search_views()
    idx3 = st.match_index_for(view3)
    assert idx3 is not idx2
    assert idx3.n_live[:4, 0].tolist() == [100, 0, 120, 90]


def _np_keys(x: np.ndarray) -> np.ndarray:
    """``sort_keys`` in numpy: int32 keys ordered as float32 ``<``."""
    bits = x.astype(np.float32).view(np.int32)
    return np.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


@pytest.mark.parametrize("t,t_chunk", [(256, 2048), (256, 64), (200, 64)])
def test_kept_coef1_order_is_a_stable_argsort_of_live_d1(t, t_chunk):
    """Each chunk's kept coefficient-1 order is numpy's stable argsort of
    the live frames' d1 (time order; d0 neither PAD nor NaN, d1 not NaN),
    by sort_keys: ±inf d1, ±0.0 and repeated values (ties) included; NaN
    past the run; and the same values as the d0 order's entries sorted by
    d1 (the order the bit-sliced kernel sorted in shared memory before the
    index kept one), time for time up to the order of ties."""
    db = _db(3, t=t)
    db[9, 0::3, 1] = np.nan
    db[10, 0::4, 1] = np.inf
    db[10, 1::4, 1] = -np.inf
    db[11, :, 1] = np.round(db[11, :, 1])  # many ties
    db[12, 0::2, 1] = 0.0
    db[12, 1::2, 1] = -0.0
    idx = mi.build_match_index(torch.from_numpy(db), t_chunk)
    chunk, nc = idx.chunk, idx.n_chunks
    assert idx.d1.shape == idx.pos1.shape == (db.shape[0], nc, chunk)
    assert idx.d1.dtype == torch.float32 and idx.pos1.dtype == torch.int16
    assert idx.n1.shape == (db.shape[0], nc) and idx.n1.dtype == torch.int32
    d1s, pos1, n1 = mi.coef1_order(idx)
    for a in range(db.shape[0]):
        for c in range(nc):
            seg = db[a, c * chunk : (c + 1) * chunk]
            ok = ((seg[:, 0] != PAD_VALUE) & ~np.isnan(seg[:, 0])
                  & ~np.isnan(seg[:, 1]))
            times = np.nonzero(ok)[0]
            order = times[np.argsort(_np_keys(seg[times, 1]), kind="stable")]
            m = len(order)
            assert int(n1[a, c]) == m
            np.testing.assert_array_equal(pos1[a, c, :m].numpy(), order)
            np.testing.assert_array_equal(
                idx.d1[a, c, :m].view(torch.int32).numpy(),
                seg[order, 1].view(np.int32))
            assert np.isnan(d1s[a, c, m:].numpy()).all()
            # the d0 order's live entries sorted by d1, stable in d0 rank
            n = int(idx.n_live[a, c])
            e1 = idx.entries[a, c, :n, 1].numpy()
            p0 = idx.pos[a, c, :n].numpy()
            keep = ~np.isnan(e1)
            r = np.argsort(_np_keys(e1[keep]), kind="stable")
            np.testing.assert_array_equal(e1[keep][r].view(np.int32),
                                          seg[order, 1].view(np.int32))
            key = lambda k, tt: np.lexsort((tt, k))  # noqa: E731
            kk = _np_keys(e1[keep][r])
            tt = p0[keep][r]
            np.testing.assert_array_equal(tt[key(kk, tt)], order)


def test_one_coefficient_store_keeps_no_coef1_order():
    """A one-coefficient store's index keeps no coefficient-1 order (the
    kernels never read one): no fields, no row tensors, and coef1_order
    raises."""
    db = _db(4, c=1)
    idx = mi.build_match_index(torch.from_numpy(db), 64)
    assert idx.d1 is None and idx.pos1 is None and idx.n1 is None
    assert set(idx.row_tensors()) == {"entries", "pos", "n_live"}
    with pytest.raises(ValueError, match="one-coefficient"):
        mi.coef1_order(idx)
    two = mi.build_match_index(torch.from_numpy(_db(4, c=2)), 64)
    assert set(two.row_tensors()) == {"entries", "pos", "n_live", "d1",
                                      "pos1", "n1"}


def test_two_coefficient_search_needs_the_kept_order():
    """The bit-sliced kernel's operands: no order for a one-coefficient
    search; from two coefficients on the kept order's tensors, and an index
    without them (not one that build_match_index makes) is refused before
    any launch."""
    import dataclasses

    from tiresias_tpu_torch.ops import match_kernels as tk

    two = mi.build_match_index(torch.from_numpy(_db(4, c=2)), 64)
    assert tk._kept(two, 1) == tk._kept(two, 2) == (
        two.d1.data_ptr(), two.pos1.data_ptr(), two.n1.data_ptr())
    bare = dataclasses.replace(two, d1=None, pos1=None, n1=None)
    assert tk._kept(bare, 1) == (None, None, None)
    with pytest.raises(ValueError, match="kept coefficient-1 order"):
        tk._kept(bare, 2)
