"""The port's certified prefilters against the JAX package (PARITY.md D17,
D19, D20), on the CPU with the kernels' plain twins.

Byte-equal: the quantized dialplan map and the strict/aligned bound maps
(dead rows, PAD, +-inf and NaN values). Equal: the bound specs, the
saturation gate, and the int32 bound votes (which must also dominate the
exact votes). The prefiltered votes and certificates equal JAX's where the
k-th bound has no tie (so both select the same rows), a certified result's
top-1 is the full scan's, near-duplicates de-certify, and the context
filter and top-k listings hold. The JAX aligned prefilter runs its Pallas
kernels in interpret mode, as ``tests/test_match_pallas.py`` runs them.

Engine level: a JAX-synced two-context store restored by the port, whose
candidate budgets are cut so its 128-row views cross the size gates; every
search mode's TIR* and ranked listing equal the JAX engine's, the port's
prefilter must have run and certified, and the adaptive gate, the
saturation gate, the auto-split bail-out and the fallback counter behave as
the JAX engine's do.
"""

import os
import shutil
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiresias_tpu.api import Tiresias as JaxTiresias
from tiresias_tpu.config import ContextConfig, TiresiasConfig
from tiresias_tpu.ops import match_jax
from tiresias_tpu.ops import match_lattice as jml
from tiresias_tpu.ops.match_pallas import (
    aligned_prefiltered_votes as jax_aligned_prefiltered,
)
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
from tiresias_tpu_torch.ops.mfcc import PAD_VALUE
from tiresias_tpu_torch.store import fingerprint_store as tfs
from tiresias_tpu_torch.utils.tracing import metrics

torch.set_num_threads(2)

SR = 8000


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---- maps -------------------------------------------------------------- #


def _store_layout(rng, a=200, t=96, c=3, dead=(5, 77), nonfinite=True):
    """Speech-like rows in the store layout (PAD_VALUE past each row's end,
    dead rows all PAD and masked off), a few +-inf and NaN values among the
    live frames, and frames outside every bound spec's clip range."""
    db = rng.normal(-20.0, 12.0, (a, t, c)).astype(np.float32)
    db[..., 1:] = rng.normal(0.0, 8.0, (a, t, c - 1))
    db[0, :4, 0] = [-417.0, 100.0, -130.0, 45.0]
    db[1, :3, 1] = [-60.0, 50.0, -40.0]
    n = rng.integers(1, t + 1, a)
    n[list(dead)] = 0
    mask = np.arange(t)[None, :] < n[:, None]
    db[~mask] = PAD_VALUE
    if nonfinite:
        db[3, 0, :] = np.inf
        db[4, 1, :] = -np.inf
        db[6, 0, 1] = np.nan
        db[8, 0, 0] = np.nan
    return db, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_value_map_byte_equal_jax(seed):
    rng = np.random.default_rng(seed)
    db, mask = _store_layout(rng, nonfinite=False)
    vm = np.array(jml.build_value_map(db[..., 0], mask))
    vm[9, :6] = [np.nan, np.inf, -0.0, 3.984375, 3.99, 1e30]
    want = np.asarray(jml.quantize_value_map(jnp.asarray(vm)))
    got = tml.quantize_value_map(_t(vm))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[5] == jml.BOUND_FAR).all()  # a dead row: the sentinel
    assert (want[0] < jml.BOUND_FAR).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_value_map_nan_frame_equals_jax(seed):
    """A NaN among a row's live frames makes the JAX package's distance map
    NaN along the whole row (never a hit; quantized 0). The port's build
    crashed there (a NaN bucket cast to an int64 index) before the fix."""
    rng = np.random.default_rng(seed)
    db, mask = _store_layout(rng, nonfinite=False)
    rows = np.nonzero(mask[:, 4])[0][[1, 7]]
    db[rows, 4, 0] = np.nan
    want = np.asarray(jml.build_value_map(db[..., 0], mask))
    got = tml.build_value_map(_t(db[..., 0]), _t(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(want[rows]).all() and not np.isnan(want[0]).any()
    np.testing.assert_array_equal(
        tml.quantize_value_map(got).numpy(),
        np.asarray(jml.quantize_value_map(jnp.asarray(want))))


def test_store_value_maps_with_a_nan_frame_equal_jax(tmp_path):
    """The same through both stores' views, with the uint8 companion."""
    from tiresias_tpu.store import FingerprintStore as JaxStore

    rng = np.random.default_rng(3)
    jstore, tstore = JaxStore(n_coefs=2), tfs.FingerprintStore(2, None, "cpu")
    for st in (jstore, tstore):
        st.create_context("c", str(tmp_path))
    for i in range(5):
        fp = rng.normal(-20, 6, (60 + 10 * i, 2)).astype(np.float32)
        if i == 2:
            fp[7, 0] = np.nan
        for st in (jstore, tstore):
            st.add_audio(f"a{i}", "c", fp, f"h{i}", uuid=f"u{i}")
    (jv,), (tv,) = jstore.search_views(), tstore.search_views()
    np.testing.assert_array_equal(tstore.value_map_for(tv).numpy(),
                                  np.asarray(jstore.value_map_for(jv)))
    np.testing.assert_array_equal(tstore.value_map_q_for(tv).numpy(),
                                  np.asarray(jstore.value_map_q_for(jv)))


@pytest.mark.parametrize("coefs", [1, 2, 3])
@pytest.mark.parametrize("chunk", [None, 64])
def test_build_bound_maps_byte_equal_jax(coefs, chunk, monkeypatch):
    """Dead rows, PAD, +-inf and NaN values; row blocks of 64 (and one)."""
    if chunk is not None:
        monkeypatch.setattr(tml, "BUILD_CHUNK", chunk)
    rng = np.random.default_rng(10 + coefs)
    db, mask = _store_layout(rng)
    jspecs, jmaps = jml.build_bound_maps(jnp.asarray(db), jnp.asarray(mask),
                                         coefs)
    specs, maps = tml.build_bound_maps(_t(db), _t(mask), coefs)
    assert specs == jspecs
    for got, want in zip(maps, jmaps):
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert all((np.asarray(m)[[5, 77]] == jml.BOUND_FAR).all() for m in jmaps)


@pytest.mark.parametrize("coefs", [1, 2, 3, 8])
def test_bound_specs_equal_jax(coefs):
    assert tml.bound_coef_indices(coefs) == jml.bound_coef_indices(coefs)
    assert tml.bound_specs(coefs) == jml.bound_specs(coefs)
    assert all(sp[5] == 768 for sp in tml.bound_specs(coefs))
    assert (tml.BOUND_Q, tml.BOUND_FAR) == (jml.BOUND_Q, jml.BOUND_FAR)
    assert tml.LATTICE_PREFILTER_K == jml.LATTICE_PREFILTER_K
    from tiresias_tpu.ops.match_pallas import PREFILTER_K

    assert tk.PREFILTER_K == PREFILTER_K


SAT_TOLS = [-1.0, 0.0, 0.001, 0.1, 0.373, 0.3735, 0.374, 0.5, 0.746, 0.7461,
            0.75, 1.0, 3.98, 3.984, 3.984375, 3.99, 4.0]


@pytest.mark.parametrize("which", [None, 1, 2, 3, 8, "specs2"])
def test_bound_tol_ok_equal_jax_across_saturation(which):
    arg = jml.bound_specs(2) if which == "specs2" else which
    for tol in SAT_TOLS:
        assert tml.bound_tol_ok(arg, tol) == jml.bound_tol_ok(arg, tol), tol
    assert tml.bound_tol_ok(arg, 0.001) and not tml.bound_tol_ok(arg, 4.0)


def _strict_case(rng, a=160, t=96, f=40, b=4, c=3, near=(17, 90)):
    db, mask = _store_layout(rng, a=a, t=t, c=c, nonfinite=False)
    for r in near:  # rows the queries copy: every frame live
        db[r] = rng.normal(-20.0, 12.0, (t, c))
        mask[r] = True
    # coefficient 0 mostly above 0 dB, so the band (1, 1000) Hz, [0, 30] dB,
    # keeps most frames active and drops the q1 test of about half
    db[..., 0] = np.where(mask, db[..., 0] + 25.0, PAD_VALUE)
    q = np.stack(
        [db[r, 4 : 4 + f] + rng.normal(0, 0.02, (f, c)) for r in near]
        + [rng.normal(-15, 10, (f, c)) for _ in range(b - len(near))]
    ).astype(np.float32)
    n_frames = np.array([f - 3 * (i % 2) for i in range(b)])
    return db, mask, q, n_frames


@pytest.mark.parametrize("coefs", [2, 3])
@pytest.mark.parametrize("tol", [0.01, 0.1, 0.5])
@pytest.mark.parametrize("band", [(-1, -1), (1, 1000)])
def test_bound_votes_equal_jax_and_dominate_exact(coefs, tol, band):
    rng = np.random.default_rng(int(tol * 100) + coefs)
    db, mask, q, n_frames = _strict_case(rng)
    jspecs, jmaps = jml.build_bound_maps(jnp.asarray(db), jnp.asarray(mask),
                                         coefs)
    jq, ja, ju = match_jax.prepare_query(q, n_frames, *band,
                                         trunc_coef1=False)
    want = np.asarray(jml.bound_votes(jspecs, jmaps, jq, ja, ju, tol))
    specs, maps = tml.build_bound_maps(_t(db), _t(mask), coefs)
    tq, ta, tu = tm.prepare_query(_t(q), n_frames, *band, trunc_coef1=False)
    got = tml.bound_votes(specs, maps, tq, ta, tu, tol)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    exact = tm.match_votes(_t(db), _t(mask), tq, ta, tu, tol, coefs=coefs)
    assert (got >= exact).all()
    if band != (-1, -1):
        assert (~tu & ta).any()  # coefficient-1 bypass credit is exercised


# ---- the dialplan prefilter -------------------------------------------- #


def _clustered(seed=0, n_audios=256, t=64):
    """Per-audio clustered max1 values (the JAX package's own prefilter
    fixture): bounds are selective, so small-k certificates hold."""
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-25, 20, size=(n_audios, 1)).astype(np.float32)
    db0 = (mu + rng.normal(0, 1.5, (n_audios, t))).astype(np.float32)
    n_frames = rng.integers(t // 2, t + 1, size=n_audios)
    mask = np.arange(t)[None, :] < n_frames[:, None]
    return np.where(mask, db0, PAD_VALUE).astype(np.float32), mask


def _lattice_both(db0, mask, q, active, tol, k, band=(-np.inf, np.inf),
                  top=1, ctx=None, ctx_id=None):
    vm = jml.build_value_map(jnp.asarray(db0), jnp.asarray(mask))
    vmq = jml.quantize_value_map(vm)
    jv, jc = jml.lattice_prefiltered_votes(
        vm, vmq, jnp.asarray(q), jnp.asarray(active), tol, band[0], band[1],
        k=k, top=top, ctx_ids=None if ctx is None else jnp.asarray(ctx),
        ctx_id=ctx_id,
    )
    tvm = tml.build_value_map(_t(db0), _t(mask))
    tv, tc = tml.lattice_prefiltered_votes(
        tvm, tml.quantize_value_map(tvm), _t(q), _t(active), tol, band[0],
        band[1], k=k, top=top, ctx_ids=None if ctx is None else _t(ctx),
        ctx_id=ctx_id,
    )
    bound = np.asarray(jml.lattice_votes(
        vmq, jnp.asarray(q), jnp.asarray(active),
        jnp.float32(tol) * jml.BOUND_Q, band[0], band[1]))
    full = np.asarray(jml.lattice_votes(
        vm, jnp.asarray(q), jnp.asarray(active), tol, band[0], band[1]))
    if ctx is not None:
        bound = np.where((ctx == ctx_id)[None, :], bound, -1)
        full = np.where((ctx == ctx_id)[None, :], full, 0)
    return (np.asarray(jv), np.asarray(jc)), (tv.numpy(), tc.numpy()), \
        bound, full


def _tie_free_k(bound_row, lo=8, hi=64):
    """A candidate count whose k-th and (k+1)-th bounds differ (then any
    exact top-k selects the same rows), preferring one in [lo, hi]."""
    s = -np.sort(-bound_row)
    ok = [k for k in range(1, len(s)) if s[k - 1] != s[k]]
    inside = [k for k in ok if lo <= k <= hi]
    return (inside or ok)[0]


def _lattice_queries(db0, seed, f=48):
    rng = np.random.default_rng(seed)
    q = np.stack([db0[11, :f], rng.uniform(-30, 25, f).astype(np.float32),
                  db0[200, :f] + 0.3]).astype(np.float32)
    active = np.ones(q.shape, bool)
    active[0, 40:] = False
    return q, active


@pytest.mark.parametrize("tol", [0.001, 0.05, 0.5, 1.0])
@pytest.mark.parametrize("seed", [1, 2])
def test_lattice_prefiltered_equals_jax(tol, seed):
    """Per query, at a candidate count with no tie at the k-th bound."""
    db0, mask = _clustered(seed)
    q, active = _lattice_queries(db0, seed)
    certified = []
    for b in range(q.shape[0]):
        qb, ab = q[b : b + 1], active[b : b + 1]
        bound = _lattice_both(db0, mask, qb, ab, tol, 8)[2]
        k = _tie_free_k(bound[0])
        (jv, jc), (tv, tc), bound, full = _lattice_both(db0, mask, qb, ab,
                                                        tol, k)
        assert (bound >= full).all()
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tc, jc)
        if tc[0]:  # certified: the full scan's D5 top-1
            assert tv[0].max() == full[0].max()
            assert np.argmax(tv[0]) == np.argmax(full[0])
        certified.append(bool(tc[0]))
    if tol >= 0.05:  # at 0.001 the truncation loss leaves few hits
        assert all(certified)


def test_lattice_prefiltered_band_filter_equals_jax():
    db0, mask = _clustered(3)
    q, active = _lattice_queries(db0, 3)
    (jv, jc), (tv, tc), _, full = _lattice_both(
        db0, mask, q, active, 0.05, 40, band=(-20.0, 10.0))
    np.testing.assert_array_equal(tc, jc)
    assert tc.all()
    for b in range(q.shape[0]):
        assert tv[b].max() == full[b].max()
        assert np.argmax(tv[b]) == np.argmax(full[b])


def test_lattice_prefiltered_context_filter():
    db0, mask = _clustered(5)
    q = db0[None, 200, :48]
    active = np.ones((1, 48), bool)
    ctx = np.zeros(db0.shape[0], np.int32)
    ctx[128:] = 1
    (jv, jc), (tv, tc), _, full = _lattice_both(db0, mask, q, active, 0.05,
                                                32, ctx=ctx, ctx_id=1)
    assert tc.all() and jc.all()
    assert (tv[:, :128] == 0).all()
    assert full[0].max() > 0
    assert tv[0].max() == full[0].max()
    assert np.argmax(tv[0]) == np.argmax(full[0]) >= 128


def test_lattice_near_duplicates_decertify():
    db0, mask = _clustered(7)
    db0[:64] = db0[0]
    mask[:64] = mask[0]
    q = db0[None, 0, :48]
    active = np.ones((1, 48), bool)
    (_, jc), (_, tc), _, _ = _lattice_both(db0, mask, q, active, 1.0, 16)
    assert not tc.any() and not jc.any()


@pytest.mark.parametrize("top", [2, 3])
def test_lattice_topk_certificate(top):
    db0, mask = _clustered(11)
    db0[41] = db0[40] + 0.02
    db0[42] = db0[40] - 0.02
    mask[41] = mask[42] = mask[40]
    q = db0[None, 40, :48]
    active = np.ones((1, 48), bool)
    (jv, jc), (tv, tc), _, full = _lattice_both(db0, mask, q, active, 0.1,
                                                32, top=top)
    assert tc.all() and jc.all()
    order_full = np.lexsort((np.arange(full.shape[1]), -full[0]))[:top]
    order_pre = np.lexsort((np.arange(tv.shape[1]), -tv[0]))[:top]
    np.testing.assert_array_equal(order_pre, order_full)
    np.testing.assert_array_equal(tv[0, order_pre], full[0, order_full])
    with pytest.raises(ValueError, match="candidate budget"):
        tml.lattice_prefiltered_votes(
            torch.zeros((4, tml.K_SIZE)), torch.zeros((4, tml.K_SIZE),
                                                      dtype=torch.uint8),
            _t(q), _t(active), 0.1, -np.inf, np.inf, k=2, top=3)


def test_certificate_and_scatter_equal_jax():
    rng = np.random.default_rng(4)
    votes_k = rng.integers(0, 9, (6, 5)).astype(np.int32)
    unsel = rng.integers(-1, 9, 6).astype(np.int32)
    idx = np.stack([rng.permutation(40)[:5] for _ in range(6)])
    for top in (1, 2, 5):
        np.testing.assert_array_equal(
            tml.certificate(_t(votes_k), _t(unsel), top).numpy(),
            np.asarray(jml.certificate(jnp.asarray(votes_k),
                                       jnp.asarray(unsel), top)))
    np.testing.assert_array_equal(
        tml.scatter_candidates(_t(votes_k), _t(idx), 40).numpy(),
        np.asarray(jml.scatter_candidates(jnp.asarray(votes_k),
                                          jnp.asarray(idx), 40)))


def test_select_candidates_unselected_max_is_exact():
    """Which of the tied rows topk picks is free; the unselected maximum is
    computed after the picks are set to -1, so it is exact either way."""
    bound = torch.tensor([[5, 9, 9, 9, 1, 0, 9, 2]], dtype=torch.int32)
    idx, unsel = tml.select_candidates(bound, 3)
    assert sorted(bound[0, idx[0]].tolist()) == [9, 9, 9]
    assert unsel.tolist() == [9]
    idx, unsel = tml.select_candidates(bound, 4)
    assert unsel.tolist() == [5]


# ---- the strict/aligned prefilter -------------------------------------- #


def _aligned_case(seed, a=64, t=128):
    rng = np.random.default_rng(seed)
    db = rng.uniform(-40, 30, size=(a, t, 2)).astype(np.float32)
    n_frames = rng.integers(96, t + 1, size=a)
    mask = np.arange(t)[None, :] < n_frames[:, None]
    db = np.where(mask[:, :, None], db, PAD_VALUE).astype(np.float32)
    db[9] = PAD_VALUE  # a dead row
    mask[9] = False
    q = np.stack([db[7, 10:42], db[31, 40:72] + 0.01,
                  rng.uniform(-40, 30, (32, 2))]).astype(np.float32)
    return db, mask, q


def _aligned_both(db, mask, q, tol, k, aligned, top=1, ctx=None,
                  ctx_id=None, band=(-1, -1)):
    specs, jmaps = jml.build_bound_maps(jnp.asarray(db), jnp.asarray(mask))
    jq, ja, ju = match_jax.prepare_query(q, None, *band, trunc_coef1=False)
    jv, jc = jax_aligned_prefiltered(
        db, jmaps, jq, ja, ju, tol, specs=specs, coefs=2, k=k,
        interpret=True, top=top, aligned=aligned,
        ctx_ids=None if ctx is None else jnp.asarray(ctx), ctx_id=ctx_id,
    )
    tspecs, tmaps = tml.build_bound_maps(_t(db), _t(mask))
    tq, ta, tu = tm.prepare_query(_t(q), None, *band, trunc_coef1=False)
    tv, tc = tk.aligned_prefiltered_votes(
        _t(db), tmaps, tq, ta, tu, tol, specs=tspecs, coefs=2, k=k, top=top,
        aligned=aligned, ctx_ids=None if ctx is None else _t(ctx),
        ctx_id=ctx_id,
    )
    bound = tml.bound_votes(tspecs, tmaps, tq, ta, tu, tol).numpy()
    full = tm.match_votes(_t(db), _t(mask), tq, ta, tu, tol, coefs=2,
                          aligned=aligned).numpy()
    if ctx is not None:
        bound = np.where((ctx == ctx_id)[None, :], bound, -1)
        full = np.where((ctx == ctx_id)[None, :], full, 0)
    return (np.asarray(jv), np.asarray(jc)), (tv.numpy(), tc.numpy()), \
        bound, full


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("tol", [0.05, 0.3])
def test_aligned_prefiltered_equals_jax(aligned, tol):
    db, mask, q = _aligned_case(2)
    specs, maps = tml.build_bound_maps(_t(db), _t(mask))
    winners = []
    for b in range(q.shape[0]):
        tq, ta, tu = tm.prepare_query(_t(q[b : b + 1]), None, -1, -1,
                                      trunc_coef1=False)
        k = _tie_free_k(tml.bound_votes(specs, maps, tq, ta, tu,
                                        tol).numpy()[0], 8, 24)
        (jv, jc), (tv, tc), bound, full = _aligned_both(
            db, mask, q[b : b + 1], tol, k, aligned)
        assert (bound >= full).all()
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tv, jv)
        if tc[0]:
            assert tv[0].max() == full[0].max()
            assert np.argmax(tv[0]) == np.argmax(full[0])
        winners.append(int(np.argmax(tv[0])) if tc[0] else None)
    assert winners[:2] == [7, 31]


@pytest.mark.parametrize("aligned", [True, False])
def test_aligned_prefilter_near_duplicates_decertify(aligned):
    rng = np.random.default_rng(3)
    base = rng.uniform(-40, 30, size=(64, 2)).astype(np.float32)
    db = np.broadcast_to(base, (16, 64, 2)).copy()
    mask = np.ones((16, 64), bool)
    (_, jc), (_, tc), _, _ = _aligned_both(db, mask, base[None, 8:24], 0.05,
                                           4, aligned)
    assert not tc.any() and not jc.any()


@pytest.mark.parametrize("aligned", [True, False])
def test_aligned_prefilter_context_and_top(aligned):
    db, mask, q = _aligned_case(5)
    db[40] = db[31] + 0.02  # near copies of the second query's row
    db[41] = db[31] - 0.02
    mask[40] = mask[41] = mask[31]
    ctx = np.zeros(db.shape[0], np.int32)
    ctx[30:] = 1
    (jv, jc), (tv, tc), _, full = _aligned_both(
        db, mask, q, 0.05, 12, aligned, top=3, ctx=ctx, ctx_id=1)
    np.testing.assert_array_equal(tc, jc)
    assert tc[1]
    assert (tv[:, :30] == 0).all()
    order_full = np.lexsort((np.arange(full.shape[1]), -full[1]))[:3]
    order_pre = np.lexsort((np.arange(tv.shape[1]), -tv[1]))[:3]
    np.testing.assert_array_equal(order_pre, order_full)
    np.testing.assert_array_equal(tv[1, order_pre], full[1, order_full])
    assert set(order_pre.tolist()) == {31, 40, 41}


def test_aligned_prefilter_rejects_empty_specs_and_big_top():
    db, mask, q = _aligned_case(6)
    tq, ta, tu = tm.prepare_query(_t(q), None, -1, -1, trunc_coef1=False)
    with pytest.raises(ValueError, match="non-empty"):
        tk.aligned_prefiltered_votes(_t(db), (), tq, ta, tu, 0.1)
    specs, maps = tml.build_bound_maps(_t(db), _t(mask))
    with pytest.raises(ValueError, match="candidate budget"):
        tk.aligned_prefiltered_votes(_t(db), maps, tq, ta, tu, 0.1,
                                     specs=specs, k=4, top=5)


@pytest.mark.parametrize("aligned", [False, True])
def test_candidate_twin_equals_full_votes_at_those_rows(aligned):
    """Duplicates, dead and PAD rows, and an id past the rows (scores 0)."""
    db, mask, q = _aligned_case(8)
    tq, ta, tu = tm.prepare_query(_t(q), None, -1, -1, trunc_coef1=False)
    full = tm.match_votes(_t(db), _t(mask), tq, ta, tu, 0.1, coefs=2,
                          aligned=aligned)
    cand = torch.tensor([[7, 7, 9, 0, 63], [31, 9, 31, 2, 64],
                         [1, 2, 3, 4, 5]], dtype=torch.int32)
    got = tk.match_votes_cand(_t(db), tq, ta, tu, 0.1, cand, coefs=2,
                              aligned=aligned)
    want = torch.where(cand < 64, full.gather(1, cand.clamp(max=63).long()),
                       0)
    assert torch.equal(got, want)


# ---- the engine -------------------------------------------------------- #


def _speechlike(rng, seconds):
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f0 = rng.uniform(90, 220)
    sig = sum(
        rng.uniform(0.2, 1.0) / h
        * (1.0 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.5, 3) * t))
        * np.sin(2 * np.pi * f0 * h * t)
        for h in range(1, 9)
    )
    sig = sig + 0.02 * rng.standard_normal(n)
    level = np.repeat(rng.uniform(0.5, 1.0, n // 800 + 1), 800)[:n]
    return (0.3 * level * sig / np.abs(sig).max()).astype(np.float32)


@pytest.fixture
def jax_query_fp(monkeypatch):
    """The port fingerprints its queries with the JAX function, so both
    engines vote bitwise-equal query fingerprints (as in
    tests/test_torch_engine.py)."""

    def fp(padded, samplerate, dsp, law=None, n_valid=None, device="cpu"):
        out = jax_fp(padded, samplerate, dsp, law=law, n_valid=n_valid)
        return torch.from_numpy(np.array(out)).to(device)

    monkeypatch.setattr(tengine, "fingerprint_padded_batch", fp)


@pytest.fixture
def small_budgets(monkeypatch):
    """Candidate budgets of 16 so a 128-row view crosses both size gates."""
    monkeypatch.setattr(tml, "LATTICE_PREFILTER_K", 16)
    monkeypatch.setattr(tk, "PREFILTER_K", 16)


def _cfg(root):
    return TiresiasConfig(
        contexts=(ContextConfig("media", str(root / "media")),
                  ContextConfig("promo", str(root / "promo"))),
        data_dir=str(root / "data"),
    )


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """24 + 8 speech-like tracks of 2-3.5 s in two contexts (tier 128, one
    view of 128 rows), "promo" repeating one media track; synced by the JAX
    engine, restored by the port."""
    root = tmp_path_factory.mktemp("prefilter")
    rng = np.random.default_rng(41)
    # each track at its own level, 2 dB apart: coefficient 0 then tells
    # tracks apart, and the bounds can certify with 8 candidates
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
    jeng = JaxTiresias(_cfg(root), exclusive=False)
    teng = Tiresias(_cfg(root), exclusive=False, device="cpu")
    return root, jeng, teng


def _queries(root, rng):
    out = []
    for ctx in ("media", "promo"):
        for name in sorted(os.listdir(root / ctx))[::3]:
            pcm, _ = read_wav_i16(str(root / ctx / name))
            s = 256 * int(rng.integers(0, (len(pcm) - 12800) // 256))
            out.append(pcm[s : s + 12800])
    out.append(np.zeros(12800, np.int16))
    return out


def _vars(results):
    return [r.to_channel_vars() for r in results]


def _spy(monkeypatch, eng):
    """Record every certificate the port's engine notes."""
    seen = []
    note = eng._pf_note

    def spy(view, mode, certified):
        seen.append((mode, certified))
        note(view, mode, certified)

    monkeypatch.setattr(eng, "_pf_note", spy)
    return seen


ENGINE_MODES = {
    "dialplan": ({"coefs": 1}, 0.5, "lattice"),
    "bag": ({"coefs": 2, "trunc_coef1": False}, 0.1, "bag"),
    "aligned": ({"coefs": 2, "trunc_coef1": False, "aligned": True}, 0.1,
                "aligned"),
    "margin": ({"coefs": 2, "trunc_coef1": False, "aligned": True,
                "min_margin": 0.2}, 0.1, "aligned"),
}


@pytest.mark.parametrize("name", sorted(ENGINE_MODES))
def test_engine_prefiltered_search_equals_jax(stores, jax_query_fp,
                                              small_budgets, monkeypatch,
                                              name):
    root, jeng, teng = stores
    mode, tol, pf = ENGINE_MODES[name]
    (view,) = teng.store.search_views()
    assert view.db.shape[0] == 128 > 2 * 16
    seen = _spy(monkeypatch, teng)
    queries = _queries(root, np.random.default_rng(3))
    for ctx, filt in ((None, False), ("media", True), ("promo", True)):
        kw = dict(tolerance=tol, filter_context=filt, **mode)
        want = jeng.search_pcm_batch(ctx, queries, SR, **kw)
        teng._pf_misses.clear()  # keep the gate open: every search tries
        got = teng.search_pcm_batch(ctx, queries, SR, **kw)
        assert _vars(got) == _vars(want), (ctx, filt)
        single = []
        for q in queries:
            teng._pf_misses.clear()
            single.append(teng.search_pcm(ctx, q, SR, **kw))
        assert _vars(single) == _vars(want)
    assert {m for m, _ in seen} == {pf}
    assert len(seen) == 3 * (len(queries) + 1)
    assert any(c for _, c in seen)  # the prefilter answered some searches
    assert sum(r.found for r in got) >= 2


@pytest.mark.parametrize("name", ["dialplan", "bag", "aligned"])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_engine_prefiltered_topk_equals_jax(stores, jax_query_fp,
                                            small_budgets, monkeypatch, name,
                                            k):
    root, jeng, teng = stores
    mode, tol, pf = ENGINE_MODES[name]
    seen = _spy(monkeypatch, teng)
    for q in _queries(root, np.random.default_rng(4))[:5]:
        for ctx, filt in ((None, False), ("media", True)):
            kw = dict(k=k, tolerance=tol, filter_context=filt, **mode)
            want = jeng.search_pcm_topk(ctx, q, SR, **kw)
            teng._pf_misses.clear()
            got = teng.search_pcm_topk(ctx, q, SR, **kw)
            assert [(r.name, r.context, r.match_count) for r in got] == [
                (r.name, r.context, r.match_count) for r in want]
    assert len(seen) == 10 and all(m == pf for m, _ in seen)


def test_engine_gate_switches_off_after_8_misses_and_rearms(
        tmp_path, small_budgets):
    """24 copies of one tone tie beyond k=16 rows at tol 1.0: every dialplan
    search de-certifies, exactly, and counts a fallback; after 8 misses the
    gate skips the bound scan for this view; a mutation (a new view, a new
    gen) re-arms it."""
    eng = Tiresias(TiresiasConfig(data_dir=str(tmp_path)), restore=False,
                   device="cpu")
    eng.create_context("c")
    tone = synth_tone(440, 1.0, SR)
    for i in range(24):
        eng.add_audio_pcm("c", f"dup{i}", tone * (1.0 + 1e-5 * i), SR)
    calls = []
    real = eng._lattice_prefiltered
    eng._lattice_prefiltered = lambda *a: calls.append(1) or real(*a)
    before = metrics.snapshot()["counters"].get(
        "search.prefilter_fallbacks", 0)
    for _ in range(10):
        r = eng.search_pcm("c", tone, SR, tolerance=1.0)
        assert r.found and r.name == "dup0"  # exact, by the full scan
    view = eng.store.search_views()[0]
    assert len(calls) == 8
    assert eng._pf_misses[(view.gen, "lattice")] == 8
    assert not eng._lattice_pf_ok(view, 1.0)
    after = metrics.snapshot()["counters"]["search.prefilter_fallbacks"]
    assert after - before == 8
    eng.add_audio_pcm("c", "fresh", synth_tone(999, 1.0, SR), SR)
    view2 = eng.store.search_views()[0]
    assert view2.gen != view.gen and eng._lattice_pf_ok(view2, 1.0)
    eng.close()


def test_pf_miss_dict_is_bounded_and_keeps_the_live_streak(tmp_path):
    eng = Tiresias(TiresiasConfig(data_dir=str(tmp_path)), restore=False,
                   device="cpu")
    live = SimpleNamespace(gen=-1)
    gen = 10**6
    for _ in range(7):
        eng._pf_note(live, "lattice", False)
        for _ in range(20):
            eng._pf_note(SimpleNamespace(gen=gen), "lattice", False)
            gen += 1
        assert eng._pf_allowed(live, "lattice")
    assert len(eng._pf_misses) <= 32
    eng._pf_note(live, "lattice", False)
    assert not eng._pf_allowed(live, "lattice")
    assert eng._pf_allowed(live, "aligned")  # per mode
    eng._pf_note(live, "lattice", True)
    assert eng._pf_allowed(live, "lattice")
    eng.close()


@pytest.mark.parametrize("coefs,tol,runs", [
    (2, 1.0, False), (2, 0.5, True), (1, 0.75, False), (1, 0.7, True),
])
def test_engine_saturated_tolerance_skips_the_aligned_prefilter(
        stores, small_budgets, monkeypatch, coefs, tol, runs):
    """Past the uint8 saturation of every bound coefficient the bound could
    never certify: the engine must not run it (2 coefs: s=4 saturates at
    ~0.746, s=8 at ~0.373; 1 coef: s=4 only)."""
    root, _, teng = stores
    calls = []
    monkeypatch.setattr(teng, "_aligned_prefiltered",
                        lambda *a: calls.append(1))
    teng._pf_misses.clear()
    q = _queries(root, np.random.default_rng(5))[0]
    teng.search_pcm(None, q, SR, coefs=coefs, tolerance=tol,
                    trunc_coef1=False, aligned=True)
    assert bool(calls) == runs


def test_engine_saturated_tolerance_skips_the_lattice_prefilter(
        stores, small_budgets, monkeypatch):
    root, _, teng = stores
    calls = []
    monkeypatch.setattr(teng, "_lattice_prefiltered",
                        lambda *a: calls.append(1))
    teng._pf_misses.clear()
    q = _queries(root, np.random.default_rng(5))[0]
    assert teng.search_pcm(None, q, SR, coefs=1, tolerance=4.0).found
    assert not calls  # 4.0 * 64 >= 255
    teng.search_pcm(None, q, SR, coefs=1, tolerance=3.9)
    assert calls


@pytest.mark.parametrize("aligned", [False, True])
def test_engine_autosplit_view_bails_out_of_the_aligned_prefilter(
        tmp_path, monkeypatch, jax_query_fp, small_budgets, aligned):
    monkeypatch.setattr(jfs, "MAX_TIER_FRAMES", 128)
    monkeypatch.setattr(tfs, "MAX_TIER_FRAMES", 128)
    cfg = TiresiasConfig(data_dir=str(tmp_path))
    jeng = JaxTiresias(cfg, restore=False)
    jeng.create_context("c")
    long_pcm = synth_chirp(200, 1800, 15.0, SR)
    jeng.add_audio_pcm("c", "long", long_pcm, SR)
    for i in range(20):
        jeng.add_audio_pcm("c", f"s{i}", synth_chirp(300 + 40 * i,
                                                     900 + 30 * i, 2.0, SR),
                           SR)
    jeng.close()
    jeng = JaxTiresias(cfg, exclusive=False)
    teng = Tiresias(cfg, exclusive=False, device="cpu")
    (view,) = teng.store.search_views()
    assert view.segments and view.db.shape[0] > 2 * 16
    built = []
    real = teng.store.bound_maps_for
    monkeypatch.setattr(teng.store, "bound_maps_for",
                        lambda *a: built.append(1) or real(*a))
    kw = dict(coefs=2, trunc_coef1=False, aligned=aligned, tolerance=0.1)
    queries = [long_pcm[3 * SR : 6 * SR], long_pcm[7 * SR : 10 * SR]]
    got = teng.search_pcm_batch("c", queries, SR, **kw)
    assert _vars(got) == _vars(jeng.search_pcm_batch("c", queries, SR, **kw))
    assert got[0].name == "long" and not built
    # the dialplan prefilter needs no bail-out: the map min-combines rows
    seen = _spy(monkeypatch, teng)
    kw = dict(coefs=1, tolerance=0.5)
    got = teng.search_pcm_batch("c", queries, SR, **kw)
    assert _vars(got) == _vars(jeng.search_pcm_batch("c", queries, SR, **kw))
    assert seen and seen[0][0] == "lattice"


def test_warmup_builds_the_prefilter_maps(tmp_path, small_budgets):
    rng = np.random.default_rng(12)
    from tiresias_tpu_torch.config import MatchConfig

    for match, attr in ((MatchConfig(), "value_map_q"),
                        (MatchConfig(coefs=2, trunc_coef1=False, aligned=True,
                                     tolerance=0.1), "bound_maps"),
                        (MatchConfig(coefs=2, trunc_coef1=False,
                                     tolerance=0.1), None)):
        cfg = TiresiasConfig(data_dir=str(tmp_path / str(attr)), match=match)
        eng = Tiresias(cfg, device="cpu")
        eng.create_context("c")
        for i in range(3):
            eng.add_audio_pcm("c", f"t{i}", _speechlike(rng, 2.0), SR)
        eng.warm_search_maps()
        (view,) = eng.store.search_views()
        for name in ("value_map_q", "bound_maps"):
            assert (getattr(view, name) is not None) == (name == attr), name
        eng.close()


def test_int16_query_through_both_prefilters_on_the_port_alone(
        stores, small_budgets, monkeypatch):
    """The port's own fingerprints (no JAX in the query path): certified
    answers equal the port's full scan with the gates shut."""
    root, _, teng = stores
    queries = _queries(root, np.random.default_rng(6))
    for mode, tol, _ in ENGINE_MODES.values():
        teng._pf_misses.clear()
        got = teng.search_pcm_batch(None, queries, SR, tolerance=tol, **mode)
        with monkeypatch.context() as m:
            m.setattr(tml, "LATTICE_PREFILTER_K", 10**6)
            m.setattr(tk, "PREFILTER_K", 10**6)
            want = teng.search_pcm_batch(None, queries, SR, tolerance=tol,
                                         **mode)
        assert _vars(got) == _vars(want)
