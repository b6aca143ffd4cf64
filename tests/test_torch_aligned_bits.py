"""The bit-sliced K5 in plain torch (``match_index.aligned_votes_bits_plain``)
against the JAX package and the port's twins, on the CPU.

``aligned_votes_bits_plain`` states the algorithm of the bit-sliced CUDA
kernel ``match_votes_aligned_bits_kernel_ws`` (``csrc/match.cu``), over the
rows the full scan's index kernel lists from ``SMALL_BATCH`` queries on and
over work items (the grouped forms and the forced route "bits"):
rank bands of coefficients 0 and 1 by bisection on ``fl(d − q)``,
block-prefix bitsets of each chunk's d0 and d1 orders, hits ``B0 & (B1 |
~use2)``, and the offset histogram as bit-sliced counters folded every 255
frames. It must equal ``match_jax.match_votes(aligned=True)``, the Pallas
kernel in interpret mode, the twin ``match.match_votes`` and the wrappers'
CPU paths (``match_votes_fused_aligned``, ``match_votes_cand``) int32 for
int32. The CUDA kernel is held to the twin and to this statement on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from tiresias_tpu.ops import match_jax
from tiresias_tpu.ops import match_pallas as mp
from tiresias_tpu_torch.ops import match as tm
from tiresias_tpu_torch.ops import match_index as mi
from tiresias_tpu_torch.ops import match_kernels as tk
from tiresias_tpu_torch.ops.mfcc import PAD_VALUE

torch.set_num_threads(2)

TOLS = [0.0, 0.05, 0.1, 1.0, 2e5, np.inf]
BANDS = [(-1, -1), (1, 300)]  # band filter off; on (q0 < 1 frames dropped)


def _case(seed, t, f, a=20, c=8):
    """Ragged rows with PAD past each end, row 3 empty, row 4 tombstoned;
    NaN, ±inf and ±0.0 d0 frames in row 5; NaN and ±inf d1 on live d0 in
    row 6; row 7 narrow (every band wide at tol 0.1). Queries: noisy
    excerpts of rows 6, 7 and 9 (the last one 5 frames in, so it crosses a
    chunk edge of a small ``t_chunk``), a random one, with NaN query values
    in its first frames."""
    rng = np.random.default_rng(seed)
    db = rng.uniform(-30.0, 20.0, (a, t, c)).astype(np.float32)
    n = rng.integers(max(f // 2, t // 2), t + 1, a)
    n[[6, 7, 9]] = t
    db[np.arange(t)[None, :] >= n[:, None]] = PAD_VALUE
    db[3] = PAD_VALUE
    db[4] = PAD_VALUE
    db[5, 0:40:5, 0] = np.nan
    db[5, 1:40:5, 0] = np.inf
    db[5, 2:40:5, 0] = -np.inf
    db[5, 3:40:5, 0] = 0.0
    db[5, 4:40:5, 0] = -0.0
    db[6, 0::4, 1] = np.nan
    db[6, 1::9, 1] = np.inf
    db[6, 2::9, 1] = -np.inf
    db[7, :, :2] = rng.normal(-10.0, 0.05, (t, 2)).astype(np.float32)
    q = np.stack([
        np.resize(db[6, 2:], (f, c)), np.resize(db[7, 1:], (f, c)),
        np.resize(db[9, 5:], (f, c)), rng.uniform(-30.0, 20.0, (f, c)),
    ]).astype(np.float32)
    q += rng.normal(0.0, 0.02, q.shape).astype(np.float32)
    q[3, :3, 0] = np.nan
    q[3, 3:6, 1] = np.nan
    n_frames = np.array([f, f - 1, f - 5, f], np.int32)
    return db, q, n_frames


def _mask(db):
    return (db[..., 0] != PAD_VALUE) & ~np.isnan(db[..., 0])


def _all_equal(db, q, n_frames, t_chunk, coefs, tol, band, pallas=False,
               empty=(3, 4)):
    dbt = torch.from_numpy(db)
    mask = _mask(db)
    idx = mi.build_match_index(dbt, t_chunk)
    tq, ta, tu = tm.prepare_query(torch.from_numpy(q), n_frames, *band,
                                  trunc_coef1=False)
    got = mi.aligned_votes_bits_plain(idx, dbt, tq, ta, tu, tol, coefs)
    assert got.dtype == torch.int32
    twin = tm.match_votes(dbt, torch.from_numpy(mask), tq, ta, tu, tol,
                          coefs=coefs, aligned=True)
    np.testing.assert_array_equal(got.numpy(), twin.numpy())
    fused = tk.match_votes_fused_aligned(dbt, tq, ta, tu, tol, coefs,
                                         index=idx)
    np.testing.assert_array_equal(got.numpy(), fused.numpy())
    jq, ja, ju = match_jax.prepare_query(q, n_frames, *band,
                                         trunc_coef1=False)
    want = np.asarray(match_jax.match_votes(db, mask, jq, ja, ju, tol,
                                            coefs=coefs, aligned=True))
    np.testing.assert_array_equal(got.numpy(), want)
    if pallas:
        pal = np.asarray(mp.match_votes_pallas_aligned(
            np.where(np.isnan(db), PAD_VALUE, db), jq, ja, ju, tol,
            coefs=coefs, interpret=True))
        np.testing.assert_array_equal(got.numpy(), pal)
    assert (got[:, list(empty)] == 0).all()  # empty and tombstoned rows
    return got, (tq, ta, tu)


@pytest.mark.parametrize("coefs", [1, 2, 4, 8])
@pytest.mark.parametrize("t,t_chunk,f", [
    (128, 2048, 24),   # one chunk
    (256, 64, 24),     # four chunks
    (200, 64, 127),    # four chunks, the last ragged
    (160, 2048, 128),
    (96, 2048, 129),
])
def test_bits_plain_equals_jax_and_twins(t, t_chunk, f, coefs):
    """Every tolerance, band filter off and on; the Pallas kernel in
    interpret mode where its masks hold (tol < 1e5) on the short queries."""
    db, q, n_frames = _case(coefs * 11 + t + f, t, f)
    for tol in TOLS:
        for band in BANDS:
            got, _ = _all_equal(db, q, n_frames, t_chunk, coefs, tol, band,
                                pallas=f == 24 and tol < 1e5
                                and band == (1, 300))
            if tol == 0.1 and band == (-1, -1) and coefs <= 2:
                assert got[0, 6] > 0 and got[2, 9] > 0


@pytest.mark.parametrize("t_chunk", [2048, 128])
@pytest.mark.parametrize("coefs", [2, 8])
def test_bits_plain_folds_long_queries(t_chunk, coefs):
    """300-frame queries take the counters past 255 frames (a fold), on one
    chunk and across chunks; the narrow row's votes reach past 255."""
    db, q, n_frames = _case(7 + coefs, 320, 300, a=12)
    for tol in (0.1, 1.0, np.inf):
        got, _ = _all_equal(db, q, n_frames, t_chunk, coefs, tol, (-1, -1))
        if tol == np.inf:
            assert int(got.max()) > 255


def _edge_case(seed, tol=np.float32(0.1), f=40):
    """Stored d0 and d1 values next to fl(q ± tol): each query frame's two
    band edges, in both coefficients, a few ulps either side."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-3.0, 3.0, (2, f, 2)).astype(np.float32)
    db = rng.uniform(-3.0, 3.0, (24, 256, 2)).astype(np.float32)
    db[1] = PAD_VALUE
    for i in range(20):
        for ci in range(2):
            for s, e in enumerate((np.float32(q[0, i, ci] + tol),
                                   np.float32(q[0, i, ci] - tol))):
                for k in range(-2, 3):
                    d = e
                    for _ in range(abs(k)):
                        d = np.nextafter(d, np.float32(np.inf * np.sign(k)))
                    rr = 2 + i
                    tt = 40 + 5 * s + k + 2
                    db[rr, tt, ci] = d
                    # the other coefficient passes, so this one decides
                    db[rr, tt, 1 - ci] = q[0, i, 1 - ci]
    return db, q, np.array([f, f], np.int32)


def test_bits_plain_exact_at_band_edges():
    db, q, n_frames = _edge_case(5)
    for tol in (0.0, 0.1, 1.0, np.inf):
        _all_equal(db, q, n_frames, 2048, 2, tol, (-1, -1), empty=(1,))


def test_bits_plain_cand_equals_twin_cand():
    """Each query's candidate rows (duplicates and ids outside the view
    included) against the twin's candidate form and the full votes."""
    db, q, n_frames = _case(3, 256, 64)
    dbt = torch.from_numpy(db)
    idx = mi.build_match_index(dbt, 128)
    rng = np.random.default_rng(4)
    cand = torch.from_numpy(
        rng.integers(-2, db.shape[0] + 2, (4, 9)).astype(np.int32))
    cand[:, 0] = 6
    cand[:, 1] = 6
    for tol in (0.1, 2e5):
        full, (tq, ta, tu) = _all_equal(db, q, n_frames, 128, 2, tol,
                                        (-1, -1))
        ok = (cand >= 0) & (cand < db.shape[0])
        want = torch.where(ok, full.gather(1, cand.clamp(0, db.shape[0] - 1)
                                           .long()), 0)
        for route in ("auto", "grouped", "per_item"):
            got = tk.match_votes_cand(dbt, tq, ta, tu, tol, cand, 2,
                                      index=idx, route=route, aligned=True)
            np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_coef1_order_and_prefix_bitsets():
    """The d1 order holds each chunk's live entries with a non-NaN d1 in
    ascending order (±inf included); P[k] is the set of times ranked below
    k * g; a band's bitset is exactly its entries' times."""
    db, _, _ = _case(9, 200, 24, c=2)
    idx = mi.build_match_index(torch.from_numpy(db), 64)
    d1s, pos1, n1 = mi.coef1_order(idx)
    chunk = idx.chunk
    for a in range(db.shape[0]):
        for c in range(idx.n_chunks):
            n = int(idx.n_live[a, c])
            live_t = idx.pos[a, c, :n].long()
            t_abs = c * chunk + live_t
            d1 = db[a, t_abs.numpy(), 1]
            keep = ~np.isnan(d1)
            assert int(n1[a, c]) == keep.sum()
            m = int(n1[a, c])
            got = d1s[a, c, :m].numpy()
            np.testing.assert_array_equal(got, np.sort(d1[keep]))
            assert np.isnan(d1s[a, c, m:].numpy()).all()
            np.testing.assert_array_equal(
                db[a, c * chunk + pos1[a, c, :m].numpy(), 1], got)
    p = mi.prefix_bitsets(idx.pos, idx.n_live, chunk)
    g = 1 << mi.block_shift(chunk)
    words = p.numpy()
    for a in (0, 5, 6):
        for c in range(idx.n_chunks):
            n = int(idx.n_live[a, c])
            for k in range(words.shape[2]):
                times = idx.pos[a, c, : min(n, k * g)].long().numpy()
                want = np.zeros(words.shape[3], np.int64)
                for tt in times:
                    want[tt >> 5] |= 1 << (tt & 31)
                np.testing.assert_array_equal(words[a, c, k], want)
    rng = np.random.default_rng(2)
    lo = torch.from_numpy(rng.integers(0, chunk, (1, 3, db.shape[0],
                                                  idx.n_chunks)))
    hi = torch.minimum(lo + torch.from_numpy(
        rng.integers(0, chunk, lo.shape)), idx.n_live.long()[None, None])
    lo = torch.minimum(lo, hi)
    bits = mi.band_bitsets(p, idx.pos, lo, hi, chunk).numpy()
    for a in range(db.shape[0]):
        for c in range(idx.n_chunks):
            for j in range(3):
                want = np.zeros(bits.shape[-1], np.int64)
                for r in range(int(lo[0, j, a, c]), int(hi[0, j, a, c])):
                    tt = int(idx.pos[a, c, r])
                    want[tt >> 5] |= 1 << (tt & 31)
                np.testing.assert_array_equal(bits[0, j, a, c], want)


def _grouped_case(seed, t, f, b=9):
    """``_case``'s rows and ``b`` queries (its four, then noisy copies of
    them), with candidates that put 9 queries on row 6 (an item of 8 and
    one of 1), repeat ids, leave rows 0-2 and 13-19 unchosen and hold ids
    outside the view."""
    db, q4, nf4 = _case(seed, t, f)
    rng = np.random.default_rng(seed + 1)
    more = np.arange(b - 4) % 4
    q = np.concatenate([q4, q4[more] + rng.normal(
        0.0, 0.01, q4[more].shape).astype(np.float32)])
    n_frames = np.concatenate([nf4, nf4[more]])
    cand = rng.integers(3, 13, (b, 7)).astype(np.int32)
    cand[:, 0] = 6
    cand[:, 1] = 7
    cand[0, 2] = cand[0, 3]  # a repeat
    cand[1, 4], cand[2, 5], cand[3, 6] = -1, db.shape[0], 2**30
    return db, q, n_frames, torch.from_numpy(cand)


@pytest.mark.parametrize("coefs", [1, 2, 4, 8])
@pytest.mark.parametrize("t,t_chunk,f", [
    (128, 2048, 24),   # one chunk
    (256, 64, 24),     # four chunks
    (200, 64, 129),    # four chunks, the last ragged; 129 frames
    (320, 128, 300),   # three chunks; 300 frames (a fold)
])
def test_bits_plain_grouped_form_equals_jax_and_twins(t, t_chunk, f, coefs):
    """The grouped candidate form of the statement (items of up to 8
    queries of one row, and at batch 1 each slot an item) against JAX's
    aligned votes gathered at the candidates, the twin's candidate form and
    the candidate wrapper's CPU path, int32 for int32, at every tolerance;
    an id outside the view scores 0. Items are served a few pairs at a
    time, so a row's items span several rounds."""
    db, q, n_frames, cand = _grouped_case(coefs * 7 + t + f, t, f)
    dbt = torch.from_numpy(db)
    idx = mi.build_match_index(dbt, t_chunk)
    mask = _mask(db)
    tq, ta, tu = tm.prepare_query(torch.from_numpy(q), n_frames, -1, -1,
                                  trunc_coef1=False)
    jq, ja, ju = match_jax.prepare_query(q, n_frames, -1, -1,
                                         trunc_coef1=False)
    ok = (cand >= 0) & (cand < db.shape[0])
    idc = cand.clamp(0, db.shape[0] - 1).long().numpy()
    for tol in (0.0, 0.1, 1.0, 2e5, np.inf):
        full = np.asarray(match_jax.match_votes(db, mask, jq, ja, ju, tol,
                                                coefs=coefs, aligned=True))
        want = np.where(ok.numpy(), np.take_along_axis(full, idc, 1), 0)
        for b in (9, 1):
            got = mi.aligned_votes_bits_plain(
                idx, dbt, tq[:b], ta[:b], tu[:b], tol, coefs, cand=cand[:b],
                max_pairs=24)
            assert got.dtype == torch.int32 and got.shape == (b, 7)
            np.testing.assert_array_equal(got.numpy(), want[:b])
            twin = tk.match_votes_cand_plain(dbt, tq[:b], ta[:b], tu[:b],
                                             tol, cand[:b], coefs, True)
            np.testing.assert_array_equal(got.numpy(), twin.numpy())
            wrapped = tk.match_votes_cand(dbt, tq[:b], ta[:b], tu[:b], tol,
                                          cand[:b], coefs, index=idx,
                                          aligned=True)
            np.testing.assert_array_equal(got.numpy(), wrapped.numpy())
        if tol == 0.1 and coefs <= 2:
            assert got[0, 0] > 0  # query 0 is an excerpt of row 6
