"""The port's general matcher (``ops/match.py``) and the K4/K5 wrappers
(``ops/match_kernels.py``) against the JAX package, on the CPU.

Inputs are made with numpy from a seed and go to both packages as the same
arrays. The plain twins must equal ``match_jax.match_votes`` and the Pallas
kernels in interpret mode exactly (int32 votes); query preprocessing must be
bitwise equal. On the CPU the K4/K5 wrappers take the twin, so these tests
hold the twin — the CUDA kernels are held to it on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from tiresias_tpu.ops import match_jax
from tiresias_tpu.ops import match_pallas as mp
from tiresias_tpu_torch.ops import match as tm
from tiresias_tpu_torch.ops import match_kernels as tk
from tiresias_tpu_torch.ops.mfcc import PAD_VALUE

torch.set_num_threads(2)

# band filters (freq_ignore_low, freq_ignore_high): off; one that drops the
# negative q0 frames and bypasses the coefficient-1 condition where q1 < 0;
# one narrow band that drops most frames
BANDS = [(-1, -1), (1, 300), (2, 6)]


def _case(seed, a=200, t=256, c=4, b=3, f=24):
    """db [A, T, C] with ragged rows (PAD_VALUE past each row's end, one row
    empty) and queries: two noisy excerpts of stored rows, one random, with
    padded frames past each query's n_frames."""
    rng = np.random.default_rng(seed)
    db = rng.uniform(-30.0, 20.0, (a, t, c)).astype(np.float32)
    n = rng.integers(f, t + 1, a)
    n[5] = 0
    mask = np.arange(t)[None, :] < n[:, None]
    db[~mask] = PAD_VALUE
    q = np.stack([
        db[7, 3 : 3 + f], db[a - 50, 1 : 1 + f],
        rng.uniform(-30.0, 20.0, (f, c)),
    ]).astype(np.float32)[:b]
    q += rng.normal(0.0, 0.03, q.shape).astype(np.float32)
    n_frames = np.array([f, f - 3, f - 9], np.int32)[:b]
    return db, mask, q, n_frames


def _prepared(q, n_frames, band, trunc):
    jq = match_jax.prepare_query(q, n_frames, *band, trunc_coef1=trunc)
    tq = tm.prepare_query(torch.from_numpy(q), n_frames, *band,
                          trunc_coef1=trunc)
    return jq, tq


@pytest.mark.parametrize("trunc", [True, False])
@pytest.mark.parametrize("band", BANDS)
def test_prepare_query_bitwise_equal_jax(trunc, band):
    _, _, q, n_frames = _case(0, c=2)
    (jq, ja, ju), (tq, ta, tu) = _prepared(q, n_frames, band, trunc)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    # the band filters really drop and bypass frames here
    if band != (-1, -1):
        assert not ta.numpy()[:, : n_frames.min()].all()
        assert not tu.numpy().all()


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("coefs", [1, 2, 4])
def test_twin_equals_match_jax(coefs, aligned, t):
    db, mask, q, n_frames = _case(coefs * 10 + t, t=t)
    for trunc in (True, False):
        for band in BANDS:
            (jq, ja, ju), (tq, ta, tu) = _prepared(q, n_frames, band, trunc)
            for tol in (0.05, 1.0):
                want = np.asarray(match_jax.match_votes(
                    db, mask, jq, ja, ju, tol, coefs=coefs, aligned=aligned))
                got = tm.match_votes(
                    torch.from_numpy(db), torch.from_numpy(mask), tq, ta, tu,
                    tol, coefs=coefs, aligned=aligned)
                np.testing.assert_array_equal(got.numpy(), want)
                if not trunc and band == (-1, -1):
                    # the excerpts find their rows
                    assert got[0, 7] > 0 and got[1, db.shape[0] - 50] > 0


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("coefs", [1, 2, 4])
def test_fused_wrappers_equal_pallas_interpret(coefs, aligned):
    """On a CPU tensor the K4/K5 wrappers take the twin (mask derived from
    PAD_VALUE), which equals the Pallas kernels run in interpret mode over
    two 128-row audio tiles."""
    db, _, q, n_frames = _case(100 + coefs)
    (jq, ja, ju), (tq, ta, tu) = _prepared(q, n_frames, (1, 300), False)
    kernel = mp.match_votes_pallas_aligned if aligned else mp.match_votes_pallas
    wrapper = (tk.match_votes_fused_aligned if aligned
               else tk.match_votes_fused)
    want = np.asarray(kernel(db, jq, ja, ju, 0.1, coefs=coefs, interpret=True))
    got = wrapper(torch.from_numpy(db), tq, ta, tu, 0.1, coefs=coefs)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and got.shape == (3, 200)


def test_aligned_multi_chunk_pallas_equals_twin(monkeypatch):
    """A small VMEM budget forces the Pallas aligned kernel into four time
    chunks of 64 (as its own tests do); the twin has no chunking to match,
    so the votes must still be equal."""
    monkeypatch.setattr(mp, "_VMEM_MATCH_BUDGET", 512 * (280 + 6 * 100))
    assert mp._aligned_time_chunk(256, 24, 2) == 64
    db, _, q, n_frames = _case(7, c=2)
    (jq, ja, ju), (tq, ta, tu) = _prepared(q, n_frames, (-1, -1), False)
    want = np.asarray(mp.match_votes_pallas_aligned(
        db, jq, ja, ju, 0.1, coefs=2, interpret=True))
    got = tk.match_votes_fused_aligned(torch.from_numpy(db), tq, ta, tu, 0.1,
                                       coefs=2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.max() > 0


@pytest.mark.parametrize("aligned", [False, True])
def test_search_batch_fused_equals_pallas(aligned):
    db, _, q, n_frames = _case(11, c=2)
    keep = np.ones(db.shape[0], bool)
    keep[7] = False  # the filter hides the first excerpt's row
    want = mp.search_batch_pallas(
        db, q, n_frames, coefs=2, tolerance=0.1, freq_ignore_low=1,
        freq_ignore_high=300, audio_filter=keep, trunc_coef1=False,
        aligned=aligned, interpret=True,
    )
    got = tk.search_batch_fused(
        torch.from_numpy(db), torch.from_numpy(q), n_frames, coefs=2,
        tolerance=0.1, freq_ignore_low=1, freq_ignore_high=300,
        audio_filter=torch.from_numpy(keep), trunc_coef1=False,
        aligned=aligned,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0][1] == db.shape[0] - 50
    none = tk.search_batch_fused(torch.from_numpy(db), torch.from_numpy(q),
                                 n_frames, coefs=2, aligned=aligned,
                                 with_top1=False)
    assert none[:2] == (None, None) and none[2].shape == (3, 200)


@pytest.mark.parametrize("aligned", [False, True])
def test_huge_tolerance_equals_match_jax(aligned):
    """At tol 2e5 the Pallas kernels' value-encoded masks (PAD -1e6,
    inactive +1e6) would let padding and inactive frames match; the twin's
    explicit masks (and the kernels' explicit flags) stay exact — every
    active frame hits every row that has a frame, at one common offset."""
    db, mask, q, n_frames = _case(12, c=2)
    (jq, ja, ju), (tq, ta, tu) = _prepared(q, n_frames, (1, 300), False)
    want = np.asarray(match_jax.match_votes(
        db, mask, jq, ja, ju, 2e5, coefs=2, aligned=aligned))
    got = tk._votes(torch.from_numpy(db), tq, ta, tu, 2e5, 2, aligned)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 5] == 0).all()  # the empty row
    assert (got[:, 0] == ta.sum(dim=1).to(torch.int32)).all()


@pytest.mark.parametrize("coefs", [1, 2, 4])
def test_query_rows_extend_pallas_rows(coefs):
    _, _, q, n_frames = _case(13)
    (jq, ja, ju), (tq, ta, tu) = _prepared(q, n_frames, (1, 300), False)
    rows = tk.query_rows(tq, ta, tu, coefs)
    assert rows.shape == (3, coefs + 2, 24) and rows.is_contiguous()
    np.testing.assert_array_equal(
        rows[:, : coefs + 1].numpy(), np.asarray(mp._query_rows(jq, ja, ju,
                                                                coefs)))
    np.testing.assert_array_equal(rows[:, -1].numpy(), ta.numpy())


def test_top1_lowest_index_and_filter_equal_jax():
    rng = np.random.default_rng(14)
    votes = rng.integers(0, 4, (6, 40)).astype(np.int32)
    votes[0] = 0  # no votes: -1
    votes[1, [3, 9, 30]] = 9  # ties: lowest index
    keep = rng.random(40) < 0.7
    for filt in (None, keep):
        want = match_jax.top1(votes, None if filt is None else filt)
        got = tm.top1(torch.from_numpy(votes),
                      None if filt is None else torch.from_numpy(filt))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    best, count = tm.top1(torch.zeros((2, 0), dtype=torch.int32))
    assert best.tolist() == [-1, -1] and count.tolist() == [0, 0]


@pytest.mark.parametrize("aligned", [False, True])
def test_search_batch_equals_match_jax(aligned):
    db, mask, q, n_frames = _case(15, c=2)
    want = match_jax.search_batch(db, mask, q, n_frames, coefs=2,
                                  tolerance=0.1, trunc_coef1=False,
                                  aligned=aligned)
    got = tm.search_batch(torch.from_numpy(db), torch.from_numpy(mask),
                          torch.from_numpy(q), n_frames, coefs=2,
                          tolerance=0.1, trunc_coef1=False, aligned=aligned)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_wrappers_reject_what_they_cannot_serve():
    """No silent reroute: a tensor that is neither on the CPU nor on CUDA
    raises (as a CUDA tensor would launch the kernel or raise), and so does
    a coefficient count the db does not have."""
    db, _, q, n_frames = _case(16, c=2)
    _, (tq, ta, tu) = _prepared(q, n_frames, (-1, -1), False)
    meta = torch.empty(db.shape, device="meta")
    for fn in (tk.match_votes_fused, tk.match_votes_fused_aligned):
        with pytest.raises(ValueError):
            fn(meta, tq.to("meta"), ta.to("meta"), tu.to("meta"), 0.1)
        with pytest.raises(ValueError, match="coefs"):
            fn(torch.from_numpy(db), tq, ta, tu, 0.1, coefs=3)
