"""The candidate form's work list (``group_candidates_plain``) against a
numpy reference, on the CPU.

K4/K5's grouped candidate form turns each query's candidate rows
``cand [B, k]`` into a row-major work list: every valid slot ``b * k + j``
exactly once, grouped by row, each row's slots cut into work items of at
most ``g`` queries; ids outside ``[0, rows)`` are dropped (their votes stay
0). The CUDA counting sort is held to this twin on the card
(``tests/test_torch_cuda.py``). Here the twin is held to a plain loop, and
the votes computed item by item over the list (the kernels' order of work)
to the candidate twin and to ``match_jax.match_votes`` on each query's
gathered rows.
"""

import numpy as np
import pytest
import torch

from tiresias_tpu.ops import match_jax
from tiresias_tpu_torch.ops import match as tm
from tiresias_tpu_torch.ops import match_kernels as tk
from tiresias_tpu_torch.ops.mfcc import PAD_VALUE

ROWS = 40


def _reference(cand: np.ndarray, rows: int, g: int):
    """Slots grouped by row (rows ascending, slots in order) and the items
    (row, first slot, count, 0), by a plain loop."""
    by_row = {}
    for s, r in enumerate(cand.reshape(-1).tolist()):
        if 0 <= r < rows:
            by_row.setdefault(r, []).append(s)
    slots, items = [], []
    for r in sorted(by_row):
        for p in range(0, len(by_row[r]), g):
            items.append((r, len(slots) + p, min(g, len(by_row[r]) - p), 0))
        slots += by_row[r]
    return (np.array(slots, np.int32),
            np.array(items, np.int32).reshape(-1, 4))


def _cases():
    rng = np.random.default_rng(8)
    return {
        "batch_1": rng.permutation(ROWS)[None, :12],
        "same_rows": np.tile(rng.permutation(ROWS)[:16], (64, 1)),
        "uneven": np.concatenate(
            [rng.integers(0, 3, (9, 10)), rng.integers(0, ROWS, (9, 6))],
            axis=1),
        "empty": np.zeros((5, 0), np.int64),
        "no_queries": np.zeros((0, 7), np.int64),
        "k_equals_rows": np.stack([rng.permutation(ROWS) for _ in range(6)]),
        "out_of_range": np.array([[0, -1, ROWS, 3, ROWS + 7, -2**31, 3],
                                  [3, 2**31 - 1, 0, 0, -5, 39, ROWS]]),
    }


CASES = _cases()


@pytest.mark.parametrize("g", [1, 3, 8, 16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_group_candidates_plain_equals_reference(case, g):
    cand = CASES[case].astype(np.int32)
    slots, items, n = tk.group_candidates_plain(torch.from_numpy(cand),
                                                ROWS, g)
    want_slots, want_items = _reference(cand, ROWS, g)
    np.testing.assert_array_equal(slots.numpy(), want_slots)
    np.testing.assert_array_equal(items.numpy(), want_items)
    assert n.tolist() == [len(want_items)]
    assert slots.dtype == items.dtype == n.dtype == torch.int32


@pytest.mark.parametrize("g", [1, 5, 16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_work_list_covers_each_valid_slot_once(case, g):
    """Every valid slot once, grouped by row (rows ascending), no item over
    g, items tiling the list; invalid ids dropped; the grid's upper bound
    holds."""
    cand = CASES[case].astype(np.int32)
    slots, items, n = tk.group_candidates_plain(torch.from_numpy(cand),
                                                ROWS, g)
    flat = cand.reshape(-1)
    valid = np.nonzero((flat >= 0) & (flat < ROWS))[0]
    assert sorted(slots.tolist()) == valid.tolist()
    rows_of = flat[slots.numpy()]
    assert (np.diff(rows_of) >= 0).all()
    it = items.numpy()
    assert ((it[:, 2] >= 1) & (it[:, 2] <= g)).all()
    assert (it[:, 1] == np.concatenate([[0], np.cumsum(it[:, 2])[:-1]])).all()
    assert it[:, 2].sum() == len(valid)
    for row, first, count, _ in it:
        assert (rows_of[first : first + count] == row).all()
    b, k = cand.shape
    assert int(n) <= tk.max_group_items(b, k, ROWS, g)


def test_group_candidates_rejects_a_group_size_of_zero():
    with pytest.raises(ValueError):
        tk.group_candidates_plain(torch.zeros((1, 2), dtype=torch.int32),
                                  ROWS, 0)


def _db_and_queries(b: int):
    rng = np.random.default_rng(80 + b)
    db = rng.uniform(-3.0, 3.0, (ROWS, 48, 2)).astype(np.float32)
    n = rng.integers(20, 49, ROWS)
    n[4] = 0  # an empty row
    db[np.arange(48)[None, :] >= n[:, None]] = PAD_VALUE
    db[9] = PAD_VALUE  # a tombstone
    q = db[rng.integers(0, ROWS, b), 2:22].copy()
    q += rng.normal(0.0, 0.05, q.shape).astype(np.float32)
    q[b // 2 :] = rng.uniform(-3.0, 3.0, q[b // 2 :].shape)
    return db, q, np.full(b, 20, np.int32)


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("case", ["batch_1", "uneven", "out_of_range",
                                  "k_equals_rows"])
def test_votes_over_the_work_list_equal_the_twin_and_jax(case, aligned):
    """Votes computed item by item over the work list (one row against the
    item's queries, as a grouped block does) == ``match_votes_cand_plain``
    == ``match_jax.match_votes`` on each query's gathered rows; dropped
    slots stay 0."""
    cand = CASES[case].astype(np.int32)
    b, k = cand.shape
    db, q, n_frames = _db_and_queries(b)
    tol = 0.3
    tq, ta, tu = tm.prepare_query(torch.from_numpy(q), n_frames, -1, -1,
                                  trunc_coef1=False)
    tdb = torch.from_numpy(db)
    slots, items, _ = tk.group_candidates_plain(torch.from_numpy(cand), ROWS,
                                                3)
    got = torch.zeros(b * k, dtype=torch.int32)
    for row, first, count, _ in items.tolist():
        s = slots[first : first + count].long()
        qb = s // k
        got[s] = tm.match_votes(tdb[row : row + 1],
                                tdb[row : row + 1, :, 0] != PAD_VALUE,
                                tq[qb], ta[qb], tu[qb], tol, coefs=2,
                                aligned=aligned)[:, 0]
    got = got.reshape(b, k)
    twin = tk.match_votes_cand(tdb, tq, ta, tu, tol, torch.from_numpy(cand),
                               coefs=2, aligned=aligned)
    assert torch.equal(got, twin)
    jq, ja, ju = match_jax.prepare_query(q, n_frames, -1, -1,
                                         trunc_coef1=False)
    valid = (cand >= 0) & (cand < ROWS)
    for i in range(b):
        rows = db[cand[i][valid[i]]]
        want = np.asarray(match_jax.match_votes(
            rows, rows[..., 0] != PAD_VALUE, jq[i : i + 1], ja[i : i + 1],
            ju[i : i + 1], tol, coefs=2, aligned=aligned))[0]
        np.testing.assert_array_equal(got[i][torch.from_numpy(valid[i])],
                                      want)
        assert (got[i][~torch.from_numpy(valid[i])] == 0).all()
    assert (got > 0).any()
