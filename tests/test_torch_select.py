"""K-b (the certified prefilters' candidate selection) and the dialplan
rescore of the port, on the CPU with their plain twins.

``select_candidates_reference`` is held to a numpy statement of the tie
rule (every row above the k-th value v, then rows equal to v in ascending
row order; ``idx`` ascending; the highest bound left out, -1 when none is)
on heavy ties at the threshold, all -1 rows, fewer than k non-negative
rows, k = A, k = 1, values up to 2**31 - 1, spread bounds (96 values), wide
ones (0..10**6: more values than the kernel's histogram has bins) and
INT_MIN and INT_MAX tied at the threshold. The kernel's launch plan
(``select_plan``: cluster size, slice, residency, shared memory) is held to
its rules at the prefilters' shapes, at its switch points (cluster,
cooperative grid, streamed) and at the 62,914,560-row limit.
``rescore_rows_reference`` is held int32 for int32 to JAX's
``_prefilter_core`` formula (the row
gather, ``<= tol`` in float32, the HIGHEST-precision einsum, the context
mask) with NaN rows and values exactly at ``tol``, and the whole selection
and rescore to ``_prefilter_core`` itself at a tie-free k. The kernels
themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiresias_tpu.ops import match_lattice as jml
from tiresias_tpu_torch.ops import match_lattice as tml
from tiresias_tpu_torch.ops.mfcc import PAD_VALUE
from tiresias_tpu_torch.utils import build

INT_MAX = 2**31 - 1


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np_select(bound: np.ndarray, k: int):
    """The tie rule, row by row: v the k-th highest value, every row above
    v, then the first rows equal to v; the rest's maximum, or -1."""
    b, _ = bound.shape
    idx = np.empty((b, k), np.int32)
    rest_max = np.empty(b, np.int32)
    for r in range(b):
        x = bound[r].astype(np.int64)
        v = np.sort(x)[::-1][k - 1]
        above = np.flatnonzero(x > v)
        ties = np.flatnonzero(x == v)[: k - above.size]
        chosen = np.sort(np.concatenate([above, ties]))
        idx[r] = chosen
        rest = np.delete(x, chosen)
        rest_max[r] = rest.max() if rest.size else -1
    return idx, rest_max


def _bounds(kind: str, b: int, a: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(-1, 95, (b, a))
    if kind == "heavy_ties":  # a few values, so the k-th is tied many times
        return rng.integers(-1, 3, (b, a))
    if kind == "all_minus_one":
        return np.full((b, a), -1)
    if kind == "few_non_negative":  # fewer than k rows above -1
        x = np.full((b, a), -1)
        x[:, ::37] = rng.integers(0, 4, x[:, ::37].shape)
        return x
    if kind == "overflow":  # values up to 2**31 - 1, tied at the top
        x = rng.integers(-1, 40, (b, a))
        x[:, ::11] = rng.choice([2045, 2046, 3000, INT_MAX], x[:, ::11].shape)
        return x
    if kind == "int32_range":
        return rng.integers(-1, INT_MAX, (b, a), endpoint=True)
    if kind == "spread":  # 96 values, as a long query's bounds
        return rng.integers(-1, 95, (b, a))
    if kind == "wide":  # more distinct values than the histogram's bins
        return rng.integers(0, 10**6, (b, a), endpoint=True)
    if kind == "extremes":  # INT_MIN and INT_MAX, tied at the threshold
        x = rng.integers(-1, 40, (b, a))
        m = rng.random((b, a))
        x[m < 0.2] = INT_MAX
        x[m > 0.6] = -(2**31)
        return x
    raise ValueError(kind)


KINDS = ["random", "heavy_ties", "all_minus_one", "few_non_negative",
         "overflow", "int32_range", "spread", "wide", "extremes"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", ["1", "mid", "A"])
@pytest.mark.parametrize("b,a", [(1, 300), (4, 1000)])
def test_select_twin_follows_the_tie_rule(kind, k, b, a):
    bound = _bounds(kind, b, a, seed=a + b).astype(np.int32)
    k = {"1": 1, "mid": a // 3, "A": a}[k]
    idx, rest = tml.select_candidates_reference(_t(bound), k)
    want_idx, want_rest = _np_select(bound, k)
    assert idx.dtype == torch.int32 and rest.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(rest.numpy(), want_rest)


# K-b's shapes on the prefilters' paths ([B, A], as SELECT_SHAPES in
# tools/select_timing.py) and the plan each gets: (CTAs a row, None for one
# an SM; cooperative; resident)
PLAN_SHAPES = {(1, 1_000_000): (None, True, True),
               (1, 100_096): (16, False, True),
               (64, 10_112): (2, False, True), (64, 100_096): (2, False, True),
               (1, 62_914_560): (16, False, False)}
# clusters an H100 SXM (132 SMs) holds at once (tiresias_select_max_clusters
# on the card, small CTAs): 4 CTAs 62, 8 CTAs 30, 16 CTAs 14; the 114-SM
# card's are these counts scaled by 114 / 132 (a stand-in: its GPCs differ)
H100_CLUSTERS = {2: 132, 4: 62, 8: 30, 16: 14}
CARDS = {"h100": 132, "h100_114_sms": 114}


def _clusters(sms):
    def count(p):
        return H100_CLUSTERS[p.ctas] * sms // 132 // (2 // p.ctas_per_sm)
    return count


def _plan(b, a, sms=132):
    return tml.select_plan(b, a, sms, _clusters(sms))


def _check_plan(p, rows, sms=132):
    assert p.slice % 4 == 0 and p.slice * p.ctas >= rows
    assert p.slice - 4 < -(-rows // p.ctas)  # the share, rounded up
    assert p.chunk % tml.SELECT_TILE == 0 and 1 <= p.slots <= 8
    assert p.slots * p.chunk >= p.data_elems
    assert p.smem == tml._select_smem(p.cooperative, p.data_elems, p.slots)
    assert p.smem <= tml._SMEM_BLOCK - tml._SMEM_STATIC
    if p.cooperative:  # one CTA an SM, the slice resident
        assert p.resident and p.ctas_per_sm == 1
        assert tml.SELECT_GRID_MIN_CTAS <= p.ctas <= sms
    else:
        assert p.ctas in (2, 4, 8, 16)
    if p.resident:  # the slice and its 16-byte alignment stay in the CTA
        assert p.data_elems == p.slice + 4
        assert -(-p.data_elems // p.chunk) <= p.slots
    else:  # every pass streams it through the ring
        assert (p.slots, p.chunk) == tml.SELECT_RING
        assert p.data_elems == p.slots * p.chunk
        assert tml._select_smem(False, p.slice + 4, 8) > (tml._SMEM_BLOCK
                                                         - tml._SMEM_STATIC)


@pytest.mark.parametrize("shape", list(PLAN_SHAPES), ids=str)
@pytest.mark.parametrize("card", list(CARDS))
def test_select_plan_at_the_prefilters_shapes(shape, card):
    b, a = shape
    sms = CARDS[card]
    p = _plan(b, a, sms)
    _check_plan(p, a, sms)
    ctas, coop, resident = PLAN_SHAPES[shape]
    assert (p.ctas, p.cooperative, p.resident) == (ctas or sms, coop,
                                                  resident)
    # one wave: the card holds every row's CTAs at once (on the smaller
    # card, 57 clusters of 2 large CTAs hold only part of a [64, 100,096]
    # batch: no plan does better, and the plan widens no cluster then)
    if p.cooperative:
        assert b * p.ctas <= sms
    elif card == "h100" or p.ctas > 2:
        assert b <= _clusters(sms)(p)


def test_select_plan_switch_points_and_range():
    """The longest row a cluster holds in shared memory, then the
    cooperative route up to the longest row its slices hold, then the
    streamed clusters; small rows keep >= SELECT_MIN_SLICE rows a CTA,
    never one CTA a row; a batch that leaves fewer than
    SELECT_GRID_MIN_CTAS SMs a row streams; past the limit, or with no
    batch, the plan raises."""
    def last(pred, lo=1, hi=tml.SELECT_MAX_ROWS):
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if pred(_plan(1, mid)) else (lo, mid)
        return lo

    fit = last(lambda p: p.resident and not p.cooperative)
    grid = last(lambda p: p.resident, fit + 1)
    one, two = _plan(1, fit), _plan(1, fit + 1)
    top, past = _plan(1, grid), _plan(1, grid + 1)
    assert one.ctas == 16 and one.resident and not one.cooperative
    assert two.cooperative and top.cooperative and two.ctas == 132
    assert past.ctas == 16 and not past.resident and not past.cooperative
    assert 800_000 < fit < 1_000_000 and 6_000_000 < grid < 8_000_000
    for p, rows in ((one, fit), (two, fit + 1), (top, grid),
                    (past, grid + 1)):
        _check_plan(p, rows)
    for b in (2, 4):  # the card shared between the rows
        p = _plan(b, 1_000_000)
        assert p.cooperative and p.ctas == 132 // b
    for b in (8, 9):  # 16 slices past shared memory; 14 SMs a row
        p = _plan(b, 1_000_000)
        assert not p.cooperative and not p.resident
    for rows in (1, 7, 4097, 10_112, 33_000, 250_000):
        p = _plan(1, rows)
        _check_plan(p, rows)
        assert p.ctas >= 2 and p.resident and not p.cooperative
        assert p.ctas == 2 or p.slice >= tml.SELECT_MIN_SLICE
    assert _plan(3, 1).ctas == 2
    with pytest.raises(ValueError, match="range"):
        _plan(1, tml.SELECT_MAX_ROWS + 1)
    with pytest.raises(ValueError, match="range"):
        _plan(0, 100)


def test_select_ties_at_the_threshold_by_row_order():
    bound = torch.tensor([[5, 9, 9, 9, 1, 0, 9, 2],
                          [-1, 3, -1, 3, 3, -1, -1, -1]], dtype=torch.int32)
    idx, rest = tml.select_candidates(bound, 3)
    assert idx.tolist() == [[1, 2, 3], [1, 3, 4]]
    assert rest.tolist() == [9, -1]  # a 9 is left out; only -1 rows remain
    idx, rest = tml.select_candidates(bound, 4)
    assert idx.tolist() == [[1, 2, 3, 6], [0, 1, 3, 4]]
    assert rest.tolist() == [5, -1]
    idx, rest = tml.select_candidates(bound, 8)
    assert idx.tolist() == [list(range(8))] * 2
    assert rest.tolist() == [-1, -1]  # nothing is left


def test_select_on_the_cpu_is_the_twin_and_counts_no_launch():
    bound = _t(_bounds("heavy_ties", 3, 500, 4).astype(np.int32))
    before = dict(build.LAUNCHES)
    got = tml.select_candidates(bound, 100)
    want = tml.select_candidates_reference(bound, 100)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert build.LAUNCHES == before


def test_wrappers_raise_off_the_cpu_without_a_kernel():
    """A tensor on no CPU goes to the kernel or raises: never the twin."""
    bound = torch.empty((2, 50), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="select_candidates"):
        tml.select_candidates(bound, 8)
    vm = torch.empty((50, 640), dtype=torch.float32, device="meta")
    c = torch.empty((2, 640), dtype=torch.int32, device="meta")
    idx = torch.empty((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="rescore_rows"):
        tml.rescore_rows(vm, c, idx, 0.5)


def _jax_rescore(vm, c, idx, tol, ctx=None, ctx_id=None):
    """``_prefilter_core``'s rescore, line for line."""
    m_rows = jnp.asarray(vm)[jnp.asarray(idx)]
    hits = (m_rows <= jnp.float32(tol)).astype(jnp.float32)
    votes = jnp.einsum("bk,bjk->bj", jnp.asarray(c, jnp.float32), hits,
                       precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)
    if ctx is not None:
        keep = jnp.asarray(ctx) == ctx_id
        votes = jnp.where(keep[jnp.asarray(idx)], votes, 0)
    return np.asarray(votes)


@pytest.mark.parametrize("tol", [0.0, 0.001, 0.5, 1.0, 3.9])
@pytest.mark.parametrize("ctx", [False, True])
def test_rescore_twin_equals_jax_formula(tol, ctx):
    rng = np.random.default_rng(int(tol * 1000) + ctx)
    a, kk, b, k = 300, 640, 5, 48
    vm = rng.uniform(0, 4, (a, kk)).astype(np.float32)
    vm[rng.random((a, kk)) < 0.05] = np.float32(tol)  # exactly at tol
    vm[rng.random((a, kk)) < 0.02] = np.inf
    vm[[7, 123]] = np.nan  # F2: a NaN frame makes its row NaN
    c = rng.integers(0, 9, (b, kk)).astype(np.int32)
    idx = rng.integers(0, a, (b, k)).astype(np.int32)
    idx[:, 0] = 7
    ids = rng.integers(0, 3, a).astype(np.int32) if ctx else None
    got = tml.rescore_rows_reference(
        _t(vm), _t(c), _t(idx), tol, None if ids is None else _t(ids),
        1 if ctx else None)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), _jax_rescore(vm, c, idx, tol, ids, 1 if ctx else None))
    assert (got.numpy()[:, 0] == 0).all()  # the NaN row gets no hit
    np.testing.assert_array_equal(  # the CPU dispatch is the twin
        tml.rescore_rows(_t(vm), _t(c), _t(idx), tol,
                         None if ids is None else _t(ids),
                         1 if ctx else None).numpy(), got.numpy())


def _clustered(seed, n_audios=256, t=64):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-25, 20, size=(n_audios, 1)).astype(np.float32)
    db0 = (mu + rng.normal(0, 1.5, (n_audios, t))).astype(np.float32)
    n_frames = rng.integers(t // 2, t + 1, size=n_audios)
    mask = np.arange(t)[None, :] < n_frames[:, None]
    return np.where(mask, db0, PAD_VALUE).astype(np.float32), mask


@pytest.mark.parametrize("tol", [0.05, 0.5])
@pytest.mark.parametrize("ctx", [False, True])
def test_selection_and_rescore_equal_prefilter_core(tol, ctx):
    """The port's bound scan, selection and rescore against JAX's
    ``_prefilter_core`` per query at a candidate count with no tie at the
    k-th bound: the same rows (JAX's in its own order), the same exact
    votes at each row, the same unselected maximum."""
    db0, mask = _clustered(11 + ctx)
    rng = np.random.default_rng(3)
    f = 48
    q = np.stack([db0[17, :f], db0[200, :f] + 0.2,
                  rng.uniform(-30, 25, f)]).astype(np.float32)
    active = np.ones(q.shape, bool)
    active[0, 30:] = False
    ids = (np.arange(db0.shape[0]) % 3).astype(np.int32)
    vm = jml.build_value_map(jnp.asarray(db0), jnp.asarray(mask))
    vmq = jml.quantize_value_map(vm)
    tvm = tml.build_value_map(_t(db0), _t(mask))
    tvmq = tml.quantize_value_map(tvm)
    scan = tml.dialplan_scan(tol, -np.inf, np.inf, tml.K_MIN, tml.K_SIZE)
    for r in range(q.shape[0]):
        qb, ab = q[r : r + 1], active[r : r + 1]
        bound, c = tml.bound_scan(
            scan, (tvmq,), _t(qb), _t(ab),
            ctx_ids=_t(ids) if ctx else None, ctx_id=2 if ctx else None,
            with_counts=True)
        s = -np.sort(-bound.numpy()[0])
        k = next(k for k in range(16, len(s)) if s[k - 1] != s[k])
        jv, jidx, jun, _ = jml._prefilter_core(
            vm, vmq, jnp.asarray(qb), jnp.asarray(ab), jnp.float32(tol),
            jnp.float32(-np.inf), jnp.float32(np.inf),
            jnp.asarray(ids) if ctx else None, jnp.int32(2) if ctx else None,
            k=k, k_min=tml.K_MIN, k_size=tml.K_SIZE, has_ctx=ctx)
        idx, un = tml.select_candidates(bound, k)
        votes = tml.rescore_rows(tvm, c, idx, tol,
                                 _t(ids) if ctx else None,
                                 2 if ctx else None)
        order = np.argsort(np.asarray(jidx)[0])
        np.testing.assert_array_equal(idx.numpy()[0],
                                      np.asarray(jidx)[0][order])
        np.testing.assert_array_equal(votes.numpy()[0],
                                      np.asarray(jv)[0][order])
        np.testing.assert_array_equal(un.numpy(), np.asarray(jun))
