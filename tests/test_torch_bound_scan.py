"""The port's bound scan (``match_lattice.bound_scan`` and its plain twin
``bound_scan_reference``) against the JAX package's bound stages, on the
CPU, int32 for int32.

Strict/aligned: ``tiresias_tpu.ops.match_lattice.bound_votes`` over the
bound maps of coefficients (0,), (0, 1) and (1, 2), then the context mask
``match_pallas.aligned_prefiltered_votes`` applies. Dialplan:
``_prefilter_core``'s histogram and ``_hit_matmul`` against the quantized
map, then its context mask; the port's histogram output equals JAX's.
Inputs are made with numpy from a seed: NaN, +-inf and out-of-lattice
query frames, frames that bypass coefficient 1 (``use2`` False), dead and
padding rows (the 255 sentinel), tolerances below, at and past the
saturation, and a bucket holding more than 255 frames of one query.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiresias_tpu.ops import match_lattice as jml
from tiresias_tpu_torch.ops import match_lattice as tml
from tiresias_tpu_torch.ops.mfcc import PAD_VALUE

torch.set_num_threads(2)

INF = float("inf")
# thresholds (s * tol + 1) * 64 reach the 255 sentinel at tol 0.74609375
# for s = 4 (coefficient 0) and 0.373046875 for s = 8; the dialplan's
# tol * 64 at 3.984375
STRICT_TOLS = [0.01, 0.1, 0.5, 0.74609375, 2.0]
DIALPLAN_TOLS = [0.001, 0.5, 3.984375, 10.0]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rows(rng, a=150, t=48, c=3):
    """Stored rows in the store layout: PAD past each row's end, two dead
    rows, a clipped and an out-of-lattice value."""
    db = rng.normal(-20.0, 12.0, (a, t, c)).astype(np.float32)
    db[..., 1:] = rng.normal(0.0, 8.0, (a, t, c - 1))
    db[0, :3, 0] = [-417.0, 100.0, -130.0]
    db[1, :3, 1] = [-60.0, 50.0, -40.0]
    n = rng.integers(1, t + 1, a)
    n[[5, 77]] = 0
    mask = np.arange(t)[None, :] < n[:, None]
    db[~mask] = PAD_VALUE
    return db, mask


def _queries(rng, db, b=9, f=300, c=3):
    """Queries near stored rows, with every hazard the bucketing meets: NaN,
    +-inf, huge and out-of-lattice values, inactive frames, coefficient-1
    bypass frames, and query 0 with 290 frames in one bucket."""
    src = db[rng.integers(0, db.shape[0], b)][:, rng.integers(0, 48, f)]
    q = (src + rng.normal(0, 0.05, (b, f, c))).astype(np.float32)
    q[0, :290] = np.float32(3.3)  # > 255 in one bucket: two planes
    q[1, :6, 0] = [np.nan, np.inf, -np.inf, 1e30, -700.0, 200.0]
    q[2, :4, 1] = [np.nan, np.inf, -np.inf, 90.0]
    q[3, :3, 2] = [np.nan, -np.inf, 1e9]
    q[4] = np.nan  # a query with no countable frame
    active = rng.random((b, f)) < 0.9
    active[0, :290] = True
    use2 = rng.random((b, f)) < 0.7
    use2[0, :100] = False  # bypass credit past the lattice count
    return q, active, use2


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(909)
    db, mask = _rows(rng)
    q, active, use2 = _queries(rng, db)
    ctx = rng.integers(0, 3, db.shape[0]).astype(np.int32)
    ctx[[5, 77]] = -1
    return db, mask, q, active, use2, ctx


@pytest.fixture(scope="module")
def strict_maps(case):
    db, mask = case[:2]
    return {
        coefs: (jml.build_bound_maps(jnp.asarray(db), jnp.asarray(mask),
                                     coefs),
                tml.build_bound_maps(_t(db), _t(mask), coefs))
        for coefs in (1, 2, 3)
    }


@pytest.mark.parametrize("ctx_id", [None, 1])
@pytest.mark.parametrize("tol", STRICT_TOLS)
@pytest.mark.parametrize("coefs", [1, 2, 3])
def test_strict_bound_scan_equals_jax(case, strict_maps, coefs, tol, ctx_id):
    """Both the CPU route of ``bound_scan`` (through ``bound_votes``) and
    ``bound_scan_reference`` equal JAX's ``bound_votes`` + context mask."""
    _, _, q, active, use2, ctx = case
    (jspecs, jmaps), (specs, maps) = strict_maps[coefs]
    assert [s[0] for s in specs] == {1: [0], 2: [0, 1], 3: [1, 2]}[coefs]
    want = np.asarray(jml.bound_votes(
        jspecs, jmaps, jnp.asarray(q), jnp.asarray(active),
        jnp.asarray(use2), jnp.float32(tol)))
    ctx_t = None
    if ctx_id is not None:
        want = np.where((ctx == ctx_id)[None, :], want, -1)
        ctx_t = _t(ctx)
    tq, ta, tu = _t(q), _t(active), _t(use2)
    got = tml.bound_votes(specs, maps, tq, ta, tu, tol, ctx_t, ctx_id)
    twin = tml.bound_scan_reference(tml.strict_scan(specs, tol), maps, tq,
                                    ta, tu, ctx_t, ctx_id)
    assert got.dtype == twin.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(twin.numpy(), want)
    if 1 in [s[0] for s in specs]:
        assert (active & ~use2).any()  # the bypass credit is exercised
    if ctx_id is not None:
        assert (want == -1).any() and (want > 0).any()


def _jax_dialplan(vm, vmq, q0, active, tol, band, ctx, ctx_id):
    """``_prefilter_core``'s bound stage: its histogram, ``_hit_matmul``
    against the uint8 map, the context mask."""
    has_ctx = ctx_id is not None
    _, _, _, c = jml._prefilter_core(
        vm, vmq, jnp.asarray(q0), jnp.asarray(active), jnp.float32(tol),
        jnp.float32(band[0]), jnp.float32(band[1]),
        jnp.asarray(ctx if has_ctx else 0),
        jnp.asarray(ctx_id if has_ctx else 0, jnp.int32), k=8,
        k_min=jml.K_MIN, k_size=jml.K_SIZE, has_ctx=has_ctx)
    bound = np.asarray(jml._hit_matmul(c, vmq,
                                       jnp.float32(tol) * float(jml.BOUND_Q)))
    if has_ctx:
        bound = np.where((ctx == ctx_id)[None, :], bound, -1)
    return bound, np.asarray(c)


@pytest.mark.parametrize("ctx_id", [None, 2])
@pytest.mark.parametrize("band", [(-INF, INF), (-30.0, 10.0)])
@pytest.mark.parametrize("tol", DIALPLAN_TOLS)
def test_dialplan_bound_scan_equals_jax(case, tol, band, ctx_id):
    db, mask, q, active, _, ctx = case
    vm = jml.build_value_map(jnp.asarray(db[..., 0]), jnp.asarray(mask))
    vmq = jml.quantize_value_map(vm)
    q0 = np.trunc(q[..., 0])  # the dialplan's truncated max1
    q0[1, :6] = q[1, :6, 0]  # NaN, +-inf and out-of-lattice frames
    want, want_c = _jax_dialplan(vm, vmq, q0, active, tol, band, ctx,
                                 ctx_id)
    scans = tml.dialplan_scan(tol, *band)
    tvmq = _t(np.array(vmq))
    ctx_t = None if ctx_id is None else _t(ctx)
    for fn in (tml.bound_scan, tml.bound_scan_reference):
        got, c = fn(scans, (tvmq,), _t(q0), _t(active), ctx_ids=ctx_t,
                    ctx_id=ctx_id, with_counts=True)
        assert got.dtype == c.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(c.numpy(), want_c.astype(np.int32))
    assert want_c.max() > 255  # query 0's bucket: past one u8 plane
    if tol * jml.BOUND_Q >= jml.BOUND_FAR and ctx_id is None:
        # saturated: a dead row's 255 sentinel passes every counted frame
        assert (want[:, 5] == want_c.sum(axis=1)).all()


def test_bound_scan_counts_and_credit_by_hand():
    """Two frames in one bucket, one NaN frame, one clipped frame and one
    bypass frame, checked by hand on a 2-row map: the reference's bucketing
    (clip keeps NaN, trunc not floor) and the credit."""
    specs = tml.bound_specs(2)  # coefficients 0 (s = 4) and 1 (s = 8)
    scans = tml.strict_scan(specs, 0.1)
    maps = tuple(torch.full((2, sp.k_size), 255, dtype=torch.uint8)
                 for sp in scans)
    # row 0 is near everything; row 1 only at coefficient 0's bucket of
    # trunc(-1.9 * 4) = -7 (floor would give -8)
    maps[0][0] = 0
    maps[1][0] = 0
    maps[0][1, -7 - scans[0].k_min] = 0
    q = torch.tensor([[[-1.9, 0.0], [-1.9, 0.0], [np.nan, 0.0],
                       [500.0, 0.0], [0.0, 9.0]]], dtype=torch.float32)
    active = torch.ones((1, 5), dtype=torch.bool)
    use2 = torch.tensor([[True, True, True, True, False]])
    got, c = tml.bound_scan(scans, maps, q, active, use2, with_counts=True)
    # coefficient 0: the two -1.9 frames (bucket -7), 500 clipped to 40
    # (bucket 160), the bypass frame's 0.0; NaN counts nowhere
    assert int(c.sum()) == 4 and int(c[0, -7 - scans[0].k_min]) == 2
    assert int(c[0, 160 - scans[0].k_min]) == 1
    # row 0: min(4, 4 + 1 credit); row 1: min(2, 0 + 1 credit)
    assert got.tolist() == [[4, 1]]


def test_bound_scan_rejects_mismatched_inputs():
    scans = tml.strict_scan(tml.bound_specs(2), 0.1)
    maps = tuple(torch.zeros((3, sp.k_size), dtype=torch.uint8)
                 for sp in scans)
    q = torch.zeros((1, 4, 2))
    flags = torch.ones((1, 4), dtype=torch.bool)
    with pytest.raises(ValueError):  # one map for two scans
        tml.bound_scan(scans, maps[:1], q, flags, flags)
    with pytest.raises(ValueError):  # coefficient 1 without use2
        tml.bound_scan(scans, maps, q, flags)
