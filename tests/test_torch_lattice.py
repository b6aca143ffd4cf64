"""PyTorch port's lattice matcher vs the JAX package and the reference oracle.

Everything here is integer or single-rounding arithmetic, so the port must
agree EXACTLY: the distance map bitwise (masked rows, out-of-lattice values,
segment min-combine), the histogram and the votes (band filters, NaN/+-inf
frames), against ``tiresias_tpu.ops.match_lattice`` and
``tiresias_tpu.ops.match_ref.search_reference``. The CUDA kernel K3' runs
only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from tiresias_tpu.ops import match_jax
from tiresias_tpu.ops import match_lattice as jml
from tiresias_tpu.ops.match_ref import search_reference
from tiresias_tpu.store.fingerprint_store import (
    _combine_segment_rows as jax_combine_segment_rows,
)
from tiresias_tpu_torch.ops import match_lattice as tml
from tiresias_tpu_torch.store.fingerprint_store import _combine_segment_rows

torch.set_num_threads(2)


def _db(rng, a=40, t=128, masked_rows=(3, 17)):
    """Speech-like stored max1 values, ragged valid lengths, fully masked
    rows, and out-of-lattice outliers (they bucket at the edge but keep
    their true value)."""
    db0 = rng.normal(-25.0, 18.0, (a, t)).astype(np.float32)
    db0[0, :4] = [-700.0, 300.0, -416.98972, 127.5]
    db0[1, 5] = -512.5
    lens = rng.integers(1, t + 1, a)
    mask = np.arange(t)[None, :] < lens[:, None]
    mask[list(masked_rows)] = False
    db0[~mask] = -1e6  # PAD_VALUE, as the store lays rows out
    return db0, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_value_map_bitwise(seed):
    rng = np.random.default_rng(seed)
    db0, mask = _db(rng)
    ref = np.asarray(jml.build_value_map(db0, mask))
    got = tml.build_value_map(torch.from_numpy(db0), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.isinf(ref[3]).all() and np.isinf(ref[17]).all()


def test_build_value_map_chunked_rows_bitwise(monkeypatch):
    rng = np.random.default_rng(5)
    db0, mask = _db(rng, a=50)
    ref = np.asarray(jml.build_value_map(db0, mask))
    monkeypatch.setattr(tml, "BUILD_CHUNK", 16)
    got = tml.build_value_map(torch.from_numpy(db0), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_value_map_is_brute_force_distance():
    rng = np.random.default_rng(6)
    db0, mask = _db(rng, a=6, t=16, masked_rows=())
    # in-lattice values only: below K_MIN the edge bucket's distance is not
    # a distance in either package (stored values never go below -417)
    db0 = np.clip(db0, -500.0, 300.0)
    got = tml.build_value_map(torch.from_numpy(db0), torch.from_numpy(mask))
    ks = np.arange(tml.K_MIN, tml.K_MIN + tml.K_SIZE, dtype=np.float32)
    for a in range(6):
        vals = db0[a][mask[a]]
        brute = np.abs(vals[None, :] - ks[:, None]).min(axis=1)
        np.testing.assert_array_equal(got[a].numpy(), brute)


def test_segment_rows_min_combine_bitwise():
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    db0, mask = _db(rng, a=12, masked_rows=())
    vm = np.asarray(jml.build_value_map(db0, mask))
    groups = ((2, 3, 4), (8, 9))
    ref = np.asarray(jax_combine_segment_rows(jnp.asarray(vm), groups))
    got = _combine_segment_rows(torch.from_numpy(vm.copy()), groups).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.isinf(got[[3, 4, 9]]).all()


def _queries(rng, b=5, f=94):
    q0 = rng.normal(-25.0, 18.0, (b, f)).astype(np.float32)
    q0[0, :6] = [np.nan, np.inf, -np.inf, -900.0, 500.0, -0.5]
    q0[1, :3] = [127.99, -512.0, -512.01]  # lattice edges
    active = np.ones((b, f), bool)
    active[2, 50:] = False
    return q0, active


def _sparse_queries(rng, b=6, f=94):
    """Real query histograms are sparse: every frame of a query in one or
    two adjacent lattice buckets (a 3 s query lands in 1-3 of 640)."""
    base = rng.uniform(-40.0, 10.0, (b, 1)).astype(np.float32)
    q0 = base + rng.uniform(0.0, 0.9, (b, f)).astype(np.float32)
    q0[0] = base[0, 0] + 0.5  # one bucket
    active = np.ones((b, f), bool)
    active[1, 30:] = False
    active[2] = False  # an all-zero histogram row
    return q0, active


def _long_query(rng, f=17000):
    """One 17,000-frame query: thousands of frames per bucket, past the
    255 a single u8 plane of K3' holds."""
    q0 = rng.normal(-25.0, 2.0, (1, f)).astype(np.float32)
    return q0, np.ones((1, f), bool)


BANDS = [(-1, -1), (100, -1), (-1, 3000), (200, 1000)]
TOLS = [0.001, 0.5, 1.0, 3.0]
QUERIES = {"mixed": _queries, "sparse": _sparse_queries, "long": _long_query}
# the mixed cases keep their original ids ("0.001-band0")
VOTE_CASES = [
    pytest.param(kind, tol, band, id=("" if kind == "mixed" else kind + "-")
                 + f"{tol}-band{i}")
    for kind in QUERIES for tol in TOLS for i, band in enumerate(BANDS)
]


@pytest.mark.parametrize("kind, tol, band", VOTE_CASES)
def test_lattice_votes_exact_vs_jax(kind, tol, band):
    rng = np.random.default_rng(11)
    db0, mask = _db(rng)
    vm = np.array(jml.build_value_map(db0, mask))
    q0, active = QUERIES[kind](rng)
    lo, hi = match_jax.band_thresholds(*band)
    ref = np.asarray(
        jml.lattice_votes(vm, q0, active, np.float32(tol), np.float32(lo),
                          np.float32(hi))
    )
    t_lo, t_hi = tml.band_thresholds(*band)
    got = tml.lattice_votes(
        torch.from_numpy(vm), torch.from_numpy(q0), torch.from_numpy(active),
        tol, t_lo, t_hi,
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    if kind == "long" and band == (-1, -1):
        assert got.max() > 255  # the plane split's case on the card


@pytest.mark.parametrize("band", BANDS)
def test_histogram_exact_vs_jax(band):
    rng = np.random.default_rng(12)
    q0, active = _queries(rng)
    lo, hi = match_jax.band_thresholds(*band)
    ref = np.asarray(jml._histogram(
        q0, active, np.float32(lo), np.float32(hi), jml.K_MIN, jml.K_SIZE
    ))
    got = tml.histogram(
        torch.from_numpy(q0), torch.from_numpy(active),
        *tml.band_thresholds(*band),
    )
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int32))


@pytest.mark.parametrize("band", [(-1, -1), (150, 2500)])
@pytest.mark.parametrize("tol", [0.25, 1.0, 2.0])
def test_lattice_votes_exact_vs_reference_oracle(band, tol):
    """Against the literal per-frame SQL-loop simulation of the reference
    (fp_handler.c:207-408) on per-audio fingerprint lists."""
    rng = np.random.default_rng(13)
    n_audio, t = 16, 64
    db = []
    for _ in range(n_audio):
        n = int(rng.integers(12, t + 1))
        db.append(rng.normal(-25.0, 12.0, (n, 2)).astype(np.float32))
    db0 = np.full((n_audio, t), -1e6, np.float32)
    mask = np.zeros((n_audio, t), bool)
    for a, d in enumerate(db):
        db0[a, : len(d)] = d[:, 0]
        mask[a, : len(d)] = True
    vm = tml.build_value_map(torch.from_numpy(db0), torch.from_numpy(mask))
    for b in range(4):
        query = rng.normal(-25.0, 12.0, (40, 2)).astype(np.float32)
        query[:10] = db[b][:10] + 0.01  # a partial self-match
        ref = search_reference(
            db, query, coefs=1, tolerance=tol, freq_ignore_low=band[0],
            freq_ignore_high=band[1],
        )
        got = tml.lattice_votes(
            vm, torch.from_numpy(query[None, :, 0]),
            torch.ones((1, 40), dtype=torch.bool), tol,
            *tml.band_thresholds(*band),
        )[0].numpy()
        np.testing.assert_array_equal(got, ref.votes)


def test_hit_votes_never_counts_inf_rows():
    counts = torch.zeros((2, tml.K_SIZE), dtype=torch.int32)
    counts[:, 10] = 7
    vm = torch.full((4, tml.K_SIZE), torch.inf)
    vm[1, 10] = 0.0
    vm[2, 10] = float("nan")
    got = tml.hit_votes(counts, vm, 1e30)
    assert got.tolist() == [[0, 7, 0, 0], [0, 7, 0, 0]]


def test_reference_twin_is_hit_matmul():
    rng = np.random.default_rng(14)
    db0, mask = _db(rng)
    vm = np.array(jml.build_value_map(db0, mask))
    q0, active = _queries(rng)
    c = np.asarray(jml._histogram(q0, active, -np.inf, np.inf,
                                  jml.K_MIN, jml.K_SIZE))
    ref = np.asarray(jml._hit_matmul(c, vm, np.float32(1.0)))
    got = tml.lattice_votes_reference(
        torch.from_numpy(c.astype(np.int32)), torch.from_numpy(vm), 1.0
    )
    np.testing.assert_array_equal(got.numpy(), ref)



@pytest.mark.parametrize(
    "max_count, planes",
    [(None, 4), (0, 1), (94, 1), (255, 1), (256, 2), (17000, 2),
     (65535, 2), (65536, 3), (2**24 - 1, 3), (2**24, 4), (2**31 - 1, 4)],
)
def test_count_planes_cover_the_bound(max_count, planes):
    assert tml.count_planes(max_count) == planes
    if max_count is not None:
        assert max_count < 256**planes


def test_count_planes_reject_a_negative_bound():
    with pytest.raises(ValueError):
        tml.count_planes(-1)


@pytest.mark.parametrize("max_count", [None, 17000, 70000])
def test_plane_split_sums_to_the_votes(max_count):
    """K3''s arithmetic in plain torch: counts cut into u8 planes, each
    plane's 0/1-hit products summed in int32 and recombined with wrapping
    shifts give the twin's votes exactly (and ``hit_votes`` on the CPU
    takes the twin whatever the bound)."""
    rng = np.random.default_rng(15)
    vm = torch.from_numpy(rng.uniform(0, 4, (50, 100)).astype(np.float32))
    vm[3] = torch.inf
    vm[4, ::2] = torch.nan
    top = 70000 if max_count is None else max_count
    counts = torch.from_numpy(rng.integers(0, 3, (7, 100)).astype(np.int32))
    counts[0, 5], counts[6, 99] = top, top // 2
    hits = (vm <= 1.0).to(torch.int32)
    votes = torch.zeros((7, 50), dtype=torch.int64)
    for p in range(tml.count_planes(max_count)):
        plane = (counts >> (8 * p)) & 0xFF
        partial = plane.to(torch.int64) @ hits.T.to(torch.int64)
        assert partial.max() <= max(top, 255 * 100)
        votes += partial << (8 * p)
    want = tml.lattice_votes_reference(counts, vm, 1.0)
    assert torch.equal(votes.to(torch.int32), want)
    assert torch.equal(tml.hit_votes(counts, vm, 1.0, max_count), want)
