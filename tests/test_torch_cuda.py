"""The port's hand-written CUDA kernels against their plain PyTorch twins.

Needs an NVIDIA GPU (sm_90a) and ``nvcc``; every test is marked ``cuda``
and skips elsewhere. This file imports nothing of JAX, so it runs on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Fingerprints are held to 1e-4 dB where the DCT coefficient has |c| >= 1
and to the same bound scaled by 1/|c| below that (an absolute bound of
~2.3e-5 on c: 10*log10|c| magnifies the float32 summation-order difference
of c near zero). Float32 kernels differ from the twins by ~4e-6 dB; TF32
rounding of the inputs moves values by ~1e-3 dB. K1 and K2 run on the FFT
route for power-of-two windows (64 to 4096 samples) and on the DFT route for
any other; both are held to the same twin. Votes are exact: K3', K4 and K5
must equal their twins int32 for int32.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tiresias_tpu_torch.config import ContextConfig, DspConfig, TiresiasConfig
from tiresias_tpu_torch.ops import match as tm
from tiresias_tpu_torch.ops import match_index as mi
from tiresias_tpu_torch.ops import match_kernels as tk
from tiresias_tpu_torch.ops import match_lattice as ml
from tiresias_tpu_torch.ops import mfcc_kernels as mk
from tiresias_tpu_torch.ops.mfcc import PAD_VALUE
from tiresias_tpu_torch.utils import build
from tiresias_tpu_torch.utils.audio import write_wav

SR = 8000


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _speechlike(rng, n):
    t = np.arange(n) / SR
    f0 = rng.uniform(90, 220)
    sig = sum(
        rng.uniform(0.2, 1.0) / h * np.sin(2 * np.pi * f0 * h * t)
        for h in range(1, 9)
    )
    sig = sig + 0.02 * rng.standard_normal(n)
    return (0.3 * sig / np.abs(sig).max()).astype(np.float32)


def _assert_fp_close(got, want):
    err = (got - want).abs().double()
    c = torch.pow(10.0, want.double() / 10.0)
    bound = 1e-4 * torch.clamp(1.0 / c, min=1.0)
    assert float((err / bound).max()) <= 1.0, float(err.max())


FLOOR_DB = np.float32(10.0) * np.float32(mk.LOG10_FLOOR)


def _dsp(n_fft):
    return DspConfig(buf_size=n_fft, hop_size=n_fft // 2)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 31, 32, 128, 300, 8192])
def test_mfcc_rows_matches_twin(dev, rows):
    """K1 at N = 512 (the FFT route) against its twin; row 0 is digital
    silence and must give the exact floor on coef 1."""
    rng = np.random.default_rng(rows)
    consts = mk.device_constants(DspConfig(), SR, dev)
    frames = rng.standard_normal((rows, 512)).astype(np.float32)
    frames[0] = 0.0  # digital silence: exact floor on coef 1
    frames = torch.from_numpy(frames).to(dev)
    build.reset_launch_counts()
    got = mk.mfcc_rows(frames, consts)
    assert build.LAUNCHES["mfcc_rows"] == 1
    want = mk.mfcc_rows_plain(frames, consts)
    assert got.shape == (rows, 2)
    _assert_fp_close(got, want)
    assert got[0, 1] == want[0, 1] == FLOOR_DB


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 31, 128])
@pytest.mark.parametrize("n_fft", [64, 1024, 4096])
def test_mfcc_rows_fft_window_sizes(dev, n_fft, rows):
    """The FFT route at other power-of-two windows (one, two and three
    radix-8 passes with radix-4 tails), speech-like rows and a silent one."""
    rng = np.random.default_rng(n_fft + rows)
    consts = mk.device_constants(_dsp(n_fft), SR, dev)
    frames = np.stack([_speechlike(rng, n_fft) for _ in range(rows)])
    frames[rows // 2] = 0.0
    frames = torch.from_numpy(frames).to(dev)
    got = mk.mfcc_rows(frames, consts)
    _assert_fp_close(got, mk.mfcc_rows_plain(frames, consts))
    assert got[rows // 2, 1] == FLOOR_DB


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [1, 33, 256, 960])
def test_mfcc_framed_matches_twin_and_rows_route(dev, frames):
    """K2 (FFT route) against its twin and against K1 on the same frames;
    frame counts that are not a multiple of the 32-frame block; the third
    signal is digital silence."""
    rng = np.random.default_rng(frames)
    consts = mk.device_constants(DspConfig(), SR, dev)
    pcm = np.stack([_speechlike(rng, frames * 256) for _ in range(3)])
    pcm[2] = 0.0
    pcm = torch.from_numpy(pcm).to(dev)
    build.reset_launch_counts()
    got = mk.mfcc_framed(pcm, consts, 256, 512)
    assert build.LAUNCHES["mfcc_framed"] == 1
    _assert_fp_close(got, mk.mfcc_framed_plain(pcm, consts, 256, 512))
    rows = mk.frames_from_pcm(pcm, 256, 512).reshape(-1, 512).contiguous()
    _assert_fp_close(got.reshape(-1, 2), mk.mfcc_rows(rows, consts))
    assert (got[2, :, 1] == FLOOR_DB).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,frames", [(64, 37), (1024, 33), (4096, 9)])
def test_mfcc_framed_fft_window_sizes(dev, n_fft, frames):
    rng = np.random.default_rng(n_fft)
    hop = n_fft // 2
    consts = mk.device_constants(_dsp(n_fft), SR, dev)
    pcm = torch.from_numpy(
        np.stack([_speechlike(rng, frames * hop) for _ in range(2)])
    ).to(dev)
    got = mk.mfcc_framed(pcm, consts, hop, n_fft)
    _assert_fp_close(got, mk.mfcc_framed_plain(pcm, consts, hop, n_fft))


@pytest.mark.cuda
def test_mfcc_dft_route_for_other_windows(dev):
    """buf 480 / hop 240 is no power of two: K1 and K2 take the DFT route,
    counted under their own names, and agree with the twins."""
    dsp = DspConfig(buf_size=480, hop_size=240)
    consts = mk.device_constants(dsp, SR, dev)
    assert consts.fft is None
    rng = np.random.default_rng(480)
    pcm = torch.from_numpy(
        np.stack([_speechlike(rng, 41 * 240) for _ in range(2)])
    ).to(dev)
    build.reset_launch_counts()
    got = mk.mfcc_framed(pcm, consts, 240, 480)
    _assert_fp_close(got, mk.mfcc_framed_plain(pcm, consts, 240, 480))
    rows = mk.frames_from_pcm(pcm, 240, 480).reshape(-1, 480).contiguous()
    _assert_fp_close(mk.mfcc_rows(rows, consts),
                     mk.mfcc_rows_plain(rows, consts))
    assert build.LAUNCHES["mfcc_framed_dft"] == 1
    assert build.LAUNCHES["mfcc_rows_dft"] == 1
    assert build.LAUNCHES["mfcc_rows"] == build.LAUNCHES["mfcc_framed"] == 0


def _lattice_case(dev, case, b):
    """Counts [b, K] int32 and a map [301, K] (rows not a multiple of 16;
    rows 7 and 17 +inf, 11 NaN, others with +inf/NaN buckets) for K3'
    against its twin, made with numpy from a seed."""
    rng = np.random.default_rng(b)
    k = {"k100": 100, "k99": 99}.get(case, ml.K_SIZE)
    vm = rng.uniform(0.0, 4.0, (301, k)).astype(np.float32)
    vm[7] = vm[17] = np.inf
    vm[11] = np.nan
    vm[13, ::3] = np.nan
    vm[19, 1::2] = np.inf
    if case in ("dense", "k100", "k99"):
        counts = rng.integers(0, 5, (b, k))
    else:  # real histograms: a query's frames in one or two buckets
        counts = np.zeros((b, k), np.int64)
        for i in range(1, b):  # row 0 stays all zero
            lo = int(rng.integers(0, k - 1))
            counts[i, lo] = rng.integers(1, 94)
            if i % 2:
                counts[i, lo + 1] = rng.integers(1, 94)
        if case == "one_query":
            counts[:] = 0
            counts[b // 2, [200, 201]] = (60, 34)
        if case == "big":  # past one u8 plane, and past two
            counts[0, 300] = 300
            counts[b - 1, k - 1] = 70000
    return (torch.from_numpy(counts.astype(np.int32)).to(dev),
            torch.from_numpy(vm).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense", "sparse", "one_query", "big",
                                  "k100", "k99"])
@pytest.mark.parametrize("b", [1, 5, 64, 70])
def test_lattice_votes_match_twin_exactly(dev, b, case):
    """K3' == its twin int32 for int32: dense and sparse histograms, an
    all-zero row, one query with counts, counts >= 256 and >= 65,536 in a
    bucket (two and three u8 planes), K = 100 and 99 (not multiples of 32;
    99 has unaligned rows), with the tight plane bound and without one."""
    counts, vm = _lattice_case(dev, case, b)
    bound = int(counts.max())
    for tol in (0.001, 0.5, 1.0, 10.0):
        want = ml.lattice_votes_reference(counts, vm, tol)
        for max_count in (bound, None):
            got = ml.hit_votes(counts, vm, tol, max_count)
            assert torch.equal(got, want), (tol, max_count)
        assert (got[:, [7, 11, 17]] == 0).all()
        if case == "sparse":
            assert (got[0] == 0).all()  # the all-zero histogram row


@pytest.mark.cuda
def test_wrappers_count_launches_and_reject_bad_inputs(dev):
    consts = mk.device_constants(DspConfig(), SR, dev)
    build.reset_launch_counts()
    mk.mfcc_rows(torch.zeros((4, 512), device=dev), consts)
    ml.hit_votes(torch.zeros((1, ml.K_SIZE), dtype=torch.int32, device=dev),
                 torch.zeros((128, ml.K_SIZE), device=dev), 1.0)
    db = torch.full((16, 128, 2), PAD_VALUE, device=dev)
    q = torch.zeros((1, 8, 2), device=dev)
    flags = torch.ones((1, 8), dtype=torch.bool, device=dev)
    tk.match_votes_fused(db, q, flags, flags, 0.1, 2)
    # batch 1: the grouped form, each row one work item (its index kernel
    # and, an item of fewer than BITS_MIN_QUERIES queries, the grouped
    # every-pair kernel; no work list); batch 8: the index kernel, then the
    # bit-sliced kernel over the rows it lists; the forced routes: the
    # every-pair and the bit-sliced kernel alone (the latter counted with
    # its work-item launches); the grouped candidate form's forced routes:
    # the bit-sliced kernel and the grouped every-pair kernel alone
    tk.match_votes_fused_aligned(db, q, flags, flags, 0.1, 2)
    q8, flags8 = q.repeat(8, 1, 1), flags.repeat(8, 1)
    tk.match_votes_fused_aligned(db, q8, flags8, flags8, 0.1, 2)
    tk.match_votes_fused_aligned(db, q, flags, flags, 0.1, 2, route="dense")
    tk.match_votes_fused_aligned(db, q, flags, flags, 0.1, 2, route="bits")
    cand = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    for route in ("bits", "dense"):
        tk.match_votes_cand(db, q, flags, flags, 0.1, cand, 2, route=route,
                            aligned=True)
    assert build.LAUNCHES == {"mfcc_rows": 1, "mfcc_framed": 0,
                              "mfcc_rows_dft": 0, "mfcc_framed_dft": 0,
                              "lattice_votes": 1,
                              "bound_scan_planes": 0, "bound_scan": 0,
                              "match_votes": 1, "match_votes_aligned": 1,
                              "match_votes_aligned_dense": 1,
                              "group_candidates": 0,
                              "match_votes_cand": 0,
                              "match_votes_aligned_cand": 1,
                              "match_votes_aligned_cand_dense": 2,
                              "match_votes_cand_per_item": 0,
                              "match_votes_aligned_cand_per_item": 0,
                              "match_votes_aligned_bits": 1,
                              "match_votes_aligned_cand_bits": 2,
                              "select_candidates": 0, "rescore_rows": 0}
    with pytest.raises(ValueError):
        mk.mfcc_rows(torch.zeros((4, 512), device=dev, dtype=torch.float64),
                     consts)
    with pytest.raises(ValueError):
        mk.mfcc_rows(torch.zeros((512, 4), device=dev).T, consts)
    with pytest.raises(ValueError):  # FFT route without its tables
        mk.mfcc_rows(torch.zeros((4, 512), device=dev), tuple(consts[:4]))
    with pytest.raises(ValueError):
        ml.hit_votes(torch.zeros((1, ml.K_SIZE), device=dev),
                     torch.zeros((128, ml.K_SIZE), device=dev), 1.0)
    with pytest.raises(ValueError):  # a CPU query against a card db
        tk.match_votes_fused(db, q.cpu(), flags.cpu(), flags.cpu(), 0.1, 2)
    specs, maps = ml.build_bound_maps(db, flags.new_ones((16, 128)), 2)
    with pytest.raises(ValueError):  # masks on the CPU, queries on the card
        ml.bound_votes(specs, maps, q, flags.cpu(), flags.cpu(), 0.1)
    with pytest.raises(ValueError):  # a float32 map
        ml.bound_scan(ml.dialplan_scan(0.1, -1.0, 1.0, -384, 768),
                      (maps[0].float(),), q[..., 0], flags)
    with pytest.raises(ValueError):
        tk.match_votes_fused(db.double(), q, flags, flags, 0.1, 2)
    with pytest.raises(ValueError):  # K4 has no bit-sliced route
        tk.match_votes_fused(db, q, flags, flags, 0.1, 2, route="bits")
    with pytest.raises(ValueError):  # nor K4's candidate forms
        tk.match_votes_cand(db, q, flags, flags, 0.1, cand, 2, route="bits")


# thresholds of the uint8 maps' tests: below, at and past the saturation
# (255), negative and NaN
U8_THRESHOLDS = (0.0, 0.5, 6.4, 63.99, 64.0, 89.6, 254.0, 254.99, 255.0,
                 300.0, float("inf"), -1.0, float("nan"),
                 ml.bound_threshold(None, 0.5), ml.bound_threshold(8.0, 0.1))


def _scan_case(dev, b, kind):
    """Scans, uint8 maps (rows 7, 11, 17 on the 255 sentinel, row 20 a ramp)
    and queries for bound_scan against its twin, from a seed: NaN, +-inf and
    out-of-lattice frames, inactive and bypass frames, query 0 with more
    than 255 frames in one bucket (two planes; "long": more than 65,535,
    three planes and 32-query tiles, at batch 1), context ids."""
    g = np.random.default_rng(b * 11 + len(kind))
    inf = float("inf")
    rows = 20000 if kind == "many_rows" else 301
    f = 66000 if kind == "long" else 300
    if kind.startswith("strict"):
        scans = ml.strict_scan(ml.bound_specs(int(kind[-1])), 0.1)
        q = g.normal(0.0, 30.0, (b, f, 3)).astype(np.float32)
        q[0, :290] = 3.3
    else:
        k_min, k_size = (-50, 99) if kind == "k99" else (ml.K_MIN, ml.K_SIZE)
        band = (-30.0, 40.0) if kind == "k99" else (-inf, inf)
        scans = ml.dialplan_scan(0.5, *band, k_min, k_size)
        q = g.uniform(k_min - 20, k_min + k_size + 20, (b, f)).astype(
            np.float32)
        # query 0's crowded bucket inside the band
        q[0, : 65600 if kind == "long" else 290] = max(k_min, -30) + 3.7
    q[b - 1, :4] = np.array([np.nan, np.inf, -np.inf, 1e30]).reshape(
        (4,) + (1,) * (q.ndim - 2))
    active = g.random((b, f)) < 0.9
    use2 = g.random((b, f)) < 0.7
    active[0, : 65600 if kind == "long" else 290] = True
    use2[0, :290] = True
    maps = []
    for sp in scans:
        m = g.integers(0, 256, (rows, sp.k_size)).astype(np.uint8)
        m[[7, 11, 17]] = 255
        m[20, :64] = np.arange(64)
        maps.append(torch.from_numpy(m).to(dev))
    ctx = torch.from_numpy(g.integers(0, 3, rows).astype(np.int32)).to(dev)
    return (scans, tuple(maps), torch.from_numpy(q).to(dev),
            torch.from_numpy(active).to(dev), torch.from_numpy(use2).to(dev),
            ctx)


@pytest.mark.cuda
@pytest.mark.parametrize("b,kind", [
    (b, kind) for kind in ("dialplan", "k99", "many_rows", "long", "strict1",
                           "strict2", "strict3")
    for b in (1, 64, 70) if kind != "long" or b == 1])
def test_bound_scan_matches_twin_exactly(dev, b, kind):
    """bound_scan == bound_scan_reference int32 for int32, bound and
    histogram: the dialplan map (640 buckets; 99, unaligned rows, with a
    band; 20,000 rows, where a warp takes several row tiles), the strict
    bound maps of coefficients (0,), (0, 1) and (1, 2) (768 buckets), at
    ``U8_THRESHOLDS``, with and without a context; two launches a scan and
    none of K3'."""
    scans, maps, q, active, use2, ctx = _scan_case(dev, b, kind)
    build.reset_launch_counts()
    calls = 0
    for thr in U8_THRESHOLDS:
        sc = tuple(sp._replace(threshold=thr) for sp in scans)
        for ctx_id in (None, 1):
            ids = None if ctx_id is None else ctx
            want, want_c = ml.bound_scan_reference(sc, maps, q, active, use2,
                                                   ids, ctx_id, True)
            got, got_c = ml.bound_scan(sc, maps, q, active, use2, ids,
                                       ctx_id, True)
            calls += 1
            assert torch.equal(got, want), (thr, ctx_id)
            assert torch.equal(got_c, want_c), (thr, ctx_id)
            if thr < 255 and ctx_id is None and not sc[0].bypass:
                assert (got[:, [7, 11, 17]] == 0).all()
    assert int(want_c.max()) > (65535 if kind == "long" else 255)
    assert build.LAUNCHES["bound_scan_planes"] == calls
    assert build.LAUNCHES["bound_scan"] == calls
    assert build.LAUNCHES["lattice_votes"] == 0


def _match_case(dev, seed, rows, t, c, b, f):
    """Store-layout rows (PAD_VALUE past each end; row 1 empty, row 2 full)
    and noisy excerpt / random queries, made with numpy from a seed."""
    g = np.random.default_rng(seed)
    db = g.uniform(-30.0, 20.0, (rows, t, c)).astype(np.float32)
    n = g.integers(f, t + 1, rows)
    n[1], n[2] = 0, t
    db[np.arange(t)[None, :] >= n[:, None]] = PAD_VALUE
    q = [db[r, 1 : 1 + f] for r in (0, 2, rows - 1)]
    q += [g.uniform(-30.0, 20.0, (f, c)) for _ in range(b - 3)]
    q = np.stack(q).astype(np.float32)
    q += g.normal(0.0, 0.02, q.shape).astype(np.float32)
    n_frames = np.array([f - (i % 3) * 5 for i in range(b)], np.int32)
    return (torch.from_numpy(db).to(dev), torch.from_numpy(q).to(dev),
            n_frames)


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("coefs", [1, 2, 4, 8])
def test_match_kernels_equal_twin_exactly(dev, coefs, aligned):
    """K4/K5 vs the twin, int32 exact, on each route (K5's bit-sliced
    route too, over the index's kept coefficient-1 order, and at tol 1 K5
    against the bit-sliced kernel's plain statement; an index without the
    kept order is refused from two coefficients on): a one-chunk tier, a
    tier of 1,536 frames, one of 5,000 (three index chunks of 2,048, the
    last ragged), a 300-frame query (past one counter fold), band filters
    that drop q0 frames and bypass q1 conditions, and tol 2e5 (every frame
    in every band)."""
    fn = tk.match_votes_fused_aligned if aligned else tk.match_votes_fused
    for rows, t, f in ((200, 256, 24), (300, 1536, 300), (40, 5000, 40)):
        db, q, n_frames = _match_case(dev, coefs + t, rows, t, 8, 5, f)
        index = mi.build_match_index(db)
        for band in ((-1, -1), (1, 300)):
            qq, act, use2 = tm.prepare_query(q, n_frames, *band,
                                             trunc_coef1=False)
            for tol in (0.05, 1.0, 2e5):
                want = tm.match_votes(db, db[..., 0] != PAD_VALUE, qq, act,
                                      use2, tol, coefs=coefs,
                                      aligned=aligned)
                for route in ("auto", "dense", "index") + (
                        ("bits",) if aligned else ()):
                    got = fn(db, qq, act, use2, tol, coefs, index=index,
                             route=route)
                    assert torch.equal(got, want), (t, f, band, tol, route)
                if aligned and coefs > 1:
                    with pytest.raises(ValueError):
                        fn(db, qq, act, use2, tol, coefs, route="bits",
                           index=dataclasses.replace(index, d1=None))
                if aligned and tol == 1.0:
                    assert torch.equal(mi.aligned_votes_bits_plain(
                        index, db, qq, act, use2, tol, coefs), want)
                assert (got[:, 1] == 0).all()  # the empty row
                assert torch.equal(fn(db, qq, act, use2, tol, coefs), want)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 64, 130])
def test_match_kernel_routes_are_counted_and_exact(dev, b):
    """Batches of 1, 64 and 130 queries; at tol 0.05 every item takes the
    index route, at tol 2e5 every K5 item of a row with frames takes the
    wide route (an empty row's items count as index items): the bit-sliced
    kernel serves it from BITS_MIN_QUERIES queries on (below SMALL_BATCH in
    the grouped form over every row), the grouped every-pair kernel below; the
    device counters see both."""
    db, q, n_frames = _match_case(dev, 900 + b, 200, 256, 2, max(b, 3), 24)
    q, n_frames = q[:b], n_frames[:b]
    qq, act, use2 = tm.prepare_query(q, n_frames, -1, -1, trunc_coef1=False)
    index = mi.build_match_index(db)
    empty = int((index.n_live.sum(dim=1) == 0).sum())
    counts = tk.route_counts(dev)
    for tol in (0.05, 2e5):
        for aligned, fn in ((False, tk.match_votes_fused),
                            (True, tk.match_votes_fused_aligned)):
            before = counts.clone()
            got = fn(db, qq, act, use2, tol, 2, index=index)
            torch.cuda.synchronize()
            want = tm.match_votes(db, db[..., 0] != PAD_VALUE, qq, act, use2,
                                  tol, coefs=2, aligned=aligned)
            assert torch.equal(got, want), (tol, aligned)
            moved = (counts - before).tolist()
            index_items, dense_items = moved[2:4] if aligned else moved[:2]
            assert sum(moved[:2] if aligned else moved[2:]) == 0
            if tol == 0.05:
                assert index_items > 0 and dense_items == 0, moved
            elif aligned:
                assert dense_items == b * (200 - empty), moved
                assert index_items == b * empty, moved
                assert moved[4] == (dense_items if b >= tk.BITS_MIN_QUERIES
                                    else 0), moved  # the bit-sliced


def _listed_case(dev, seed, t, c, b, f):
    """Rows and queries for K5's listed launch (the full scan from
    SMALL_BATCH queries on). Every coefficient of a "near" row is N(mu +
    shift, 0.05) dB with mu = -10 + its index, so every band of a near
    query (the same distribution) is wide at tol 0.1 and far ones' are
    empty: 24 rows near all but the last 6 queries, 4 near the last 6's
    first 3, 4 near the fourth, 4 near the last 2 (from 16 queries on, rows
    the index kernel lists with 3, 1 and 2 queries: it lists a row with
    every query where its first 8 queries' bands are wide); 2 uniform rows
    (narrow bands: the index route), row 1 empty, row 2 tombstoned (PAD,
    as the store writes it), rows ragged past a random end, NaN and +-inf
    d0 and d1 in row 3, NaN query values in query 6. Returns db, q,
    n_frames and the near (query, row) pairs, which the index kernel lists
    whatever else it lists."""
    g = np.random.default_rng(seed)
    mu = -10.0 + np.arange(c)
    shifts = [0.0] * 24 + [25.0] * 4 + [-15.0] * 4 + [12.0] * 4
    db = np.stack([g.normal(mu + s, 0.05, (t, c)) for s in shifts]
                  + [g.uniform(-30.0, 20.0, (t, c)) for _ in range(2)])
    ends = g.integers(t // 2, t + 1, len(db))
    ends[:4] = t
    db[np.arange(t)[None, :] >= ends[:, None]] = PAD_VALUE
    db[1] = PAD_VALUE
    db[2] = PAD_VALUE
    db[3, 0:40:5, 0] = np.nan
    db[3, 1:40:5, 0] = np.inf
    db[3, 2:40:5, 0] = -np.inf
    db[3, 3:40:4, 1] = np.nan
    db[3, 4:40:9, 1] = np.inf
    q_shift = [0.0] * (b - 6) + [25.0] * 3 + [-15.0] + [12.0] * 2
    q = np.stack([g.normal(mu + s, 0.05, (f, c)) for s in q_shift])
    q[6, :6, 0] = np.nan
    q[6, 6:9, 1] = np.nan
    n_frames = np.array([f - (i % 3) * 2 for i in range(b)], np.int32)
    near = np.array(shifts + [np.nan] * 2)[None, :] == np.array(
        q_shift)[:, None]
    near[:, [1, 2]] = False
    return (torch.from_numpy(db.astype(np.float32)).to(dev),
            torch.from_numpy(q.astype(np.float32)).to(dev), n_frames,
            torch.from_numpy(near).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("b, t, f, coefs", [
    (8, 256, 24, 2), (64, 256, 24, 2), (128, 256, 24, 2),
    (8, 1536, 300, 1), (8, 1536, 300, 2), (8, 1536, 300, 8),
    (9, 5000, 40, 2), (10, 2048, 300, 2), (11, 256, 24, 8),
    (16, 256, 24, 2)])
def test_listed_full_scan_equals_plain_and_twin(dev, b, t, f, coefs):
    """K5's full scan from SMALL_BATCH queries on: the index kernel lists
    each wide row with its queries and the warp-specialised bit-sliced
    kernel serves the list; its votes equal aligned_votes_bits_plain and
    the twin, int32 for int32. Batches of 8, 64 and 128 on rows whose bands
    are wide at tol 0.1; offset tiles of one, two and three counter words
    a lane (t + f - 1 past 1,152 and 2,176 frames), queries of 300 frames
    (counts folded past 255), three index chunks (5,000 frames), coefs 1, 2
    and 8; rows listed with 1, 2 and 3 queries (a query split over several
    count warps), an empty and a tombstoned row, NaN and +-inf values. One
    launch of each kernel; the bit-sliced kernel serves every item the
    index kernel lists, the near pairs among them, and every frame of them
    that has a band once a tile (a single tile at 256 frames: between the
    near pairs' count from their bands and every pair's)."""
    db, q, n_frames, near = _listed_case(dev, 7 * b + t + f + coefs, t, 8,
                                         b, f)
    listed = int(near.sum())
    qq, act, use2 = tm.prepare_query(q, n_frames, -1, -1, trunc_coef1=False)
    index = mi.build_match_index(db)
    counts = tk.route_counts(dev)
    before = counts.clone()
    build.reset_launch_counts()
    got = tk.match_votes_fused_aligned(db, qq, act, use2, 0.1, coefs,
                                       index=index)
    torch.cuda.synchronize()
    moved = (counts - before).tolist()
    want = tm.match_votes(db, db[..., 0] != PAD_VALUE, qq, act, use2, 0.1,
                          coefs=coefs, aligned=True)
    assert torch.equal(got, want)
    assert torch.equal(mi.aligned_votes_bits_plain(
        index, db, qq, act, use2, 0.1, coefs), want)
    assert (got[:, 1:3] == 0).all() and (got > 0).any()
    assert build.LAUNCHES["match_votes_aligned"] == 1
    assert build.LAUNCHES["match_votes_aligned_bits"] == 1
    assert build.LAUNCHES["match_votes_aligned_cand_bits"] == 0
    assert moved[4] == moved[3] >= listed, moved
    assert moved[5] > 0, moved
    if t + f - 1 <= 1024 + 128:  # one tile: each frame with a band, once
        lo, hi = mi.band_bounds_plain(index, qq[..., 0], 0.1)
        band = (hi - lo)[..., 0]
        wide = band > 32
        go = act[:, :, None] & (band > 0)
        if coefs > 1:
            d1, _, n1 = mi.coef1_order(index)
            lo1, hi1 = mi.band_bounds_plain(dataclasses.replace(
                index, entries=torch.stack([d1, d1], -1),
                n_live=n1.to(torch.int32)), qq[..., 1], 0.1)
            go &= ~(wide & use2[:, :, None] & (hi1 == lo1)[..., 0])
        on_near = go & near[:, None, :]
        assert (int((on_near & wide).sum()) <= moved[5]
                <= int((go & wide).sum())), moved
        assert (int((on_near & ~wide).sum()) <= moved[6]
                <= int((go & ~wide).sum())), moved


@pytest.mark.cuda
def test_match_kernels_exact_at_edge_values(dev):
    """Stored values next to fl(q0 ± tol), ±0.0, ±inf and NaN stored frames,
    ±inf, ±0.0 and huge query values, a row whose frames share one d0; tol
    0, 0.1, 1 and inf, on every route."""
    g = np.random.default_rng(5)
    db = g.uniform(-3, 3, (64, 256, 2)).astype(np.float32)
    db[1] = PAD_VALUE
    db[2, :, 0] = 0.5
    db[3, ::7, 0] = np.inf
    db[3, 1::7, 0] = -np.inf
    db[3, 2::7, 0] = np.nan
    db[3, 3::7, 0] = -0.0
    db[3, 4::7, 0] = 0.0
    q = g.uniform(-3, 3, (6, 40, 2)).astype(np.float32)
    q[0, :10, 0] = [np.inf, -np.inf, 0.0, -0.0, 0.5, np.nan, 1e-8, -1e-8,
                    3e38, -3e38]
    q[1, :, 0] = 0.5
    tol = np.float32(0.1)
    for i in range(20):
        for s, e in enumerate((np.float32(q[2, i, 0] + tol),
                               np.float32(q[2, i, 0] - tol))):
            for k in range(-2, 3):
                d = e
                for _ in range(abs(k)):
                    d = np.nextafter(d, np.float32(np.inf * np.sign(k)))
                db[4 + i, 50 + 5 * s + k + 2, 0] = d
    dbt, qt = torch.from_numpy(db).to(dev), torch.from_numpy(q).to(dev)
    qq, act, use2 = tm.prepare_query(qt, None, -1, -1, trunc_coef1=False)
    index = mi.build_match_index(dbt)
    mask = (dbt[..., 0] != PAD_VALUE) & ~torch.isnan(dbt[..., 0])
    for tol in (0.0, 0.1, 1.0, float("inf")):
        for aligned, fn in ((False, tk.match_votes_fused),
                            (True, tk.match_votes_fused_aligned)):
            want = tm.match_votes(dbt, mask, qq, act, use2, tol, coefs=2,
                                  aligned=aligned)
            for route in ("auto", "dense", "index") + (
                    ("bits",) if aligned else ()):
                got = fn(dbt, qq, act, use2, tol, 2, index=index,
                         route=route)
                assert torch.equal(got, want), (tol, aligned, route)


_CAND_ROUTES = ("auto", "dense", "index", "grouped", "per_item")


def _cand_routes(aligned):
    """The candidate form's routes: K5's also "bits" (the bit-sliced
    kernel on every item of the grouped form)."""
    return _CAND_ROUTES + (("bits",) if aligned else ())


def _cand_launched(name, route, b):
    """Holds the launch counts of one candidate-form call: the grouped form
    (its work list, but for K5 at batch 1, and kernels: K5's index kernel,
    then its wide kernels, each launched where an item may take it: the
    bit-sliced one for items of BITS_MIN_QUERIES queries or more, the
    grouped every-pair kernel for items of fewer, none on the forced route
    "index"; the forced routes "bits" and "dense" run the bit-sliced kernel
    or the grouped every-pair kernel alone) or the per-item form (forced,
    and K4's auto at batch 1; K5's runs its index kernel alone)."""
    aligned = "aligned" in name
    grouped = route != "per_item" and not (
        b == 1 and route == "auto" and not aligned)
    alone = aligned and route in ("dense", "bits")
    form = "" if grouped else "_per_item"
    assert build.LAUNCHES[name + form] == int(not alone)
    assert build.LAUNCHES[name + ("_per_item" if grouped else "")] == 0
    if aligned:  # the grouped form's wide kernels: by the items' queries
        most = min(b, tk.CAND_GROUP["aligned"])  # an item's queries
        fewest = 1 if b > 1 else most
        bits = route == "bits" or (route not in ("dense", "index")
                                   and most >= tk.BITS_MIN_QUERIES)
        dense = route == "dense" or (route not in ("bits", "index")
                                     and fewest < tk.BITS_MIN_QUERIES)
        assert build.LAUNCHES[name + "_dense"] == int(grouped and dense)
        assert build.LAUNCHES[name + "_bits"] == int(grouped and bits)
    assert build.LAUNCHES["group_candidates"] == int(
        grouped and not (aligned and b == 1))


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("b", [1, 7, 64, 130])
def test_match_cand_forms_equal_full_kernels(dev, b, aligned):
    """K4/K5's candidate forms == the full kernel's votes at the same rows
    and == the twin, int32 exact: the grouped form on the auto, forced
    dense, forced index and "grouped" routes (K5's forced "bits" too), and
    the per-item form; K5 also == the bit-sliced kernel's
    plain statement in its grouped form (items of up to 8 queries, or at
    batch 1 each slot an item); duplicate and shared candidates, the empty
    row, padding rows of PAD_VALUE, a tombstoned row, a row with NaN frames,
    ids past the rows and negative ids (0 votes); a one-chunk tier, a
    1,024-frame tier with 200-frame queries at coefs 3 (two query stages in
    the grouped every-pair kernel, rest_close), and a tier of three index
    chunks."""
    full_fn = tk.match_votes_fused_aligned if aligned else tk.match_votes_fused
    name = "match_votes_aligned_cand" if aligned else "match_votes_cand"
    for rows, t, f, coefs in ((200, 256, 24, 2), (300, 1024, 200, 3),
                              (40, 5000, 40, 2)):
        db, q, n_frames = _match_case(dev, 50 + b + t, rows, t, coefs,
                                      max(b, 3), f)
        db[rows - 8 :] = PAD_VALUE  # padding rows
        db[5] = PAD_VALUE  # a tombstone
        db[6, ::7, 0] = float("nan")  # NaN frames never vote
        q, n_frames = q[:b], n_frames[:b]
        qq, act, use2 = tm.prepare_query(q, n_frames, -1, -1,
                                         trunc_coef1=False)
        index = mi.build_match_index(db)
        g = torch.Generator(device=dev).manual_seed(b + t)
        cand = torch.randint(0, rows, (b, 33), generator=g, device=dev,
                             dtype=torch.int32)
        cand[:, :7] = torch.tensor([0, 0, 1, 5, rows - 1, 2, 6], device=dev)
        cand[0, 7] = rows  # past the rows
        cand[-1, 8] = -1
        valid = (cand >= 0) & (cand < rows)
        for tol in (0.05, 1.0):
            full = full_fn(db, qq, act, use2, tol, coefs, index=index)
            want = torch.where(
                valid, full.gather(1, cand.clamp(0, rows - 1).long()), 0)
            for route in _cand_routes(aligned):
                build.reset_launch_counts()
                got = tk.match_votes_cand(db, qq, act, use2, tol, cand, coefs,
                                          index=index, route=route,
                                          aligned=aligned)
                assert torch.equal(got, want), (t, tol, route)
                _cand_launched(name, route, b)
            if aligned:
                assert torch.equal(mi.aligned_votes_bits_plain(
                    index, db, qq, act, use2, tol, coefs, cand=cand), want)
            assert (want[:, 2:4] == 0).all() and (want > 0).any()
            twin = tk.match_votes_cand_plain(db, qq, act, use2, tol, cand,
                                             coefs, aligned)
            assert torch.equal(twin, want)


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("sharing", ["same", "even", "skewed"])
def test_match_cand_grouped_shared_rows(dev, sharing, aligned):
    """64 queries x 1,024 candidates on shared rows: every query on the same
    1,024 rows (each row in 64 lists: 64 / g work items), the slots spread
    evenly over all 1,100 rows, and half of them on 16 rows; the grouped
    form on every route and the per-item form == the full kernel's votes at
    those rows (and the twin, for "same")."""
    full_fn = tk.match_votes_fused_aligned if aligned else tk.match_votes_fused
    rows, b, k = 1100, 64, 1024
    db, q, n_frames = _match_case(dev, 90, rows, 256, 2, b, 128)
    qq, act, use2 = tm.prepare_query(q, n_frames, -1, -1, trunc_coef1=False)
    index = mi.build_match_index(db)
    g = torch.Generator(device=dev).manual_seed(91)
    if sharing == "same":
        cand = torch.randperm(rows, generator=g, device=dev)[:k].repeat(b, 1)
    elif sharing == "even":
        cand = torch.arange(b * k, device=dev).reshape(b, k) % rows
    else:
        cand = torch.randint(0, rows, (b, k), generator=g, device=dev)
        cand[:, : k // 2] = torch.randint(0, 16, (b, k // 2), generator=g,
                                          device=dev)
    cand = cand.to(torch.int32).contiguous()
    tol = 1.0
    want = full_fn(db, qq, act, use2, tol, 2, index=index).gather(
        1, cand.long())
    assert (want > 0).any()
    for route in _cand_routes(aligned):
        got = tk.match_votes_cand(db, qq, act, use2, tol, cand, 2,
                                  index=index, route=route, aligned=aligned)
        assert torch.equal(got, want), route
    if sharing == "same":
        assert torch.equal(tk.match_votes_cand_plain(
            db, qq, act, use2, tol, cand, 2, aligned), want)


@pytest.mark.cuda
def test_match_cand_wide_items_split_by_their_queries(dev):
    """64 queries x 101 candidates at tol 2e5 (every item wide): each query
    alone on a row of its own and all 64 on 100 shared rows (items of 8).
    The index kernel hands the shared rows' items to the bit-sliced kernel
    and the lone queries' items to the grouped every-pair kernel, both in
    one call, counted on the device; votes == the full kernel's."""
    rows, b = 200, 64
    db, q, n_frames = _match_case(dev, 93, rows, 256, 2, b, 24)
    qq, act, use2 = tm.prepare_query(q, n_frames, -1, -1, trunc_coef1=False)
    index = mi.build_match_index(db)
    live = (index.n_live.sum(dim=1) > 0).cpu()
    solo = torch.arange(2, 2 + b, device=dev)[:, None]
    shared = torch.arange(100, 200, device=dev).repeat(b, 1)
    cand = torch.cat([solo, shared], 1).to(torch.int32).contiguous()
    tol = 2e5
    want = tk.match_votes_fused_aligned(db, qq, act, use2, tol, 2,
                                        index=index).gather(1, cand.long())
    counts = tk.route_counts(dev)
    before = counts.clone()
    build.reset_launch_counts()
    got = tk.match_votes_cand(db, qq, act, use2, tol, cand, 2, index=index,
                              aligned=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    moved = (counts - before).tolist()
    n_solo = int(live[2 : 2 + b].sum())
    n_shared = b * int(live[100:200].sum())
    assert moved[3] == n_solo + n_shared, moved  # K5's wide items
    assert moved[4] == n_shared, moved  # of them, the bit-sliced kernel's
    assert build.LAUNCHES["match_votes_aligned_cand_bits"] == 1
    assert build.LAUNCHES["match_votes_aligned_cand_dense"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 8, 16])
def test_group_candidates_kernel_equals_twin(dev, g):
    """The work list on the card == group_candidates_plain: the same items
    (row, first slot, count) and, row by row, the same slots (the kernel's
    order inside a row is the atomics'); batch 1, every query on the same
    rows, uniform, ids past the rows and negative, no candidate at all,
    and 100,096 rows (25 tiles of the scan)."""
    gen = torch.Generator(device=dev).manual_seed(g)
    cases = [
        (torch.randperm(10112, generator=gen, device=dev)[:1024][None],
         10112),
        (torch.randperm(10112, generator=gen, device=dev)[:1024].repeat(
            64, 1), 10112),
        (torch.randint(-3, 10115, (64, 1024), generator=gen, device=dev),
         10112),
        (torch.zeros((64, 0), dtype=torch.int64, device=dev), 10112),
        (torch.randint(0, 100096, (64, 1024), generator=gen, device=dev),
         100096),
    ]
    for cand, rows in cases:
        cand = cand.to(torch.int32).contiguous()
        build.reset_launch_counts()
        slots, items, n = tk.group_candidates(cand, rows, g)
        assert build.LAUNCHES["group_candidates"] == 1
        ps, pi, pn = tk.group_candidates_plain(cand.cpu(), rows, g)
        n = int(n)
        assert n == int(pn) and items.shape[0] >= n
        assert torch.equal(items[:n].cpu(), pi)
        ks = slots[: ps.numel()].cpu().long()
        flat = cand.reshape(-1).cpu().long()
        assert torch.equal(flat[ks], flat[ps.long()])
        key = flat[ks] * max(flat.numel(), 1) + ks
        assert torch.equal(ks[torch.argsort(key)], ps.long())


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [False, True])
def test_prefilters_on_card_equal_full_scans(dev, aligned):
    """The certified prefilters on the card: certified answers' top-1 (votes
    and lowest row) equal the full scan's, for the dialplan lattice and the
    strict bag / aligned search."""
    g = np.random.default_rng(3)
    rows, t = 3000, 128
    mu = g.uniform(-25, 20, (rows, 1, 1)).astype(np.float32)
    db = (mu + g.normal(0, 1.5, (rows, t, 2))).astype(np.float32)
    n = g.integers(t // 2, t + 1, rows)
    db[np.arange(t)[None, :] >= n[:, None]] = PAD_VALUE
    db = torch.from_numpy(db).to(dev)
    mask = db[..., 0] != PAD_VALUE
    q = db[torch.arange(64, device=dev) * 40, 2:50].clone()
    q[:, :, 1] += 0.01
    nf = np.full(64, 48)
    qq, act, use2 = tm.prepare_query(q, nf, -1, -1, trunc_coef1=False)
    specs, maps = ml.build_bound_maps(db, mask, 2)
    votes, cert = tk.aligned_prefiltered_votes(
        db, maps, qq, act, use2, 0.1, specs=specs, coefs=2, k=256,
        aligned=aligned, index=mi.build_match_index(db))
    fn = tk.match_votes_fused_aligned if aligned else tk.match_votes_fused
    full = fn(db, qq, act, use2, 0.1, 2)
    assert cert.float().mean() > 0.5
    cols = torch.arange(rows, device=dev)

    def top1(v):  # (votes, lowest row among the maxima)
        m = v.max(dim=1).values
        return m, torch.where(v == m[:, None], cols, rows).min(dim=1).values

    for got, want in zip(top1(votes), top1(full)):
        assert torch.equal(got[cert], want[cert])
    vm = ml.build_value_map(db[..., 0], mask)
    q0 = torch.trunc(q[..., 0]) + 0.3
    valid = torch.ones_like(act)
    lv, lc = ml.lattice_prefiltered_votes(vm, ml.quantize_value_map(vm), q0,
                                          valid, 0.5, float("-inf"),
                                          float("inf"))
    lf = ml.lattice_votes(vm, q0, valid, 0.5, float("-inf"), float("inf"))
    assert lc.any()
    assert torch.equal(lv.max(dim=1).values[lc], lf.max(dim=1).values[lc])


@pytest.mark.cuda
def test_prefilters_take_bound_scan(dev):
    """Both prefilters reach their bound through bound_scan, two launches a
    scan, context mask included, and never through K3'; the bounds equal
    the CPU twin's."""
    g = np.random.default_rng(5)
    rows, t = 600, 64
    db = g.normal(-20.0, 12.0, (rows, t, 2)).astype(np.float32)
    db[:, 50:] = PAD_VALUE
    db = torch.from_numpy(db).to(dev)
    mask = db[..., 0] != PAD_VALUE
    q = (db[:8, 3:40] + 0.02).contiguous()
    qq, act, use2 = tm.prepare_query(q, None, -1, -1, trunc_coef1=False)
    specs, maps = ml.build_bound_maps(db, mask, 2)
    ctx = torch.arange(rows, device=dev, dtype=torch.int32) % 3
    index = mi.build_match_index(db)
    build.reset_launch_counts()
    for aligned in (False, True):
        tk.aligned_prefiltered_votes(db, maps, qq, act, use2, 0.1,
                                     specs=specs, coefs=2, k=64, ctx_ids=ctx,
                                     ctx_id=1, aligned=aligned, index=index)
    vm = ml.build_value_map(db[..., 0], mask)
    vmq = ml.quantize_value_map(vm)
    ml.lattice_prefiltered_votes(vm, vmq, torch.trunc(qq[..., 0]), act, 0.5,
                                 float("-inf"), float("inf"), k=64,
                                 ctx_ids=ctx, ctx_id=1)
    assert build.LAUNCHES["bound_scan_planes"] == 3
    assert build.LAUNCHES["bound_scan"] == 3
    assert build.LAUNCHES["lattice_votes"] == 0
    got = ml.bound_votes(specs, maps, qq, act, use2, 0.1, ctx, 1)
    want = ml.bound_votes(specs, tuple(m.cpu() for m in maps), qq.cpu(),
                          act.cpu(), use2.cpu(), 0.1, ctx.cpu(), 1)
    assert torch.equal(got.cpu(), want) and (want == -1).any()


def _select_bounds(kind, b, a, g):
    if kind == "random":
        return g.integers(-1, 95, (b, a))
    if kind == "heavy_ties":
        return g.integers(-1, 3, (b, a))
    if kind == "all_minus_one":
        return np.full((b, a), -1)
    if kind == "few_non_negative":
        x = np.full((b, a), -1)
        x[:, ::97] = g.integers(0, 5, x[:, ::97].shape)
        return x
    if kind == "overflow":  # past the kernel's histogram: the radix path
        x = g.integers(-1, 50, (b, a))
        x[:, ::13] = g.choice([2044, 2045, 3000, 2**31 - 1],
                              x[:, ::13].shape)
        return x
    if kind == "int32_range":
        return g.integers(-2**31, 2**31 - 1, (b, a), endpoint=True)
    if kind == "spread":  # 96 values, as chip_smoke's [64, 100,096] bounds
        return g.integers(-1, 95, (b, a))
    if kind == "wide":  # more values than bins: the refinement passes
        return g.integers(0, 10**6, (b, a), endpoint=True)
    if kind == "extremes":  # INT_MIN and INT_MAX tied at the threshold
        x = g.integers(-1, 50, (b, a))
        m = g.random((b, a))
        x[m < 0.02] = 2**31 - 1
        x[m > 0.98] = -2**31
        return x
    raise ValueError(kind)


SELECT_KINDS = ["random", "heavy_ties", "all_minus_one", "few_non_negative",
                "overflow", "int32_range", "spread", "wide", "extremes"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SELECT_KINDS)
@pytest.mark.parametrize("b,a", [(1, 1), (1, 7), (3, 4097), (64, 10112),
                                 (1, 100096), (2, 1000000)])
def test_select_kernel_equals_twin_bitwise(dev, kind, b, a):
    """K-b: the kernel's rows and unselected maximum bit for bit equal to
    the twin's, at k = 1, 256, 1,024 and A (ties at the threshold, -1 rows,
    values up to 2**31 - 1 and below -1, spread and wide bounds, INT_MIN
    and INT_MAX at the threshold)."""
    g = np.random.default_rng(a + b)
    bound = torch.from_numpy(_select_bounds(kind, b, a, g).astype(
        np.int32)).to(dev)
    for k in sorted({1, min(a, 256), min(a, 1024), a}):
        build.reset_launch_counts()
        idx, rest = ml.select_candidates(bound, k)
        torch.cuda.synchronize()
        assert build.LAUNCHES["select_candidates"] == 1
        want_idx, want_rest = ml.select_candidates_reference(bound, k)
        assert idx.dtype == torch.int32 and rest.dtype == torch.int32
        assert torch.equal(idx, want_idx), (kind, k)
        assert torch.equal(rest, want_rest), (kind, k)


def _select_plan(b, a):
    return ml._device_plan(torch.cuda.current_device(), b, a)[0]


def _select_switch_rows():
    """The longest row a cluster holds in shared memory, and the longest
    the cooperative route holds (the next streams)."""
    def last(pred, lo=1, hi=ml.SELECT_MAX_ROWS):
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if pred(_select_plan(1, mid)) else (lo, mid)
        return lo

    fit = last(lambda p: p.resident and not p.cooperative)
    return fit, last(lambda p: p.resident, fit + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("route", [
    "largest resident", "first cooperative", "largest cooperative",
    "first streamed", "streamed batch 16", "cooperative batch 4",
    "clusters of 8", "clusters of 4", "offset view",
    "offset view cooperative"])
@pytest.mark.parametrize("kind", ["random", "overflow", "extremes", "wide"])
def test_select_kernel_at_the_switch_points(dev, route, kind):
    """K-b on each side of its plan's switch points (the longest row a
    cluster holds in shared memory, the cooperative route from the next
    row to its longest, the first streamed row, the cluster sizes between,
    a batch that shares the card and one that streams) and on bounds whose
    rows start off 16 bytes: bitwise equal to the twin, one launch a
    call."""
    fit, grid = _select_switch_rows()
    b, a = {"largest resident": (1, fit), "first cooperative": (1, fit + 1),
            "largest cooperative": (1, grid), "first streamed": (1, grid + 1),
            "streamed batch 16": (16, 1_000_000),
            "cooperative batch 4": (4, 1_000_000),
            "clusters of 8": (1, 10_112), "clusters of 4": (3, 4097),
            "offset view": (5, 10_113),
            "offset view cooperative": (1, 1_000_001)}[route]
    g = np.random.default_rng(a + len(kind))
    x = _select_bounds(kind, b, a, g).astype(np.int32)
    if route == "cooperative batch 4":  # rows that refine to other depths
        for r, other in enumerate(("wide", "int32_range", "heavy_ties"), 1):
            x[r] = _select_bounds(other, 1, a, g)[0]
    if route.startswith("offset view"):  # row starts at 4 (mod 16) bytes
        flat = torch.from_numpy(np.concatenate([[7], x.ravel()]).astype(
            np.int32)).to(dev)
        bound = flat[1:].view(b, a)
    else:
        bound = torch.from_numpy(x).to(dev)
    p = _select_plan(b, a)
    want_plan = {"largest resident": (16, False, True),
                 "first streamed": (16, False, False),
                 "streamed batch 16": (16, False, False),
                 "clusters of 8": (8, False, True),
                 "clusters of 4": (4, False, True)}.get(route)
    assert want_plan is None or (p.ctas, p.cooperative,
                                 p.resident) == want_plan
    if "cooperative" in route:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert p.cooperative and p.ctas == sms // b
    for k in (1, 256, 1024):
        build.reset_launch_counts()
        idx, rest = ml.select_candidates(bound, k)
        torch.cuda.synchronize()
        assert build.LAUNCHES["select_candidates"] == 1
        want_idx, want_rest = ml.select_candidates_reference(bound, k)
        assert torch.equal(idx, want_idx), (route, kind, k)
        assert torch.equal(rest, want_rest), (route, kind, k)


@pytest.mark.cuda
@pytest.mark.parametrize("b,a", [(64, 10112), (1, 100096), (64, 100096),
                                 (1, 1000000)])
def test_select_is_one_launch_of_one_kernel(dev, b, a):
    """One select_candidates call is one kb_select kernel: no memset, topk
    or sort kernel, no second launch (the profiler's device events)."""
    g = np.random.default_rng(b)
    bound = torch.from_numpy(_select_bounds("overflow", b, a, g).astype(
        np.int32)).to(dev)
    ml.select_candidates(bound, 256)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ml.select_candidates(bound, 256)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    names = [e.name for e in kernels]
    assert len(names) == 3 and all("kb_select" in n for n in names), names
    assert not any(w in n.lower() for n in names
                   for w in ("memset", "memcpy", "topk", "sort"))


@pytest.mark.cuda
@pytest.mark.parametrize("ctx", [False, True])
@pytest.mark.parametrize("b,k,kk", [(64, 256, 640), (1, 256, 640),
                                    (3, 1024, 640), (5, 13, 37)])
def test_rescore_kernel_equals_twin_bitwise(dev, ctx, b, k, kk):
    """The dialplan rescore: int32-equal to the twin with NaN rows, +inf,
    values exactly at tol, the context mask, and a K that is no multiple
    of 4 (the scalar loads)."""
    g = np.random.default_rng(b * k + kk + ctx)
    a, tol = 10112, 0.5
    vm = g.uniform(0, 3, (a, kk)).astype(np.float32)
    vm[g.random((a, kk)) < 0.05] = np.float32(tol)
    vm[g.random((a, kk)) < 0.01] = np.inf
    vm[g.integers(0, a, 9)] = np.nan
    vm = torch.from_numpy(vm).to(dev)
    counts = torch.from_numpy(g.integers(0, 6, (b, kk)).astype(
        np.int32)).to(dev)
    idx = torch.from_numpy(g.integers(0, a, (b, k)).astype(np.int32)).to(dev)
    ids = (torch.from_numpy(g.integers(0, 3, a).astype(np.int32)).to(dev)
           if ctx else None)
    build.reset_launch_counts()
    got = ml.rescore_rows(vm, counts, idx, tol, ids, 1 if ctx else None)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rescore_rows"] == 1
    want = ml.rescore_rows_reference(vm, counts, idx, tol, ids,
                                     1 if ctx else None)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_prefilters_launch_select_and_rescore(dev):
    """Every prefilter selects through the K-b kernels, the dialplan one
    rescores through rescore_rows, with no torch.topk in the selection;
    bad inputs raise."""
    g = np.random.default_rng(9)
    rows, t = 700, 64
    db = g.normal(-20.0, 12.0, (rows, t, 2)).astype(np.float32)
    db[:, 50:] = PAD_VALUE
    db = torch.from_numpy(db).to(dev)
    mask = db[..., 0] != PAD_VALUE
    q = (db[:8, 3:40] + 0.02).contiguous()
    qq, act, use2 = tm.prepare_query(q, None, -1, -1, trunc_coef1=False)
    specs, maps = ml.build_bound_maps(db, mask, 2)
    ctx = torch.arange(rows, device=dev, dtype=torch.int32) % 3
    build.reset_launch_counts()
    for aligned in (False, True):
        tk.aligned_prefiltered_votes(db, maps, qq, act, use2, 0.1,
                                     specs=specs, coefs=2, k=64, ctx_ids=ctx,
                                     ctx_id=1, aligned=aligned,
                                     index=mi.build_match_index(db))
    assert build.LAUNCHES["select_candidates"] == 2
    assert build.LAUNCHES["rescore_rows"] == 0
    vm = ml.build_value_map(db[..., 0], mask)
    vmq = ml.quantize_value_map(vm)
    q0 = torch.trunc(qq[..., 0])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = ml.lattice_prefiltered_votes(vm, vmq, q0, act, 0.5,
                                           float("-inf"), float("inf"),
                                           k=64, ctx_ids=ctx, ctx_id=1)
        torch.cuda.synchronize()
    assert not any("topk" in e.key.lower() or "sort" in e.key.lower()
                   for e in prof.key_averages())
    assert build.LAUNCHES["select_candidates"] == 3
    assert build.LAUNCHES["rescore_rows"] == 1
    want = ml.lattice_prefiltered_votes(
        vm.cpu(), vmq.cpu(), q0.cpu(), act.cpu(), 0.5, float("-inf"),
        float("inf"), k=64, ctx_ids=ctx.cpu(), ctx_id=1)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    bound = torch.zeros((2, 50), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        ml.select_candidates(bound.long(), 8)
    with pytest.raises(ValueError):
        ml.select_candidates(bound, 51)
    with pytest.raises(ValueError):
        ml.select_candidates(bound.t(), 1)
    with pytest.raises(ValueError):
        ml.rescore_rows(vm, torch.zeros((2, 640), dtype=torch.int32,
                                        device=dev),
                        torch.zeros((2, 8), dtype=torch.int64, device=dev),
                        0.5)


@pytest.mark.cuda
def test_aligned_long_query_takes_the_dense_kernel(dev):
    """A 30,000-frame query's offset histogram does not fit in the index
    kernel's shared memory: K5 runs only its bit-sliced kernel (offset tiles
    of 3,200, counts folded every 255 frames), held to a numpy brute force,
    as is the forced every-pair route; the forced index route and K5's
    per-item candidate form raise, and the grouped candidate form runs the
    bit-sliced kernel alone (the grouped every-pair kernel only on its
    forced route "dense"), equal."""
    db, _, _ = _match_case(dev, 77, 8, 256, 2, 3, 24)
    q = db[3:4, torch.arange(30000, device=dev) % 20].clone() + 0.01
    qq, act, use2 = tm.prepare_query(q, None, -1, -1, trunc_coef1=False)
    build.reset_launch_counts()
    got = tk.match_votes_fused_aligned(db, qq, act, use2, 1.0, 2)
    assert build.LAUNCHES["match_votes_aligned_cand_bits"] == 1
    assert build.LAUNCHES["match_votes_aligned_bits"] == 0
    assert build.LAUNCHES["match_votes_aligned"] == 0
    assert build.LAUNCHES["match_votes_aligned_dense"] == 0
    assert torch.equal(got, tk.match_votes_fused_aligned(
        db, qq, act, use2, 1.0, 2, route="dense"))
    with pytest.raises(ValueError):
        tk.match_votes_fused_aligned(db, qq, act, use2, 1.0, 2,
                                     route="index")
    cand = torch.arange(8, device=dev, dtype=torch.int32)[None]
    build.reset_launch_counts()
    assert torch.equal(tk.match_votes_cand(
        db, qq, act, use2, 1.0, cand, 2, route="grouped", aligned=True), got)
    assert build.LAUNCHES["match_votes_aligned_cand_bits"] == 1
    assert build.LAUNCHES["match_votes_aligned_cand_dense"] == 0
    assert build.LAUNCHES["match_votes_aligned_cand"] == 0
    assert torch.equal(tk.match_votes_cand(
        db, qq, act, use2, 1.0, cand, 2, route="dense", aligned=True), got)
    with pytest.raises(ValueError):
        tk.match_votes_cand(db, qq, act, use2, 1.0, cand, 2,
                            route="per_item", aligned=True)
    d = db.cpu().numpy()
    qn = q[0].cpu().numpy()
    want = []
    for a in range(d.shape[0]):
        live = d[a, :, 0] != PAD_VALUE
        ok = ((np.abs(d[a, None, :, 0] - qn[:, None, 0]) <= np.float32(1.0))
              & (np.abs(d[a, None, :, 1] - qn[:, None, 1]) <= np.float32(1.0))
              & live[None, :])
        f, t = np.nonzero(ok)
        want.append(np.bincount(t - f + len(qn) - 1).max(initial=0))
    assert got[0].tolist() == want and max(want) > 0


@pytest.mark.cuda
def test_engine_on_card_agrees_with_cpu(dev, tmp_path):
    from tiresias_tpu_torch.api import Tiresias

    rng = np.random.default_rng(0)
    media = tmp_path / "media"
    os.makedirs(media)
    sigs = [_speechlike(rng, int(s * SR)) for s in (3.0, 5.0, 8.0, 8.0)]
    for i, s in enumerate(sigs):
        write_wav(str(media / f"t{i}.wav"), s, SR)
    cfg = TiresiasConfig(contexts=(ContextConfig("media", str(media)),),
                         data_dir=str(tmp_path / "data"))
    eng = Tiresias(cfg, device=dev)
    assert eng.sync().created == 4
    eng.close()
    gpu = Tiresias(cfg, device=dev, exclusive=False)
    cpu = Tiresias(cfg, device="cpu", exclusive=False)
    queries = [s[256 * 3 : 256 * 3 + 24064] for s in sigs]
    got = gpu.search_pcm_batch(None, queries, SR, tolerance=1.0)
    want = cpu.search_pcm_batch(None, queries, SR, tolerance=1.0)
    assert [(r.status, r.name) for r in got] == [
        (r.status, r.name) for r in want]
    assert all(r.found and r.match_count >= r.frame_count - 1 for r in got)
    # strict and aligned modes from the SAME query fingerprints: the match
    # stage on the card (K4/K5) gives the CPU's TIR* exactly
    from tiresias_tpu_torch.ops.mfcc import (
        fingerprint_padded_batch,
        pad_frames_bucket,
    )

    padded, n_frames = pad_frames_bucket(queries, 256)
    qfp = fingerprint_padded_batch(padded, SR, cfg.dsp, device="cpu")
    for kw in ({"aligned": False}, {"aligned": True},
               {"aligned": True, "min_margin": 0.2}):
        args = (n_frames, 0.1, -1, -1, None)
        opts = dict(coefs=2, trunc_coef1=False, **kw)
        on_card = gpu._match(qfp.to(dev), *args, **opts)
        on_cpu = cpu._match(qfp, *args, **opts)
        assert [r.to_channel_vars() for r in on_card] == [
            r.to_channel_vars() for r in on_cpu]
        if "min_margin" not in kw:
            assert all(r.found for r in on_card)


def _corpus_engines(dev, tmp_path, lengths=(3.0, 5.0, 8.0, 8.0, 4.0, 3.0)):
    """An engine on the card and one on the CPU over one checkpoint; the
    third and fourth tracks are the same audio under two names (a tie)."""
    from tiresias_tpu_torch.api import Tiresias

    rng = np.random.default_rng(1)
    cfg = TiresiasConfig(data_dir=str(tmp_path / "data"))
    eng = Tiresias(cfg, device=dev)
    eng.create_context("m")
    sigs = [_speechlike(rng, int(s * SR)) for s in lengths]
    sigs[3] = sigs[2]
    for i, s in enumerate(sigs):
        q = np.clip(np.round(s * 32768.0), -32768, 32767).astype(np.int16)
        sigs[i] = q
        assert eng.add_audio_pcm("m", f"t{i}", q, SR, file_hash=f"h{i}")
    eng.close()
    return (Tiresias(cfg, device=dev, exclusive=False),
            Tiresias(cfg, device="cpu", exclusive=False), sigs)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [
    {"coefs": 1, "tolerance": 1.0},
    {"coefs": 2, "trunc_coef1": False, "tolerance": 0.1},
    {"coefs": 2, "trunc_coef1": False, "aligned": True, "tolerance": 0.1},
], ids=["dialplan", "strict", "aligned"])
def test_topk_on_card_equals_cpu(dev, tmp_path, monkeypatch, mode):
    """Ranked top-k from the SAME query fingerprints: votes (K3', K4, K5),
    order and names on the card equal the CPU twins', ties included, in a
    two-view store."""
    from tiresias_tpu_torch.api import engine as tengine
    from tiresias_tpu_torch.ops.mfcc import fingerprint_padded_batch

    gpu, cpu, sigs = _corpus_engines(dev, tmp_path)
    assert len(gpu.store.search_views()) == 2

    def shared_fp(padded, samplerate, dsp, law=None, n_valid=None,
                  device="cpu"):
        out = fingerprint_padded_batch(padded, samplerate, dsp, law=law,
                                       n_valid=n_valid, device="cpu")
        return out.to(device)

    monkeypatch.setattr(tengine, "fingerprint_padded_batch", shared_fp)
    build.reset_launch_counts()
    for s in sigs:
        q = s[256 * 3 : 256 * 3 + 24000]
        for k in (1, 3, 64):
            got = gpu.search_pcm_topk("m", q, SR, k=k, **mode)
            want = cpu.search_pcm_topk("m", q, SR, k=k, **mode)
            assert [(r.name, r.match_count, r.frame_count) for r in got] == [
                (r.name, r.match_count, r.frame_count) for r in want]
            assert got and len(got) <= k
    # t2 and t3 hold the same audio: equal votes, listed in insertion order
    # (one truncated coefficient ties every track; bag votes most of them)
    listing = gpu.search_pcm_topk("m", sigs[2][768:24768], SR, k=6, **mode)
    names = [r.name for r in listing]
    votes = {r.name: r.match_count for r in listing}
    assert votes["t2"] == votes["t3"] and names.index("t2") < names.index("t3")
    for r1, r2 in zip(listing, listing[1:]):
        assert r1.match_count > r2.match_count or (
            r1.match_count == r2.match_count and r1.name < r2.name)
    # a batch-1 aligned search runs as the grouped form over every row
    name = ("lattice_votes" if mode["coefs"] == 1 else
            "match_votes_aligned_cand" if mode.get("aligned") else
            "match_votes")
    assert build.LAUNCHES[name] > 0


@pytest.mark.cuda
def test_server_round_trip_on_card(dev, tmp_path):
    """Eight channels over a real socket against an engine on the card:
    every TIR* equals the direct batch search, through K1 and K3'."""
    import asyncio
    import base64
    import json
    import socket
    import threading

    from tiresias_tpu_torch.serve.server import RecognitionServer
    from tiresias_tpu_torch.utils.tracing import metrics

    gpu, _, sigs = _corpus_engines(dev, tmp_path)
    gpu.warmup_async(laws=("ulaw",)).join()
    started, holder = threading.Event(), {}

    def runner():
        async def main():
            srv = RecognitionServer(gpu, port=0, samplerate=SR)
            await srv.start()
            holder["srv"], holder["loop"] = srv, asyncio.get_running_loop()
            started.set()
            try:
                await srv.serve_forever()
            except asyncio.CancelledError:
                pass

        asyncio.run(main())

    threading.Thread(target=runner, daemon=True).start()
    assert started.wait(30)
    windows = [sigs[i % len(sigs)][512 : 512 + 16000] for i in range(8)]
    errors0 = metrics.snapshot()["counters"].get("serve.search_errors", 0)
    build.reset_launch_counts()
    results = {}
    try:
        with socket.create_connection(("127.0.0.1", holder["srv"].port),
                                      timeout=120) as s:
            f = s.makefile("rw")
            for i in range(8):
                f.write(json.dumps({"op": "open", "channel": f"c{i}",
                                    "duration_ms": 2000,
                                    "tolerance": 1.0}) + "\n")
            for off in range(0, 16000, 160):
                for i, w in enumerate(windows):
                    f.write(json.dumps({
                        "op": "pcm", "channel": f"c{i}",
                        "pcm": base64.b64encode(
                            w[off : off + 160].astype("<i2").tobytes()
                        ).decode()}) + "\n")
            f.flush()
            while len(results) < 8:
                msg = json.loads(f.readline())
                if "result" in msg:
                    msg["result"].pop("CONFIDENCE")
                    results[msg["channel"]] = msg["result"]
    finally:
        asyncio.run_coroutine_threadsafe(
            holder["srv"].stop(), holder["loop"]).result(60)
    served = dict(build.LAUNCHES)
    direct = gpu.search_pcm_batch(None, windows, SR, tolerance=1.0)
    for i, want in enumerate(direct):
        assert results[f"c{i}"] == want.to_channel_vars()
        assert want.found
    assert served["mfcc_rows"] > 0 and served["lattice_votes"] > 0
    assert metrics.snapshot()["counters"].get(
        "serve.search_errors", 0) == errors0


def _view_tensors(view) -> dict:
    """Every tensor of a store view, by name (float32 as its bits, so NaN
    and -0.0 compare exactly)."""
    return {k: x.view(torch.int32) if x.dtype == torch.float32 else x
            for k, x in view.tensors().items()}


def _view_votes(store, view, qq, act, use2, cand):
    """K3', bound_scan (the dialplan and the strict bound, with and without
    a context), K4, K5 and the candidate forms on one view."""
    inf = float("inf")
    vm, vmq = store.value_map_for(view), store.value_map_q_for(view)
    specs, maps = store.bound_maps_for(view, 2)
    index = store.match_index_for(view)
    ctx = store.ctx_ids_for(view)
    q0 = torch.trunc(qq[..., 0]).contiguous()
    out = {
        "K3'": ml.lattice_votes(vm, q0, act, 0.5, -inf, inf),
        "bound_scan dialplan": ml.bound_scan(
            ml.dialplan_scan(0.5, -inf, inf), (vmq,), q0, act),
        "bound_scan strict": ml.bound_votes(specs, maps, qq, act, use2, 0.1),
        "bound_scan strict ctx": ml.bound_votes(specs, maps, qq, act, use2,
                                                0.1, ctx, 1),
    }
    for aligned in (False, True):
        fn = tk.match_votes_fused_aligned if aligned else tk.match_votes_fused
        out[f"K{4 + aligned}"] = fn(view.db, qq, act, use2, 0.1, 2,
                                    index=index)
        for route in ("grouped", "per_item"):
            out[f"K{4 + aligned} cand {route}"] = tk.match_votes_cand(
                view.db, qq, act, use2, 0.1, cand, 2, index=index,
                route=route, aligned=aligned)
    return out


@pytest.mark.cuda
def test_incremental_views_equal_a_full_rebuild(dev, monkeypatch):
    """The store's views updated row by row on the card (a tier of 1,024
    frames) equal a full rebuild of the same store state bitwise after each
    step of the mutation script (appends of 1 and 8 tracks, deletes of 1
    and 3, an append deleted before the next build, a delete of an appended
    row); the old view's tensors are untouched; K3', bound_scan, K4, K5 and
    the candidate forms give int32-equal votes on both views (the context
    ids on live rows: a dead row keeps its stale id)."""
    from tiresias_tpu_torch.store.fingerprint_store import FingerprintStore

    g = np.random.default_rng(21)
    store = FingerprintStore(n_coefs=2, device=dev)
    for ctx in ("a", "b"):
        store.create_context(ctx)
    uuids = []

    def add(ctx="a"):
        n = int(g.integers(520, 1025))
        fp = np.stack([g.normal(-25.0, 15.0, n), g.normal(0.0, 8.0, n)], 1)
        e = store.add_audio(f"x{len(uuids)}", ctx, fp.astype(np.float32),
                            f"h{len(uuids)}")
        uuids.append(e.uuid)
        return e.uuid

    def warm(v):
        store.value_map_q_for(v)
        store.bound_maps_for(v, 2)
        store.match_index_for(v)
        store.seq_for(v)
        store.ctx_ids_for(v)
        return v

    for i in range(40):
        add("ab"[i % 2])
    warm(*store.search_views())
    build_view = store._build_view
    steps = (
        lambda: add(),
        lambda: [add("ab"[i % 2]) for i in range(8)],
        lambda: store.delete_audio(uuids[3]),
        lambda: store.delete_audios(uuids[10:13]),
        lambda: store.delete_audio(add("b")),
        lambda: store.delete_audio(uuids[41]),
    )
    for step, mutate in enumerate(steps):
        (old,) = store.search_views()
        before = {k: x.clone() for k, x in _view_tensors(old).items()}
        mutate()
        monkeypatch.setattr(store, "_build_view", lambda *a: pytest.fail(
            "an update rebuilt the view in full"))
        (view,) = store.search_views()
        monkeypatch.undo()
        assert view is not old and view.gen != old.gen
        assert set(_view_tensors(view)) == set(before)  # all carried
        for k, x in _view_tensors(old).items():
            assert torch.equal(x, before[k]), (step, k)
        tier = store._tiers[view.tier_frames]
        full = warm(build_view(tier, len(tier.entries)))
        got, want = _view_tensors(view), _view_tensors(full)
        live = torch.tensor([i not in view.dead_rows
                             for i in range(view.db.shape[0])], device=dev)
        for k in want:
            if k == "ctx_dev":
                assert torch.equal(got[k][live], want[k][live]), step
            else:
                assert torch.equal(got[k], want[k]), (step, k)
        live_rows = [i for i in range(view.n_audios)
                     if i not in view.dead_rows]
        rows = torch.tensor(live_rows[-4:], device=dev)
        q = (view.db[rows, 100:260] + 0.02).contiguous()
        qq, act, use2 = tm.prepare_query(q, None, -1, -1, trunc_coef1=False)
        cand = torch.randint(0, view.db.shape[0], (4, 33), device=dev,
                             dtype=torch.int32)
        cand[:, 0] = rows.to(torch.int32)
        a_votes = _view_votes(store, view, qq, act, use2, cand)
        b_votes = _view_votes(store, full, qq, act, use2, cand)
        for k, v in a_votes.items():
            if k.endswith("ctx"):
                v, w = v[:, live], b_votes[k][:, live]
            else:
                w = b_votes[k]
            assert v.dtype == torch.int32 and torch.equal(v, w), (step, k)
        assert (a_votes["K5"].gather(1, cand[:, :1].long()) > 0).all()


def _card_mesh(dev):
    from tiresias_tpu_torch.parallel import make_mesh

    return make_mesh(4, 2, devices=[dev] * 8)


def _clustered_rows(dev, rows=3001, t=128, seed=3):
    g = np.random.default_rng(seed)
    mu = g.uniform(-25, 20, (rows, 1, 1)).astype(np.float32)
    db = (mu + g.normal(0, 1.5, (rows, t, 2))).astype(np.float32)
    n = g.integers(t // 2, t + 1, rows)
    db[np.arange(t)[None, :] >= n[:, None]] = PAD_VALUE
    return db


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [False, True])
def test_sharded_search_on_card_equals_unsharded(dev, aligned):
    """K4/K5 per shard of a (4, 2) mesh whose eight cells all sit on the
    card, gathered: int32-equal to the unsharded kernel (3,001 rows pad to
    3,004, 63 queries to 64), one launch per cell."""
    from tiresias_tpu_torch.parallel import shard_db, sharded_search

    db = _clustered_rows(dev)
    mask = db[..., 0] != PAD_VALUE
    mesh = _card_mesh(dev)
    db_s, mask_s, a = shard_db(mesh, db, mask)
    tdb = torch.from_numpy(db).to(dev)
    q = tdb[torch.arange(63, device=dev) * 40, 2:50].clone()
    q[:, :, 1] += 0.01
    nf = np.full(63, 48)
    name = "match_votes_aligned" if aligned else "match_votes"
    before = build.LAUNCHES[name]
    _, _, votes = sharded_search(mesh, db_s, mask_s, q, nf, coefs=2,
                                 tolerance=0.1, trunc_coef1=False,
                                 aligned=aligned, n_audios=a)
    torch.cuda.synchronize(dev)
    assert build.LAUNCHES[name] - before == 8
    qq, act, use2 = tm.prepare_query(q, nf, -1, -1, trunc_coef1=False)
    fn = tk.match_votes_fused_aligned if aligned else tk.match_votes_fused
    assert torch.equal(votes, fn(tdb, qq, act, use2, 0.1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [False, True])
def test_sharded_prefilters_on_card_equal_unsharded(dev, aligned):
    """Both certified prefilters per shard of a (4, 2) mesh on the card:
    the gathered votes and certificate columns equal the unsharded
    prefilter run on each shard's rows, int32 for int32, and where every
    shard certifies the top-1 equals the full scan's."""
    from tiresias_tpu_torch.parallel import sharding as sh

    db = _clustered_rows(dev, rows=3000)
    tdb = torch.from_numpy(db).to(dev)
    mask = tdb[..., 0] != PAD_VALUE
    mesh = _card_mesh(dev)
    q = tdb[torch.arange(64, device=dev) * 40, 2:50].clone()
    q[:, :, 1] += 0.01
    qq, act, use2 = tm.prepare_query(q, np.full(64, 48), -1, -1,
                                     trunc_coef1=False)
    specs, maps = ml.build_bound_maps(tdb, mask, 2)
    votes, certs = sh.sharded_aligned_prefiltered(
        mesh, tdb, maps, qq, act, use2, 0.1, specs, 2, k=128,
        aligned=aligned)
    vm = ml.build_value_map(tdb[..., 0], mask)
    vmq = ml.quantize_value_map(vm)
    q0 = torch.trunc(q[..., 0]) + 0.3
    valid = torch.ones_like(act)
    inf = float("inf")
    lvotes, lcerts = sh.sharded_lattice_prefiltered(
        mesh, vm, vmq, q0, valid, 0.5, -inf, inf, k=64)
    per = 750
    for i in range(4):
        rows = slice(i * per, (i + 1) * per)
        for j in range(2):
            qs = slice(32 * j, 32 * (j + 1))
            v, c = tk.aligned_prefiltered_votes(
                tdb[rows].contiguous(),
                tuple(m[rows].contiguous() for m in maps), qq[qs], act[qs],
                use2[qs], 0.1, specs=specs, coefs=2, k=128, aligned=aligned,
                index=mi.build_match_index(tdb[rows].contiguous()))
            assert torch.equal(votes[qs, rows], v)
            assert torch.equal(certs[qs, i], c)
            lv, lc = ml.lattice_prefiltered_votes(
                vm[rows].contiguous(), vmq[rows].contiguous(), q0[qs],
                valid[qs], 0.5, -inf, inf, k=64)
            assert torch.equal(lvotes[qs, rows], lv)
            assert torch.equal(lcerts[qs, i], lc)
    fn = tk.match_votes_fused_aligned if aligned else tk.match_votes_fused
    full = fn(tdb, qq, act, use2, 0.1, 2)
    ok = certs.all(dim=1)
    assert ok.any()
    assert torch.equal(votes.max(dim=1).values[ok],
                       full.max(dim=1).values[ok])
    lfull = ml.lattice_votes(vm, q0, valid, 0.5, -inf, inf)
    lok = lcerts.all(dim=1)
    assert torch.equal(lvotes.max(dim=1).values[lok],
                       lfull.max(dim=1).values[lok])


def _legacy_layout(directory, version: int, entries: list, fps: list,
                   n_coefs: int) -> None:
    """A v1 (one dense ``matrix``) or v2 (a ``tier_<t>`` matrix per tier)
    checkpoint written by hand, as the JAX package's old saves laid it
    out."""
    import json

    from tiresias_tpu_torch.store.fingerprint_store import tier_for

    with open(os.path.join(directory, "catalog.json"), "w") as f:
        json.dump({"version": version, "n_coefs": n_coefs,
                   "contexts": {"a": "", "b": ""}, "entries": entries}, f)
    if version == 1:
        t_max = max(e["n_frames"] for e in entries)
        m = np.full((len(entries), t_max, n_coefs), PAD_VALUE, np.float32)
        for i, fp in enumerate(fps):
            m[i, : fp.shape[0]] = fp
        arrays = {"matrix": m}
    else:
        rows: dict = {}
        for e, fp in zip(entries, fps):
            rows.setdefault(tier_for(e["n_frames"]), []).append(fp)
        arrays = {}
        for t, fs in rows.items():
            m = np.full((len(fs), t, n_coefs), PAD_VALUE, np.float32)
            for i, fp in enumerate(fs):
                m[i, : fp.shape[0]] = fp
            arrays[f"tier_{t}"] = m
    with open(os.path.join(directory, "fingerprints.npz"), "wb") as f:
        np.savez_compressed(f, **arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["lattice_votes", "select_candidates",
                                    "mfcc_rows"])
def test_scaled_profile_reading_within_5pct_of_whole(dev, kernel):
    """utils/timing.profile_reading of a profile whose first records are
    lost (removed here, as CUPTI loses them) against the whole profile of
    the same 20 calls: the launch counters name the launches a call of
    every kernel of the wrapper, and the scaled reading is within 5% of the
    whole one."""
    from tiresias_tpu_torch.utils import timing

    g = np.random.default_rng(7)
    if kernel == "lattice_votes":  # two kernels a call: planes + votes
        counts, vm = _lattice_case(dev, "dense", 64)

        def fn():
            ml.hit_votes(counts, vm, 0.5)
    elif kernel == "select_candidates":
        bound = torch.from_numpy(_select_bounds("random", 64, 10_112, g)
                                 .astype(np.int32)).to(dev)

        def fn():
            ml.select_candidates(bound, 256)
    else:
        consts = mk.device_constants(DspConfig(), SR, dev)
        frames = torch.from_numpy(g.standard_normal((8192, 512)).astype(
            np.float32)).to(dev)

        def fn():
            mk.mfcc_rows(frames, consts)
    reps = 20
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a whole profile to hold the reading to
        before = dict(build.LAUNCHES)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            timing.lead_in()
            for _ in range(reps):
                fn()
            timing.edge_spin()
            torch.cuda.synchronize()
        after = dict(build.LAUNCHES)
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and timing.SPIN not in e.name),
                        key=lambda e: e.time_range.start)
        records = [(e.name, e.self_device_time_total) for e in events]
        whole, scaled = timing.profile_reading(records, reps)
        if records and not scaled:
            break
    assert records and not scaled, "no whole profile in 3"
    names = {n for n, _ in records}
    per_call = timing.launches_per_call(names, before, after, reps)
    assert per_call == {n: len(records) // reps // len(names)
                        for n in names}, (per_call, names)
    for lost in (1, 3, len(names) * 5 + 1):
        got, scaled = timing.profile_reading(records[lost:], reps, per_call)
        assert scaled
        assert abs(got[""] - whole[""]) <= 0.05 * whole[""], (lost, got,
                                                              whole)


@pytest.mark.cuda
def test_dryrun_main_on_the_card(dev, capsys):
    """``python -m tiresias_tpu_torch.dryrun`` on cuda:0: entry()'s step,
    then the sharded ops, the served search and the sharded ingest with its
    checkpoint restore on 8 cells of this card."""
    from tiresias_tpu_torch import dryrun

    build.reset_launch_counts()
    assert dryrun.main([]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "entry ok: [(4,), (4,)]"
    assert lines[1].startswith("dryrun_multichip ok: ")
    assert '"served_search": "ok(name=t2,' in lines[1]
    assert '"sharded_ingest": "ok(created=16)"' in lines[1]
    assert '"mesh_checkpoint": "ok(name=m3.wav,' in lines[1]
    assert build.LAUNCHES["match_votes"] > 0
    assert build.LAUNCHES["mfcc_rows"] + build.LAUNCHES["mfcc_framed"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("version", [1, 2])
def test_legacy_restore_on_card_equals_v4(dev, tmp_path, version):
    """A v1/v2 checkpoint restored on cuda:0: entries and every view tensor
    (maps, bound maps, K4/K5's index built on the card) bitwise equal to
    the v4 restore of the same audios, and the kernels' votes on both."""
    from tiresias_tpu_torch.store.fingerprint_store import FingerprintStore

    rng = np.random.default_rng(40 + version)
    lengths = [int(n) for n in rng.integers(20, 900, 300)]
    entries = [{"uuid": f"u{i}", "name": f"n{i}", "context": "ab"[i % 2],
                "hash": f"h{i}", "n_frames": n}
               for i, n in enumerate(lengths)]
    fps = [rng.normal(-25.0, 15.0, (n, 2)).astype(np.float32)
           for n in lengths]
    legacy, v4 = tmp_path / "legacy", tmp_path / "v4"
    legacy.mkdir()
    _legacy_layout(str(legacy), version, entries, fps, 2)
    ref = FingerprintStore(2, device=dev)
    for c in ("a", "b"):
        ref.create_context(c, "")
    for e, fp in zip(entries, fps):
        ref.add_audio(e["name"], e["context"], fp, e["hash"], uuid=e["uuid"])
    ref.save(str(v4))
    got = FingerprintStore.load(str(legacy), 2, device=dev)
    want = FingerprintStore.load(str(v4), 2, device=dev)
    assert [(e.uuid, e.seq) for e in got.entries] == [
        (e.uuid, e.seq) for e in want.entries]
    gviews, wviews = got.search_views(), want.search_views()
    assert [v.tier_frames for v in gviews] == [v.tier_frames for v in wviews]
    q = torch.from_numpy(rng.normal(-25.0, 15.0, (4, 64, 2)).astype(
        np.float32)).to(dev)
    qq, act, use2 = tm.prepare_query(q, np.full(4, 64), -1, -1, False)
    for store, views in ((got, gviews), (want, wviews)):
        for v in views:
            store.value_map_q_for(v)
            store.bound_maps_for(v, 2)
            store.match_index_for(v)
            store.seq_for(v)
            store.ctx_ids_for(v)
    for gv, wv in zip(gviews, wviews):
        gt, wt = gv.tensors(), wv.tensors()
        assert gt.keys() == wt.keys()
        for name in gt:
            x, y = gt[name], wt[name]
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            assert torch.equal(x, y), (gv.tier_frames, name)
        for vote in (tk.match_votes_fused, tk.match_votes_fused_aligned):
            a = vote(gv.db, qq, act, use2, 0.5, 2,
                     index=got.match_index_for(gv))
            b = vote(wv.db, qq, act, use2, 0.5, 2,
                     index=want.match_index_for(wv))
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_soak_on_card_with_mutator(dev):
    """The soak tool on the card: 16 real-time channels for 10 s with the
    live admin mutator; every window correct, no errors, flat memory."""
    import tempfile

    from tiresias_tpu_torch.tools import soak

    eng = soak.build_engine("cuda")
    try:
        out = soak.run_soak(eng, channels=16, seconds=10.0,
                            mutate_dir=tempfile.mkdtemp(prefix="tir_mut"),
                            mutate_period=3.0)
    finally:
        eng.close()
    assert out["windows"] > 0 and out["pct"] == 100.0, out["summary"]
    assert out["errors"] == 0 and out["mutations"] >= 2, out["summary"]
    assert out["mem_flat"], out["mem_line"]
    assert out["match_ms"]
