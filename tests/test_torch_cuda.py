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

import os

import numpy as np
import pytest
import torch

from tiresias_tpu_torch.config import ContextConfig, DspConfig, TiresiasConfig
from tiresias_tpu_torch.ops import match as tm
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
    tk.match_votes_fused_aligned(db, q, flags, flags, 0.1, 2)
    assert build.LAUNCHES == {"mfcc_rows": 1, "mfcc_framed": 0,
                              "mfcc_rows_dft": 0, "mfcc_framed_dft": 0,
                              "lattice_votes": 1, "match_votes": 1,
                              "match_votes_aligned": 1}
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
    with pytest.raises(ValueError):
        tk.match_votes_fused(db.double(), q, flags, flags, 0.1, 2)


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
    """K4/K5 vs the twin, int32 exact: a tier of 1,536 frames (K5 walks 4
    time chunks), a 300-frame query (more than one shared-memory stage),
    band filters that drop q0 frames and bypass q1 conditions, and tol 2e5
    (past the Pallas kernels' value-encoded masks)."""
    fn = tk.match_votes_fused_aligned if aligned else tk.match_votes_fused
    for rows, t, f in ((200, 256, 24), (300, 1536, 300)):
        db, q, n_frames = _match_case(dev, coefs + t, rows, t, 8, 5, f)
        for band in ((-1, -1), (1, 300)):
            qq, act, use2 = tm.prepare_query(q, n_frames, *band,
                                             trunc_coef1=False)
            for tol in (0.05, 1.0, 2e5):
                got = fn(db, qq, act, use2, tol, coefs)
                want = tm.match_votes(db, db[..., 0] != PAD_VALUE, qq, act,
                                      use2, tol, coefs=coefs,
                                      aligned=aligned)
                assert torch.equal(got, want), (rows, t, f, band, tol)
                assert (got[:, 1] == 0).all()  # the empty row


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
