"""PyTorch port's fingerprint chain vs the JAX package.

The port's plain twins of kernels K1 (``mfcc_rows``) and K2
(``mfcc_framed``) are held against the Pallas kernels they replace, run in
interpret mode on the CPU exactly as tests/test_mfcc_pallas.py runs them,
at atol 0.02 (the same bound test_mfcc_pallas.py uses between the
DFT-as-matmul chain and the FFT path: the two sum in different orders and
the log-log output magnifies float32 rounding near the mel noise floor).
Host-side layout functions must be bitwise equal. Fingerprints are held
against the frozen goldens within the PARITY.md section 2 bound. The CUDA
kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import os

import numpy as np
import pytest
import torch

from golden_corpus import MIN_COVERAGE, all_cases
from tiresias_tpu.config import DspConfig
from tiresias_tpu.ops import mfcc_jax
from tiresias_tpu.ops.dct import dct_matrix
from tiresias_tpu.ops.windows import hanningz
from tiresias_tpu.ops.mfcc_pallas import (
    _fingerprint_framed,
    _mfcc_rows,
    fingerprint_padded_batch_pallas,
    pallas_constants,
)
from tiresias_tpu.utils.g711 import encode
from tiresias_tpu_torch.ops import mfcc
from tiresias_tpu_torch.ops import mfcc_kernels as mk
from tiresias_tpu_torch.ops.mfcc_kernels import (
    ROW_TILE,
    device_constants,
    kernel_constants,
    mfcc_framed,
    mfcc_framed_plain,
    mfcc_rows,
    mfcc_rows_plain,
)

torch.set_num_threads(2)

SR = 8000
ATOL = 0.02
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "mfcc_goldens.npz")


def _speechlike(rng, n, sr=SR):
    t = np.arange(n) / sr
    f0 = rng.uniform(90, 220)
    sig = sum(
        rng.uniform(0.2, 1.0) / h * np.sin(2 * np.pi * f0 * h * t)
        for h in range(1, 9)
    )
    sig = sig + 0.02 * rng.standard_normal(n)
    return (0.3 * sig / np.abs(sig).max()).astype(np.float32)


def _cpu_consts(dsp, sr=SR):
    return device_constants(dsp, sr, torch.device("cpu"))


@pytest.mark.parametrize("sr", [8000, 16000, 44100])
def test_kernel_constants_bitwise_equal_pallas(sr):
    dsp = DspConfig()
    ours = kernel_constants(dsp, sr)
    ref = pallas_constants(dsp, sr)
    for o, r in zip(ours, ref):
        assert o.dtype == np.float32
        np.testing.assert_array_equal(o, r[: o.shape[0], : o.shape[1]])
        # everything the port drops is the TPU's zero lane padding
        rest = r.copy()
        rest[: o.shape[0], : o.shape[1]] = 0
        assert not rest.any()
    assert ours[0].shape == (512, dsp.n_bins)
    assert ours[3].shape == (dsp.n_filters, dsp.n_coefs)


def test_rows_plain_matches_pallas_interpret():
    dsp = DspConfig()
    rng = np.random.default_rng(11)
    pcm = np.stack([_speechlike(rng, 40 * 256) for _ in range(3)])
    frames = np.array(mfcc_jax.frames_from_pcm(pcm, 256, 512)).reshape(
        -1, 512
    )
    rows = frames.shape[0]
    padded = np.pad(frames, ((0, ROW_TILE - rows % ROW_TILE), (0, 0)))
    ref = np.asarray(
        _mfcc_rows(padded, *pallas_constants(dsp, SR), interpret=True)
    )[:rows, : dsp.n_coefs]
    got = mfcc_rows(torch.from_numpy(frames), _cpu_consts(dsp)).numpy()
    assert got.shape == (rows, dsp.n_coefs)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_framed_plain_matches_pallas_interpret():
    dsp = DspConfig()
    rng = np.random.default_rng(12)
    f = ROW_TILE + 37  # a partial second tile exercises the halo
    pcm = np.stack([_speechlike(rng, f * 256) for _ in range(2)])
    ref = np.asarray(
        _fingerprint_framed(
            pcm, *pallas_constants(dsp, SR), 256, 512, dsp.n_coefs,
            interpret=True,
        )
    )
    got = mfcc_framed(torch.from_numpy(pcm), _cpu_consts(dsp), 256, 512)
    assert got.shape == ref.shape == (2, f, dsp.n_coefs)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "lengths",
    [
        (24000, 3000, 11000),  # 3 s queries: 128-frame bucket -> K1 route
        (64000, 61000),  # 8 s clips: 256 frames -> K2 route
    ],
)
def test_routing_matches_pallas_batch(lengths):
    """Both sides of the routing rule (mfcc_pallas.py:348-356)."""
    dsp = DspConfig()
    rng = np.random.default_rng(len(lengths))
    pcms = [_speechlike(rng, n) for n in lengths]
    padded, n_frames = mfcc.pad_frames_bucket(pcms, dsp.hop_size)
    ref = np.asarray(
        fingerprint_padded_batch_pallas(padded, SR, dsp, interpret=True)
    )
    got = mfcc.fingerprint_padded_batch(padded, SR, dsp, device="cpu").numpy()
    assert got.shape == ref.shape
    for i, nf in enumerate(n_frames):
        np.testing.assert_allclose(got[i, :nf], ref[i, :nf], atol=ATOL, rtol=0)


def test_framed_equals_rows_route():
    """K2's twin frames in the same order K1's twin is fed."""
    dsp = DspConfig()
    rng = np.random.default_rng(5)
    pcm = torch.from_numpy(np.stack([_speechlike(rng, 70 * 256)]))
    consts = _cpu_consts(dsp)
    framed = mfcc_framed_plain(pcm, consts, 256, 512)
    frames = mfcc.frames_from_pcm(pcm, 256, 512).reshape(-1, 512)
    rows = mfcc_rows_plain(frames, consts).reshape(1, 70, -1)
    torch.testing.assert_close(framed, rows, atol=0, rtol=0)


def test_frames_from_pcm_bitwise():
    rng = np.random.default_rng(3)
    pcm = rng.standard_normal((2, 9 * 256)).astype(np.float32)
    ref = np.asarray(mfcc_jax.frames_from_pcm(pcm, 256, 512))
    got = mfcc.frames_from_pcm(torch.from_numpy(pcm), 256, 512).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("law", [None, "ulaw", "alaw"])
def test_to_float_pcm_bitwise(law):
    rng = np.random.default_rng(4)
    i16 = np.clip(rng.normal(0, 8000, 4096), -32768, 32767).astype(np.int16)
    wire = i16 if law is None else encode(i16.astype(np.float32) / 32768, law)
    ref = np.asarray(mfcc_jax.to_float_pcm(wire, law))
    got = mfcc.to_float_pcm(torch.from_numpy(wire), law).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_mask_valid_samples_bitwise():
    rng = np.random.default_rng(6)
    pcm = rng.standard_normal((3, 512)).astype(np.float32)
    n_valid = np.array([0, 100, 512], np.int32)
    ref = np.asarray(mfcc_jax.mask_valid_samples(pcm, n_valid))
    got = mfcc.mask_valid_samples(
        torch.from_numpy(pcm), torch.from_numpy(n_valid)
    ).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["int16", "float", "mixed", "ulaw"])
def test_pad_frames_bucket_bitwise(kind):
    rng = np.random.default_rng(7)
    lens = (1000, 24000, 257)
    sigs = [(0.3 * rng.standard_normal(n)).astype(np.float32) for n in lens]
    law = None
    if kind == "int16":
        sigs = [(s * 32768).astype(np.int16) for s in sigs]
    elif kind == "mixed":
        sigs[0] = (sigs[0] * 32768).astype(np.int16)
    elif kind == "ulaw":
        law = "ulaw"
        sigs = [encode(s, law) for s in sigs]
    for multiple in (32, 128):
        ref = mfcc_jax.pad_frames_bucket(sigs, 256, multiple, law=law)
        got = mfcc.pad_frames_bucket(sigs, 256, multiple, law=law)
        for r, g in zip(ref, got):
            assert r.dtype == g.dtype
            np.testing.assert_array_equal(g, r)


def test_pad_frames_bucket_rejects_like_jax():
    bad = [np.array([0.0, np.nan], np.float32)]
    with pytest.raises(ValueError):
        mfcc.pad_frames_bucket(bad, 256)
    with pytest.raises(ValueError):
        mfcc.pad_frames_bucket([np.zeros(10, np.uint8)], 256)


def test_g711_wire_matches_linear():
    """uint8 codes expanded on the device fingerprint exactly like the same
    samples shipped as int16 (PARITY D18)."""
    dsp = DspConfig()
    rng = np.random.default_rng(8)
    sigs = [_speechlike(rng, n) for n in (24000, 20000)]
    codes = [encode(s, "alaw") for s in sigs]
    from tiresias_tpu.utils.g711 import decode

    lin = [decode(c, "alaw") for c in codes]
    fp_w, nf_w = mfcc.fingerprint_signals_async(codes, SR, dsp, law="alaw",
                                                device="cpu")
    fp_l, nf_l = mfcc.fingerprint_signals_async(lin, SR, dsp, device="cpu")
    np.testing.assert_array_equal(nf_w, nf_l)
    torch.testing.assert_close(fp_w, fp_l, atol=0, rtol=0)


def test_coef_weights_scale_like_jax():
    dsp = DspConfig(n_coefs=2, coef_weights=(1.5, 0.5))
    rng = np.random.default_rng(9)
    pcm = _speechlike(rng, 12000)
    ref = mfcc_jax.fingerprint_signal(pcm, SR, dsp)
    got = mfcc.fingerprint_signal(pcm, SR, dsp, device="cpu")
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("weights", [None, (1.5, 0.5), (3.0, 0.7, 1.1)])
def test_coef_scale_for_bitwise_equal_jax(weights):
    dsp = DspConfig(n_coefs=len(weights or (0, 0)), coef_weights=weights)
    got, ref = mfcc.coef_scale_for(dsp), mfcc_jax.coef_scale_for(dsp)
    if weights is None:
        assert got is None and ref is None
    else:
        assert got.dtype == np.asarray(ref).dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(ref))


def test_silence_hits_exact_floor():
    dsp = DspConfig()
    got = mfcc.fingerprint_signal(np.zeros(2048, np.float32), SR, dsp,
                                  device="cpu")
    ref = np.asarray(mfcc_jax.fingerprint_signal(np.zeros(2048, np.float32), SR))
    # coef 0 sums the same 40 floor values in another order (1 ulp); the
    # antisymmetric coef 1 cancels exactly to 0, i.e. the exact floor
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    floor = np.float32(10.0) * np.float32(mfcc.LOG10_FLOOR)
    assert (got[:, 1] == floor).all() and (ref[:, 1] == floor).all()


def test_safe_log10_floor_and_threshold():
    x = torch.tensor([0.0, 2e-42, 1e-38, 1e-37, 1.0, 100.0])
    got = mfcc.safe_log10(x).numpy()
    ref = np.asarray(mfcc_jax.safe_log10(x.numpy()))
    np.testing.assert_array_equal(got, ref)
    assert got[0] == got[1] == got[2] == np.float32(np.log10(2e-42))


def _frozen_bound(g, name, dsp):
    """PARITY.md section 2 float32 error-propagation bound from the frozen
    stages (the derivation is in tests/test_mfcc_jax.py)."""
    mels = g[f"{name}/mels"]
    coefs = g[f"{name}/coefs"]
    e_max = mels.max(axis=1, keepdims=True)
    rel = np.where(mels > 0, 2e-5 * e_max / np.maximum(mels, 1e-300), 0.0)
    err_c = (rel / np.log(10.0)) @ np.abs(
        dct_matrix(dsp.n_filters, dsp.n_coefs)
    ).T
    return (10.0 / np.log(10.0)) * err_c / np.maximum(np.abs(coefs), 1e-12)


@pytest.mark.parametrize("name", sorted(all_cases()))
def test_fingerprint_matches_frozen_goldens(name):
    g = np.load(GOLDENS)
    make_pcm, sr = all_cases()[name]
    dsp = DspConfig()
    ours = mfcc.fingerprint_signal(make_pcm(), sr, dsp, device="cpu")
    golden = g[f"{name}/fp"]
    bound = _frozen_bound(g, name, dsp)
    assert ours.shape == golden.shape
    use = bound < 0.2
    assert use.mean() >= MIN_COVERAGE[name]
    assert (np.abs(ours - golden) - bound)[use].max() < 5e-3



# ---------------------------------------------------------------------------
# the FFT route's host side (csrc/mfcc_fft.cu runs only on the card)
# ---------------------------------------------------------------------------

FFT_SIZES = [64, 512, 1024, 4096]


def _fft_tables(n, sr=SR):
    dsp = DspConfig(buf_size=n, hop_size=n // 2)
    return mk.FftTables(*(torch.from_numpy(np.ascontiguousarray(c))
                          for c in mk.fft_constants(dsp, sr)))


@pytest.mark.parametrize("n", [32, 64, 128, 480, 512, 1000, 4096, 8192])
def test_fft_route_by_window_size(n):
    want = n in (64, 128, 512, 4096)
    assert mk.fft_route(n) == want
    dsp = DspConfig(buf_size=n, hop_size=n // 2)
    consts = _cpu_consts(dsp)
    assert (consts.fft is not None) == want
    if want:
        radices = mk.fft_radices(n // 2)
        assert int(np.prod(radices)) == n // 2 and radices[0] == 8
        assert set(radices) <= {4, 8} and radices.count(4) <= 2
    else:
        with pytest.raises(ValueError):
            mk.fft_constants(dsp, SR)


@pytest.mark.parametrize("n", FFT_SIZES)
def test_fft_twiddle_and_window_tables(n):
    t = mk.fft_constants(DspConfig(buf_size=n, hop_size=n // 2), SR)
    m = n // 2
    np.testing.assert_array_equal(
        t.win2.reshape(-1), hanningz(n, np.float64).astype(np.float32))
    for table, period, size in ((t.tw, m, m), (t.tws, n, m // 2 + 1)):
        want = np.exp(-2j * np.pi * np.arange(size) / period)
        assert table.dtype == np.float32 and table.shape == (size, 2)
        np.testing.assert_array_equal(table[:, 0],
                                      want.real.astype(np.float32))
        np.testing.assert_array_equal(table[:, 1],
                                      want.imag.astype(np.float32))
    assert tuple(t.tw[0]) == (1.0, 0.0) and tuple(t.tws[0]) == (1.0, 0.0)


@pytest.mark.parametrize("sr", [8000, 16000, 44100])
@pytest.mark.parametrize("n", FFT_SIZES)
def test_mel_ranges_cover_exactly_the_nonzero_weights(n, sr):
    """The ranges rebuild mel_t exactly: each filter's [first, last] holds
    every non-zero weight, first and last are non-zero, and nothing else."""
    dsp = DspConfig(buf_size=n, hop_size=n // 2)
    mel_t = kernel_constants(dsp, sr)[2]
    t = mk.fft_constants(dsp, sr)
    assert t.mel_idx.shape == (dsp.n_filters, 3)
    dense = np.zeros_like(mel_t)
    for j, (lo, hi, off) in enumerate(t.mel_idx):
        dense[lo : hi + 1, j] = t.mel_w[off : off + hi - lo + 1]
        if hi >= lo:
            assert mel_t[lo, j] != 0 and mel_t[hi, j] != 0
        else:
            assert not mel_t[:, j].any()
    np.testing.assert_array_equal(dense, mel_t)
    assert t.mel_w.size == int(sum(max(hi - lo + 1, 0)
                                   for lo, hi, _ in t.mel_idx))
    if n >= 512:  # the profiles' windows: a bin lies in at most two filters
        assert ((mel_t != 0).sum(axis=1) <= 2).all()


@pytest.mark.parametrize("n", FFT_SIZES)
def test_packed_rfft_plain_matches_float64_rfft(n):
    """The kernel's pack -> N/2-point Stockham FFT -> split, written out in
    torch with its tables, against numpy's float64 rfft of the same
    windowed frames, within float32 rounding (a few ulp of the frame's
    largest bin per radix-2 stage). Zero frames give exact zeros; DC and
    Nyquist are real."""
    rng = np.random.default_rng(n)
    tabs = _fft_tables(n)
    frames = rng.standard_normal((6, n)).astype(np.float32)
    frames[1] = 0.0
    frames[2] = 0.25  # DC only
    frames[3] = np.where(np.arange(n) % 2, -0.5, 0.5)  # Nyquist only
    frames[4] = _speechlike(rng, n)
    re, im = mk.packed_rfft_plain(torch.from_numpy(frames), tabs)
    assert re.shape == im.shape == (6, n // 2 + 1)
    w = tabs.win2.numpy().reshape(-1).astype(np.float64)
    ref = np.fft.rfft(frames.astype(np.float64) * w, axis=1)
    scale = np.abs(ref).max(axis=1, keepdims=True)
    tol = 4 * np.finfo(np.float32).eps * np.log2(n) * scale
    assert (np.abs(re.numpy() - ref.real) <= tol).all()
    assert (np.abs(im.numpy() - ref.imag) <= tol).all()
    assert (re[1] == 0).all() and (im[1] == 0).all()
    assert (im[:, 0] == 0).all() and (im[:, -1] == 0).all()
    np.testing.assert_allclose(re[2, 0].item(), ref[2, 0].real, rtol=1e-6)
    np.testing.assert_allclose(re[3, -1].item(), ref[3, -1].real, rtol=1e-6)


@pytest.mark.parametrize("n", FFT_SIZES)
def test_fft_chain_plain_within_fingerprint_bound_of_twin(n):
    """The FFT route's whole chain in plain torch — |packed rFFT|, the mel
    ranges summed in ascending bin order, safe_log10, the paired DCT —
    within the kernel-vs-twin bound (1e-4 dB, scaled by 1/|c| below
    |c| = 1) of the DFT-product twin, silence at the exact floor."""
    dsp = DspConfig(buf_size=n, hop_size=n // 2)
    consts = _cpu_consts(dsp)
    rng = np.random.default_rng(n + 1)
    frames = np.stack([_speechlike(rng, n) for _ in range(8)])
    frames[3] = 0.0
    frames = torch.from_numpy(frames)
    re, im = mk.packed_rfft_plain(frames, consts.fft)
    mag = torch.sqrt(re * re + im * im)
    mel = torch.zeros((frames.shape[0], dsp.n_filters))
    for j, (lo, hi, off) in enumerate(consts.fft.mel_idx.tolist()):
        for k in range(lo, hi + 1):
            mel[:, j] = torch.addcmul(mel[:, j], mag[:, k],
                                      consts.fft.mel_w[off + k - lo])
    got = 10.0 * mk.safe_log10(torch.abs(
        mk.dct_paired(mk.safe_log10(mel), consts.dct_t)))
    want = mfcc_rows_plain(frames, consts)
    err = (got - want).abs().double()
    c = torch.pow(10.0, want.double() / 10.0)
    assert float((err / (1e-4 * torch.clamp(1.0 / c, min=1.0))).max()) <= 1.0
    floor = np.float32(10.0) * np.float32(mk.LOG10_FLOOR)
    assert got[3, 1] == want[3, 1] == floor
