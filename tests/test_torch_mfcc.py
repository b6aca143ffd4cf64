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
from tiresias_tpu.ops.mfcc_pallas import (
    _fingerprint_framed,
    _mfcc_rows,
    fingerprint_padded_batch_pallas,
    pallas_constants,
)
from tiresias_tpu.utils.g711 import encode
from tiresias_tpu_torch.ops import mfcc
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
    got = mfcc.fingerprint_padded_batch(padded, SR, dsp).numpy()
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
    fp_w, nf_w = mfcc.fingerprint_signals_async(codes, SR, dsp, law="alaw")
    fp_l, nf_l = mfcc.fingerprint_signals_async(lin, SR, dsp)
    np.testing.assert_array_equal(nf_w, nf_l)
    torch.testing.assert_close(fp_w, fp_l, atol=0, rtol=0)


def test_coef_weights_scale_like_jax():
    dsp = DspConfig(n_coefs=2, coef_weights=(1.5, 0.5))
    rng = np.random.default_rng(9)
    pcm = _speechlike(rng, 12000)
    ref = mfcc_jax.fingerprint_signal(pcm, SR, dsp)
    got = mfcc.fingerprint_signal(pcm, SR, dsp)
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
    got = mfcc.fingerprint_signal(np.zeros(2048, np.float32), SR, dsp)
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
    ours = mfcc.fingerprint_signal(make_pcm(), sr, dsp)
    golden = g[f"{name}/fp"]
    bound = _frozen_bound(g, name, dsp)
    assert ours.shape == golden.shape
    use = bound < 0.2
    assert use.mean() >= MIN_COVERAGE[name]
    assert (np.abs(ours - golden) - bound)[use].max() < 5e-3

