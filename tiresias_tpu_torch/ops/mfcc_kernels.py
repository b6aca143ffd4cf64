"""Fused MFCC kernels K1 and K2 (port of ``tiresias_tpu.ops.mfcc_pallas``).

Both compute the windowed spectrum -> |.| -> mel -> safe_log10 -> DCT ->
``10*log10|.|`` chain in float32, on one of two routes chosen by the window
size ``N = buf_size``:

  * the FFT route (``csrc/mfcc_fft.cu``), for a power-of-two N from 64 to
    4096 (every profile): one warp per frame computes the real FFT as an
    N/2-point complex Stockham FFT of the packed even/odd samples, split
    into bins 0..N/2, then the mel bank over each filter's bin range;
  * the DFT route (``csrc/mfcc.cu``), for any other N: the Pallas kernels'
    own method, the window-folded DFT as a [rows, N] x [N, n_bins] product.

  * :func:`mfcc_rows` (K1, replaces ``_mfcc_kernel``): pre-framed rows.
  * :func:`mfcc_framed` (K2, replaces ``_framing_kernel``): frames assembled
    inside the kernel from the signal, each sample read once per block.

Each wrapper launches its kernel for a CUDA tensor (raising on any failure)
and takes its plain PyTorch twin for a CPU tensor; the twins live here too
(:func:`mfcc_rows_plain`, :func:`mfcc_framed_plain`), as does
:func:`packed_rfft_plain`, the FFT route's transform written out in torch
with the kernel's own tables and pass order.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from tiresias_tpu_torch.config import DspConfig
from tiresias_tpu_torch.ops.dct import dct_matrix
from tiresias_tpu_torch.ops.melbank import mel_filterbank
from tiresias_tpu_torch.ops.windows import hanningz
from tiresias_tpu_torch.utils import build

# Row tile of the routing rule in fingerprint_padded_batch (the framed
# kernel's padding-waste test is stated in these units).
ROW_TILE = 256

# aubio SAFE_LOG10 (PARITY.md section 2): values below the smallest safe
# threshold map to the exact constant log10(VERY_SMALL_NUMBER).
VERY_SMALL_NUMBER = 2e-42
FLOOR_THRESHOLD = 1e-37
LOG10_FLOOR = float(np.log10(VERY_SMALL_NUMBER))


def safe_log10(x: torch.Tensor) -> torch.Tensor:
    return torch.where(
        x >= FLOOR_THRESHOLD,
        torch.log10(torch.clamp(x, min=FLOOR_THRESHOLD)),
        torch.tensor(LOG10_FLOOR, dtype=x.dtype, device=x.device),
    )


@functools.lru_cache(maxsize=16)
def kernel_constants(
    dsp: DspConfig, samplerate: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``(dft_re [win, n_bins], dft_im [win, n_bins], mel_t [n_bins,
    n_filters], dct_t [n_filters, n_coefs])`` float32 — the chain's
    "weights". The Hann window is folded into the DFT matrices. Bitwise the
    unpadded block of ``tiresias_tpu.ops.mfcc_pallas.pallas_constants``
    (the TPU's 128-lane zero padding is not carried over)."""
    win = dsp.buf_size
    n = np.arange(win)[:, None]
    k = np.arange(dsp.n_bins)[None, :]
    ang = -2.0 * np.pi * n * k / win
    w = hanningz(win, dtype=np.float64)[:, None]
    dft_re = (w * np.cos(ang)).astype(np.float32)
    dft_im = (w * np.sin(ang)).astype(np.float32)
    mel_t = mel_filterbank(dsp.n_filters, win, samplerate).T.astype(np.float32)
    dct_t = dct_matrix(dsp.n_filters, dsp.n_coefs).T.astype(np.float32)
    return (
        np.ascontiguousarray(dft_re),
        np.ascontiguousarray(dft_im),
        np.ascontiguousarray(mel_t),
        np.ascontiguousarray(dct_t),
    )


class FftTables(NamedTuple):
    """The FFT route's tables, float64 rounded to float32 (int32 for
    ``mel_idx``), for a window of N samples and M = N/2 complex points.

    ``win2 [M, 2]``: the periodic Hann window as (even, odd) sample pairs;
    ``tw [M, 2]``: ``exp(-2 pi i t / M)`` as (re, im); ``tws [M/2 + 1,
    2]``: the split's ``exp(-2 pi i k / N)``; ``mel_idx`` and ``mel_w``: the
    mel bank as bin ranges (:func:`mel_ranges`).
    """

    win2: object
    tw: object
    tws: object
    mel_idx: object
    mel_w: object


class MfccConstants(NamedTuple):
    """The chain's "weights" on one device: the DFT route's (and the
    twins') four matrices of :func:`kernel_constants`, and the FFT route's
    :class:`FftTables` where N is a power of two in range (else None)."""

    dft_re: torch.Tensor
    dft_im: torch.Tensor
    mel_t: torch.Tensor
    dct_t: torch.Tensor
    fft: FftTables | None


# Windows the FFT route serves: powers of two, 32 to 2048 complex points.
FFT_MIN, FFT_MAX = 64, 4096


def fft_route(n_fft: int) -> bool:
    """True when a window of ``n_fft`` samples takes the FFT kernels."""
    return FFT_MIN <= n_fft <= FFT_MAX and n_fft & (n_fft - 1) == 0


def fft_radices(m: int) -> list[int]:
    """The Stockham passes of an ``m``-point complex FFT (m = 2^L, L >= 4),
    as the kernel runs them: radix 8 while it divides, ending in one radix
    4 (L % 3 == 2) or two (L % 3 == 1)."""
    log2m = m.bit_length() - 1
    tail = {0: [], 1: [4, 4], 2: [4]}[log2m % 3]
    return [8] * ((log2m - 2 * len(tail)) // 3) + tail


def mel_ranges(mel_t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The mel bank ``mel_t [n_bins, n_filters]`` as bin ranges:
    ``mel_idx [n_filters, 3]`` int32 holds each filter's first and last
    non-zero bin and the offset of its weights in ``mel_w``, which holds
    ``mel_t[first..last, j]`` filter after filter (float32). A filter
    without a non-zero weight gets the empty range (0, -1)."""
    idx, weights, off = [], [], 0
    for j in range(mel_t.shape[1]):
        nz = np.flatnonzero(mel_t[:, j])
        lo, hi = (int(nz[0]), int(nz[-1])) if len(nz) else (0, -1)
        idx.append((lo, hi, off))
        weights.append(mel_t[lo : hi + 1, j])
        off += hi - lo + 1
    return (np.asarray(idx, np.int32).reshape(-1, 3),
            np.concatenate(weights).astype(np.float32))


def _unit_roots(n: int, count: int) -> np.ndarray:
    ang = -2.0 * np.pi * np.arange(count) / n
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=16)
def fft_constants(dsp: DspConfig, samplerate: int) -> FftTables:
    """:class:`FftTables` as numpy arrays for ``dsp.buf_size`` samples."""
    n = dsp.buf_size
    if not fft_route(n):
        raise ValueError(f"no FFT route for a {n}-sample window")
    m = n // 2
    mel_idx, mel_w = mel_ranges(kernel_constants(dsp, samplerate)[2])
    return FftTables(
        win2=hanningz(n, dtype=np.float64).astype(np.float32).reshape(m, 2),
        tw=_unit_roots(m, m), tws=_unit_roots(n, m // 2 + 1),
        mel_idx=mel_idx, mel_w=mel_w,
    )


@functools.lru_cache(maxsize=16)
def device_constants(
    dsp: DspConfig, samplerate: int, device: torch.device
) -> MfccConstants:
    """:func:`kernel_constants` and, where the window takes the FFT route,
    :func:`fft_constants`, as tensors on ``device``, uploaded once per
    (dsp, samplerate, device). Read-only: every caller shares them."""
    dft = [torch.from_numpy(c).to(device)
           for c in kernel_constants(dsp, samplerate)]
    fft = None
    if fft_route(dsp.buf_size):
        fft = FftTables(*(torch.from_numpy(np.ascontiguousarray(c)).to(device)
                          for c in fft_constants(dsp, samplerate)))
    return MfccConstants(*dft, fft)


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------


def _no_tf32() -> None:
    # the twins are the float32 reference: TF32 keeps ~3 decimal digits,
    # the same class of drift as the TPU's bf16 default (+-0.03)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mfcc_rows_plain(frames: torch.Tensor, consts) -> torch.Tensor:
    """K1's plain twin: ``[R, win]`` frames -> ``[R, n_coefs]``. ``consts``
    is :class:`MfccConstants` or any sequence that starts with its four
    matrices."""
    _no_tf32()
    dft_re, dft_im, mel_t, dct_t = consts[:4]
    re = frames @ dft_re
    im = frames @ dft_im
    mag = torch.sqrt(re * re + im * im)
    logm = safe_log10(mag @ mel_t)
    return 10.0 * safe_log10(torch.abs(dct_paired(logm, dct_t)))


def dct_paired(logm: torch.Tensor, dct_t: torch.Tensor) -> torch.Tensor:
    """``logm [R, N] @ dct_t [N, C]`` with filters j and N-1-j summed as a
    pair of separately rounded products, as the kernels do: the DCT-II rows
    are exactly (anti)symmetric in float32, so a constant row (digital
    silence) gives exactly 0 rather than rounding noise."""
    n = logm.shape[1]
    half = n // 2
    lo = logm[:, :half, None] * dct_t[None, :half]
    hi = logm[:, n - half :].flip(1)[:, :, None] * dct_t[n - half :].flip(0)[None]
    out = (lo + hi).sum(dim=1)
    if n % 2:
        out = out + logm[:, half, None] * dct_t[half][None]
    return out


def frames_from_pcm(pcm: torch.Tensor, hop_size: int, buf_size: int):
    """pvoc-style framing: ``[..., S]`` (S a multiple of hop) ->
    ``[..., S // hop, buf_size]``; frame f covers samples
    ``[(f+1)*hop - win, (f+1)*hop)`` with zeros before t0."""
    if buf_size % hop_size != 0:
        raise ValueError("buf_size must be a multiple of hop_size")
    k = buf_size // hop_size
    *lead, s = pcm.shape
    if s % hop_size != 0:
        raise ValueError("signal length must be a multiple of hop_size")
    f = s // hop_size
    chunks = pcm.reshape(*lead, f, hop_size)
    parts = []
    for back in range(k - 1, -1, -1):
        if back == 0:
            parts.append(chunks)
        else:
            zero = chunks.new_zeros((*lead, back, hop_size))
            parts.append(torch.cat([zero, chunks[..., :-back, :]], dim=-2))
    return torch.cat(parts, dim=-1)


_SQRT_HALF = float(np.float32(np.sqrt(0.5)))


def _rotate(tr, ti, eighths: int):
    """``(tr + i ti) * exp(-2 pi i eighths / 8)`` for eighths 0-3, with the
    kernel's arithmetic (``rotate`` in ``csrc/mfcc_fft.cu``)."""
    if eighths == 0:
        return tr, ti
    if eighths == 1:
        return (tr + ti) * _SQRT_HALF, (ti - tr) * _SQRT_HALF
    if eighths == 2:
        return ti, -tr
    return (ti - tr) * _SQRT_HALF, -(tr + ti) * _SQRT_HALF


def _bitrev(k: int, radix: int) -> int:
    bits = radix.bit_length() - 1
    return int(format(k, f"0{bits}b")[::-1], 2)


def _dft_dif(vr: list, vi: list) -> None:
    """In-place radix-2 decimation-in-frequency DFT of ``len(vr)`` (2, 4 or
    8) points, leaving X[k] at position ``_bitrev(k)``, as the kernel's
    ``dft_dif`` does in registers."""
    radix = len(vr)
    h = radix // 2
    while h >= 1:
        for base in range(0, radix, 2 * h):
            for i in range(h):
                a, b = base + i, base + i + h
                tr, ti = vr[a] - vr[b], vi[a] - vi[b]
                vr[a], vi[a] = vr[a] + vr[b], vi[a] + vi[b]
                vr[b], vi[b] = _rotate(tr, ti, i * 8 // (2 * h))
        h //= 2


def _stockham(zr: torch.Tensor, zi: torch.Tensor, tw: torch.Tensor):
    """Unnormalised complex DFT along the last axis of ``zr + i zi``
    (``[R, M]``) in the kernel's Stockham passes: pass p reads butterfly j's
    points at ``j + r*M/radix``, turns point r by ``tw[(j % ns) * r *
    M/(ns*radix)]``, transforms them, and writes point k at
    ``(j // ns) * ns * radix + j % ns + k * ns`` (ns: product of the
    earlier radices), so the result lands in natural order."""
    m = zr.shape[-1]
    ns = 1
    for radix in fft_radices(m):
        q = m // radix
        j = torch.arange(q)
        vr = [zr[:, j + r * q] for r in range(radix)]
        vi = [zi[:, j + r * q] for r in range(radix)]
        if ns > 1:
            for r in range(1, radix):
                t = (j % ns) * r * (m // (ns * radix))
                wr, wi = tw[t, 0], tw[t, 1]
                vr[r], vi[r] = vr[r] * wr - vi[r] * wi, vr[r] * wi + vi[r] * wr
        _dft_dif(vr, vi)
        zr, zi = torch.empty_like(zr), torch.empty_like(zi)
        dst = (j // ns) * ns * radix + j % ns
        for k in range(radix):
            zr[:, dst + k * ns] = vr[_bitrev(k, radix)]
            zi[:, dst + k * ns] = vi[_bitrev(k, radix)]
        ns *= radix
    return zr, zi


def packed_rfft_plain(frames: torch.Tensor, tables: FftTables):
    """The FFT route's transform in plain torch: windowed ``[R, N]`` frames
    -> ``(re, im)`` of bins 0..N/2, ``[R, N/2 + 1]`` each, unnormalised.
    Packs sample pairs as ``z[m] = x[2m] w[2m] + i x[2m+1] w[2m+1]``, takes
    the N/2-point complex DFT Z (:func:`_stockham`) and splits it, bins k
    and M-k from the same loads (k = 1..M/2): ``X[k] = E + W O`` and
    ``X[M-k] = conj(E - W O)`` with ``E = (Z[k] + conj Z[M-k]) / 2``,
    ``O = -i (Z[k] - conj Z[M-k]) / 2`` and ``W = exp(-2 pi i k/N)``; DC
    and Nyquist are ``Re Z[0] +- Im Z[0]`` exactly."""
    rows, n = frames.shape
    m = n // 2
    x = frames.reshape(rows, m, 2) * tables.win2
    zr, zi = _stockham(x[..., 0], x[..., 1], tables.tw)
    k = torch.arange(1, m // 2 + 1)
    ar, ai = zr[:, k], zi[:, k]
    br, bi = zr[:, m - k], -zi[:, m - k]
    er, ei = (ar + br) * 0.5, (ai + bi) * 0.5
    odr, odi = (ai - bi) * 0.5, (br - ar) * 0.5
    wr, wi = tables.tws[k, 0], tables.tws[k, 1]
    tr, ti = wr * odr - wi * odi, wr * odi + wi * odr
    re, im = zr.new_zeros((rows, m + 1)), zr.new_zeros((rows, m + 1))
    up = m - k[:-1]  # bins M-k for k < M/2
    re[:, up], im[:, up] = (er - tr)[:, :-1], -(ei - ti)[:, :-1]
    re[:, k], im[:, k] = er + tr, ei + ti
    re[:, 0] = zr[:, 0] + zi[:, 0]
    re[:, m] = zr[:, 0] - zi[:, 0]
    return re, im


def mfcc_framed_plain(
    pcm: torch.Tensor, consts, hop_size: int, buf_size: int
) -> torch.Tensor:
    """K2's plain twin: float PCM ``[B, S]`` -> ``[B, S // hop, n_coefs]``."""
    b = pcm.shape[0]
    frames = frames_from_pcm(pcm, hop_size, buf_size)
    f = frames.shape[1]
    return mfcc_rows_plain(frames.reshape(b * f, buf_size), consts).reshape(
        b, f, -1
    )


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(t: torch.Tensor, name: str, dtype=torch.float32) -> None:
    if t.dtype != dtype or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: needs a contiguous, 16-byte aligned {dtype} tensor "
            f"(got {t.dtype}, contiguous={t.is_contiguous()})"
        )


def _check_consts(consts, device) -> tuple[int, int, int, int]:
    dft_re, dft_im, mel_t, dct_t = consts[:4]
    win, n_bins = dft_re.shape
    n_filters, n_coefs = dct_t.shape
    if dft_im.shape != (win, n_bins) or mel_t.shape != (n_bins, n_filters):
        raise ValueError("inconsistent MFCC constant shapes")
    for c, name in zip(consts[:4], ("dft_re", "dft_im", "mel_t", "dct_t")):
        _check(c, name)
        if c.device != device:
            raise ValueError(f"{name} is on {c.device}, frames on {device}")
    return win, n_bins, n_filters, n_coefs


def _fft_tables(consts, device) -> FftTables:
    win = consts[0].shape[0]
    fft = consts.fft if isinstance(consts, MfccConstants) else None
    if fft is None or fft.win2.shape != (win // 2, 2):
        raise ValueError(
            f"a {win}-sample window takes the FFT kernels: pass the "
            f"MfccConstants of device_constants, with their FFT tables"
        )
    for c, name, dtype in zip(fft, FftTables._fields,
                              (torch.float32,) * 3 + (torch.int32,
                                                      torch.float32)):
        _check(c, name, dtype)
        if c.device != device:
            raise ValueError(f"{name} is on {c.device}, frames on {device}")
    return fft


def _cuda_only(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


def _check_rows(frames: torch.Tensor, consts, name: str):
    _cuda_only(frames, name)
    shape = _check_consts(consts, frames.device)
    _check(frames, "frames")
    win = shape[0]
    if frames.ndim != 2 or frames.shape[1] != win or win % 4:
        raise ValueError(f"frames must be [R, {win}] with win % 4 == 0")
    return shape


def mfcc_rows(frames: torch.Tensor, consts) -> torch.Tensor:
    """K1: ``[R, win]`` float32 frames -> ``[R, n_coefs]`` fingerprint, on
    the FFT route for a power-of-two window (:func:`fft_route`), else on
    the DFT route (:func:`mfcc_rows_dft`)."""
    if frames.device.type == "cpu":
        return mfcc_rows_plain(frames, consts)
    if not fft_route(consts[0].shape[0]):
        return mfcc_rows_dft(frames, consts)
    win, _, n_filters, n_coefs = _check_rows(frames, consts, "mfcc_rows")
    fft = _fft_tables(consts, frames.device)
    rows = frames.shape[0]
    out = torch.empty((rows, n_coefs), dtype=torch.float32, device=frames.device)
    if rows == 0:
        return out
    rc = build.kernel_library().tiresias_mfcc_rows_fft(
        frames.data_ptr(), rows, win, fft.win2.data_ptr(), fft.tw.data_ptr(),
        fft.tws.data_ptr(), fft.mel_idx.data_ptr(), fft.mel_w.data_ptr(),
        n_filters, consts.dct_t.data_ptr(), n_coefs, out.data_ptr(),
        torch.cuda.current_stream(frames.device).cuda_stream,
    )
    build.check("mfcc_rows", rc)
    return out


def mfcc_rows_dft(frames: torch.Tensor, consts) -> torch.Tensor:
    """K1 on the DFT route (any window with ``win % 4 == 0``): the
    window-folded DFT as a product, the method of the Pallas kernel."""
    if frames.device.type == "cpu":
        return mfcc_rows_plain(frames, consts)
    win, n_bins, n_filters, n_coefs = _check_rows(frames, consts,
                                                  "mfcc_rows_dft")
    rows = frames.shape[0]
    out = torch.empty((rows, n_coefs), dtype=torch.float32, device=frames.device)
    if rows == 0:
        return out
    dft_re, dft_im, mel_t, dct_t = consts[:4]
    rc = build.kernel_library().tiresias_mfcc_rows(
        frames.data_ptr(), rows, win, dft_re.data_ptr(), dft_im.data_ptr(),
        n_bins, mel_t.data_ptr(), n_filters, dct_t.data_ptr(), n_coefs,
        out.data_ptr(), torch.cuda.current_stream(frames.device).cuda_stream,
    )
    build.check("mfcc_rows_dft", rc)
    return out


def _check_framed(pcm, consts, hop_size, buf_size, name):
    _cuda_only(pcm, name)
    shape = _check_consts(consts, pcm.device)
    _check(pcm, "pcm")
    if buf_size != 2 * hop_size or shape[0] != buf_size or hop_size % 4:
        raise ValueError(
            f"{name} needs buf_size == 2 * hop_size, hop_size % 4 == 0"
        )
    if pcm.ndim != 2 or pcm.shape[1] % hop_size:
        raise ValueError("pcm must be [B, S] with S a multiple of hop_size")
    return shape


def mfcc_framed(
    pcm: torch.Tensor, consts, hop_size: int, buf_size: int
) -> torch.Tensor:
    """K2: float32 PCM ``[B, S]`` (S a multiple of hop) ->
    ``[B, S // hop, n_coefs]`` with in-kernel framing (win == 2*hop), on the
    FFT route for a power-of-two window, else on the DFT route
    (:func:`mfcc_framed_dft`)."""
    if pcm.device.type == "cpu":
        return mfcc_framed_plain(pcm, consts, hop_size, buf_size)
    if not fft_route(buf_size):
        return mfcc_framed_dft(pcm, consts, hop_size, buf_size)
    _, _, n_filters, n_coefs = _check_framed(pcm, consts, hop_size, buf_size,
                                             "mfcc_framed")
    fft = _fft_tables(consts, pcm.device)
    b, s = pcm.shape
    f = s // hop_size
    out = torch.empty((b, f, n_coefs), dtype=torch.float32, device=pcm.device)
    if b == 0 or f == 0:
        return out
    rc = build.kernel_library().tiresias_mfcc_framed_fft(
        pcm.data_ptr(), b, s, hop_size, f, fft.win2.data_ptr(),
        fft.tw.data_ptr(), fft.tws.data_ptr(), fft.mel_idx.data_ptr(),
        fft.mel_w.data_ptr(), n_filters, consts.dct_t.data_ptr(), n_coefs,
        out.data_ptr(), torch.cuda.current_stream(pcm.device).cuda_stream,
    )
    build.check("mfcc_framed", rc)
    return out


def mfcc_framed_dft(
    pcm: torch.Tensor, consts, hop_size: int, buf_size: int
) -> torch.Tensor:
    """K2 on the DFT route (any ``buf_size == 2 * hop_size`` with
    ``hop_size % 4 == 0``)."""
    if pcm.device.type == "cpu":
        return mfcc_framed_plain(pcm, consts, hop_size, buf_size)
    _, n_bins, n_filters, n_coefs = _check_framed(pcm, consts, hop_size,
                                                  buf_size, "mfcc_framed_dft")
    b, s = pcm.shape
    f = s // hop_size
    out = torch.empty((b, f, n_coefs), dtype=torch.float32, device=pcm.device)
    if b == 0 or f == 0:
        return out
    dft_re, dft_im, mel_t, dct_t = consts[:4]
    rc = build.kernel_library().tiresias_mfcc_framed(
        pcm.data_ptr(), b, s, hop_size, f, dft_re.data_ptr(),
        dft_im.data_ptr(), n_bins, mel_t.data_ptr(), n_filters,
        dct_t.data_ptr(), n_coefs, out.data_ptr(),
        torch.cuda.current_stream(pcm.device).cuda_stream,
    )
    build.check("mfcc_framed_dft", rc)
    return out
