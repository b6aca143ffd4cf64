"""Fused MFCC kernels K1 and K2 (port of ``tiresias_tpu.ops.mfcc_pallas``).

Both compute the window-folded DFT -> |.| -> mel -> safe_log10 -> DCT ->
``10*log10|.|`` chain in float32 (``csrc/mfcc.cu``, sharing one device
function from ``csrc/common.cuh``):

  * :func:`mfcc_rows` (K1, replaces ``_mfcc_kernel``): pre-framed rows.
  * :func:`mfcc_framed` (K2, replaces ``_framing_kernel``): frames assembled
    inside the kernel from the signal, each sample read once per block.

Each wrapper launches its kernel for a CUDA tensor (raising on any failure)
and takes its plain PyTorch twin for a CPU tensor; the twins live here too
(:func:`mfcc_rows_plain`, :func:`mfcc_framed_plain`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tiresias_tpu.config import DspConfig
from tiresias_tpu.ops.dct import dct_matrix
from tiresias_tpu.ops.melbank import mel_filterbank
from tiresias_tpu.ops.reference_dsp import VERY_SMALL_NUMBER
from tiresias_tpu.ops.windows import hanningz
from tiresias_tpu_torch.utils import build

# Row tile of the routing rule in fingerprint_padded_batch (the framed
# kernel's padding-waste test is stated in these units).
ROW_TILE = 256

# aubio SAFE_LOG10 (PARITY.md section 2): values below the smallest safe
# threshold map to the exact constant log10(2e-42).
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


@functools.lru_cache(maxsize=16)
def device_constants(
    dsp: DspConfig, samplerate: int, device: torch.device
) -> tuple[torch.Tensor, ...]:
    """:func:`kernel_constants` as tensors on ``device``, uploaded once per
    (dsp, samplerate, device). Read-only: every caller shares them."""
    return tuple(
        torch.from_numpy(c).to(device) for c in kernel_constants(dsp, samplerate)
    )


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------


def _no_tf32() -> None:
    # the twins are the float32 reference: TF32 keeps ~3 decimal digits,
    # the same class of drift as the TPU's bf16 default (+-0.03)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mfcc_rows_plain(frames: torch.Tensor, consts) -> torch.Tensor:
    """K1's plain twin: ``[R, win]`` frames -> ``[R, n_coefs]``."""
    _no_tf32()
    dft_re, dft_im, mel_t, dct_t = consts
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
    dft_re, dft_im, mel_t, dct_t = consts
    win, n_bins = dft_re.shape
    n_filters, n_coefs = dct_t.shape
    if dft_im.shape != (win, n_bins) or mel_t.shape != (n_bins, n_filters):
        raise ValueError("inconsistent MFCC constant shapes")
    for c, name in zip(consts, ("dft_re", "dft_im", "mel_t", "dct_t")):
        _check(c, name)
        if c.device != device:
            raise ValueError(f"{name} is on {c.device}, frames on {device}")
    return win, n_bins, n_filters, n_coefs


def _cuda_only(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


def mfcc_rows(frames: torch.Tensor, consts) -> torch.Tensor:
    """K1: ``[R, win]`` float32 frames -> ``[R, n_coefs]`` fingerprint."""
    if frames.device.type == "cpu":
        return mfcc_rows_plain(frames, consts)
    _cuda_only(frames, "mfcc_rows")
    win, n_bins, n_filters, n_coefs = _check_consts(consts, frames.device)
    _check(frames, "frames")
    if frames.ndim != 2 or frames.shape[1] != win or win % 4:
        raise ValueError(f"frames must be [R, {win}] with win % 4 == 0")
    rows = frames.shape[0]
    out = torch.empty((rows, n_coefs), dtype=torch.float32, device=frames.device)
    if rows == 0:
        return out
    lib = build.kernel_library()
    dft_re, dft_im, mel_t, dct_t = consts
    rc = lib.tiresias_mfcc_rows(
        frames.data_ptr(), rows, win, dft_re.data_ptr(), dft_im.data_ptr(),
        n_bins, mel_t.data_ptr(), n_filters, dct_t.data_ptr(), n_coefs,
        out.data_ptr(), torch.cuda.current_stream(frames.device).cuda_stream,
    )
    build.check("mfcc_rows", rc)
    return out


def mfcc_framed(
    pcm: torch.Tensor, consts, hop_size: int, buf_size: int
) -> torch.Tensor:
    """K2: float32 PCM ``[B, S]`` (S a multiple of hop) ->
    ``[B, S // hop, n_coefs]`` with in-kernel framing (win == 2*hop)."""
    if pcm.device.type == "cpu":
        return mfcc_framed_plain(pcm, consts, hop_size, buf_size)
    _cuda_only(pcm, "mfcc_framed")
    win, n_bins, n_filters, n_coefs = _check_consts(consts, pcm.device)
    _check(pcm, "pcm")
    if buf_size != 2 * hop_size or win != buf_size or hop_size % 4:
        raise ValueError(
            "mfcc_framed needs buf_size == 2 * hop_size, hop_size % 4 == 0"
        )
    if pcm.ndim != 2 or pcm.shape[1] % hop_size:
        raise ValueError("pcm must be [B, S] with S a multiple of hop_size")
    b, s = pcm.shape
    f = s // hop_size
    out = torch.empty((b, f, n_coefs), dtype=torch.float32, device=pcm.device)
    if b == 0 or f == 0:
        return out
    lib = build.kernel_library()
    dft_re, dft_im, mel_t, dct_t = consts
    rc = lib.tiresias_mfcc_framed(
        pcm.data_ptr(), b, s, hop_size, f, dft_re.data_ptr(),
        dft_im.data_ptr(), n_bins, mel_t.data_ptr(), n_filters,
        dct_t.data_ptr(), n_coefs, out.data_ptr(),
        torch.cuda.current_stream(pcm.device).cuda_stream,
    )
    build.check("mfcc_framed", rc)
    return out
