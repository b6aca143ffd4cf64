"""The fingerprint chain in plain PyTorch: the benchmark's reference for what
the program computes from PCM (aubio's MFCC as the reference Asterisk
module stores it).

    pcm [N, S] float32 -> frames of ``win`` samples every ``hop`` (zeros
    before t = 0; frame f ends at sample (f + 1) * hop) -> periodic Hann
    window -> |rfft| -> Slaney mel bank (magnitude, 40 filters) -> safe
    log10 -> orthonormal DCT-II, first ``n_coefs`` rows -> 10 * safe
    log10 |.|

Written from the published algorithms (aubio's ``hanningz`` window,
``aubio_filterbank_set_mel_coeffs_slaney`` with its triangle-band walk, its
``SAFE_LOG10`` floor, the DCT of ``mfcc.c``); it imports nothing of the
program. The benchmark's control computes it one precision below the
float32 that the configuration states: ``precision="tf32"`` rounds the
operands of the two matrix products to TF32's 10-bit mantissa, as a
tensor-core TF32 product does; ``"tf32+bf16"`` also holds the fingerprint
values in bfloat16, the step below float32 for values that are stored and
compared rather than multiplied.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# aubio SAFE_LOG10: values below the threshold map to log10(2e-42)
VERY_SMALL_NUMBER = 2e-42
FLOOR_THRESHOLD = 1e-37
LOG10_FLOOR = float(np.log10(VERY_SMALL_NUMBER))

# Slaney's 40-filter bank (Auditory Toolbox mfcc.m, as aubio builds it)
LOWEST_FREQUENCY = 133.3333
LINEAR_SPACING = 66.66666666
LOG_SPACING = 1.0711703
LINEAR_FILTERS = 13
LOG_FILTERS = 27

PRECISIONS = ("float32", "tf32", "tf32+bf16")


def tf32_rounded(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, nearest with
    ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _edge_freqs(n_filters: int, samplerate: float) -> np.ndarray:
    if n_filters == LINEAR_FILTERS + LOG_FILTERS:
        freqs = np.empty(n_filters + 2)
        for fn in range(LINEAR_FILTERS):
            freqs[fn] = LOWEST_FREQUENCY + fn * LINEAR_SPACING
        last = freqs[LINEAR_FILTERS - 1]
        for fn in range(LOG_FILTERS + 2):
            freqs[fn + LINEAR_FILTERS] = last * LOG_SPACING ** (fn + 1)
        return freqs
    # any other count: HTK mel spacing from 0 Hz to Nyquist
    top = 1127.01048 * np.log(1.0 + samplerate / 2.0 / 700.0)
    mels = np.linspace(0.0, top, n_filters + 2)
    return 700.0 * (np.exp(mels / 1127.01048) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_bank(n_filters: int, win: int, samplerate: int) -> np.ndarray:
    """``[n_bins, n_filters]`` float32: aubio's triangle bands, walked bin
    by bin as aubio walks them (the Nyquist bin is never assigned)."""
    freqs = _edge_freqs(n_filters, float(samplerate))
    n_bins = win // 2 + 1
    lower, center, upper = freqs[:-2], freqs[1:-1], freqs[2:]
    heights = 2.0 / (upper - lower)
    fft_freqs = np.arange(n_bins) * samplerate / ((n_bins - 1) * 2)
    bank = np.zeros((n_filters, n_bins))
    for fn in range(n_filters):
        b = 0
        while b < n_bins - 1:
            b += 1
            if fft_freqs[b - 1] <= lower[fn] < fft_freqs[b]:
                break
        rise = heights[fn] / (center[fn] - lower[fn])
        while b < n_bins - 1:
            bank[fn, b] = (fft_freqs[b] - lower[fn]) * rise
            b += 1
            if fft_freqs[b] >= center[fn]:
                break
        fall = heights[fn] / (upper[fn] - center[fn])
        while b < n_bins - 1:
            bank[fn, b] = max(0.0, bank[fn, b]
                              + (upper[fn] - fft_freqs[b]) * fall)
            b += 1
            if fft_freqs[b] >= upper[fn]:
                break
    return np.ascontiguousarray(bank.T.astype(np.float32))


@functools.lru_cache(maxsize=8)
def dct_rows(n_filters: int, n_coefs: int) -> np.ndarray:
    """``[n_filters, n_coefs]`` float32: the orthonormal DCT-II's first rows,
    transposed."""
    j = np.arange(n_coefs)[:, None]
    i = np.arange(n_filters)[None, :]
    mat = np.cos(j * (i + 0.5) * np.pi / n_filters) / np.sqrt(n_filters / 2)
    mat[0] *= np.sqrt(2.0) / 2.0
    return np.ascontiguousarray(mat.T.astype(np.float32))


def hann(win: int) -> np.ndarray:
    """aubio's periodic Hann window ``hanningz``, float32."""
    i = np.arange(win)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / win))).astype(np.float32)


def safe_log10(x: torch.Tensor) -> torch.Tensor:
    floor = torch.full_like(x, LOG10_FLOOR)
    return torch.where(x >= FLOOR_THRESHOLD,
                       torch.log10(x.clamp(min=FLOOR_THRESHOLD)), floor)


def frames_of(pcm: torch.Tensor, hop: int, win: int) -> torch.Tensor:
    """``[N, S]`` -> ``[N, ceil(S / hop), win]``: zeros before the signal
    and after it up to a whole hop."""
    n, s = pcm.shape
    f = -(-s // hop)
    padded = torch.zeros((n, win - hop + f * hop), dtype=pcm.dtype,
                         device=pcm.device)
    padded[:, win - hop: win - hop + s] = pcm
    return padded.unfold(1, win, hop)


def fingerprints(pcm: torch.Tensor, samplerate: int, hop: int, win: int,
                 n_filters: int, n_coefs: int,
                 precision: str = "float32",
                 rows_per_block: int = 1 << 16) -> torch.Tensor:
    """``pcm [N, S]`` float32 -> ``[N, ceil(S / hop), n_coefs]`` float32,
    in blocks of frames so that it fits beside the caller's data."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    dev = pcm.device
    window = torch.from_numpy(hann(win)).to(dev)
    mel = torch.from_numpy(mel_bank(n_filters, win, samplerate)).to(dev)
    dct = torch.from_numpy(dct_rows(n_filters, n_coefs)).to(dev)
    tf32 = precision.startswith("tf32")
    if tf32:
        mel, dct = tf32_rounded(mel), tf32_rounded(dct)
    frames = frames_of(pcm.to(torch.float32), hop, win)
    n, f, _ = frames.shape
    flat = frames.reshape(n * f, win)
    out = torch.empty((n * f, n_coefs), dtype=torch.float32, device=dev)
    tf32_flags = (torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for lo in range(0, n * f, rows_per_block):
            x = flat[lo: lo + rows_per_block] * window
            mag = torch.fft.rfft(x, dim=1).abs()
            if tf32:
                mag = tf32_rounded(mag)
            logm = safe_log10(mag @ mel)
            if tf32:
                logm = tf32_rounded(logm)
            out[lo: lo + rows_per_block] = 10.0 * safe_log10((logm @ dct).abs())
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32_flags
    if precision.endswith("bf16"):
        out = out.to(torch.bfloat16).to(torch.float32)
    return out.reshape(n, f, n_coefs)
