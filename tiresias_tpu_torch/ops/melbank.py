"""Mel filterbank construction (aubio / Slaney parity).

The reference creates its MFCC object as ``new_aubio_mfcc(512, 40, 2, sr)``
(``fp_handler.c:615``). With 40 filters aubio builds the
Malcolm Slaney (Auditory Toolbox ``mfcc.m``) filterbank via
``aubio_filterbank_set_mel_coeffs_slaney`` + ``aubio_filterbank_set_triangle_bands``.

aubio is not installable in this environment, so this module re-derives that
construction from the published algorithm, *including its loop/edge quirks*
(see PARITY.md §2):

  * 42 edge frequencies: 13 linearly spaced from 133.3333 Hz step 66.6667 Hz,
    then 29 more multiplying the last linear frequency by 1.0711703 each step.
  * filter ``fn`` rises over ``[lower, center)`` and falls over
    ``[center, upper)`` with unit-area height ``2/(upper-lower)``.
  * the per-bin weights are assigned by a literal walk over bins with
    break-on-crossing conditions; the Nyquist bin (index ``n_bins-1``) is
    never assigned and stays 0.
  * at 8 kHz the top Slaney filters extend past Nyquist and are silently
    truncated/empty (aubio warns but proceeds).

The bank is applied to the FFT *magnitude* spectrum (aubio filterbank default
``power == 1``), not the power spectrum.
"""

from __future__ import annotations

import numpy as np

SLANEY_LOWEST_FREQUENCY = 133.3333
SLANEY_LINEAR_SPACING = 66.66666666
SLANEY_LOG_SPACING = 1.0711703
SLANEY_LINEAR_FILTERS = 13
SLANEY_LOG_FILTERS = 27
SLANEY_N_FILTERS = SLANEY_LINEAR_FILTERS + SLANEY_LOG_FILTERS  # 40


def slaney_edge_freqs() -> np.ndarray:
    """The 42 triangle edge frequencies of the Slaney 40-filter bank."""
    freqs = np.empty(SLANEY_N_FILTERS + 2, dtype=np.float64)
    for fn in range(SLANEY_LINEAR_FILTERS):
        freqs[fn] = SLANEY_LOWEST_FREQUENCY + fn * SLANEY_LINEAR_SPACING
    last_linear_cf = freqs[SLANEY_LINEAR_FILTERS - 1]
    for fn in range(SLANEY_LOG_FILTERS + 2):
        freqs[fn + SLANEY_LINEAR_FILTERS] = last_linear_cf * SLANEY_LOG_SPACING ** (fn + 1)
    return freqs


def triangle_bands(freqs: np.ndarray, samplerate: float, n_bins: int) -> np.ndarray:
    """aubio ``aubio_filterbank_set_triangle_bands`` re-derivation.

    Args:
      freqs: ``n_filters + 2`` edge frequencies.
      samplerate: audio sample rate (Hz).
      n_bins: number of FFT bins (``buf_size // 2 + 1``).

    Returns:
      ``[n_filters, n_bins]`` float64 filter matrix.
    """
    n_filters = len(freqs) - 2
    lower = freqs[:n_filters]
    center = freqs[1 : n_filters + 1]
    upper = freqs[2 : n_filters + 2]
    heights = 2.0 / (upper - lower)  # unit-area triangles (aubio norm=1)
    # bin k corresponds to frequency k * sr / ((n_bins - 1) * 2)
    fft_freqs = np.arange(n_bins, dtype=np.float64) * samplerate / ((n_bins - 1) * 2)

    filters = np.zeros((n_filters, n_bins), dtype=np.float64)
    for fn in range(n_filters):
        # Walk to the first bin past the lower edge (aubio's skip loop).
        b = 0
        while b < n_bins - 1:
            if fft_freqs[b] <= lower[fn] and fft_freqs[b + 1] > lower[fn]:
                b += 1
                break
            b += 1
        # Rising slope.
        rise_inc = heights[fn] / (center[fn] - lower[fn])
        while b < n_bins - 1:
            filters[fn, b] = (fft_freqs[b] - lower[fn]) * rise_inc
            if fft_freqs[b + 1] >= center[fn]:
                b += 1
                break
            b += 1
        # Falling slope (note the `+=` and clamp-at-zero, as in aubio).
        down_inc = heights[fn] / (upper[fn] - center[fn])
        while b < n_bins - 1:
            filters[fn, b] += (upper[fn] - fft_freqs[b]) * down_inc
            if filters[fn, b] < 0.0:
                filters[fn, b] = 0.0
            if fft_freqs[b + 1] >= upper[fn]:
                b += 1
                break
            b += 1
    return filters


def hz_to_mel_htk(f):
    return 1127.01048 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (np.exp(np.asarray(m, dtype=np.float64) / 1127.01048) - 1.0)


def htk_edge_freqs(n_filters: int, samplerate: float, fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """HTK-style mel-spaced edges (used when n_filters != 40, an extension)."""
    if fmax is None:
        fmax = samplerate / 2.0
    mels = np.linspace(hz_to_mel_htk(fmin), hz_to_mel_htk(fmax), n_filters + 2)
    return mel_to_hz_htk(mels)


def mel_filterbank(n_filters: int, buf_size: int, samplerate: float) -> np.ndarray:
    """Filterbank matching the reference's choice logic.

    40 filters → Slaney bank (the reference's configuration,
    fp_handler.c:38,615); any other count → HTK-style
    mel-spaced triangles through the same triangle-band builder.
    """
    n_bins = buf_size // 2 + 1
    if n_filters == SLANEY_N_FILTERS:
        freqs = slaney_edge_freqs()
    else:
        freqs = htk_edge_freqs(n_filters, samplerate)
    return triangle_bands(freqs, samplerate, n_bins)
