"""Analysis windows (aubio-compatible).

The reference's phase vocoder (``new_aubio_pvoc`` at
``fp_handler.c:613``) uses aubio's default window,
``hanningz``: ``w[i] = 0.5 * (1 - cos(2*pi*i / N))`` — a *periodic* Hann
window (denominator ``N``, not ``N-1``), per aubio's ``new_aubio_window``.

aubio is not installable in this environment; this module is a from-scratch
re-derivation of the published aubio algorithm (see PARITY.md §1).
"""

from __future__ import annotations

import numpy as np


def hanningz(size: int, dtype=np.float64) -> np.ndarray:
    """aubio's 'hanningz' window: 0.5*(1 - cos(2*pi*i/size))."""
    i = np.arange(size, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / size))).astype(dtype)


def hanning(size: int, dtype=np.float64) -> np.ndarray:
    """Symmetric Hann (aubio 'hanning'): 0.5 - 0.5*cos(2*pi*i/(size-1))."""
    i = np.arange(size, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * i / (size - 1))).astype(dtype)


_WINDOWS = {
    "hanningz": hanningz,
    "hanning": hanning,
}


def get_window(name: str, size: int, dtype=np.float64) -> np.ndarray:
    try:
        fn = _WINDOWS[name]
    except KeyError:
        raise ValueError(f"unknown window {name!r}; have {sorted(_WINDOWS)}") from None
    return fn(size, dtype=dtype)
