"""DCT-II matrix (aubio MFCC parity).

aubio's MFCC builds its DCT coefficients as (``src/spectral/mfcc.c``):

    scaling = 1 / sqrt(n_filters / 2)
    dct[j][i] = scaling * cos(j * (i + 0.5) * pi / n_filters)
    dct[0][i] *= sqrt(2) / 2

i.e. the orthonormal DCT-II, of which the first ``n_coefs`` rows are kept.
The reference stores coefficients 0 and 1 (``DEF_AUBIO_COEFS == 2``,
fp_handler.c:39,649-652).
"""

from __future__ import annotations

import numpy as np


def dct_matrix(n_filters: int, n_coefs: int) -> np.ndarray:
    """Return the ``[n_coefs, n_filters]`` orthonormal DCT-II matrix."""
    scaling = 1.0 / np.sqrt(n_filters / 2.0)
    j = np.arange(n_coefs, dtype=np.float64)[:, None]
    i = np.arange(n_filters, dtype=np.float64)[None, :]
    mat = scaling * np.cos(j * (i + 0.5) * np.pi / n_filters)
    mat[0, :] *= np.sqrt(2.0) / 2.0
    return mat
