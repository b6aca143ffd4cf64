"""G.711 µ-law expansion in plain NumPy/PyTorch (CCITT G.711, the algorithm
of Sun's g711.c that Asterisk, sox and CPython's audioop use): the
reference's reading of the µ-law codes that the benchmark sends."""

from __future__ import annotations

import numpy as np
import torch

BIAS = 0x84


def ulaw_table() -> np.ndarray:
    """``[256]`` int16: the linear value of every µ-law code."""
    u = np.arange(256, dtype=np.int32) ^ 0xFF  # codes are stored inverted
    t = (((u & 0x0F) << 3) + BIAS) << ((u & 0x70) >> 4)
    return np.where(u & 0x80, BIAS - t, t - BIAS).astype(np.int16)


def ulaw_to_float(codes: torch.Tensor) -> torch.Tensor:
    """uint8 codes -> float32 samples in [-1, 1) (the linear value / 32768)."""
    table = torch.from_numpy(ulaw_table().astype(np.float32) / 32768.0)
    return table.to(codes.device)[codes.long()]
