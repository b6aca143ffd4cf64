"""G.711 µ-law compression for the benchmark's traffic: int16 PCM -> the
codes a trunk carries (Sun g711.c's ``linear2ulaw``, as CPython's audioop
computes it), on whatever device the samples are."""

from __future__ import annotations

import torch

BIAS = 0x84
CLIP = 8159
# 14-bit segment ends (the compressor works on pcm >> 2)
SEG_END = (0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF, 0x1FFF)


def encode_ulaw(pcm: torch.Tensor) -> torch.Tensor:
    """int16 samples -> uint8 µ-law codes."""
    val = pcm.to(torch.int32) >> 2
    neg = val < 0
    mag = torch.clamp(torch.where(neg, -val, val), max=CLIP) + (BIAS >> 2)
    ends = torch.tensor(SEG_END, dtype=torch.int32, device=pcm.device)
    seg = torch.searchsorted(ends, mag.contiguous())  # first end >= mag
    segc = torch.clamp(seg, max=7)
    code = torch.where(seg >= 8, torch.full_like(mag, 0x7F),
                       (segc << 4) | ((mag >> (segc + 1)) & 0x0F))
    return (code ^ torch.where(neg, 0x7F, 0xFF)).to(torch.uint8)
