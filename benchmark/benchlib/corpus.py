"""Speech-like clips made on the device from a seed: the benchmark's stand-in
for recorded prompts (the repository holds none).

A copy of ``tiresias_tpu_torch/bench.py``'s ``_speechlike_batch`` /
``_build_synth_corpus`` generator, rewritten to draw every parameter with a
``torch.Generator`` on the device: each clip is a stack of 8 harmonics of a
90-220 Hz fundamental with 3-7 Hz vibrato, each harmonic's amplitude
(0.2-1.0, over its number) modulated at 0.5-3 Hz, plus 2% white noise,
scaled to a peak of 0.3 and rounded to int16.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

HARMONICS = 8


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed for one stream of the run's inputs (``keys``: ints or
    strings), from the run's ``seed`` of any size."""
    words = [int(seed)] + [k if isinstance(k, int) else zlib.crc32(k.encode())
                           for k in keys]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return int(state >> np.uint64(1))


def speechlike(n_clips: int, n_samples: int, samplerate: int, seed: int,
               device) -> torch.Tensor:
    """``[n_clips, n_samples]`` int16 clips, the same for the same seed on
    the same device."""
    g = torch.Generator(device=device).manual_seed(seed)

    def uniform(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)

    f0 = uniform(90.0, 220.0, (n_clips, 1))
    vibf = uniform(3.0, 7.0, (n_clips, 1))
    h = torch.arange(1, HARMONICS + 1, device=device, dtype=torch.float32)
    amp = uniform(0.2, 1.0, (n_clips, HARMONICS)) / h
    modf = uniform(0.5, 3.0, (n_clips, HARMONICS))
    phase = uniform(0.0, 6.28, (n_clips, HARMONICS))
    noise = torch.randn((n_clips, n_samples), generator=g, device=device)
    t = torch.arange(n_samples, dtype=torch.float32,
                     device=device)[None, :] / samplerate
    arg = 2 * np.pi * f0 * (1.0 + 0.03 * torch.sin(2 * np.pi * vibf * t)) * t
    out = 0.02 * noise
    for k in range(HARMONICS):
        mod = 1.0 + 0.5 * torch.sin(2 * np.pi * modf[:, k, None] * t
                                    + phase[:, k, None])
        out += amp[:, k, None] * mod * torch.sin(arg * (k + 1))
    out *= 0.3 / out.abs().amax(dim=1, keepdim=True).clamp(min=1e-9)
    return torch.clamp(torch.round(out * 32768.0), -32768, 32767).to(
        torch.int16)


def checksum(pcm: torch.Tensor) -> int:
    """A position-weighted sum of int16 clips: equal for equal clips, and a
    cheap witness that a clip made again is the clip made before."""
    w = torch.arange(1, pcm.shape[1] + 1, device=pcm.device,
                     dtype=torch.int64) % 65521
    return int((pcm.to(torch.int64) * w).sum())
