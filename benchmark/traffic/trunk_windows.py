"""The trunk-window generator: a pool of G.711 windows that a closed loop
sends in batches, as a scorer's score pass sends its channels' windows.

A mix file (``traffic/<mix>.json``) gives its parameters: ``pool`` windows
of ``window_samples`` codes in the ``law``; an ``excerpt_share`` of them are
excerpts of catalog tracks, at offsets on whole hops, the tracks drawn with
Zipf skew ``zipf_s`` over a seeded ranking, with white noise at ``snr_db``
below the excerpt's power added before the codes are made; the rest are
speech-like clips of the same length made from the seed and not in the
catalog (impostors). The pool is sent ``batch`` windows a call in a seeded
order, cycled; ``warmup_calls`` calls of that shape come before the window.
Every seed gives the same sizes and the same mix, in another order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchlib.corpus import speechlike, sub_seed
from benchlib.g711 import encode_ulaw


@dataclasses.dataclass
class Pool:
    codes: np.ndarray  # [P, W] uint8
    track: np.ndarray  # [P] the excerpt's track, -1 for an impostor
    offset: np.ndarray  # [P] the excerpt's first sample
    order: np.ndarray  # [P] the seeded order of sending

    def windows(self, idx) -> list:
        return [self.codes[i] for i in idx]


class Plan:
    def __init__(self, mix: dict, catalog: dict, track_samples: int,
                 hop: int, seed: int):
        if mix["law"] != "ulaw":
            raise ValueError("the generator makes µ-law windows only")
        self.mix, self.seed = mix, seed
        self.samplerate = int(catalog["samplerate"])
        n_tracks = int(catalog["tracks"])
        rng = np.random.default_rng(sub_seed(seed, "traffic"))
        p = int(mix["pool"])
        w = int(mix["window_samples"])
        n_exc = int(round(p * float(mix["excerpt_share"])))
        ranks = np.arange(1, n_tracks + 1, dtype=np.float64)
        weights = ranks ** -float(mix["zipf_s"])
        by_rank = rng.permutation(n_tracks)
        tracks = by_rank[rng.choice(n_tracks, size=n_exc,
                                    p=weights / weights.sum())]
        last_hop = (track_samples - w) // hop
        offsets = rng.integers(0, last_hop + 1, size=n_exc) * hop
        slot = rng.permutation(p)  # pool slots of excerpts, then impostors
        self.track = np.full(p, -1, np.int64)
        self.offset = np.zeros(p, np.int64)
        self.track[slot[:n_exc]] = tracks
        self.offset[slot[:n_exc]] = offsets
        self.order = rng.permutation(p)
        self.codes = np.empty((p, w), np.uint8)
        self.window = w

    def take(self, lo: int, pcm: torch.Tensor) -> None:
        """Cut, noise and encode the excerpts of the catalog tracks
        ``lo .. lo + len(pcm)`` (int16 on the device)."""
        hit = np.flatnonzero((self.track >= lo)
                             & (self.track < lo + pcm.shape[0]))
        if hit.size == 0:
            return
        dev = pcm.device
        rows = torch.from_numpy(self.track[hit] - lo).to(dev)
        start = torch.from_numpy(self.offset[hit]).to(dev)
        cols = start[:, None] + torch.arange(self.window, device=dev)[None]
        x = pcm[rows[:, None], cols].to(torch.float32)
        g = torch.Generator(device=dev).manual_seed(
            sub_seed(self.seed, "noise", lo))
        noise = torch.randn(x.shape, generator=g, device=dev)
        rms = x.square().mean(dim=1, keepdim=True).sqrt()
        x = x + noise * rms * 10.0 ** (-float(self.mix["snr_db"]) / 20.0)
        i16 = torch.clamp(torch.round(x), -32768, 32767).to(torch.int16)
        self.codes[hit] = encode_ulaw(i16).cpu().numpy()

    def finish(self, device) -> Pool:
        """Make the impostors and hand over the pool."""
        imp = np.flatnonzero(self.track < 0)
        if imp.size:
            hop_pad = -(-self.window // 256) * 256
            pcm = speechlike(imp.size, hop_pad, self.samplerate,
                             sub_seed(self.seed, "impostor"), device)
            self.codes[imp] = encode_ulaw(pcm[:, : self.window]).cpu().numpy()
        return Pool(self.codes, self.track, self.offset, self.order)


def plan(mix: dict, catalog: dict, track_samples: int, hop: int,
         seed: int) -> Plan:
    return Plan(mix, catalog, track_samples, hop, seed)
