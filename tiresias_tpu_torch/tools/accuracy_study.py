"""Recognition-accuracy study on the port.

Builds a synthetic speech-like corpus, ingests it, and sweeps matching
configurations over excerpt / noisy / unrelated query sets, printing top-1
accuracy and false accepts per configuration: the dialplan reference
semantics (K3'), aligned votes (K5) at coefs 4 and 8 and four tolerances,
and the same excerpts as G.711 u-law wire bytes.

Run (on ``cuda``; ``--device cpu`` for the plain PyTorch versions):

    python -m tiresias_tpu_torch.tools.accuracy_study [n_clips] [n_queries]
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np

from tiresias_tpu_torch.api import Tiresias
from tiresias_tpu_torch.config import DspConfig, TiresiasConfig
from tiresias_tpu_torch.utils.audio import float_to_i16
from tiresias_tpu_torch.utils.g711 import encode

SR = 8000
CLIP_S = 3.0
QUERY_S = 1.5


def speechlike(rng: np.random.Generator, seconds: float) -> np.ndarray:
    """Harmonic stacks with pitch/amplitude modulation + breath noise —
    enough spectral structure to be individually identifiable."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f0 = rng.uniform(90, 220)
    vibrato = 1.0 + 0.03 * np.sin(2 * np.pi * rng.uniform(3, 7) * t)
    out = np.zeros(n)
    for h in range(1, 9):
        amp = rng.uniform(0.2, 1.0) / h
        mod = 1.0 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.5, 3.0) * t
                                 + rng.uniform(0, 6.28))
        out += amp * mod * np.sin(2 * np.pi * f0 * h * vibrato * t)
    out += 0.02 * rng.standard_normal(n)
    out *= 0.3 / max(1e-9, np.abs(out).max())
    return out.astype(np.float32)


def add_noise(pcm: np.ndarray, snr_db: float, rng) -> np.ndarray:
    sig = float((pcm ** 2).mean())
    noise = rng.standard_normal(len(pcm)).astype(np.float32)
    noise *= np.sqrt(sig / (10 ** (snr_db / 10)) / float((noise ** 2).mean()))
    return pcm + noise


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tiresias_tpu_torch.tools.accuracy_study")
    ap.add_argument("n_clips", nargs="?", type=int, default=200)
    ap.add_argument("n_queries", nargs="?", type=int, default=50)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    n_clips, n_queries = args.n_clips, args.n_queries
    rng = np.random.default_rng(99)

    dsp = DspConfig(n_coefs=8)  # store 8; search any prefix
    eng = Tiresias(
        TiresiasConfig(dsp=dsp, data_dir=tempfile.mkdtemp(prefix="tir_acc")),
        restore=False, device=args.device,
    )
    eng.create_context("c")
    clips = [speechlike(rng, CLIP_S) for _ in range(n_clips)]
    for i, clip in enumerate(clips):
        i16 = float_to_i16(clip)
        eng.add_audio_pcm("c", f"clip{i}", i16.astype(np.float32) / 32768.0,
                          SR)
    names = [e.name for e in eng.get_audios("c")]
    print(f"corpus: {len(names)} clips x {CLIP_S}s", file=sys.stderr)

    qn = int(QUERY_S * SR)
    picks = rng.choice(n_clips, size=min(n_queries, n_clips), replace=False)
    excerpts, truth = [], []
    for i in picks:
        off = rng.integers(0, int((CLIP_S - QUERY_S) * SR))
        off -= off % 256  # frame-aligned excerpt
        excerpts.append(clips[i][off : off + qn])
        truth.append(f"clip{i}")
    noisy = [add_noise(q, 20.0, rng) for q in excerpts]
    unrelated = [speechlike(rng, QUERY_S) for _ in range(n_queries)]

    # trunk-quality query sets: the same excerpts as raw G.711 u-law wire
    # bytes (clean catalog, companded queries), searched with wire_law so
    # the device expansion is what is measured
    def to_wire(qs):
        return [encode(float_to_i16(q), "ulaw") for q in qs]

    wire_excerpts = to_wire(excerpts)
    wire_noisy = to_wire(noisy)
    wire_unrelated = to_wire(unrelated)

    def run(label, wire=None, **kw):
        if wire is not None:
            q_ex, q_nz, q_un = wire_excerpts, wire_noisy, wire_unrelated
        else:
            q_ex, q_nz, q_un = excerpts, noisy, unrelated

        def score(queries, expect):
            res = eng.search_pcm_batch("c", queries, SR, wire_law=wire, **kw)
            if expect is None:  # unrelated: count confident false accepts
                return sum(r.found and r.confidence > 0.5 for r in res)
            return sum(
                r.found and r.name == want for r, want in zip(res, expect)
            )
        ex = score(q_ex, truth)
        nz = score(q_nz, truth)
        fa = score(q_un, None)
        print(f"{label:55s} exact {ex}/{n_queries}  noisy20dB {nz}/{n_queries}"
              f"  false-accepts {fa}/{n_queries}", flush=True)

    run("reference semantics (coefs=1, trunc, tol 0.001)")
    for coefs in (4, 8):
        for tol in (0.1, 0.3, 0.5, 1.0):
            run(
                f"aligned, coefs={coefs}, tol={tol}",
                coefs=coefs, tolerance=tol, trunc_coef1=False, aligned=True,
            )
    # the recommended accuracy configurations against G.711 trunk queries:
    # companding moves stored values by up to ~0.7 dB, so the tighter
    # tolerances are expected to need headroom
    for tol in (0.1, 0.15, 0.2, 0.3):
        run(
            f"aligned, coefs=8, tol={tol}, G.711 ulaw wire",
            wire="ulaw",
            coefs=8, tolerance=tol, trunc_coef1=False, aligned=True,
        )
    eng.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
