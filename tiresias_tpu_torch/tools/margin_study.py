"""Margin-based acceptance study on the port.

Hypothesis: true matches win by a wide vote margin over the runner-up,
impostors near-tie, so accepting on margin = (v1 - v2) / v1 separates them
where absolute confidence cannot. This study measures the margin
distributions of true noisy matches against impostors at several
tolerances, over a synthetic speech-like corpus synthesized and
fingerprinted on the device, and prints recall / false-accept tables per
margin threshold (aligned votes, coefs 8, through the engine's certified
prefilter with its certificate taken at the top 2, so the runner-up is
exact).

Run (on ``cuda``; ``--device cpu`` for the plain PyTorch versions):

    python -m tiresias_tpu_torch.tools.margin_study --tracks 10240
    python -m tiresias_tpu_torch.tools.margin_study --weighted [--tracks N]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np
import torch

from tiresias_tpu_torch.api import Tiresias
from tiresias_tpu_torch.config import DspConfig, TiresiasConfig
from tiresias_tpu_torch.ops.mfcc import fingerprint_padded_batch
from tiresias_tpu_torch.utils.device import resolve_device

SR = 8000
CLIP_S, QUERY_S = 2.0, 1.5
TOLS = (0.1, 0.2, 0.3, 0.35, 0.4, 0.45, 0.5)
BATCH = 512
# measured |delta| p90 per coef at 20 dB SNR (speechlike), divided by its
# mean: the weighted study's per-coefficient scale
NOISE_P90 = (0.182, 0.065, 0.131, 0.112, 0.110, 0.130, 0.274, 0.407)


def speechlike_batch(
    rng: np.random.Generator, n_clips: int, seconds: float, sr: int = SR
) -> np.ndarray:
    """[n_clips, n] of individually identifiable harmonic-stack clips (the
    accuracy study's ``speechlike`` vectorized across clips), n cut to
    whole 256-sample frames."""
    n = int(seconds * sr)
    n -= n % 256  # frame-aligned clip length
    t = np.arange(n, dtype=np.float32)[None, :] / sr
    f0 = rng.uniform(90, 220, (n_clips, 1)).astype(np.float32)
    vib = 1.0 + 0.03 * np.sin(
        2 * np.pi * rng.uniform(3, 7, (n_clips, 1)).astype(np.float32) * t
    )
    out = np.zeros((n_clips, n), np.float32)
    for h in range(1, 9):
        amp = (rng.uniform(0.2, 1.0, (n_clips, 1)) / h).astype(np.float32)
        mod = 1.0 + 0.5 * np.sin(
            2 * np.pi * rng.uniform(0.5, 3.0, (n_clips, 1)).astype(np.float32)
            * t
            + rng.uniform(0, 6.28, (n_clips, 1)).astype(np.float32)
        )
        out += amp * mod * np.sin(2 * np.pi * f0 * h * vib * t)
    out += 0.02 * rng.standard_normal((n_clips, n)).astype(np.float32)
    out *= 0.3 / np.maximum(1e-9, np.abs(out).max(axis=1, keepdims=True))
    return out.astype(np.float32)


def draw_params(rng: np.random.Generator, nb: int) -> tuple:
    """Per-clip synthesis parameters (f0, vibrato rate, harmonic amplitudes,
    modulation rates and phases), drawn on the host from ``rng``."""
    return (
        rng.uniform(90, 220, (nb, 1)),
        rng.uniform(3, 7, (nb, 1)),
        rng.uniform(0.2, 1.0, (nb, 8, 1)) / np.arange(1, 9)[None, :, None],
        rng.uniform(0.5, 3.0, (nb, 8, 1)),
        rng.uniform(0, 6.28, (nb, 8, 1)),
    )


def synth_batch(params: tuple, seed: int, n_clip: int, dsp: DspConfig,
                device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(int16 clips ``[nb, n_clip]``, fingerprints ``[nb, F, C]``), both on
    ``device``: the harmonic stacks synthesized there, their noise from a
    ``torch.Generator`` seeded with ``seed``, fingerprinted by
    :func:`fingerprint_padded_batch`."""
    f0, vibf, amp, modf, phase = (
        torch.as_tensor(p, dtype=torch.float32, device=device) for p in params
    )
    t = torch.arange(n_clip, dtype=torch.float32, device=device)[None, None] / SR
    vib = 1.0 + 0.03 * torch.sin(2 * torch.pi * vibf[:, None, :] * t)
    h = torch.arange(1, 9, dtype=torch.float32, device=device)[None, :, None]
    mod = 1.0 + 0.5 * torch.sin(2 * torch.pi * modf * t + phase)
    out = (amp * mod * torch.sin(2 * torch.pi * f0[:, None, :] * h * vib * t)
           ).sum(dim=1)
    g = torch.Generator(device=device).manual_seed(seed)
    out += 0.02 * torch.randn(out.shape, generator=g, device=device)
    out *= 0.3 / out.abs().amax(dim=1, keepdim=True).clamp(min=1e-9)
    i16 = torch.clamp(torch.round(out * 32768.0), -32768, 32767).to(
        torch.int16)
    return i16, fingerprint_padded_batch(i16, SR, dsp, device=device)


def synth_corpus(rng: np.random.Generator, n_tracks: int, targets: list,
                 dsp: DspConfig, device: torch.device
                 ) -> tuple[np.ndarray, dict]:
    """(fingerprints ``[n_tracks, F, C]`` on the host, ``{track: float32
    pcm}`` of the ``targets``), in batches of 512 synthesized on the
    device, batch ``k``'s noise seeded with ``1000 + k``."""
    n_clip = int(CLIP_S * SR)
    n_clip -= n_clip % 256
    tset = set(targets)
    fps, kept = [], {}
    done = batch_no = 0
    while done < n_tracks:
        nb = min(BATCH, n_tracks - done)
        i16, fp = synth_batch(draw_params(rng, nb), 1000 + batch_no, n_clip,
                              dsp, device)
        batch_no += 1
        fps.append(fp.cpu().numpy())
        rows = [j for j in range(nb) if done + j in tset]
        if rows:
            pcm = i16[rows].cpu().numpy()
            for j, pr in zip(rows, pcm):
                kept[done + j] = pr.astype(np.float32) / 32768.0
        done += nb
    return np.concatenate(fps), kept


def add_noise(rng: np.random.Generator, pcm: np.ndarray,
              snr_db: float) -> np.ndarray:
    sig = float((pcm**2).mean())
    noise = rng.standard_normal(len(pcm)).astype(np.float32)
    noise *= np.sqrt(sig / (10 ** (snr_db / 10)) / float((noise**2).mean()))
    return (pcm + noise).astype(np.float32)


def top2(v: np.ndarray) -> tuple[int, int, int]:
    """(winner column, its votes, the best votes of any other column)."""
    i1 = int(np.argmax(v))
    v1 = int(v[i1])
    v = v.copy()
    v[i1] = -1
    v2 = int(v.max()) if v.shape[0] > 1 else 0
    return i1, v1, max(v2, 0)


def query_stats(votes: np.ndarray, names: list[str], n_frames: np.ndarray,
                truth: list[str] | None = None) -> dict:
    """Per-query acceptance statistics of votes ``[B, A]``: the winner
    column ``w``, its votes ``v1``, the runner-up's ``v2``, the margin
    ``m`` = (v1 - v2) / v1 (0 without votes), the confidence ``conf`` =
    v1 / n_frames, the winner's z-score ``z`` over the row, and, when
    ``truth`` names each query's clip, ``correct`` (the winner is it, with
    votes)."""
    rows = [top2(votes[i]) for i in range(votes.shape[0])]

    def zscore(v, v1):
        mu, sd = float(v.mean()), float(v.std())
        return (v1 - mu) / sd if sd > 0 else 0.0

    out = dict(
        w=np.array([i1 for i1, _, _ in rows]),
        v1=np.array([v1 for _, v1, _ in rows]),
        v2=np.array([v2 for _, _, v2 in rows]),
        m=np.array([(v1 - v2) / v1 if v1 > 0 else 0.0
                    for _, v1, v2 in rows]),
        conf=np.array([v1 / n_frames[i] for i, (_, v1, _) in enumerate(rows)]),
        z=np.array([zscore(votes[i], v1)
                    for i, (_, v1, _) in enumerate(rows)]),
    )
    if truth is not None:
        out["correct"] = np.array([
            names[i1] == want and v1 > 0
            for (i1, v1, _), want in zip(rows, truth)
        ])
    return out


def tolerance_lines(tol: float, t: dict, i: dict) -> list[str]:
    """The per-tolerance block: top-1, the winners' z-scores, the joint
    confidence x margin table and the z-score table (recall | false
    accepts), from :func:`query_stats` of the true (``t``) and impostor
    (``i``) queries."""
    ok = t["correct"]
    lines = [
        f"\n== tol {tol} ==  correct-top1 {ok.sum()}/{len(ok)}",
        f"  z of winner: true-correct p10/p50 "
        f"{np.percentile(t['z'][ok], [10, 50]).round(1) if ok.any() else '-'}"
        f"  impostor p50/p90/max "
        f"{np.percentile(i['z'], [50, 90, 100]).round(1)}",
        "  JOINT conf x margin acceptance (recall | FA):",
    ]
    for cthr in (0.0, 0.5, 0.6, 0.7, 0.75):
        row = []
        for mthr in (0.0, 0.05, 0.1, 0.2):
            rec = int((ok & (t["m"] >= mthr) & (t["conf"] >= cthr)).sum())
            fa = int(((i["m"] >= mthr) & (i["conf"] >= cthr)).sum())
            row.append(f"c>={cthr},m>={mthr}: {rec}|{fa}")
        lines.append("   " + "  ".join(row))
    lines.append("  Z-SCORE acceptance (recall | FA):")
    row = []
    for zthr in (10, 15, 20, 30, 50):
        rec = int((ok & (t["z"] >= zthr)).sum())
        fa = int((i["z"] >= zthr).sum())
        row.append(f"z>={zthr}: {rec}|{fa}")
    lines.append("   " + "  ".join(row))
    return lines


def sweep_lines(stats: dict) -> list[str]:
    """The cross-tolerance tables from ``{tol: (true stats, impostor
    stats)}``: fine margins at 0.35-0.45, a winner stable across 0.3 and
    0.4 with margins at both, and winner stability 0.1/0.2 vs 0.3."""
    lines = []
    for tol in (0.35, 0.4, 0.45):
        if tol not in stats:
            continue
        t, i = stats[tol]
        lines.append(f"\n== fine margins, tol {tol} ==")
        for mthr in (0.06, 0.07, 0.08, 0.09, 0.1, 0.12, 0.15):
            rec = int((t["correct"] & (t["m"] >= mthr)).sum())
            fa = int((i["m"] >= mthr).sum())
            lines.append(f"   m>={mthr}: recall {rec}/{len(t['m'])} "
                         f"FA {fa}/{len(i['m'])}")
    if 0.3 in stats and 0.4 in stats:
        (at, ai), (bt, bi) = stats[0.3], stats[0.4]
        st_t = (at["w"] == bt["w"]) & bt["correct"]
        st_i = ai["w"] == bi["w"]
        lines += ["\n== stable(0.3,0.4) & joint margins ==",
                  f"  true stable&correct {st_t.sum()}  "
                  f"impostor stable {st_i.sum()}/{len(ai['w'])}"]
        for mthr in (0.0, 0.03, 0.05, 0.08, 0.1):
            rec = int((st_t & (at["m"] >= mthr) & (bt["m"] >= mthr)).sum())
            fa = int((st_i & (ai["m"] >= mthr) & (bi["m"] >= mthr)).sum())
            lines.append(f"   both m>={mthr}: recall {rec}/{len(at['w'])} "
                         f"FA {fa}/{len(ai['w'])}")
    for ta, tb in ((0.1, 0.3), (0.2, 0.3)):
        if ta not in stats or tb not in stats:
            continue
        (at, ai), (bt, bi) = stats[ta], stats[tb]
        stable_t = at["w"] == bt["w"]
        stable_i = ai["w"] == bi["w"]
        lines += [f"\n== stability {ta} vs {tb} ==",
                  f"  true: stable {stable_t.sum()}/{len(at['w'])} "
                  f"(correct&stable {(bt['correct'] & stable_t).sum()})",
                  f"  impostor: stable {stable_i.sum()}/{len(ai['w'])}"]
        for cthr in (0.0, 0.5, 0.6, 0.7):
            for mthr in (0.0, 0.05, 0.1):
                rec = int((bt["correct"] & stable_t & (bt["m"] >= mthr)
                           & (bt["conf"] >= cthr)).sum())
                fa = int((stable_i & (bi["m"] >= mthr)
                          & (bi["conf"] >= cthr)).sum())
                lines.append(
                    f"   stable & c>={cthr} & m>={mthr}: recall "
                    f"{rec}/{len(at['w'])}  FA {fa}/{len(ai['w'])}")
    return lines


def _targets(n_tracks: int, n_queries: int) -> list[int]:
    return list(range(0, n_tracks, max(1, n_tracks // n_queries)))[:n_queries]


def _excerpts(rng: np.random.Generator, kept: dict,
              targets: list[int]) -> list[np.ndarray]:
    qn = int(QUERY_S * SR)
    qn -= qn % 256
    out = []
    for i in targets:
        off = int(rng.integers(0, int((CLIP_S - QUERY_S) * SR)))
        off -= off % 256
        out.append(kept[i][off : off + qn])
    return out


def _engine(dsp: DspConfig, fps: np.ndarray, device, tag: str) -> Tiresias:
    """An engine in a temporary data directory holding ``fps`` as
    ``clip<i>`` in context ``c``."""
    eng = Tiresias(
        TiresiasConfig(dsp=dsp, data_dir=tempfile.mkdtemp(prefix=tag)),
        restore=False, device=device,
    )
    eng.create_context("c")
    for i in range(fps.shape[0]):
        eng.store.add_audio(f"clip{i}", "c", fps[i], f"{tag}{i:08d}")
    return eng


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tiresias_tpu_torch.tools.margin_study")
    ap.add_argument("--tracks", type=int, default=10_240)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--impostors", type=int, default=50)
    ap.add_argument("--snr", type=float, default=20.0)
    ap.add_argument("--weighted", action="store_true",
                    help="run the noise-weighted fingerprint space study")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.weighted:
        weighted_study(args.tracks, device)
        return 0

    rng = np.random.default_rng(99)
    dsp = DspConfig(n_coefs=8)
    t0 = time.time()
    targets = _targets(args.tracks, args.queries)
    fps, kept = synth_corpus(rng, args.tracks, targets, dsp, device)
    eng = _engine(dsp, fps, device, "ms")
    print(f"corpus ready: {fps.shape[0]} tracks in {time.time() - t0:.0f}s",
          flush=True)
    excerpts = _excerpts(rng, kept, targets)
    truth = [f"clip{i}" for i in targets]
    noisy = [add_noise(rng, q, args.snr) for q in excerpts]
    impostors = list(speechlike_batch(rng, args.impostors, QUERY_S))

    # the margin analysis needs the exact runner-up: the prefilter stays on
    # but its certificate is taken at the top 2 (a top-1 certificate's
    # candidates can understate v2 and overstate margins)
    def votes_of(queries, tol):
        return eng._compute_votes(
            "c", queries, SR, 8, tol, -1, -1, False, False, True,
            prefilter=True, prefilter_top=2,
        )

    stats = {}
    for tol in TOLS:
        vt, entries, nf = votes_of(noisy, tol)
        vi, _, nfi = votes_of(impostors, tol)
        names = [e.name for e in entries]
        stats[tol] = (query_stats(vt, names, nf, truth),
                      query_stats(vi, names, nfi))
        print("\n".join(tolerance_lines(tol, *stats[tol])), flush=True)
    print("\n".join(sweep_lines(stats)), flush=True)
    eng.close()
    return 0


def weighted_study(tracks: int = 10_240, device="cuda") -> None:
    """Noise-weighted fingerprint space: every fingerprint (stored and
    query) divided per coefficient by the measured 20 dB-SNR deviation
    profile, so one scalar tolerance means a per-coefficient tolerance
    matched to how much noise moves that coefficient (coefs 6-7 deviate ~6x
    more than coef 1)."""
    device = resolve_device(device)
    rng = np.random.default_rng(99)
    dsp = DspConfig(n_coefs=8)
    w = np.array(NOISE_P90, np.float32)
    w /= w.mean()
    n_queries, n_imp = 100, 50
    targets = _targets(tracks, n_queries)
    fps, kept = synth_corpus(rng, tracks, targets, dsp, device)
    print(f"corpus ready: {fps.shape[0]} tracks", flush=True)
    excerpts = _excerpts(rng, kept, targets)
    noisy = np.stack([add_noise(rng, q, 20.0) for q in excerpts])
    impostors = speechlike_batch(rng, n_imp, QUERY_S)
    qf_t = fingerprint_padded_batch(noisy, SR, dsp, device=device).cpu().numpy()
    qf_i = fingerprint_padded_batch(impostors, SR, dsp,
                                    device=device).cpu().numpy()
    n_q_frames = excerpts[0].shape[0] // dsp.hop_size

    def votes(eng, qf, tol):
        # the engine's per-view votes (aligned, certificate at the top 2)
        coefs, tol, lo, hi, trunc, aligned, _ = eng._resolve_search(
            8, tol, -1, -1, False, True, 0.0)
        view = eng.store.search_views()[0]
        nf = np.full(qf.shape[0], n_q_frames, np.int32)
        votes_of = eng._view_votes(
            eng.store, torch.from_numpy(qf).to(device), nf, tol, lo, hi,
            None, coefs, trunc, aligned, top=2,
        )
        return votes_of(view)[:, : view.n_audios].cpu().numpy()

    for label, scale in (("scalar", np.ones(8, np.float32)), ("weighted", w)):
        eng = _engine(dsp, (fps / scale).astype(np.float32), device, "w")
        qt = (qf_t / scale).astype(np.float32)
        qi = (qf_i / scale).astype(np.float32)
        print(f"\n### {label} space, {tracks} distractors", flush=True)
        for tol in ((0.1, 0.2, 0.3) if label == "scalar"
                    else (0.1, 0.15, 0.2, 0.25, 0.3)):
            rt = [top2(v) for v in votes(eng, qt, tol)]
            ri = [top2(v) for v in votes(eng, qi, tol)]
            correct = np.array([i1 == t and v1 > 0
                                for (i1, v1, _), t in zip(rt, targets)])
            m_t = np.array([(v1 - v2) / v1 if v1 > 0 else 0
                            for _, v1, v2 in rt])
            m_i = np.array([(v1 - v2) / v1 if v1 > 0 else 0
                            for _, v1, v2 in ri])
            line = f"  tol {tol}: top1 {correct.sum()}/{len(rt)} | margins:"
            for mthr in (0.0, 0.05, 0.1, 0.2, 0.3):
                rec = int((correct & (m_t >= mthr)).sum())
                fa = int((m_i >= mthr).sum())
                line += f"  m>={mthr}: {rec}|{fa}"
            print(line, flush=True)
        eng.close()


if __name__ == "__main__":
    sys.exit(main())
