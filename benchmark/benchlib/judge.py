"""The check that decides ``correct``: the program's stored catalog and its
answers, held to the plain reference (``benchmark/reference``) computed
again from the benchmark's own inputs.

Two numbers, each with its limit in the cell's own file:

- ``fp_err_db``: the widest gap between a catalog fingerprint the program
  stored and the reference's of the same PCM, in dB, scaled by the DCT
  coefficient's magnitude where it is below 1 (there 10 log10|c| magnifies
  float32 rounding of c itself): ``max |got - want| * min(1, 10^(want/10))``.
- ``answer_mismatch_pct``: the share of a seeded sample of the window's
  answered windows whose TIR* answer (status, track, votes, frame count)
  is not the reference's answer to the same G.711 codes, nor the answer it
  gives for any fingerprints that ``fp_err_db``'s limit passes (a pair
  whose gap lies within rounding of the tolerance may vote either way).

The reference side imports only the reference and the benchmark's own
generator; nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchlib.corpus import checksum, speechlike, sub_seed
from reference import dsp as ref_dsp
from reference import search as ref_search
from reference.g711 import ulaw_to_float

# an answer: (status, the track's row or -1, votes, frames)
FOUND, NOTFOUND, OTHER = 1, 0, 2


def track_samples(config: dict) -> int:
    cat = config["catalog"]
    hop = int(config["dsp"]["hop_size"])
    n = int(round(float(cat["track_seconds"]) * int(cat["samplerate"])))
    return n - n % hop


def catalog_batch(config: dict, seed: int, lo: int, device) -> torch.Tensor:
    """Tracks ``lo ..`` of the catalog as int16 PCM, made from the seed."""
    cat = config["catalog"]
    nb = min(int(cat["batch"]), int(cat["tracks"]) - lo)
    return speechlike(nb, track_samples(config), int(cat["samplerate"]),
                      sub_seed(seed, "catalog", lo), device)


def _dsp_args(config: dict) -> dict:
    d = config["dsp"]
    return dict(samplerate=int(config["catalog"]["samplerate"]),
                hop=int(d["hop_size"]), win=int(d["buf_size"]),
                n_filters=int(d["n_filters"]), n_coefs=int(d["n_coefs"]))


def reference_catalog(config: dict, seed: int, device, checksums: list,
                      precision: str = "float32") -> torch.Tensor:
    """``[tracks, frames, coefs]``: the reference's fingerprints of the
    catalog, each batch of PCM made again and held to the checksum the
    set-up recorded."""
    cat = config["catalog"]
    args = _dsp_args(config)
    parts = []
    for i, lo in enumerate(range(0, int(cat["tracks"]), int(cat["batch"]))):
        pcm = catalog_batch(config, seed, lo, device)
        if checksum(pcm) != checksums[i]:
            raise RuntimeError(f"catalog batch {i} made again differs from "
                               "the set-up's")
        parts.append(ref_dsp.fingerprints(pcm.to(torch.float32) / 32768.0,
                                          precision=precision, **args))
    return torch.cat(parts)


def fp_err_db(port_fps: np.ndarray, ref: torch.Tensor) -> float:
    worst = 0.0
    for lo in range(0, ref.shape[0], 1024):
        want = ref[lo: lo + 1024]
        got = torch.from_numpy(port_fps[lo: lo + 1024]).to(want.device)
        scale = torch.pow(10.0, want.double() / 10.0).clamp(max=1.0)
        worst = max(worst, float(((got - want).abs().double()
                                  * scale).max()))
    return worst


def supported(config: dict) -> None:
    m = config["match"]
    if (m["trunc_coef1"] or m["freq_ignore_low"] > 0
            or m["freq_ignore_high"] > 0 or m["min_margin"] > 0
            or m["filter_context"]):
        raise ValueError("the reference covers untruncated votes with no band "
                         "filter, no margin and no context filter")


def _windows_fp(config: dict, codes: np.ndarray, device,
                precision: str = "float32") -> torch.Tensor:
    x = ulaw_to_float(torch.from_numpy(np.ascontiguousarray(codes)).to(device))
    return ref_dsp.fingerprints(x, precision=precision, **_dsp_args(config))


def _votes(config: dict, q: torch.Tensor, ref_cat: torch.Tensor,
           slack=None) -> torch.Tensor:
    m = config["match"]
    dev = ref_cat.device
    mask = torch.ones(ref_cat.shape[:2], dtype=torch.bool, device=dev)
    return ref_search.votes(q, ref_cat, mask, float(m["tolerance"]),
                            int(m["coefs"]), bool(m["aligned"]),
                            rows_per_block=2048 if dev.type == "cuda" else 64,
                            slack=slack)


def reference_answers(config: dict, ref_cat: torch.Tensor, codes: np.ndarray,
                      precision: str = "float32") -> list:
    """The TIR* answer ``(status, row, votes, frames)`` of each window of
    G.711 ``codes [U, W]`` against the reference catalog (rows in insertion
    order)."""
    supported(config)
    q = _windows_fp(config, codes, ref_cat.device, precision)
    out = []
    for u in range(q.shape[0]):
        row, count = ref_search.top1(_votes(config, q[u], ref_cat))
        frames = int(q.shape[1])
        out.append((FOUND, row, count, frames) if row >= 0
                   else (NOTFOUND, -1, 0, frames))
    return out


def sample(n_answered: int, size: int, seed: int) -> np.ndarray:
    """A seeded sample of the answered windows (indices in answer order)."""
    rng = np.random.default_rng(sub_seed(seed, "sample"))
    return np.sort(rng.choice(n_answered, size=min(size, n_answered),
                              replace=False))


def slack(fp: torch.Tensor, fp_limit: float) -> torch.Tensor:
    """Per value, the most by which a fingerprint that ``fp_err_db`` passes
    at ``fp_limit`` may differ from ``fp`` (dB; inf where |c| underflows)."""
    scale = torch.pow(10.0, fp.double() / 10.0).clamp(max=1.0)
    return (fp_limit / scale).to(torch.float32)


class Rounding:
    """Whether an answer that differs from the reference's is still the
    reference's for some fingerprints within ``fp_limit`` (``fp_err_db``'s
    measure) of its own, the catalog's and the window's: its votes lie
    between the fewest and the most that such fingerprints give, and no
    other row's fewest beat them."""

    def __init__(self, config: dict, ref_cat: torch.Tensor, fp_limit: float):
        self.config, self.ref_cat, self.fp_limit = config, ref_cat, fp_limit
        self.ed = slack(ref_cat, fp_limit)

    def allows(self, code: np.ndarray, answer: tuple) -> bool:
        status, row, count, frames = answer
        q = _windows_fp(self.config, code[None], self.ref_cat.device)[0]
        if status == OTHER or frames != q.shape[0]:
            return False
        eq = slack(q, self.fp_limit)
        fewest, most = (_votes(self.config, q, self.ref_cat,
                               (sign, eq, self.ed)) for sign in (-1.0, 1.0))
        if status == NOTFOUND:
            return row == -1 and count == 0 and int(fewest.max()) == 0
        if count <= 0 or not 0 <= row < fewest.numel():
            return False
        if not int(fewest[row]) <= count <= int(most[row]):
            return False
        # the lowest row among equals wins
        return bool((fewest[:row] < count).all()
                    and (fewest[row + 1:] <= count).all())


def mismatches(got: list, want: list, codes: list, rounding: Rounding
               ) -> tuple[float, list, list]:
    """(the share in % of answers that neither equal the reference's nor
    are allowed by ``rounding``, the indices that differ, those not
    allowed)."""
    differ = [k for k, (g, w) in enumerate(zip(got, want))
              if tuple(g) != tuple(w)]
    wrong = [k for k in differ if not rounding.allows(codes[k], got[k])]
    return 100.0 * len(wrong) / max(1, len(got)), differ, wrong


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
