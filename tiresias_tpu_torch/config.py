"""Configuration system for the PyTorch port (a copy of ``tiresias_tpu.config``;
the port imports nothing of the JAX package).

Mirrors the reference's two-scope config model — a ``[global]`` section with match
parameters plus one section per fingerprint context naming a ``directory`` —
while replacing Asterisk's INI loader with :mod:`configparser`.

Reference behavior this reproduces:
  * ``app_tiresias.c:177-224`` (``init_config``): every
    section becomes a context except ``global``; every ``name=value`` pair is
    kept as a string.
  * the reference's ``doc/configuration.rst`` documents the only known keys:
    ``[global] tolerance`` and ``[<context>] directory``.
  * Call-time overrides win over config values
    (``application_handler.c:115-123``).

DSP parameters are fixed constants in the reference
(``fp_handler.c:33-41``); here they are an explicit,
overridable dataclass so alternative analysis profiles can coexist.
"""

from __future__ import annotations

import configparser
import dataclasses
import os
from typing import Mapping

# Reference constants: fp_handler.c:33-41
DEF_HOP_SIZE = 256
DEF_BUF_SIZE = 512
DEF_SAMPLERATE = 0  # 0 = take the sample rate from the file
DEF_N_FILTERS = 40
DEF_N_COEFS = 2
DEF_SEARCH_TOLERANCE = 0.001
# Reference constant: application_handler.c:60
DEF_DURATION_MS = 3000

GLOBAL_SECTION = "global"

# Measured 20 dB-SNR fingerprint deviation profile (|delta| p90 per coef
# over speech-like audio, mean-normalized — tools/margin_study.py): the
# recommended ``DspConfig.coef_weights`` for noisy-telephony deployments
# at n_coefs=8. In this space, aligned@8 tol 0.2 with min_margin 0.2
# scored 66/100 noisy-20 dB recall at 0/50 false accepts vs 38/100 for
# the best unweighted operating point (10k distractors; see
# docs/performance.md for the at-scale numbers).
NOISE20_COEF_WEIGHTS = (
    1.032, 0.369, 0.743, 0.635, 0.624, 0.737, 1.554, 2.308,
)


@dataclasses.dataclass(frozen=True)
class DspConfig:
    """Analysis-chain parameters (aubio-equivalent names).

    ``hop_size``/``buf_size``/``n_filters``/``n_coefs`` mirror
    ``DEF_AUBIO_HOPSIZE``/``BUFSIZE``/``FILTER``/``COEFS``
    (fp_handler.c:33-39).
    """

    hop_size: int = DEF_HOP_SIZE
    buf_size: int = DEF_BUF_SIZE
    samplerate: int = DEF_SAMPLERATE  # 0 = native rate of the file
    n_filters: int = DEF_N_FILTERS
    n_coefs: int = DEF_N_COEFS
    # Per-coefficient fingerprint scaling (round-5 noise extension; None
    # = reference parity). When set (len == n_coefs, all > 0), every
    # fingerprint — ingest AND query — is divided per coef by these
    # weights, so one scalar search tolerance ``t`` means a per-coef
    # tolerance ``t * w_c``: |q/w - d/w| <= t  <=>  |q - d| <= t*w.
    # Additive noise moves the high-order MFCC coefficients ~6x more
    # than coef 1 (measured 20 dB-SNR profile: NOISE20_COEF_WEIGHTS), so
    # a scalar tolerance either over-trusts fragile coefs or wastes the
    # stable ones; weighting the space fixes the tolerance SHAPE.
    # Applied to the LOG-domain values at every fingerprint entry point
    # (ops.mfcc_jax.coef_scale_for — one fused elementwise multiply; a
    # DCT-matrix scale would only SHIFT the log values), so every kernel
    # — XLA, fused Pallas, sharded — inherits it at zero per-query cost.
    # Stored fingerprints live in the weighted space: the checkpoint
    # records the weights and an engine restore with different weights
    # is rejected (stale values).
    coef_weights: tuple | None = None

    def __post_init__(self) -> None:
        if self.hop_size < 1:
            raise ValueError("hop_size must be a positive sample count")
        if self.buf_size % self.hop_size != 0:
            raise ValueError("buf_size must be a multiple of hop_size")
        if self.n_coefs < 1 or self.n_coefs > self.n_filters:
            raise ValueError("n_coefs must be in [1, n_filters]")
        if self.coef_weights is not None:
            w = tuple(float(x) for x in self.coef_weights)
            if len(w) != self.n_coefs:
                raise ValueError(
                    f"coef_weights needs n_coefs={self.n_coefs} entries, "
                    f"got {len(w)}"
                )
            if any(x <= 0 for x in w):
                raise ValueError("coef_weights must all be positive")
            # frozen dataclass: normalize through __setattr__ like
            # dataclasses' own __init__ does
            object.__setattr__(self, "coef_weights", w)

    @property
    def n_bins(self) -> int:
        return self.buf_size // 2 + 1


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Search parameters (reference defaults cited per field)."""

    # fp_handler.c:41
    tolerance: float = DEF_SEARCH_TOLERANCE
    # application_handler.c:180 — the dialplan always
    # searches on one coefficient.
    coefs: int = 1
    # <=0 disables the band filter (fp_handler.c:293,300)
    freq_ignore_low: int = -1
    freq_ignore_high: int = -1
    # Reference parity: C (int) cast of the query's max1
    # (fp_handler.c:290). False = high-accuracy extension
    # (PARITY.md D8) — no truncation, enabling small-tolerance recognition.
    trunc_coef1: bool = True
    # Extension (PARITY.md D9): offset-consistent (time-aligned) voting
    # instead of the reference's bag-of-frames ∃-any-frame vote. Dramatically
    # more discriminative on similar-sounding corpora.
    aligned: bool = False
    # Extension (round 5, noise operating point): margin-based
    # acceptance. A result is only FOUND when the winner's votes beat
    # the runner-up AUDIO's votes by this fraction of the winner's:
    # (v1 - v2) >= min_margin * v1. True matches win by a wide margin
    # while impostor queries near-tie many rows — at a widened
    # tolerance this separates them where absolute confidence cannot
    # (docs/performance.md §noise; 0 = reference parity, no gate).
    min_margin: float = 0.0

    def __post_init__(self) -> None:
        if not 0.0 <= self.min_margin < 1.0:
            # >= 1 would silently reject EVERY match, exact self-matches
            # included ((v1 - v2) < m*v1 holds at v2=0); negative would
            # silently disable the gate. One rule for every entry point
            # (config file, CLI, API, protocol).
            raise ValueError(
                f"min_margin must be in [0, 1), got {self.min_margin}"
            )


@dataclasses.dataclass(frozen=True)
class ContextConfig:
    name: str
    directory: str


@dataclasses.dataclass(frozen=True)
class TiresiasConfig:
    dsp: DspConfig = dataclasses.field(default_factory=DspConfig)
    match: MatchConfig = dataclasses.field(default_factory=MatchConfig)
    contexts: tuple[ContextConfig, ...] = ()
    # Checkpoint home; reference analogue is
    # /var/lib/asterisk/third-party/tiresias (app_tiresias.c:41)
    data_dir: str = "~/.tiresias_tpu"

    def context(self, name: str) -> ContextConfig | None:
        for ctx in self.contexts:
            if ctx.name == name:
                return ctx
        return None

    @property
    def expanded_data_dir(self) -> str:
        return os.path.expanduser(self.data_dir)


def load_config(path: str) -> TiresiasConfig:
    """Parse a ``tiresias.conf``-style INI file.

    Like the reference, unknown keys are preserved-but-ignored and a context
    section without a ``directory`` key is skipped
    (app_tiresias.c:299-304).
    """
    # no interpolation: the reference's Asterisk INI treats '%' as a
    # literal character (a directory named '100%tones' is legal)
    parser = configparser.ConfigParser(interpolation=None)
    read = parser.read(path)
    if not read:
        raise FileNotFoundError(path)
    return config_from_mapping({s: dict(parser.items(s)) for s in parser.sections()})


def config_from_mapping(sections: Mapping[str, Mapping[str, str]]) -> TiresiasConfig:
    match_kwargs: dict = {}
    data_dir = TiresiasConfig.data_dir
    dsp_kwargs: dict = {}
    contexts: list[ContextConfig] = []

    for section, items in sections.items():
        if section == GLOBAL_SECTION:
            if "tolerance" in items:
                match_kwargs["tolerance"] = float(items["tolerance"])
            if "coefs" in items:
                match_kwargs["coefs"] = int(items["coefs"])
            if "freq_ignore_low" in items:
                match_kwargs["freq_ignore_low"] = int(items["freq_ignore_low"])
            if "freq_ignore_high" in items:
                match_kwargs["freq_ignore_high"] = int(items["freq_ignore_high"])
            for bkey in ("trunc_coef1", "aligned"):
                if bkey in items:
                    match_kwargs[bkey] = items[bkey].strip().lower() in (
                        "1",
                        "true",
                        "yes",
                        "on",
                    )
            if "data_dir" in items:
                data_dir = items["data_dir"]
            if "min_margin" in items:
                match_kwargs["min_margin"] = float(items["min_margin"])
            for key in ("hop_size", "buf_size", "samplerate", "n_filters", "n_coefs"):
                if key in items:
                    dsp_kwargs[key] = int(items[key])
            if "coef_weights" in items:
                raw = items["coef_weights"].strip()
                if raw.lower() in ("noise20", "noise"):
                    # the measured 20 dB profile (requires n_coefs=8)
                    dsp_kwargs["coef_weights"] = NOISE20_COEF_WEIGHTS
                else:
                    dsp_kwargs["coef_weights"] = tuple(
                        float(x) for x in raw.replace(",", " ").split()
                    )
            continue
        directory = items.get("directory")
        if directory is None:
            # Context without a directory is ignored, matching
            # app_tiresias.c:299-304.
            continue
        contexts.append(ContextConfig(name=section, directory=directory))

    return TiresiasConfig(
        dsp=DspConfig(**dsp_kwargs),
        match=MatchConfig(**match_kwargs),
        contexts=tuple(contexts),
        data_dir=data_dir,
    )
