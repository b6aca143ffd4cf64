"""Named analysis profiles.

The reference hardcodes one analysis configuration (hop 256 / win 512 /
40 filters / 2 coefficients, fp_handler.c:33-39) and
analyses at each file's native samplerate. These presets package the same
chain for the main deployment scenarios; all flow through the identical
kernels — a profile is just a (DspConfig, MatchConfig) pair.

Pick one when constructing the engine:

    from tiresias_tpu_torch.profiles import WIDEBAND
    eng = Tiresias(TiresiasConfig(dsp=WIDEBAND.dsp, match=WIDEBAND.match, ...))
"""

from __future__ import annotations

import dataclasses

from tiresias_tpu_torch.config import DspConfig, MatchConfig


@dataclasses.dataclass(frozen=True)
class Profile:
    name: str
    dsp: DspConfig
    match: MatchConfig
    description: str


# The reference's exact configuration: 8 kHz telephony, 32 ms window /
# 16 ms hop, dialplan search semantics (coefs=1, integer truncation).
TELEPHONY = Profile(
    name="telephony",
    dsp=DspConfig(),
    match=MatchConfig(),
    description="Reference parity: 8 kHz PBX audio, hop 256 / win 512, "
    "40 mel filters, 2 stored coefficients, dialplan search semantics.",
)

# 16 kHz wideband speech: same 32 ms / 16 ms timing at twice the rate,
# high-accuracy matching (no truncation).
WIDEBAND = Profile(
    name="wideband",
    dsp=DspConfig(hop_size=256, buf_size=512, n_filters=40, n_coefs=4),
    match=MatchConfig(coefs=4, tolerance=0.1, trunc_coef1=False, aligned=True),
    description="16 kHz wideband speech; 4 matched coefficients, exact "
    "(untruncated) time-aligned matching — the measured-best accuracy "
    "configuration (docs/performance.md).",
)

# 44.1/48 kHz music: longer window for frequency resolution, more
# coefficients for timbre discrimination.
MUSIC = Profile(
    name="music",
    dsp=DspConfig(hop_size=512, buf_size=1024, n_filters=40, n_coefs=8),
    match=MatchConfig(coefs=8, tolerance=0.1, trunc_coef1=False, aligned=True),
    description="Full-band music; 23 ms window at 44.1 kHz, 8 matched "
    "coefficients, exact time-aligned matching.",
)

PROFILES = {p.name: p for p in (TELEPHONY, WIDEBAND, MUSIC)}


def get_profile(name: str) -> Profile:
    try:
        return PROFILES[name]
    except KeyError:
        raise KeyError(
            f"unknown profile {name!r}; available: {sorted(PROFILES)}"
        ) from None
