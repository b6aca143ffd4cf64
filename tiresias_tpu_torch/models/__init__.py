"""models subpackage of the port: the analysis-model registry.

The "model families" here are fingerprint analysis profiles — named
(DspConfig, MatchConfig) presets over the same kernels. Defined in
:mod:`tiresias_tpu_torch.profiles` and re-exported here, as the JAX
package's ``models`` subpackage does.
"""

from tiresias_tpu_torch.profiles import (
    MUSIC,
    PROFILES,
    TELEPHONY,
    WIDEBAND,
    Profile,
    get_profile,
)

__all__ = [
    "MUSIC",
    "PROFILES",
    "TELEPHONY",
    "WIDEBAND",
    "Profile",
    "get_profile",
]
