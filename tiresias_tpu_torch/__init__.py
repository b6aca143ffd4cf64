"""tiresias-tpu on PyTorch + CUDA: the dialplan main path for NVIDIA Hopper.

A second package beside :mod:`tiresias_tpu` (the JAX reference). Plain tensor
code is PyTorch; the fused MFCC chain and the lattice vote are hand-written
CUDA kernels under ``csrc/`` (built with ``nvcc`` on first use, see
:mod:`tiresias_tpu_torch.utils.build`). The package never imports ``jax``:
it shares only the jax-free host modules of ``tiresias_tpu`` (config, audio
I/O, G.711, hashing, locking, the numpy DSP constants and the reference
search oracle).

    from tiresias_tpu_torch.api import Tiresias
    eng = Tiresias(config)            # device="cuda" by default
    eng.sync()
    res = eng.search_file("ctx", "query.wav")
"""

from tiresias_tpu.config import (
    ContextConfig,
    DspConfig,
    MatchConfig,
    TiresiasConfig,
    load_config,
)

__version__ = "0.1.0"

__all__ = [
    "ContextConfig",
    "DspConfig",
    "MatchConfig",
    "TiresiasConfig",
    "load_config",
    "__version__",
]
