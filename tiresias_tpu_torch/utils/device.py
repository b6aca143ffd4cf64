"""Device resolution (the port's counterpart of ``tiresias_tpu.utils.platform``).

The port never picks a device on its own: the caller names one, ``cuda`` is
the default, and asking for ``cuda`` on a machine without a usable card
raises instead of silently running on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent, and for any device type other than ``cuda`` or ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' explicitly to run the plain "
                "PyTorch versions of the kernels"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev


def device_report(device: torch.device) -> dict:
    """``{"platform", "kind", "count"}`` of the device a run used; ``count``
    is the number of CUDA devices visible to the process."""
    if device.type == "cuda":
        return {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(),
        }
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array → tensor on ``device``, keeping its dtype (int16 and uint8
    PCM ship unconverted). CUDA copies go through pinned memory with
    ``non_blocking=True`` so the host does not wait for kernels already
    queued on the stream (the ingest pipeline's one-batch-in-flight
    overlap)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t
