"""Batched fingerprint chain (port of ``tiresias_tpu.ops.mfcc_jax``).

    pcm [B, S] -> float32 (int16 /32768, G.711 table) -> mask padding
        -> K2 (in-kernel framing, long signals) or framing + K1 (short)
        -> [B, F, n_coefs]

All shapes are padded on the host to bucketed frame counts
(:func:`pad_frames_bucket`) with an explicit ``n_frames`` per signal, so
downstream masking is exact. The K1/K2 routing is the rule of
``tiresias_tpu/ops/mfcc_pallas.py::fingerprint_padded_batch_pallas``.
"""

from __future__ import annotations

import numpy as np
import torch

from tiresias_tpu_torch.config import DspConfig
from tiresias_tpu_torch.ops.mfcc_kernels import (  # noqa: F401 - re-exported
    LOG10_FLOOR,
    ROW_TILE,
    device_constants,
    frames_from_pcm,
    mfcc_framed,
    mfcc_rows,
    safe_log10,
)
from tiresias_tpu_torch.utils.device import resolve_device, to_device

# Padding value for fingerprint frames that don't exist; far below the
# 10*log10(2e-42) floor of real values so no tolerance band reaches it.
PAD_VALUE = -1e6


def n_frames_for(n_samples: int, hop_size: int) -> int:
    """Frame count for a signal: ceil(n/hop); 0 samples -> 0 frames."""
    return -(-n_samples // hop_size)


def coef_scale_for(dsp: DspConfig) -> np.ndarray | None:
    """``1 / coef_weights`` as a ``[n_coefs]`` float32 row, or None (the
    per-coef noise weighting scales the LOG-domain values)."""
    if dsp.coef_weights is None:
        return None
    return (1.0 / np.asarray(dsp.coef_weights, np.float32)).astype(np.float32)


def to_float_pcm(pcm: torch.Tensor, law: str | None = None) -> torch.Tensor:
    """Wire format -> float32 on the tensor's device: int16 scales by the
    exact 1/32768; uint8 G.711 codes expand through the 256-entry table
    (the exact int16 expansion / 32768, bit-identical to host decoding)."""
    if pcm.dtype == torch.uint8:
        if law is None:
            raise ValueError("uint8 PCM requires a G.711 law (pass wire_law=...)")
        from tiresias_tpu_torch.utils.g711 import decode_table

        table = torch.from_numpy(
            decode_table(law).astype(np.float32) / np.float32(32768.0)
        ).to(pcm.device)
        return table[pcm.long()]
    if pcm.dtype == torch.int16:
        return pcm.to(torch.float32) * (1.0 / 32768.0)
    return pcm.to(torch.float32)


def mask_valid_samples(
    pcm_f: torch.Tensor, n_valid: torch.Tensor | None
) -> torch.Tensor:
    """Zero decoded samples at/beyond each signal's true length (A-law's
    quietest padding code decodes to +8, not 0)."""
    if n_valid is None:
        return pcm_f
    idx = torch.arange(pcm_f.shape[-1], device=pcm_f.device)[None, :]
    return torch.where(idx < n_valid[:, None], pcm_f, 0.0)


def fingerprint_padded_batch(
    pcm: np.ndarray | torch.Tensor,
    samplerate: int,
    dsp: DspConfig | None = None,
    law: str | None = None,
    n_valid: np.ndarray | None = None,
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """Fingerprint a pre-padded batch ``[B, S]`` (S a multiple of hop; a
    numpy array, or a tensor already on the device) -> ``[B, F, n_coefs]``
    float32 on ``device``.

    Long signals take K2 (framing inside the kernel); short ones, where
    padding the frame count to a whole row tile would waste more than 20%,
    are framed here and take K1, which packs rows densely across the batch.
    """
    dsp = dsp or DspConfig()
    device = resolve_device(device)
    if n_valid is not None:
        n_valid = to_device(np.asarray(n_valid, np.int32), device)
    consts = device_constants(dsp, int(samplerate), device)
    pcm_f = mask_valid_samples(
        to_float_pcm(to_device(pcm, device), law), n_valid
    ).contiguous()
    b, s = pcm_f.shape
    f = s // dsp.hop_size
    tiles = -(-f // ROW_TILE)
    if dsp.buf_size == 2 * dsp.hop_size and tiles * ROW_TILE * 5 <= f * 6:
        out = mfcc_framed(pcm_f, consts, dsp.hop_size, dsp.buf_size)
    else:
        frames = frames_from_pcm(pcm_f, dsp.hop_size, dsp.buf_size)
        out = mfcc_rows(
            frames.reshape(b * f, dsp.buf_size).contiguous(), consts
        ).reshape(b, f, dsp.n_coefs)
    scale = coef_scale_for(dsp)
    if scale is not None:
        out = out * torch.from_numpy(scale).to(device)
    return out


def bucket_frames(
    n_frames: int, multiple: int = 128, minimum: int | None = None
) -> int:
    """Round a frame count up to a bucket (``minimum`` defaults to one)."""
    if minimum is None:
        minimum = multiple
    if n_frames <= minimum:
        return minimum
    return -(-n_frames // multiple) * multiple


def pad_frames_bucket(
    pcms: list[np.ndarray], hop_size: int, multiple: int = 128,
    law: str | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Pad a ragged list of 1-D signals to one bucketed [B, S] array.

    Returns (padded [B, F_bucket*hop], n_frames int32 [B]). The batch stays
    int16 when every input is int16 (converted on device by
    :func:`to_float_pcm`), float32 otherwise; with ``law`` every signal must
    be uint8 G.711 codes and padding is the law's silence code.
    """
    n_frames = np.array(
        [n_frames_for(len(p), hop_size) for p in pcms], dtype=np.int32
    )
    f_bucket = bucket_frames(int(n_frames.max(initial=1)), multiple)
    if law is not None:
        from tiresias_tpu_torch.utils.g711 import SILENCE_BYTE, decode_table

        decode_table(law)  # validate the name early
        for i, p in enumerate(pcms):
            if np.asarray(p).dtype != np.uint8:
                raise ValueError(
                    f"wire_law={law!r} requires uint8 G.711 codes; "
                    f"signal {i} is {np.asarray(p).dtype}"
                )
        out = np.full(
            (len(pcms), f_bucket * hop_size), SILENCE_BYTE[law], np.uint8
        )
        for i, p in enumerate(pcms):
            out[i, : len(p)] = np.asarray(p)
        return out, n_frames
    dtype = (
        np.int16
        if pcms and all(np.asarray(p).dtype == np.int16 for p in pcms)
        else np.float32
    )
    out = np.zeros((len(pcms), f_bucket * hop_size), dtype=dtype)
    for i, p in enumerate(pcms):
        p = np.asarray(p)
        if p.dtype == np.uint8:
            raise ValueError(
                f"signal {i} is uint8 (G.711 codes?) but no wire_law was given"
            )
        if dtype == np.float32 and p.dtype == np.int16:
            # mixed batch: scale int16 here, the device only scales int16
            # batches
            p = p.astype(np.float32) / 32768.0
        elif p.dtype != np.int16 and len(p) and not np.isfinite(p).all():
            # NaN/Inf samples collapse to floor fingerprints that spuriously
            # match silence
            raise ValueError(f"non-finite samples in signal {i}")
        out[i, : len(p)] = p.astype(dtype)
    return out, n_frames


def fingerprint_signals_async(
    pcms: list[np.ndarray],
    samplerate: int,
    dsp: DspConfig | None = None,
    bucket_multiple: int = 128,
    law: str | None = None,
    device: torch.device | str = "cuda",
) -> tuple[torch.Tensor, np.ndarray]:
    """Enqueue a ragged-batch fingerprint without the host readback.

    Returns (fp tensor [B, F_bucket, n_coefs] on ``device`` — padding frames
    NOT masked, see :func:`mask_fingerprints` — and n_frames [B] int32). CUDA
    work is asynchronous, so the caller overlaps host work with the device
    until it reads the result."""
    dsp = dsp or DspConfig()
    padded, n_frames = pad_frames_bucket(
        pcms, dsp.hop_size, bucket_multiple, law=law
    )
    n_valid = (
        np.array([len(p) for p in pcms], np.int32) if law is not None else None
    )
    fp = fingerprint_padded_batch(
        padded, samplerate, dsp, law=law, n_valid=n_valid, device=device
    )
    return fp, n_frames


def mask_fingerprints(fp: np.ndarray, n_frames: np.ndarray) -> np.ndarray:
    """Overwrite frames beyond each signal's count with PAD_VALUE."""
    mask = np.arange(fp.shape[1])[None, :] < n_frames[:, None]
    return np.where(mask[:, :, None], fp, PAD_VALUE).astype(np.float32)


def fingerprint_signals(
    pcms: list[np.ndarray],
    samplerate: int,
    dsp: DspConfig | None = None,
    bucket_multiple: int = 128,
    device: torch.device | str = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Fingerprint a ragged batch: (fp [B, F_bucket, n_coefs] float32 with
    PAD_VALUE beyond each signal's frames, n_frames [B] int32)."""
    fp, n_frames = fingerprint_signals_async(
        pcms, samplerate, dsp, bucket_multiple, device=device
    )
    return mask_fingerprints(fp.cpu().numpy(), n_frames), n_frames


def fingerprint_signal(
    pcm: np.ndarray, samplerate: int, dsp: DspConfig | None = None,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Single signal -> exact-length ``[n_frames, n_coefs]`` fingerprint."""
    dsp = dsp or DspConfig()
    fp, n_frames = fingerprint_signals(
        [np.asarray(pcm)], samplerate, dsp, device=device
    )
    return fp[0, : int(n_frames[0])]
