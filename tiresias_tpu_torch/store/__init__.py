"""Fingerprint store of the PyTorch port: host catalog + device tier views."""

from tiresias_tpu_torch.store.fingerprint_store import (
    AUDIO_BUCKET,
    FRAME_BUCKET,
    AudioEntry,
    FingerprintStore,
)

__all__ = ["AUDIO_BUCKET", "FRAME_BUCKET", "AudioEntry", "FingerprintStore"]
