"""Host-side audio I/O and synthesis.

The reference delegates decode to ``aubio_source`` (int16 WAV → float32 in
[-1, 1), fp_handler.c:604,633). Here:

  * WAV decode uses the stdlib ``wave`` module (int16/int32/uint8 PCM and
    float32), with a C++ fast path in ``native/`` (see
    :mod:`tiresias_tpu_torch.utils.native`) used automatically when built.
  * samples are scaled by 1/32768 for int16, matching aubio.
  * multi-channel files are downmixed by averaging, matching aubio_source's
    default mono downmix.
"""

from __future__ import annotations

import os
import wave

import numpy as np


def read_audio(path: str) -> tuple[np.ndarray, int]:
    """Read ANY supported audio file → (float32 mono PCM, native samplerate).

    RIFF/WAVE files go through the WAV fast paths; every other format
    (MP3/OGG/FLAC/...) decodes through the ffmpeg-backed native codec —
    the same breadth the reference inherits from aubio_source's libav
    backend (fp_handler.c:604). Raises ValueError when
    the format is unsupported (codec library absent or undecodable file).
    """
    if not os.path.exists(path):
        # _is_riff_wave swallows OSError, so a missing file would fall
        # through to a misleading "unsupported audio format"
        raise ValueError(f"cannot read {path}: no such file")
    if _is_riff_wave(path):
        try:
            return read_wav(path)
        except (wave.Error, EOFError, ValueError):
            # RIFF/WAVE container with a compressed codec (mu-law, A-law,
            # ADPCM, GSM...) — stdlib wave and the native fast path read
            # only PCM; standard telephony WAVs like these decode through
            # the ffmpeg codec below, same as non-WAV formats.
            pass
    from tiresias_tpu_torch.utils import native

    decoded = native.decode_audio(path)
    if decoded is None:
        if not native.codec_available():
            raise ValueError(
                f"cannot decode {path}: not an uncompressed PCM WAV and the "
                "native codec library (libtiresias_codec.so, ffmpeg-backed) "
                "is not built"
            )
        raise ValueError(f"cannot decode {path}: unsupported audio format")
    return decoded


def _is_riff_wave(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            hdr = f.read(12)
    except OSError:
        return False
    return len(hdr) == 12 and hdr[:4] == b"RIFF" and hdr[8:12] == b"WAVE"


def read_wav(path: str, *, prefer_native: bool = True) -> tuple[np.ndarray, int]:
    """Read a WAV file → (float32 mono PCM in [-1, 1), samplerate)."""
    if prefer_native:
        from tiresias_tpu_torch.utils import native

        decoded = native.decode_wav(path)
        if decoded is not None:
            return decoded
    return read_wav_py(path)


def read_wav_py(path: str) -> tuple[np.ndarray, int]:
    try:
        with wave.open(path, "rb") as wf:
            n_channels = wf.getnchannels()
            sampwidth = wf.getsampwidth()
            samplerate = wf.getframerate()
            n_frames = wf.getnframes()
            raw = wf.readframes(n_frames)
    except wave.Error as exc:
        # stdlib wave rejects IEEE-float WAVs ("unknown format: 3") —
        # parse those ourselves so a pure-Python install (no native libs)
        # still reads standard float WAVs; anything else re-raises the
        # original error so read_audio's codec fallback proceeds
        try:
            return _read_float_wav(path)
        except ValueError:
            raise exc from None

    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        as32 = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        as32 = np.where(as32 & 0x800000, as32 - 0x1000000, as32)
        data = as32.astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported WAV sample width {sampwidth} in {path}")

    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return data, samplerate


def _read_float_wav(path: str) -> tuple[np.ndarray, int]:
    """Minimal RIFF parser for IEEE-float WAVs (format tag 3, or
    WAVE_FORMAT_EXTENSIBLE wrapping it), which the stdlib ``wave`` module
    rejects. Raises ValueError for anything that is not a float WAV."""
    with open(path, "rb") as f:
        hdr = f.read(12)
        if len(hdr) < 12 or hdr[:4] != b"RIFF" or hdr[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        fmt = raw = None
        while True:
            chunk = f.read(8)
            if len(chunk) < 8:
                break
            cid = chunk[:4]
            size = int.from_bytes(chunk[4:8], "little")
            payload = f.read(size)
            if cid == b"fmt ":
                fmt = payload
            elif cid == b"data":
                raw = payload
            if size % 2:  # chunks are word-aligned
                f.seek(1, 1)
    if fmt is None or raw is None or len(fmt) < 16:
        raise ValueError(f"malformed WAV: {path}")
    tag = int.from_bytes(fmt[0:2], "little")
    n_channels = int.from_bytes(fmt[2:4], "little")
    samplerate = int.from_bytes(fmt[4:8], "little")
    bits = int.from_bytes(fmt[14:16], "little")
    if tag == 0xFFFE and len(fmt) >= 26:
        tag = int.from_bytes(fmt[24:26], "little")  # extensible subformat
    if tag != 3:
        raise ValueError(f"not an IEEE-float WAV: {path}")
    if bits == 32:
        data = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    elif bits == 64:
        data = np.frombuffer(raw, dtype="<f8").astype(np.float32)
    else:
        raise ValueError(f"unsupported float WAV bit depth {bits} in {path}")
    if n_channels > 1:
        data = data[: len(data) - len(data) % n_channels]
        data = data.reshape(-1, n_channels).mean(axis=1)
    return data, samplerate


def read_wav_i16(path: str) -> tuple[np.ndarray, int] | None:
    """Read a 16-bit mono PCM WAV as raw int16 (no float conversion).

    Returns None for any other format — callers fall back to
    :func:`read_wav`. Raw int16 batches halve host→device traffic; the
    device converts with the exact aubio scaling (ops.mfcc_jax.to_float_pcm).
    """
    try:
        with wave.open(path, "rb") as wf:
            if wf.getsampwidth() != 2 or wf.getnchannels() != 1:
                return None
            samplerate = wf.getframerate()
            raw = wf.readframes(wf.getnframes())
    except (wave.Error, OSError, EOFError):
        return None
    return np.frombuffer(raw, dtype="<i2"), samplerate


def read_wav_g711(path: str) -> tuple[np.ndarray, int, str] | None:
    """Read a mono G.711 WAV (format tag 7 µ-law / 6 A-law) as RAW wire
    bytes (uint8, one byte per sample) without expanding.

    Returns (codes uint8, samplerate, law) or None for any other format.
    Telephony corpora are stored companded; shipping the codes to the
    device (ops.mfcc_jax.to_float_pcm's table expansion, bit-identical
    to host decoding — PARITY D18) quarters the H2D bytes of the float
    path the ffmpeg fallback would take, and halves int16's. The
    reference expands on host via aubio/libav
    (fp_handler.c:604-652)."""
    try:
        with open(path, "rb") as f:
            hdr = f.read(12)
            if len(hdr) < 12 or hdr[:4] != b"RIFF" or hdr[8:12] != b"WAVE":
                return None
            fmt = raw = None
            while True:
                chunk = f.read(8)
                if len(chunk) < 8:
                    break
                cid = chunk[:4]
                size = int.from_bytes(chunk[4:8], "little")
                payload = f.read(size)
                if len(payload) < size:
                    return None  # truncated file
                if cid == b"fmt ":
                    fmt = payload
                elif cid == b"data":
                    raw = payload
                if size % 2:  # chunks are word-aligned
                    f.seek(1, 1)
    except OSError:
        return None
    if fmt is None or raw is None or len(fmt) < 16:
        return None
    tag = int.from_bytes(fmt[0:2], "little")
    n_channels = int.from_bytes(fmt[2:4], "little")
    samplerate = int.from_bytes(fmt[4:8], "little")
    bits = int.from_bytes(fmt[14:16], "little")
    law = {7: "ulaw", 6: "alaw"}.get(tag)
    if law is None or n_channels != 1 or bits != 8:
        return None  # stereo/odd G.711 takes the ffmpeg float path
    return np.frombuffer(raw, dtype=np.uint8), samplerate, law


def write_wav_g711(
    path: str, codes: np.ndarray, samplerate: int, law: str
) -> None:
    """Write raw G.711 codes as a standard telephony WAV (format tag
    7 µ-law / 6 A-law) — the fixture-side inverse of
    :func:`read_wav_g711` (tools + tests)."""
    codes = np.ascontiguousarray(np.asarray(codes, dtype=np.uint8))
    tag = {"ulaw": 7, "alaw": 6}[law]
    fmt = (
        tag.to_bytes(2, "little")
        + (1).to_bytes(2, "little")  # mono
        + int(samplerate).to_bytes(4, "little")
        + int(samplerate).to_bytes(4, "little")  # byte rate = sr * 1 * 1
        + (1).to_bytes(2, "little")  # block align
        + (8).to_bytes(2, "little")  # bits/sample
    )
    data = codes.tobytes()
    body = (
        b"WAVE"
        + b"fmt " + len(fmt).to_bytes(4, "little") + fmt
        + b"data" + len(data).to_bytes(4, "little") + data
        + (b"\x00" if len(data) % 2 else b"")
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(b"RIFF" + len(body).to_bytes(4, "little") + body)
    os.replace(tmp, path)


def float_to_i16(pcm: np.ndarray) -> np.ndarray:
    """Quantize float PCM in [-1, 1] to int16 with aubio's 32768 scale
    (round, clip) — the ONE idiom every harness must share: a drifting
    copy (32767 vs 32768, or a missing round) silently changes what
    "exact self-match" means in bit-parity tests. write_wav keeps its
    own 32767 scale (the WAV-file convention)."""
    return np.clip(
        np.round(np.asarray(pcm) * 32768.0), -32768, 32767
    ).astype(np.int16)


def write_wav(path: str, pcm: np.ndarray, samplerate: int) -> None:
    """Write float PCM in [-1, 1] as 16-bit mono WAV."""
    pcm = np.asarray(pcm)
    ints = np.clip(np.round(pcm * 32767.0), -32768, 32767).astype("<i2")
    tmp = path + ".tmp"
    with wave.open(tmp, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(samplerate)
        wf.writeframes(ints.tobytes())
    os.replace(tmp, path)


def ensure_samplerate(
    pcm: np.ndarray, samplerate: int, target: int
) -> tuple[np.ndarray, int]:
    """Resample to ``target`` Hz when it is non-zero and differs.

    ``target <= 0`` reproduces the reference's ``DEF_AUBIO_SAMPLERATE 0`` —
    analyse at the file's native rate (fp_handler.c:37,
    612); a positive ``DspConfig.samplerate`` forces every signal onto one
    rate before fingerprinting (ingest AND search, so the two always agree).
    int16 PCM is scaled to float [-1, 1) before the polyphase filter.
    """
    if target <= 0 or int(samplerate) == int(target):
        return pcm, int(samplerate)
    pcm = np.asarray(pcm)
    if pcm.dtype == np.int16:
        pcm = pcm.astype(np.float32) / 32768.0
    return resample_poly(pcm, int(samplerate), int(target)), int(target)


def resample_poly(pcm: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resample via scipy (host side; rare path — the reference
    never resamples, it analyses at the file's native rate)."""
    if sr_in == sr_out:
        return np.asarray(pcm, dtype=np.float32)
    from math import gcd

    from scipy.signal import resample_poly as _rp

    g = gcd(sr_in, sr_out)
    out = _rp(np.asarray(pcm, dtype=np.float64), sr_out // g, sr_in // g)
    return out.astype(np.float32)


def synth_tone(freq: float, duration_s: float, samplerate: int, amplitude: float = 0.5) -> np.ndarray:
    t = np.arange(int(round(duration_s * samplerate)), dtype=np.float64) / samplerate
    return (amplitude * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def synth_chirp(f0: float, f1: float, duration_s: float, samplerate: int, amplitude: float = 0.5) -> np.ndarray:
    n = int(round(duration_s * samplerate))
    t = np.arange(n, dtype=np.float64) / samplerate
    k = (f1 - f0) / duration_s
    phase = 2 * np.pi * (f0 * t + 0.5 * k * t * t)
    return (amplitude * np.sin(phase)).astype(np.float32)


def synth_noise(duration_s: float, samplerate: int, amplitude: float = 0.3, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(round(duration_s * samplerate))
    return (amplitude * rng.standard_normal(n)).astype(np.float32)
