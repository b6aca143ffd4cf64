"""ctypes bindings to the optional C++ host runtime (``native/``).

The reference's host-side runtime is C (audio decode via aubio_source, MD5
via OpenSSL — fp_handler.c:604,758). The rebuild keeps
those hot host paths native:

  * ``libtiresias_host.so`` (dependency-free): WAV decode + file MD5.
  * ``libtiresias_codec.so`` (links ffmpeg's libavformat/avcodec/
    swresample): decode of MP3/OGG/FLAC/anything-libavformat-reads, plus
    encode for corpus tooling — the breadth aubio_source inherits from its
    libav backend.

Both load lazily; every entry point returns ``None`` when its library is
absent and the caller falls back (pure-Python WAV, or skip-with-warning for
compressed formats).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_tried = False


def _candidate_paths(
    name: str = "libtiresias_host.so", env_var: str = "TIRESIAS_NATIVE_LIB"
) -> list[str]:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    paths = []
    env = os.environ.get(env_var)
    if env:
        paths.append(env)
    paths.append(os.path.join(here, "native", name))
    paths.append(os.path.join(here, name))
    return paths


def _load_lib(name: str, env_var: str, bind):
    """The one lazy loader both libraries share: env kill-switch, candidate
    path walk, bind-or-skip. Returns the bound CDLL or None."""
    if os.environ.get("TIRESIAS_DISABLE_NATIVE"):
        return None
    for path in _candidate_paths(name, env_var):
        if not os.path.exists(path):
            continue
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue  # e.g. runtime deps (ffmpeg) missing
        try:
            bind(lib)
        except AttributeError:
            continue
        return lib
    return None


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_tried
    with _lock:
        if not _lib_tried:
            _lib_tried = True
            _lib = _load_lib(
                "libtiresias_host.so", "TIRESIAS_NATIVE_LIB", _bind
            )
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    # int tir_wav_info(const char* path, int* samplerate, long* n_samples)
    lib.tir_wav_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.tir_wav_info.restype = ctypes.c_int
    # int tir_wav_decode(const char* path, float* out, long capacity)
    lib.tir_wav_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long,
    ]
    lib.tir_wav_decode.restype = ctypes.c_int
    # int tir_md5_file(const char* path, char* hex_out /* 33 bytes */)
    lib.tir_md5_file.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.tir_md5_file.restype = ctypes.c_int


def available() -> bool:
    return _load() is not None


def decode_wav(path: str) -> tuple[np.ndarray, int] | None:
    """Decode a WAV to (float32 mono PCM, samplerate), or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    samplerate = ctypes.c_int(0)
    n_samples = ctypes.c_long(0)
    rc = lib.tir_wav_info(os.fsencode(path), ctypes.byref(samplerate), ctypes.byref(n_samples))
    if rc != 0:
        return None
    out = np.empty(n_samples.value, dtype=np.float32)
    rc = lib.tir_wav_decode(
        os.fsencode(path),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_long(out.size),
    )
    if rc != 0:
        return None
    return out, samplerate.value


def md5_file(path: str) -> str | None:
    lib = _load()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(33)
    rc = lib.tir_md5_file(os.fsencode(path), buf)
    if rc != 0:
        return None
    return buf.value.decode()


# --------------------------------------------------------------------------- #
# Compressed-audio codec (ffmpeg-backed, separate .so so the base host
# library stays dependency-free)
# --------------------------------------------------------------------------- #

_codec: ctypes.CDLL | None = None
_codec_tried = False


def _load_codec() -> ctypes.CDLL | None:
    global _codec, _codec_tried
    with _lock:
        if not _codec_tried:
            _codec_tried = True
            _codec = _load_lib(
                "libtiresias_codec.so", "TIRESIAS_CODEC_LIB", _bind_codec
            )
        return _codec


def _bind_codec(lib: ctypes.CDLL) -> None:
    lib.tir_decode_audio.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.tir_decode_audio.restype = ctypes.c_int
    lib.tir_buffer_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.tir_buffer_free.restype = None
    lib.tir_encode_audio.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long,
        ctypes.c_int,
    ]
    lib.tir_encode_audio.restype = ctypes.c_int


def codec_available() -> bool:
    return _load_codec() is not None


def decode_audio(path: str) -> tuple[np.ndarray, int] | None:
    """Decode any libavformat-readable audio file to (float32 mono PCM at
    native rate, samplerate); None when the codec library is absent or the
    file can't be decoded."""
    lib = _load_codec()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_long(0)
    samplerate = ctypes.c_int(0)
    rc = lib.tir_decode_audio(
        os.fsencode(path), ctypes.byref(out), ctypes.byref(n),
        ctypes.byref(samplerate),
    )
    if rc != 0:
        return None
    if n.value <= 0:
        # zero decodable samples (e.g. a metadata-only file): malloc(0) may
        # legally return NULL, which np.ctypeslib.as_array rejects — return
        # an empty signal (callers treat it as a skip) instead of raising
        lib.tir_buffer_free(out)
        return np.zeros(0, np.float32), samplerate.value
    try:
        pcm = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.tir_buffer_free(out)
    return pcm, samplerate.value


def encode_audio(path: str, pcm: np.ndarray, samplerate: int) -> bool:
    """Encode mono float PCM to the container the extension selects
    (.flac/.ogg/.mp3/.wav). Corpus tooling + test fixtures; False when the
    codec library is absent or the encoder rejects the parameters."""
    lib = _load_codec()
    if lib is None:
        return False
    pcm = np.ascontiguousarray(np.asarray(pcm, dtype=np.float32))
    rc = lib.tir_encode_audio(
        os.fsencode(path),
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_long(pcm.size),
        ctypes.c_int(int(samplerate)),
    )
    return rc == 0
