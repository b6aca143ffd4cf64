"""File hashing and IDs.

Replaces the reference's OpenSSL MD5 file hash
(fp_handler.c:758-805 — 4 KiB fread loop, lowercase hex
digest) and libuuid uuid4 (fp_handler.c:1097-1109).
Digest format is identical so catalogs are comparable across implementations.
A C++ fast path (native/) is used when built.
"""

from __future__ import annotations

import hashlib
import uuid as _uuid


def file_md5(path: str, *, prefer_native: bool = True) -> str:
    """Lowercase hex MD5 of a file's contents (reference-compatible)."""
    if prefer_native:
        from tiresias_tpu_torch.utils import native

        digest = native.md5_file(path)
        if digest is not None:
            return digest
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def generate_uuid() -> str:
    """Lowercase uuid4 string (fp_generate_uuid equivalent)."""
    return str(_uuid.uuid4())
