"""Admin-protocol client: drive a running server's live store.

The reference's CLI executes inside the live Asterisk process against the
module's in-memory DB (cli_handler.c:26-31 calling
straight into ``fp_*`` on ``g_fp``). The rebuild's equivalent: a running
``tiresias serve`` owns the data directory (utils.locking) and exposes the
same CRUD/sync operations over its TCP protocol (``op: "admin"``); the CLI
auto-detects the server via ``server.json`` and proxies mutations here
instead of racing the server's checkpoints from a second process.
"""

from __future__ import annotations

import json
import socket

from tiresias_tpu_torch.utils.locking import read_server_info


def audio_row(entry) -> dict:
    """Wire/table row for one audio — shared by the server's admin plane
    and the CLI's offline path so the two outputs cannot drift."""
    return {
        "uuid": entry.uuid,
        "name": entry.name,
        "context": entry.context,
        "hash": entry.hash,
    }


class AdminError(RuntimeError):
    """The server answered an admin request with an error.

    ``code`` is the reply's machine-readable error class (e.g.
    ``"unknown_context"``) when the server provided one — callers must
    dispatch on it, never on the human-readable message text."""

    def __init__(self, message: str, code: str | None = None) -> None:
        super().__init__(message)
        self.code = code


class AdminClient:
    """One blocking JSON-lines connection for admin requests."""

    def __init__(self, host: str, port: int, timeout: float = 600.0) -> None:
        # generous default timeout: a proxied `sync` fingerprints a whole
        # directory before answering
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._file = self._sock.makefile("rw", encoding="utf-8", newline="\n")

    def request(self, payload: dict) -> dict:
        self._file.write(json.dumps(payload) + "\n")
        self._file.flush()
        line = self._file.readline()
        if not line:
            raise AdminError("server closed the connection")
        reply = json.loads(line)
        if "error" in reply:
            raise AdminError(reply["error"], reply.get("code"))
        return reply

    def admin(self, cmd: str, **kwargs) -> dict:
        """One admin command; returns the reply's ``admin`` object."""
        reply = self.request({"op": "admin", "cmd": cmd, **kwargs})
        return reply.get("admin", {})

    def close(self) -> None:
        try:
            self._file.close()
        finally:
            self._sock.close()

    def __enter__(self) -> "AdminClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def connect_for_data_dir(data_dir: str, timeout: float = 600.0) -> AdminClient | None:
    """AdminClient for the live server owning ``data_dir``, or None.

    ``server.json`` is trusted only while the owner lock is actually held
    (read_server_info checks); a dead server's leftover file is ignored."""
    info = read_server_info(data_dir)
    if not info:
        return None
    try:
        return AdminClient(info["host"], int(info["port"]), timeout=timeout)
    except (OSError, KeyError, ValueError, TypeError):
        # unreachable server, or a hand-edited/garbled server.json (missing
        # host/port, non-numeric port) — fall back to the offline path
        # rather than crashing every CLI command on this data dir
        return None
