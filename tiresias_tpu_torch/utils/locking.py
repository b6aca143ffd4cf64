"""Single-writer ownership of a data directory.

The reference runs its CLI inside the one Asterisk process that owns the
in-memory DB (cli_handler.c:26-31), so two writers can
never race on the checkpoint. The rebuild's CLI constructs engines in fresh
processes, so ownership must be explicit: an ``owner.lock`` file under the
data dir, held with a POSIX ``flock`` for as long as the owning engine
lives. The kernel releases the lock when the process dies — no stale-lease
cleanup, no heartbeats.

The lock file's CONTENT is informational (owner pid + optional server
address, JSON): a second writer that fails to acquire reads it to tell the
operator who owns the directory — and, when the owner is a running
``tiresias serve``, lets the CLI proxy the mutation to it over the admin
protocol instead of failing.
"""

from __future__ import annotations

import errno
import json
import logging
import os

log = logging.getLogger(__name__)

# flock errnos that mean "someone else holds it" — anything else (ENOLCK
# on NFS without lockd, EOPNOTSUPP, EINVAL on odd filesystems) means this
# filesystem cannot lock at all and must not masquerade as contention
_CONTENTION_ERRNOS = (errno.EWOULDBLOCK, errno.EAGAIN, errno.EACCES)

LOCK_FILE = "owner.lock"
SERVER_FILE = "server.json"  # written by a serving owner: {host, port, pid}


class DataDirLocked(RuntimeError):
    """Another live process owns this data directory."""

    def __init__(self, directory: str, owner: dict | None) -> None:
        self.directory = directory
        self.owner = owner or {}
        who = self.owner.get("pid", "unknown pid")
        super().__init__(
            f"data directory {directory!r} is owned by another process "
            f"({who}); offline mutation would race its checkpoints"
        )


def _read_json(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _pid_alive(pid) -> bool:
    """Best-effort same-host liveness of a pid (signal-0 probe)."""
    if not isinstance(pid, int) or pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True  # exists but not signalable by us: alive
    return True


class DataDirLock:
    """Exclusive flock on ``<directory>/owner.lock``.

    ``acquire`` is non-blocking: it either takes ownership or raises
    :class:`DataDirLocked` with whatever owner info the holder recorded.
    Platforms without ``fcntl`` (non-POSIX) degrade to no locking —
    ownership is then advisory only, matching the reference's level of
    protection there (none).
    """

    def __init__(self, directory: str) -> None:
        self.directory = directory
        self.path = os.path.join(directory, LOCK_FILE)
        self._fd: int | None = None
        self._degraded = False  # no fcntl on this platform

    @property
    def held(self) -> bool:
        return self._fd is not None or self._degraded

    def acquire(self, info: dict | None = None) -> "DataDirLock":
        if self.held:
            return self
        try:
            import fcntl
        except ImportError:  # non-POSIX: degrade to advisory-only
            self._degraded = True
            return self
        import time

        os.makedirs(self.directory, exist_ok=True)
        fd: int | None = None
        for attempt in range(3):
            fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except OSError as exc:
                os.close(fd)
                fd = None
                if exc.errno not in _CONTENTION_ERRNOS:
                    # this filesystem cannot flock (e.g. NFS without lock
                    # support): degrade to advisory-only like the
                    # no-fcntl platforms, instead of reporting a
                    # nonexistent owner forever
                    log.warning(
                        "flock unsupported on %s (%s); data-dir ownership "
                        "is advisory only here",
                        self.directory, exc,
                    )
                    self._degraded = True
                    return self
                if attempt == 2:
                    raise DataDirLocked(
                        self.directory, self.owner_info()
                    ) from None
                # A failed flock does NOT mean a live owner: it can be a
                # momentary shared-lock liveness probe (read_server_info),
                # and the file's JSON cannot disambiguate — a crashed
                # owner leaves its content behind (truncation happens only
                # on clean release). Retry briefly: a real owner holds
                # the flock continuously and still fails here; a probe
                # racing a stale file clears within milliseconds.
                time.sleep(0.05)
        assert fd is not None
        payload = {"pid": os.getpid(), **(info or {})}
        os.ftruncate(fd, 0)
        os.write(fd, json.dumps(payload).encode())
        os.fsync(fd)
        self._fd = fd
        return self

    def annotate(self, info: dict) -> None:
        """Merge extra fields (e.g. a server address) into the lock file."""
        if self._fd is None:
            return
        payload = {"pid": os.getpid(), **info}
        os.lseek(self._fd, 0, os.SEEK_SET)
        os.ftruncate(self._fd, 0)
        os.write(self._fd, json.dumps(payload).encode())

    def release(self) -> None:
        self._degraded = False
        if self._fd is None:
            return
        try:
            import fcntl

            # empty the file first: owner info must not outlive the lock
            # (the flock itself vanishes with the fd either way)
            os.ftruncate(self._fd, 0)
            fcntl.flock(self._fd, fcntl.LOCK_UN)
        except (ImportError, OSError):
            pass
        os.close(self._fd)
        self._fd = None

    def owner_info(self) -> dict | None:
        """Best-effort info about the current holder (None if unreadable)."""
        return _read_json(self.path)

    def __enter__(self) -> "DataDirLock":
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


def read_server_info(directory: str) -> dict | None:
    """The running server's address for this data dir, or None.

    Validated against liveness AND identity: ``server.json`` is trusted
    only while the owner lock is held by THE SAME PROCESS that wrote it
    (pids compared). A crashed server leaves server.json behind; if some
    OTHER process later holds the lock (an offline CLI ingest, a fresh
    non-serving engine), the stale address must not be proxied to — the
    port may have been reused by an unrelated server on a different data
    dir, and an admin mutation sent there would hit the wrong store."""
    info = _read_json(os.path.join(directory, SERVER_FILE))
    if not info:
        return None
    try:
        import fcntl

        try:
            # no O_CREAT: a missing lock file means nobody ever owned the
            # dir, and a read-only probe must not create state
            fd = os.open(os.path.join(directory, LOCK_FILE), os.O_RDONLY)
        except FileNotFoundError:
            return None
        try:
            # SHARED probe: conflicts with a live owner's exclusive lock
            # (→ someone is alive) but not with concurrent probes, and any
            # momentary interference with a racing exclusive acquire is
            # absorbed by DataDirLock.acquire's retry
            fcntl.flock(fd, fcntl.LOCK_SH | fcntl.LOCK_NB)
        except OSError as exc:
            if exc.errno not in _CONTENTION_ERRNOS:
                # flock unsupported on this filesystem (ENOLCK NFS,
                # EOPNOTSUPP): DataDirLock.acquire DEGRADES to advisory
                # success on the same filesystem, so "cannot probe" must
                # not read as "no server" — an offline CLI would then
                # mutate concurrently with the running server, the exact
                # two-writer race this module exists to prevent. Fall
                # back to pid liveness (same-host, the trust level the
                # no-fcntl platforms get).
                return info if _pid_alive(info.get("pid")) else None
            # lock held by a LIVE process — but is it the server that
            # wrote server.json? The holder's pid is in the lock content.
            holder = _read_json(os.path.join(directory, LOCK_FILE))
            if holder and holder.get("pid") == info.get("pid"):
                return info
            return None  # a different process owns the dir: stale address
        else:
            fcntl.flock(fd, fcntl.LOCK_UN)
            return None  # nobody holds the lock — stale server.json
        finally:
            os.close(fd)
    except ImportError:
        # non-POSIX: no flock to probe — pid liveness is the best signal
        return info if _pid_alive(info.get("pid")) else None


def write_server_info(directory: str, host: str, port: int) -> None:
    path = os.path.join(directory, SERVER_FILE)
    os.makedirs(directory, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"host": host, "port": port, "pid": os.getpid()}, f)
    os.replace(tmp, path)


def clear_server_info(directory: str) -> None:
    try:
        os.unlink(os.path.join(directory, SERVER_FILE))
    except OSError:
        pass
