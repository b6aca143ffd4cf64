"""Multi-process placement on ``torch.distributed`` (port of
``tiresias_tpu.parallel.distributed``).

Every process runs the same program, calls :func:`initialize_distributed`
once, and then builds meshes over the GLOBAL cell set
(:func:`global_mesh`): the devices of every rank, rank-major. The design is
the JAX package's:

  * The **host catalog is replicated**: every process restores the same
    checkpoint or syncs the same media directory, so each holds the full
    ``[A, T, C]`` fingerprint matrix in host memory.
  * The **device catalog is sharded** on the mesh's ``db`` axis: each
    process builds only the shards of its own cells from its host copy
    (:func:`put_global`, the store's meshed views); no process ships another
    process's shard.
  * **Searches** run per cell on this process's shards, and the vote blocks
    of every rank are exchanged with one ``all_gather``
    (:func:`tiresias_tpu_torch.parallel.sharding.gather_cells`), so every
    rank holds every vote and takes the same decisions.

The backend is NCCL when the local devices are CUDA devices and Gloo on the
CPU; a failed initialization raises (there is no fallback). A process that
never calls :func:`initialize_distributed` builds single-process meshes
over its own devices and needs none of this module.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from tiresias_tpu_torch.utils.device import resolve_device
from tiresias_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# the local devices this process registered with initialize_distributed (or
# found in an outside initialization), None before
_local: list[torch.device] | None = None
_initialized = False

# how long a collective waits for the other ranks before it raises
TIMEOUT_S = 300.0


def _default_ids(device: torch.device) -> list[int]:
    if device.type == "cuda":
        if os.environ.get("LOCAL_RANK"):  # torchrun: one card per process
            return [int(os.environ["LOCAL_RANK"])]
        return list(range(torch.cuda.device_count()))
    return [0]


def _devices(device: torch.device, ids) -> list[torch.device]:
    if device.type == "cuda":
        return [torch.device("cuda", int(i)) for i in ids]
    return [torch.device("cpu")] * len(ids)


def local_devices(device: str | torch.device = "cuda") -> list[torch.device]:
    """This process's devices of ``device``'s type: those registered with
    :func:`initialize_distributed` when it registered that type, else every
    visible card (``cuda``; raises without one) or one CPU cell. CPU cells
    repeat ``cpu``: like JAX's virtual CPU devices they share the host (name
    several with ``local_device_ids`` or :func:`make_mesh`'s ``devices``)."""
    dev = resolve_device(device)
    if _local is not None and _local[0].type == dev.type:
        return list(_local)
    return _devices(dev, _default_ids(dev))


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
    device: str | torch.device = "cuda",
) -> None:
    """Idempotent ``torch.distributed.init_process_group`` for a mesh.

    Arguments it is not given come from torchrun's environment:
    ``MASTER_ADDR``/``MASTER_PORT`` (or ``coordinator_address`` as
    ``"host:port"``), ``WORLD_SIZE`` (default 1), ``RANK`` (default 0) and,
    on a card, ``LOCAL_RANK``. ``local_device_ids`` names this process's
    devices (CUDA ordinals; on the CPU only their count matters; ids may
    repeat, which puts several cells on one device); the default is every
    visible card, or one CPU cell. ``device`` picks the
    type, and with it the backend: NCCL on ``cuda`` (which raises without a
    card), Gloo on ``cpu``. A process group someone else initialized is
    adopted as it is. A failed initialization raises."""
    global _local, _initialized
    if _initialized:
        return
    dev = resolve_device(device)
    ids = (list(local_device_ids) if local_device_ids is not None
           else _default_ids(dev))
    if not ids:
        raise ValueError("a process needs at least one local device")
    if dist.is_initialized():
        # an outside initializer (a host program, torchrun's launcher code):
        # re-initializing would raise
        _local, _initialized = _devices(dev, ids), True
        return
    addr = coordinator_address
    if addr is None and os.environ.get("MASTER_ADDR"):
        addr = (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    if addr is None:
        raise ValueError(
            "no coordinator: pass coordinator_address='host:port' or set "
            "MASTER_ADDR and MASTER_PORT")
    if "://" not in addr:
        addr = "tcp://" + addr
    world = (int(num_processes) if num_processes is not None
             else int(os.environ.get("WORLD_SIZE", "1")))
    rank = (int(process_id) if process_id is not None
            else int(os.environ.get("RANK", "0")))
    devices = _devices(dev, ids)
    if dev.type == "cuda":
        torch.cuda.set_device(devices[0])
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=addr, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    _local, _initialized = devices, True
    log.info("torch.distributed initialized (%s): rank %d of %d, %d local "
             "cells", backend, rank, world, len(devices))


def shutdown_distributed() -> None:
    """Destroy the process group :func:`initialize_distributed` made (a
    no-op without one), so a program ends without a live backend."""
    global _local, _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _local, _initialized = None, False


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_multiprocess() -> bool:
    return is_initialized() and dist.get_world_size() > 1


def global_cells() -> list:
    """Every rank's cells, rank-major (each rank's in its local order), as
    :class:`~tiresias_tpu_torch.parallel.sharding.Cell`. A collective: every
    rank must call it, in the same order as its other collectives."""
    from tiresias_tpu_torch.parallel.sharding import Cell

    if not is_initialized():
        raise RuntimeError("global_cells needs initialize_distributed first")
    mine = [str(d) for d in (_local or local_devices())]
    every: list = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return [Cell(torch.device(d), r) for r, devs in enumerate(every)
            for d in devs]


def global_mesh(n_db: int | None = None, n_batch: int | None = None):
    """A ``(db, batch)`` mesh over the cells of EVERY rank (every process
    builds the identical mesh). Its sharded results are exchanged between
    the ranks with ``all_gather``, at world size 1 too. Without a process
    group, a mesh over this process's devices (:func:`make_mesh`'s
    default)."""
    from tiresias_tpu_torch.parallel.sharding import make_mesh

    if not is_initialized():
        return make_mesh(n_db, n_batch)
    return make_mesh(n_db, n_batch, devices=global_cells(), distributed=True)


def put_global(arr, mesh, axis: str | None = "db"):
    """Place a replicated host array on ``mesh``: its rows split evenly over
    ``axis`` (``"db"`` or ``"batch"``; None replicates it), each process
    materializing only the parts of its own cells, each on its cell's device
    (one copy per device when cells share one). Returns a
    :class:`~tiresias_tpu_torch.parallel.sharding.Sharded`."""
    from tiresias_tpu_torch.parallel.sharding import Sharded
    from tiresias_tpu_torch.utils.device import to_device

    arr = np.asarray(arr)
    n = 1 if axis is None else int(mesh.shape[axis])
    if arr.shape[0] % n:
        raise ValueError(
            f"{arr.shape[0]} rows do not split evenly over {axis}={n}")
    per = arr.shape[0] // n
    parts = {}
    for i, j, cell in mesh.local_cells():
        idx = {None: 0, "db": i, "batch": j}[axis]
        key = (idx, cell.device)
        if key not in parts:
            parts[key] = to_device(arr[idx * per:(idx + 1) * per],
                                   cell.device)
    return Sharded(mesh, parts, arr.shape[0])
