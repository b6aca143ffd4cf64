"""parallel subpackage of the port: the (db, batch) mesh on
``torch.distributed`` (port of ``tiresias_tpu.parallel``)."""

from tiresias_tpu_torch.parallel.distributed import (
    global_mesh,
    initialize_distributed,
    is_multiprocess,
    put_global,
)
from tiresias_tpu_torch.parallel.sharding import (
    BATCH_AXIS,
    DB_AXIS,
    Mesh,
    make_mesh,
    shard_db,
    sharded_fingerprint,
    sharded_fingerprint_long,
    sharded_search,
    sharded_votes_kernels,
)

__all__ = [
    "BATCH_AXIS",
    "DB_AXIS",
    "Mesh",
    "global_mesh",
    "initialize_distributed",
    "is_multiprocess",
    "make_mesh",
    "put_global",
    "shard_db",
    "sharded_fingerprint",
    "sharded_fingerprint_long",
    "sharded_search",
    "sharded_votes_kernels",
]
