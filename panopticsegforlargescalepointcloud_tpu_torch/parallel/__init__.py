"""Data-parallel execution over ``torch.distributed``: the mesh of ranks,
replication, batch sharding, the data-parallel train step and the
one-tile-per-rank serving forward (:mod:`.mesh`), and the launcher that
starts the ranks (:mod:`.launch`)."""

from .launch import backend_for, from_env, spawn, visible_devices
from .mesh import (
    Mesh,
    make_mesh,
    make_parallel_eval_forward,
    make_parallel_train_step,
    replica_checksum,
    replicate,
    shard_batch,
)

__all__ = ["Mesh", "backend_for", "from_env", "make_mesh", "make_parallel_eval_forward",
           "make_parallel_train_step", "replica_checksum", "replicate", "shard_batch", "spawn",
           "visible_devices"]
