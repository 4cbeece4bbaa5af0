"""Data parallelism of the port over ``torch.distributed`` (one process per
GPU): the twin of ``arbitrarystyletransfer_tpu/parallel``."""

from .mesh import (
    Mesh,
    all_reduce_grads,
    all_reduce_sum,
    all_reduce_values,
    barrier,
    batch_share,
    create_mesh,
    destroy_mesh,
    gather_batch,
    is_sharded,
    local,
    replicate,
    set_mesh,
    shard_batch,
    shard_rows,
    shared,
)

__all__ = ["Mesh", "all_reduce_grads", "all_reduce_sum", "all_reduce_values",
           "barrier", "batch_share", "create_mesh", "destroy_mesh",
           "gather_batch", "is_sharded", "local", "replicate", "set_mesh",
           "shard_batch", "shard_rows", "shared"]
