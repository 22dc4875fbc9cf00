"""Process-level helpers of the training entry points, single process for
now: the meshes, sharding and context parallelism of
``chronoedit_tpu/parallel/`` are the multi-GPU slice's."""

from chronoedit_tpu_torch.parallel.distributed import (
    collate_metrics,
    init_distributed,
    is_primary,
    local_batch_size,
    process_count,
    process_index,
)

__all__ = [
    "collate_metrics",
    "init_distributed",
    "is_primary",
    "local_batch_size",
    "process_count",
    "process_index",
]
