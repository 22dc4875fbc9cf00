"""Parallelism over ``torch.distributed``: the process world, the mesh of
``data`` and ``context`` axes, context-parallel (ring and Ulysses)
attention and its collectives, and cross-rank replica checks. Parameter
sharding (FSDP, tensor parallelism), pipeline stages and
``host_local_to_global`` are item 6b of the roadmap."""

from chronoedit_tpu_torch.parallel.context import (
    gather_sequence,
    ring_attention,
    split_sequence,
    ulysses_attention,
)
from chronoedit_tpu_torch.parallel.distributed import (
    collate_metrics,
    init_distributed,
    is_primary,
    local_batch_size,
    process_count,
    process_index,
)
from chronoedit_tpu_torch.parallel.mesh import MeshConfig, make_mesh

__all__ = [
    "collate_metrics",
    "init_distributed",
    "is_primary",
    "local_batch_size",
    "process_count",
    "process_index",
    "MeshConfig",
    "make_mesh",
    "ring_attention",
    "ulysses_attention",
    "split_sequence",
    "gather_sequence",
]
