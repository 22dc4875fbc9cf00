"""Parallelism over ``torch.distributed``: the process world, the mesh of
``pipe``, ``data``, ``fsdp``, ``tensor`` and ``context`` axes, tensor
(Megatron) and FSDP sharding of the DiT's parameters
(``dit_param_sharding``, ``shard_params``), context-parallel (ring and
Ulysses) attention and the collectives, GPipe pipeline stages
(``gpipe_scan``), cross-rank replica checks, and ``host_local_to_global``,
the data line's rows of a data-parallel training batch."""

from chronoedit_tpu_torch.parallel.context import (
    gather_sequence,
    ring_attention,
    split_sequence,
    ulysses_attention,
)
from chronoedit_tpu_torch.parallel.distributed import (
    collate_metrics,
    host_local_to_global,
    init_distributed,
    is_primary,
    local_batch_size,
    process_count,
    process_index,
)
from chronoedit_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from chronoedit_tpu_torch.parallel.pipeline_parallel import gpipe_scan, stage_range
from chronoedit_tpu_torch.parallel.sharding import (
    dit_param_sharding,
    param_spec_tree,
    shard_params,
)

__all__ = [
    "collate_metrics",
    "host_local_to_global",
    "init_distributed",
    "is_primary",
    "local_batch_size",
    "process_count",
    "process_index",
    "MeshConfig",
    "make_mesh",
    "dit_param_sharding",
    "shard_params",
    "param_spec_tree",
    "ring_attention",
    "ulysses_attention",
    "split_sequence",
    "gather_sequence",
    "gpipe_scan",
    "stage_range",
]
