"""Process-world helpers for the training entry points, one process.

The port of the single-process half of
``chronoedit_tpu/parallel/distributed.py``: what the trainer, its
callbacks and the training CLI import. JAX's ``init_distributed`` joins a
multi-host world from ``JAX_*`` variables; the port's reads a launcher's
``WORLD_SIZE`` (torchrun's) and, without one or at 1, is a no-op. A world
of several processes (``torch.distributed`` over NCCL, per-process batch
shards, cross-process metric means) belongs to the multi-GPU slice, and
asking for one raises until then.
"""

from __future__ import annotations

import os


def init_distributed() -> bool:
    """Join the launcher's process world. Returns False for one process
    (no launcher, or ``WORLD_SIZE=1``); a larger world raises
    ``NotImplementedError`` (not ported yet)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    raise NotImplementedError(
        f"WORLD_SIZE={world}: multi-process training is not ported yet (one process only)")


def process_count() -> int:
    return 1


def process_index() -> int:
    return 0


def is_primary() -> bool:
    """Rank-0 check (the reference's rank0-only logging/checkpoint guard)."""
    return process_index() == 0


def collate_metrics(metrics: dict) -> dict:
    """The cross-process means of scalar metrics (the reference's
    ``collate_batches``); one process: each value as a float."""
    return {k: float(v) for k, v in metrics.items()}


def local_batch_size(global_batch: int) -> int:
    """Per-process batch size for a given global batch."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n
