"""Process-aware logger (reference: loguru rank-aware ``utils/log.py`` —
rank-0 filter with explicit rank prefixes).

The port of ``chronoedit_tpu/utils/log.py``: the rank is this process's in
the ``torch.distributed`` world (``parallel/distributed.process_index``;
0 without a process group) where JAX's is ``jax.process_index()``.
"""

from __future__ import annotations

import logging
import sys

from chronoedit_tpu_torch.parallel.distributed import process_index

_FORMAT = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"


def get_logger(name: str = "chronoedit_tpu_torch", rank0_only: bool = True,
               level: int = logging.INFO, log_file: str | None = None) -> logging.Logger:
    """Logger that (by default) only emits on rank 0 of a multi-process run;
    with ``rank0_only=False`` the other ranks' records are prefixed
    ``[RANK n]``. The rank is read once, when the logger is first made, so
    join the world first."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    rank = process_index()

    class _RankFilter(logging.Filter):
        def filter(self, record):
            if rank != 0:
                if rank0_only:
                    return False
                record.msg = f"[RANK {rank}] {record.msg}"
            return True

    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    handler.addFilter(_RankFilter())
    logger.addHandler(handler)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
    return logger
