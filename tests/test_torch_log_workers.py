"""The rank body of ``test_torch_host_utils.py``'s logger test: each rank
of a gloo world on the CPU (``parallel.launch.run_world``, spawned) makes
the port's ``get_logger`` and returns what it wrote to its standard error.
It imports the port only, never jax or the JAX package."""

from __future__ import annotations

import io
import sys


def log_world(rank: int, name: str, rank0_only: bool) -> str:
    from chronoedit_tpu_torch.utils.log import get_logger

    err, sys.stderr = sys.stderr, io.StringIO()
    try:
        logger = get_logger(name, rank0_only=rank0_only)
        logger.info("hello from rank %d", rank)
        logger.warning("second line")
        return sys.stderr.getvalue()
    finally:
        sys.stderr = err
