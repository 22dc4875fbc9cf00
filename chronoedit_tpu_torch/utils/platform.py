"""Device resolution for the CUDA port."""

from __future__ import annotations

import os

import torch


def cuda_device() -> torch.device:
    """The CUDA device to run the main path on: this rank's, ``LOCAL_RANK``
    (0 without a launcher); raises when there is none.

    There is no CPU carry-on: the CPU runs only the plain twins, in tests,
    and callers that want that pass ``torch.device("cpu")`` explicitly.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def multi_device_world() -> bool:
    """True in a ``torch.distributed`` world of more than one process."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
