"""Device resolution for the CUDA port."""

from __future__ import annotations

import torch


def cuda_device() -> torch.device:
    """The CUDA device to run the main path on (the first); raises when
    there is none.

    There is no CPU carry-on: the CPU runs only the plain twins, in tests,
    and callers that want that pass ``torch.device("cpu")`` explicitly.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    return torch.device("cuda", 0)
