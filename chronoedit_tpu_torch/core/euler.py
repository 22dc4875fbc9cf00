"""Flow-match Euler sampler (the UniPC alternative the diffusers pipeline
also supports: FlowMatchEulerDiscreteScheduler).

For flow matching the Euler step is simply
``x_{i+1} = x_i + (sigma_{i+1} - sigma_i) * v_i``: one multiply-add per
step. The port of ``chronoedit_tpu/core/euler.py``, whose ``lax.scan``
becomes a Python loop: the sigma differences are taken on the host in
float64 and rounded to fp32, as JAX's are, and the state is fp32 on the
device of ``x_init``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from chronoedit_tpu_torch.core.schedule import FlowMatchSchedule


def euler_sample(
    model_fn: Callable[[torch.Tensor, float], torch.Tensor],
    x_init: torch.Tensor,
    schedule: FlowMatchSchedule,
    int_timesteps: bool = True,
) -> torch.Tensor:
    """Integrate ``model_fn(x, timestep) -> velocity`` over the sigma grid
    from ``x_init``. Returns float32 x0."""
    sigmas = np.asarray(schedule.sigmas, np.float64)
    dsig = np.diff(sigmas).astype(np.float32)  # (n,) negative steps
    ts = np.asarray(schedule.model_timesteps(int_timesteps), np.float32)
    x = x_init.float()
    for t, ds in zip(ts.tolist(), dsig.tolist()):
        x = x + ds * model_fn(x, t).float()
    return x
