"""Flow-matching noise schedules (sigma grids with flow shift).

A copy of ``chronoedit_tpu/core/schedule.py`` (numpy only): the inference
grid ``linspace(sigma_max, sigma_min, n+1)[:-1]``, then the flow shift
``s' = shift*s / (1 + (shift-1)*s)``, timesteps ``s'*N`` and a final sigma
of 0 (reference ``fm_solvers_unipc.py:196-221``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def flow_shift(sigmas: np.ndarray, shift: float) -> np.ndarray:
    """Apply the flow-matching time shift s' = shift*s / (1 + (shift-1)*s)."""
    return shift * sigmas / (1.0 + (shift - 1.0) * sigmas)


@dataclasses.dataclass(frozen=True)
class FlowMatchSchedule:
    """An inference-time sigma grid for flow-matching samplers.

    Attributes:
      sigmas: (n+1,) float64 descending from sigma_max to the final sigma (0).
      timesteps: (n,) float64, ``sigma * num_train_timesteps`` for each step.
      num_train_timesteps: train discretization (1000 for ChronoEdit).
      shift: the flow shift that produced this grid.
    """

    sigmas: np.ndarray
    timesteps: np.ndarray
    num_train_timesteps: int
    shift: float

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    def model_timesteps(self) -> np.ndarray:
        """Timesteps as fed to the DiT: floored, as the reference casts them
        to int64 before the transformer forward (``fm_solvers_unipc.py:224``)."""
        return np.floor(self.timesteps)


def train_sigmas(num_train_timesteps: int = 1000) -> np.ndarray:
    """The (descending, unshifted) training sigma grid;
    fm_solvers_unipc.py:121-129."""
    alphas = np.linspace(1.0, 1.0 / num_train_timesteps, num_train_timesteps)[::-1]
    return 1.0 - alphas


def make_flow_schedule(num_steps: int, shift: float = 5.0,
                       num_train_timesteps: int = 1000) -> FlowMatchSchedule:
    """The inference sigma grid of the UniPC sampler for ``num_steps`` steps
    and the runtime flow ``shift`` (2.0 for the 8-step distilled model)."""
    base = train_sigmas(num_train_timesteps)
    # the reference keeps the train grid in float32 and reads sigma_max/min
    # back as Python floats: the float32 rounding (0.999 -> 0.9990000128)
    # moves floored timesteps by one, so it is kept exactly
    sigma_max = float(np.float32(base[0]))
    sigma_min = float(np.float32(base[-1]))
    sigmas = np.linspace(sigma_max, sigma_min, num_steps + 1)[:-1]
    sigmas = flow_shift(sigmas, shift)
    timesteps = sigmas * num_train_timesteps
    sigmas = np.concatenate([sigmas, [0.0]])
    return FlowMatchSchedule(
        sigmas=sigmas,
        timesteps=timesteps,
        num_train_timesteps=num_train_timesteps,
        shift=shift,
    )
