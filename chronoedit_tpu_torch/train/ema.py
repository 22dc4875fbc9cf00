"""EMA parameter tracking (classic and EDM2 power EMA).

The port of ``chronoedit_tpu/train/ema.py``: ``ema <- beta * ema + (1 -
beta) * params`` as an fp32 lerp, with a fixed beta ("classic") or the
EDM2 power schedule ``beta = (1 - 1/(t+1)) ** (gamma + 1)`` ("power"),
which copies the parameters at step 0. JAX returns a new tree; the port
updates the EMA tensors in place.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch


@dataclasses.dataclass(frozen=True)
class EMAConfig:
    enabled: bool = True
    mode: str = "power"  # "power" | "classic"
    decay: float = 0.9999  # classic mode
    edm2_gamma: float = 6.94  # power mode (EDM2 sigma_rel ~= 0.1)


def power_ema_beta(step: int, gamma: float) -> torch.Tensor:
    """EDM2 power-function decay (1 - 1/(t+1)) ** (gamma + 1), fp32."""
    t = torch.tensor(step, dtype=torch.float32) + 1.0
    return torch.pow(1.0 - 1.0 / t, gamma + 1.0)


@torch.no_grad()
def ema_update(ema_params: Iterable[torch.Tensor], params: Iterable[torch.Tensor],
               step: int, cfg: EMAConfig) -> None:
    """One EMA step, in place: ``e <- e + (1 - beta) * (p - e)`` in fp32,
    stored back in e's dtype."""
    beta = (power_ema_beta(step, cfg.edm2_gamma) if cfg.mode == "power"
            else torch.tensor(cfg.decay, dtype=torch.float32))
    w = float(1.0 - beta)  # an fp32 value, exact as a Python float
    for e, p in zip(ema_params, params):
        ef = e.float()
        e.copy_(ef + w * (p.float() - ef))
