"""Rectified-flow training math (time sampling, interpolation, weights).

The port of ``chronoedit_tpu/core/rectified_flow.py``:

- train time ``u ~ U(min, max)`` or ``sigmoid(N(0, 1))`` ("logitnormal",
  the ChronoEdit default), drawn from an explicit ``torch.Generator``;
- ``u`` discretised onto the 1000-step FlowMatchEulerDiscrete grid with a
  flow shift; the discrete timestep value (sigma * 1000) is what the DiT
  consumes; index 0 is the noisiest step;
- interpolation ``x_t = sigma * noise + (1 - sigma) * data`` with velocity
  target ``noise - data``;
- loss weight: uniform, or the Gaussian "reweighting" bell over timesteps.

The grid and the reweighting table are host float64 numpy, as in JAX; the
lookups cast them to fp32 and copy them to the tensors' device without
waiting for it (``non_blocking``), so a train step runs under
``utils/sanitize.no_host_sync``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from chronoedit_tpu_torch.core.schedule import flow_shift


@dataclasses.dataclass(frozen=True)
class RectifiedFlowConfig:
    num_train_timesteps: int = 1000
    shift: float = 5.0
    train_time_distribution: str = "logitnormal"  # or "uniform"
    min_timestep_boundary: float = 0.0
    max_timestep_boundary: float = 1.0
    train_time_weight: str = "uniform"  # or "reweighting"

    def train_grid(self) -> tuple[np.ndarray, np.ndarray]:
        """(sigmas, timesteps), both (N,) descending, float64: base sigmas
        linspace(1, 1/N, N), then the flow shift."""
        n = self.num_train_timesteps
        sigmas = flow_shift(np.linspace(1.0, 1.0 / n, n), self.shift)
        return sigmas, sigmas * n

    def reweighting_table(self) -> np.ndarray:
        """Per-index loss weights for the 'reweighting' mode."""
        _, timesteps = self.train_grid()
        n = self.num_train_timesteps
        y = np.exp(-2.0 * ((timesteps - n / 2) / n) ** 2)
        y = y - y.min()
        return y * (n / y.sum())


def sample_train_time(generator: torch.Generator, batch_size: int,
                      cfg: RectifiedFlowConfig) -> torch.Tensor:
    """u in [0, 1], (batch_size,) fp32 on the generator's device."""
    dev = generator.device
    if cfg.train_time_distribution == "uniform":
        span = cfg.max_timestep_boundary - cfg.min_timestep_boundary
        u = torch.rand((batch_size,), generator=generator, device=dev)
        return u * span + cfg.min_timestep_boundary
    if cfg.train_time_distribution == "logitnormal":
        return torch.sigmoid(torch.randn((batch_size,), generator=generator, device=dev))
    raise NotImplementedError(cfg.train_time_distribution)


def _on(table: np.ndarray, device) -> torch.Tensor:
    """A host table as fp32 on ``device``, copied without a host wait."""
    return torch.as_tensor(table, dtype=torch.float32).to(device, non_blocking=True)


def discretize_time(u: torch.Tensor, cfg: RectifiedFlowConfig
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """u in [0, 1] -> (timesteps, sigmas) fp32 on the shifted train grid,
    by ``floor(u * N)`` and a lookup."""
    sigmas, timesteps = cfg.train_grid()
    n = cfg.num_train_timesteps
    idx = torch.clamp((u.float() * n).to(torch.int32), 0, n - 1).long()
    t = _on(timesteps, u.device)[idx]
    s = _on(sigmas, u.device)[idx]
    return t, s


def get_interpolation(noise: torch.Tensor, data: torch.Tensor, sigmas: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """x_t and its velocity target. ``sigmas`` (B,) broadcasts over every
    other axis; (B, T) hits the frame axis 2 of (B, C, T, H, W)."""
    if sigmas.dim() == 1:
        shaped = sigmas.reshape(sigmas.shape + (1,) * (data.dim() - 1))
    elif sigmas.dim() == 2:
        shaped = sigmas[:, None, :, None, None]
    else:
        raise ValueError(f"sigmas must be (B,) or (B,T), got {tuple(sigmas.shape)}")
    shaped = shaped.to(data.dtype)
    return noise * shaped + data * (1.0 - shaped), noise - data


def train_time_weight(timesteps: torch.Tensor, cfg: RectifiedFlowConfig) -> torch.Tensor:
    """Per-sample loss weights for the sampled timesteps."""
    if cfg.train_time_weight == "uniform":
        return torch.ones_like(timesteps)
    if cfg.train_time_weight == "reweighting":
        dev = timesteps.device
        table = _on(cfg.reweighting_table(), dev)
        grid = _on(cfg.train_grid()[1], dev)
        idx = torch.argmin((grid[None, :] - timesteps.reshape(-1, 1)).abs(), dim=1)
        return table[idx].reshape(timesteps.shape)
    raise NotImplementedError(cfg.train_time_weight)


def x0_from_velocity(x_t: torch.Tensor, velocity: torch.Tensor,
                     sigmas: torch.Tensor) -> torch.Tensor:
    """The x0 prediction from a velocity prediction, fp32."""
    shaped = sigmas.reshape(sigmas.shape + (1,) * (x_t.dim() - sigmas.dim()))
    return x_t.float() - shaped * velocity.float()
