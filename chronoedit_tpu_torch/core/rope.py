"""3D rotary position embeddings for the Wan DiT, with temporal-skip RoPE.

Same tables and rotation as ``chronoedit_tpu/core/rope.py``:

- the head dim splits into (t, h, w) bands of 44/42/42 real dims for
  head_dim 128 (``h = w = 2 * (head_dim // 6)``);
- angles are ``pos * theta ** (-2i/dim)``, computed on the host in float64;
- channel pairs (2i, 2i+1) are interleaved complex numbers, rotated in fp32;
- temporal-skip mode gives a 2-frame latent the positions
  ``(0, temporal_skip_len - 1)``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Rope3DSpec:
    """Static description of a 3D RoPE table."""

    head_dim: int = 128
    theta: float = 10_000.0
    temporal_skip_len: int = 8

    @property
    def band_dims(self) -> tuple[int, int, int]:
        """(t, h, w) real sub-band dims."""
        h_dim = w_dim = 2 * (self.head_dim // 6)
        t_dim = self.head_dim - h_dim - w_dim
        return (t_dim, h_dim, w_dim)


def _band_angles(positions: np.ndarray, dim: int, theta: float) -> np.ndarray:
    """outer(pos, theta**(-2i/dim)) in float64, shape (len(pos), dim // 2)."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    return np.outer(positions.astype(np.float64), freqs)


@functools.lru_cache(maxsize=32)
def _rope_3d_tables_np(spec: Rope3DSpec, t_positions: tuple[int, ...],
                       height: int, width: int) -> tuple[np.ndarray, np.ndarray]:
    """Host float64 (cos, sin), each (T*H*W, head_dim // 2)."""
    t_dim, h_dim, w_dim = spec.band_dims
    ang_t = _band_angles(np.asarray(t_positions), t_dim, spec.theta)
    ang_h = _band_angles(np.arange(height), h_dim, spec.theta)
    ang_w = _band_angles(np.arange(width), w_dim, spec.theta)
    t, h, w = len(t_positions), height, width
    ang = np.concatenate(
        [
            np.broadcast_to(ang_t[:, None, None, :], (t, h, w, t_dim // 2)),
            np.broadcast_to(ang_h[None, :, None, :], (t, h, w, h_dim // 2)),
            np.broadcast_to(ang_w[None, None, :, :], (t, h, w, w_dim // 2)),
        ],
        axis=-1,
    ).reshape(t * h * w, spec.head_dim // 2)
    return np.cos(ang), np.sin(ang)


def _to_device(tables, device) -> tuple[torch.Tensor, torch.Tensor]:
    cos, sin = tables
    return (torch.as_tensor(cos, dtype=torch.float32, device=device),
            torch.as_tensor(sin, dtype=torch.float32, device=device))


def rope_3d_tables(spec: Rope3DSpec, num_frames: int, height: int, width: int,
                   device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 (cos, sin) tables (S, head_dim // 2) for a plain video grid."""
    return _to_device(
        _rope_3d_tables_np(spec, tuple(range(num_frames)), height, width), device)


def temporal_skip_rope_tables(spec: Rope3DSpec, num_frames: int, height: int,
                              width: int, device=None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 tables with temporal-skip positions: a 2-frame grid sits at
    ``(0, temporal_skip_len - 1)``; other frame counts use the plain grid."""
    if num_frames == 2:
        t_positions = (0, spec.temporal_skip_len - 1)
    else:
        t_positions = tuple(range(num_frames))
    return _to_device(_rope_3d_tables_np(spec, t_positions, height, width), device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved channel pairs (2i, 2i+1) of ``x`` (..., S, D) by
    the (S, D // 2) tables, in fp32; returns x's dtype."""
    xf = x.float().unflatten(-1, (x.shape[-1] // 2, 2))
    a, b = xf[..., 0], xf[..., 1]
    out = torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1)
    return out.flatten(-2).to(x.dtype)
