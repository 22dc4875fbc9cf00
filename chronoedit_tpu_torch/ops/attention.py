"""Attention entry point, (B, S, H, D) layout.

CPU tensors take the plain fp32 twin. CUDA tensors take the flash kernel
(K1), which is built for head dim 128 only; any other head dim raises (the
text and image encoders, whose head dims differ, come with a later port).
"""

from __future__ import annotations

import torch

from chronoedit_tpu_torch.ops import flash_attention as fa


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float | None = None) -> torch.Tensor:
    """Full bidirectional attention; q (B, Sq, H, D), k/v (B, Sk, H, D);
    ``scale`` defaults to D**-0.5."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return fa.flash_attention(q, k, v, scale)
