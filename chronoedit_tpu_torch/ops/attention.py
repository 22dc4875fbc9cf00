"""Attention entry point, (B, S, H, D) layout.

Every call goes through the differentiable :class:`FlashAttention`
Function: on CUDA tensors its forward is the flash kernel (K1/K5) and its
backward K6/K7, all built for head dim 128 only (any other head dim
raises; the text and image encoders, whose head dims differ, come with a
later port); on CPU tensors the same Function runs the plain fp32 twins. With
``qk_int8`` the int8-score forward (K9) runs instead where the KV is long.
"""

from __future__ import annotations

import torch

from chronoedit_tpu_torch.ops import flash_attention as fa


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float | None = None, qk_int8: bool = False) -> torch.Tensor:
    """Full bidirectional attention; q (B, Sq, H, D), k/v (B, Sk, H, D);
    ``scale`` defaults to D**-0.5. ``qk_int8`` asks for int8 scores
    (:func:`~ops.flash_attention.flash_attention_qk_int8`, forward only),
    which apply past JAX's resident-KV length and on either device: JAX
    honours the flag only on a TPU."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if qk_int8:
        return fa.flash_attention_qk_int8(q, k, v, scale)
    return fa.flash_attention(q, k, v, scale)
