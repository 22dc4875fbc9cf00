"""Attention entry point, (B, S, H, D) layout.

JAX chooses by head dim alone: its Pallas kernels take ``D % 128 == 0``,
any other head dim goes to XLA's attention. The port keeps that rule with
its own kernels, which are built for D = 128:

- a head dim that is a multiple of 128: the differentiable
  :class:`FlashAttention` Function; on CUDA tensors its forward is the flash
  kernel (K1/K5) and its backward K6/K7 (built for D = 128 only: any other
  multiple raises), on CPU tensors the plain fp32 twins at any head dim.
  With ``qk_int8`` the int8-score forward (K9) runs instead where the KV is
  long.
- any other head dim on CUDA tensors (CLIP's 80): PyTorch's
  ``scaled_dot_product_attention``, as JAX takes XLA's. No Pallas kernel
  exists for that shape.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from chronoedit_tpu_torch.ops import flash_attention as fa


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float | None = None, qk_int8: bool = False) -> torch.Tensor:
    """Full bidirectional attention; q (B, Sq, H, D), k/v (B, Sk, H, D);
    ``scale`` defaults to D**-0.5. ``qk_int8`` asks for int8 scores
    (:func:`~ops.flash_attention.flash_attention_qk_int8`, forward only),
    which apply past JAX's resident-KV length and on either device: JAX
    honours the flag only on a TPU. On the card at a head dim that is not a
    multiple of 128 there is no kernel, and ``qk_int8`` is ignored, as JAX
    ignores it off its kernels."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda and q.shape[-1] % 128 != 0:
        out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                             v.transpose(1, 2), scale=scale)
        return out.transpose(1, 2)
    if qk_int8:
        return fa.flash_attention_qk_int8(q, k, v, scale)
    return fa.flash_attention(q, k, v, scale)
