"""Primitive layers: parameter containers and plain tensor functions.

Conventions follow ``chronoedit_tpu/ops/layers.py``: norms take their
statistics in fp32; a linear layer computes in its input's dtype. Weights
are stored the PyTorch way, ``weight`` (out, in). Parameters are made
uninitialised (``torch.empty``) directly in their dtype on their device and
filled from an explicit ``torch.Generator``: an fp32 copy of the 14B DiT
would not fit beside the bf16 one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def empty_param(shape, device, dtype) -> nn.Parameter:
    """An uninitialised, frozen parameter made directly in ``dtype`` on
    ``device``."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class Linear(nn.Module):
    """``y = x @ W.T + b`` in x's dtype (no ``b`` with ``bias=False``, as the
    encoders' bias-free projections). Init: xavier-uniform weight and zero
    bias (``linear_init``), or N(0, std) with ``std=`` (the embedders)."""

    def __init__(self, d_in: int, d_out: int, *, device=None, dtype=torch.float32,
                 generator: torch.Generator | None = None, std: float | None = None,
                 zero: bool = False, bias: bool = True):
        super().__init__()
        self.weight = empty_param((d_out, d_in), device, dtype)
        self.bias = empty_param((d_out,), device, dtype) if bias else None
        if generator is None:
            return
        with torch.no_grad():
            if zero:
                self.weight.zero_()
            elif std is not None:
                self.weight.normal_(0.0, std, generator=generator)
            else:
                limit = math.sqrt(6.0 / (d_in + d_out))
                self.weight.uniform_(-limit, limit, generator=generator)
            if self.bias is not None:
                self.bias.zero_()


def linear(p: nn.Module, x: torch.Tensor, weight: torch.Tensor | None = None,
           side: tuple[torch.Tensor, torch.Tensor] | None = None, bias: bool = True,
           group=None) -> torch.Tensor:
    """``x @ W.T + b`` in x's dtype; ``weight`` stands in for ``p.weight``
    (a LoRA-merged copy). A quantized leaf (``ops/quant.py``) runs its own
    product, as JAX dispatches on the leaf's keys. ``side = (a, b)`` adds
    the unmerged LoRA branch ``((x @ a) @ b)`` in fp32, cast to the
    output's dtype, after any product (QLoRA's composition over a
    quantized leaf; the adapter scaling is folded into b).
    ``bias=False`` leaves the bias out, and ``group`` takes a quantized
    leaf's per-token activation scale over that tensor group: a row-split
    layer's partial product, which the caller sums over the group before
    it adds the bias once."""
    if not isinstance(p, Linear):
        from chronoedit_tpu_torch.ops import quant

        if weight is not None:
            raise ValueError("a merged weight cannot stand in for a quantized layer")
        if isinstance(p, quant.QuantLinear8):
            y = quant.quantized_linear(p, x, bias, group)
        else:
            y = quant.quantized_linear_int4(p, x, bias, group)
    else:
        w = p.weight if weight is None else weight
        b = p.bias.to(x.dtype) if bias and p.bias is not None else None
        y = F.linear(x, w.to(x.dtype), b)
    if side is not None:
        a, b = side
        y = y + ((x.float() @ a.float()) @ b.float()).to(y.dtype)
    return y


class LayerNorm(nn.Module):
    """Affine LayerNorm parameters (``scale``, ``bias``); ones/zeros init."""

    def __init__(self, dim: int, *, device=None, dtype=torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.scale = empty_param((dim,), device, dtype)
        self.bias = empty_param((dim,), device, dtype)
        if generator is not None:
            with torch.no_grad():
                self.scale.fill_(1.0)
                self.bias.zero_()


class RMSNorm(nn.Module):
    """RMSNorm weight (``scale``); ones init."""

    def __init__(self, dim: int, *, device=None, dtype=torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.scale = empty_param((dim,), device, dtype)
        if generator is not None:
            with torch.no_grad():
                self.scale.fill_(1.0)


def layer_norm(p: LayerNorm | None, x: torch.Tensor, eps: float = 1e-6,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """fp32 LayerNorm, affine when ``p`` is given; fp32 out unless
    ``out_dtype`` is set."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if p is not None:
        y = y * p.scale.float() + p.bias.float()
    return y.to(out_dtype) if out_dtype is not None else y


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU (the DiT FFN and text-embedder activation)."""
    return F.gelu(x, approximate="tanh")


def sinusoidal_timestep_embedding(timesteps: torch.Tensor, dim: int,
                                  max_period: float = 10_000.0) -> torch.Tensor:
    """diffusers ``Timesteps`` embedding as Wan configures it (cos first,
    no frequency shift), (...,) -> (..., dim) fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / half)
    args = timesteps.float()[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
