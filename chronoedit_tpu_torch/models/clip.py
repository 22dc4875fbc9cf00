"""CLIP ViT-H/14 vision tower (the I2V image conditioner), PyTorch.

The port of ``chronoedit_tpu/models/clip.py``: image 224, patch 14 -> 256
patches + CLS = 257 tokens, width 1,280, 16 heads of 80, 32 pre-LN blocks
(exact-GELU MLP, fused qkv), a pre-norm after the positional embedding,
and the I2V path's **penultimate** features: the first 31 blocks and no
final norm.

Arithmetic kept from JAX:

- ``preprocess`` resizes with an antialiased bicubic (Keys a = -0.5),
  which is what ``jax.image.resize`` does when it downsamples
  (``F.interpolate(..., antialias=True)``; without antialiasing a 720p
  frame lands far from JAX's pixels);
- the linear weights and biases and the class and position embeddings
  act in the stream dtype (JAX casts them at use), the LayerNorms' scale
  and bias in fp32 (JAX keeps them at full precision): the parameters are
  stored so, the norms in fp32 whatever ``param_dtype`` is. The reference
  file is fp16; its values are exact in fp32 and round once to bf16.

Attention has head dim 80, which no kernel takes: ``ops/attention.py``
sends it to PyTorch's SDPA on the card, as JAX sends it to XLA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from chronoedit_tpu_torch.models import weights as w
from chronoedit_tpu_torch.ops import layers as L
from chronoedit_tpu_torch.ops.attention import dot_product_attention
from chronoedit_tpu_torch.ops.layers import empty_param

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    mlp_ratio: int = 4
    num_heads: int = 16
    num_layers: int = 32
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # linears and embeddings; the LayerNorms are always fp32
    param_dtype: torch.dtype = torch.bfloat16

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_tokens(self) -> int:
        return self.num_patches + 1  # + CLS


class CLIPBlock(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device, generator):
        super().__init__()
        d, hidden = cfg.dim, cfg.dim * cfg.mlp_ratio
        kw = dict(device=device, dtype=cfg.param_dtype, generator=generator)
        norm = dict(device=device, dtype=torch.float32, generator=generator)
        self.norm1 = L.LayerNorm(d, **norm)
        self.attn = nn.ModuleDict(dict(qkv=L.Linear(d, 3 * d, **kw), proj=L.Linear(d, d, **kw)))
        self.norm2 = L.LayerNorm(d, **norm)
        self.mlp = nn.ModuleDict(dict(fc1=L.Linear(d, hidden, **kw), fc2=L.Linear(hidden, d, **kw)))


class CLIPVision(nn.Module):
    """The tower's parameters, named as in the JAX parameter tree."""

    def __init__(self, cfg: CLIPVisionConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        d, pd = cfg.dim, cfg.param_dtype
        # Conv2d(3, d, k=p, s=p, bias=False) as patch reshape + matmul
        self.patch_embed = L.Linear(3 * cfg.patch_size ** 2, d, device=device, dtype=pd,
                                    generator=generator, std=0.02, bias=False)
        self.cls_embedding = empty_param((1, 1, d), device, pd)
        self.pos_embedding = empty_param((1, cfg.num_tokens, d), device, pd)
        if generator is not None:
            with torch.no_grad():
                self.cls_embedding.normal_(0.0, d ** -0.5, generator=generator)
                self.pos_embedding.normal_(0.0, d ** -0.5, generator=generator)
        norm = dict(device=device, dtype=torch.float32, generator=generator)
        self.pre_norm = L.LayerNorm(d, **norm)
        self.blocks = nn.ModuleList(CLIPBlock(cfg, device, generator)
                                    for _ in range(cfg.num_layers))
        self.post_norm = L.LayerNorm(d, **norm)


def init_clip_vision_params(cfg: CLIPVisionConfig, generator: torch.Generator,
                            device=None) -> CLIPVision:
    """A tower with random weights drawn from ``generator`` on ``device``
    with JAX's distributions: xavier-uniform linears with zero bias, an
    N(0, 0.02) patch embedding, N(0, 1/dim) class and position
    embeddings, unit LayerNorms."""
    return CLIPVision(cfg, device=device, generator=generator)


def _vit_block(p: CLIPBlock, x: torch.Tensor, cfg: CLIPVisionConfig) -> torch.Tensor:
    b, s, _ = x.shape
    h = L.layer_norm(p.norm1, x, cfg.norm_eps, out_dtype=x.dtype)
    q, k, v = (t.reshape(b, s, cfg.num_heads, -1)
               for t in L.linear(p.attn.qkv, h).chunk(3, dim=-1))
    attn = dot_product_attention(q.contiguous(), k.contiguous(), v.contiguous())
    x = x + L.linear(p.attn.proj, attn.reshape(b, s, cfg.dim))
    h = L.layer_norm(p.norm2, x, cfg.norm_eps, out_dtype=x.dtype)
    return x + L.linear(p.mlp.fc2, F.gelu(L.linear(p.mlp.fc1, h)))


def clip_vision_forward(model: CLIPVision, pixels: torch.Tensor,
                        penultimate: bool = True) -> torch.Tensor:
    """Normalized pixels (B, 3, 224, 224) -> (B, 257, dim) features.
    ``penultimate`` stops before the last block with no final norm (the
    I2V conditioning path)."""
    cfg = model.cfg
    b, c, hh, ww = pixels.shape
    p = cfg.patch_size
    x = pixels.to(model.patch_embed.weight.device, cfg.dtype)
    # (B, 3, H, W) -> (B, N, 3*p*p) patches, feature order (c, ph, pw) as
    # the Conv2d weight's
    x = x.reshape(b, c, hh // p, p, ww // p, p).permute(0, 2, 4, 1, 3, 5)
    x = L.linear(model.patch_embed, x.reshape(b, cfg.num_patches, c * p * p))
    cls = model.cls_embedding.to(x.dtype).expand(b, 1, cfg.dim)
    x = torch.cat([cls, x], dim=1) + model.pos_embedding.to(x.dtype)
    x = L.layer_norm(model.pre_norm, x, cfg.norm_eps, out_dtype=x.dtype)
    n_blocks = cfg.num_layers - 1 if penultimate else cfg.num_layers
    for blk in list(model.blocks)[:n_blocks]:
        x = _vit_block(blk, x, cfg)
    if not penultimate:
        x = L.layer_norm(model.post_norm, x, cfg.norm_eps, out_dtype=x.dtype)
    return x


def preprocess(images: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """[-1, 1] images (B, 3, H, W) -> CLIP-normalized (B, 3, size, size) in
    fp32: bicubic with half-pixel centres, antialiased when it shrinks, as
    ``jax.image.resize``."""
    x = F.interpolate(images.float(), size=(image_size, image_size), mode="bicubic",
                      align_corners=False, antialias=True)
    x = x * 0.5 + 0.5
    mean = torch.as_tensor(CLIP_MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.as_tensor(CLIP_STD, device=x.device).reshape(1, 3, 1, 1)
    return (x - mean) / std


class CLIPImageEncoder:
    """[-1, 1] image -> 257-token penultimate features, on the tower's
    device."""

    def __init__(self, model: CLIPVision):
        self.model = model
        self.cfg = model.cfg

    @torch.inference_mode()
    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        images = images.to(self.model.patch_embed.weight.device)
        return clip_vision_forward(self.model, preprocess(images, self.cfg.image_size))


# ------------------------------------------------------------- weights

def _ln(ref: str, port: str) -> dict[str, str]:
    return {f"{ref}.weight": f"{port}.scale", f"{ref}.bias": f"{port}.bias"}


def _lin(ref: str, port: str) -> dict[str, str]:
    return {f"{ref}.weight": f"{port}.weight", f"{ref}.bias": f"{port}.bias"}


# the open-clip xlm-roberta ViT-H .pth's visual tower (after its
# ``visual.`` prefix) -> CLIPVision parameter name; "{i}" is the block
REFERENCE_NAMES = {
    "patch_embedding.weight": "patch_embed.weight",
    "cls_embedding": "cls_embedding",
    "pos_embedding": "pos_embedding",
    **_ln("pre_norm", "pre_norm"),
    **_ln("post_norm", "post_norm"),
}
REFERENCE_BLOCK_NAMES = {
    **_ln("transformer.{i}.norm1", "blocks.{i}.norm1"),
    **_lin("transformer.{i}.attn.to_qkv", "blocks.{i}.attn.qkv"),
    **_lin("transformer.{i}.attn.proj", "blocks.{i}.attn.proj"),
    **_ln("transformer.{i}.norm2", "blocks.{i}.norm2"),
    **_lin("transformer.{i}.mlp.0", "blocks.{i}.mlp.fc1"),
    **_lin("transformer.{i}.mlp.2", "blocks.{i}.mlp.fc2"),
}


def reference_names(cfg: CLIPVisionConfig) -> dict[str, str]:
    """{reference name (with ``visual.``): CLIPVision parameter name} for
    ``cfg``'s blocks."""
    names = dict(REFERENCE_NAMES)
    for i in range(cfg.num_layers):
        names.update({r.format(i=i): p.format(i=i) for r, p in REFERENCE_BLOCK_NAMES.items()})
    return {f"visual.{r}": p for r, p in names.items()}


def convert_clip_vision_checkpoint(sd: w.StateDict, cfg: CLIPVisionConfig | None = None,
                                   device=None) -> CLIPVision:
    """Reference open-clip xlm-roberta ViT-H .pth -> the vision tower on
    ``device``; the text tower's keys (and the visual head) are ignored, as
    JAX ignores them."""
    cfg = cfg or CLIPVisionConfig()
    return w.fill_module(CLIPVision(cfg, device=device), sd, reference_names(cfg),
                         strict=False)
