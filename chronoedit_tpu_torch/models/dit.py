"""Wan-style diffusion transformer (ChronoEdit-14B backbone), PyTorch.

The single-device forward of ``chronoedit_tpu/models/dit.py``:

- patch embed as reshape + linear, feature order (c, kt, kh, kw);
- N blocks of AdaLN-zero 6-way modulation from a per-block
  ``scale_shift_table`` plus the shared time projection; self-attention
  with temporal-skip 3D RoPE and qk RMSNorm across heads; I2V
  cross-attention over the text tokens plus a CLIP image branch, summed;
  gelu-tanh FFN;
- fp32 norms, modulation and gated residuals on a bf16 stream.

The blocks are an ``nn.ModuleList`` walked by a Python loop. Timesteps are
per latent frame, (B, T). The main path's kernels: K2 (LayerNorm +
modulate), K3 (gated residual), K4 (RMSNorm, on every q and k including
the text and image keys) and K1 (attention), through the wrappers in
``ops/``; in training, K6/K7 (attention's backward) through the same
wrappers' autograd Functions. Quantized serving (``ops/quant.py``,
``ChronoEditPipeline.quantize``) swaps block projections for int8/int4
leaves that ``layers.linear`` dispatches on (K8 for w4a16), and
``attn_qk_int8`` sends long self-attention to the int8-score forward (K9);
cross-attention never takes it, as in JAX.

Training: gradients flow to every parameter that requires one (full
fine-tuning) and to LoRA adapters when ``dit_forward`` is given them (their
block's targets are merged inside the block, see ``models/lora.py``).
``DiTConfig.remat = "full"`` recomputes blocks in the backward, as JAX's
``jax.checkpoint`` does: only each block's inputs stay alive between the
forward and the backward. (JAX's ``"matmul_only"`` policy is not ported: no
path of the port sets it.)
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from chronoedit_tpu_torch.core.rope import (
    Rope3DSpec, apply_rope, rope_3d_tables, temporal_skip_rope_tables)
from chronoedit_tpu_torch.models import lora as lora_lib
from chronoedit_tpu_torch.ops import layers as L
from chronoedit_tpu_torch.ops.attention import dot_product_attention
from chronoedit_tpu_torch.ops.fused_norms import (
    gated_residual, layer_norm_modulate, rms_norm_fused)


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """Static DiT hyperparameters; defaults are the 14B model (patch (1,2,2),
    40 heads x 128, in 36 channels, out 16, text 4096, freq 256, ffn 13824,
    40 layers, image_dim 1280 with 257 CLIP tokens)."""

    patch_size: tuple[int, int, int] = (1, 2, 2)
    num_heads: int = 40
    head_dim: int = 128
    in_channels: int = 36
    out_channels: int = 16
    text_dim: int = 4096
    freq_dim: int = 256
    ffn_dim: int = 13824
    num_layers: int = 40
    image_dim: int | None = 1280  # None => t2v (no image cross-attn branch)
    image_tokens: int = 257
    eps: float = 1e-6
    cross_attn_norm: bool = True
    temporal_skip: bool = True
    rope: Rope3DSpec = Rope3DSpec()
    dtype: torch.dtype = torch.bfloat16  # compute / stream dtype
    param_dtype: torch.dtype = torch.float32
    remat: str = "none"  # "none" | "full", as the JAX DiT
    # int8 q.k scores in self-attention (serving only, forward only; applies
    # past JAX's resident KV length: ops/flash_attention.uses_int8_scores)
    attn_qk_int8: bool = False

    @property
    def dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def patch_dim(self) -> int:
        return self.in_channels * math.prod(self.patch_size)


# ================================================================= modules

class SelfAttention(nn.Module):
    def __init__(self, cfg: DiTConfig, **kw):
        super().__init__()
        dim = cfg.dim
        self.q, self.k, self.v, self.o = (L.Linear(dim, dim, **kw) for _ in range(4))
        self.q_norm = L.RMSNorm(dim, **kw)
        self.k_norm = L.RMSNorm(dim, **kw)


class CrossAttention(nn.Module):
    def __init__(self, cfg: DiTConfig, **kw):
        super().__init__()
        dim = cfg.dim
        self.q, self.k, self.v, self.o = (L.Linear(dim, dim, **kw) for _ in range(4))
        self.q_norm = L.RMSNorm(dim, **kw)
        self.k_norm = L.RMSNorm(dim, **kw)
        if cfg.image_dim is not None:
            self.k_img = L.Linear(dim, dim, **kw)
            self.v_img = L.Linear(dim, dim, **kw)
            self.k_img_norm = L.RMSNorm(dim, **kw)


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig, *, device, dtype, generator):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.scale_shift_table = L.empty_param((6, cfg.dim), device, dtype)
        if generator is not None:
            with torch.no_grad():
                self.scale_shift_table.normal_(0.0, 1.0 / math.sqrt(cfg.dim),
                                               generator=generator)
        self.self_attn = SelfAttention(cfg, **kw)
        self.cross_attn = CrossAttention(cfg, **kw)
        self.ffn = nn.ModuleDict(dict(fc1=L.Linear(cfg.dim, cfg.ffn_dim, **kw),
                                      fc2=L.Linear(cfg.ffn_dim, cfg.dim, **kw)))
        if cfg.cross_attn_norm:
            self.norm2 = L.LayerNorm(cfg.dim, **kw)


class DiT(nn.Module):
    """Parameters of the DiT, named as in the JAX parameter tree."""

    def __init__(self, cfg: DiTConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        dim = cfg.dim
        kw = dict(device=device, dtype=cfg.param_dtype, generator=generator)
        self.patch_embed = L.Linear(cfg.patch_dim, dim, **kw)
        self.time_embed = nn.ModuleDict(dict(
            fc1=L.Linear(cfg.freq_dim, dim, std=0.02, **kw),
            fc2=L.Linear(dim, dim, std=0.02, **kw)))
        self.time_proj = L.Linear(dim, 6 * dim, **kw)
        self.text_embed = nn.ModuleDict(dict(
            fc1=L.Linear(cfg.text_dim, dim, std=0.02, **kw),
            fc2=L.Linear(dim, dim, std=0.02, **kw)))
        out_dim = cfg.out_channels * math.prod(cfg.patch_size)
        self.head = nn.ModuleDict(dict(proj=L.Linear(dim, out_dim, zero=True, **kw)))
        self.head.scale_shift_table = L.empty_param((2, dim), device, cfg.param_dtype)
        if generator is not None:
            with torch.no_grad():
                self.head.scale_shift_table.normal_(0.0, 1.0 / math.sqrt(dim),
                                                    generator=generator)
        if cfg.image_dim is not None:
            self.img_embed = nn.ModuleDict(dict(
                norm1=L.LayerNorm(cfg.image_dim, **kw),
                fc1=L.Linear(cfg.image_dim, cfg.image_dim, **kw),
                fc2=L.Linear(cfg.image_dim, dim, **kw),
                norm2=L.LayerNorm(dim, **kw)))
        self.blocks = nn.ModuleList(
            DiTBlock(cfg, device=device, dtype=cfg.param_dtype, generator=generator)
            for _ in range(cfg.num_layers))


def init_dit_params(cfg: DiTConfig, generator: torch.Generator,
                    device=None) -> DiT:
    """A DiT with random weights drawn from ``generator`` directly in
    ``cfg.param_dtype`` on ``device``. The distributions follow the JAX
    ``init_dit_params``: xavier-uniform projections, N(0, 0.02) time/text
    embedders, N(0, 1/dim) modulation tables, zero output projection."""
    return DiT(cfg, device=device, generator=generator)


# ================================================================= pieces

def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.reshape(b, s, h * d)


def _lin(p: L.Linear, x, weights: dict | None):
    return L.linear(p, x, None if weights is None else weights.get(p))


def _self_attention(p: SelfAttention, x, rope_cos, rope_sin, cfg: DiTConfig, weights):
    q = rms_norm_fused(p.q_norm, _lin(p.q, x, weights), cfg.eps)
    k = rms_norm_fused(p.k_norm, _lin(p.k, x, weights), cfg.eps)
    v = _lin(p.v, x, weights)
    q, k, v = (_split_heads(t, cfg.num_heads) for t in (q, k, v))
    cos, sin = rope_cos[:, None, :], rope_sin[:, None, :]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = dot_product_attention(q, k, v, qk_int8=cfg.attn_qk_int8)
    return _lin(p.o, _merge_heads(out), weights)


def _cross_attention(p: CrossAttention, x, text_ctx, img_ctx, cfg: DiTConfig, weights):
    """Text branch + image branch, summed."""
    h = cfg.num_heads
    q = _split_heads(rms_norm_fused(p.q_norm, _lin(p.q, x, weights), cfg.eps), h)
    k = rms_norm_fused(p.k_norm, _lin(p.k, text_ctx, weights), cfg.eps)
    v = _lin(p.v, text_ctx, weights)
    out = dot_product_attention(q, _split_heads(k, h), _split_heads(v, h))
    if img_ctx is not None:
        k_img = rms_norm_fused(p.k_img_norm, _lin(p.k_img, img_ctx, weights), cfg.eps)
        v_img = _lin(p.v_img, img_ctx, weights)
        out = out + dot_product_attention(q, _split_heads(k_img, h),
                                          _split_heads(v_img, h))
    return _lin(p.o, _merge_heads(out), weights)


def dit_block(p: DiTBlock, x, text_ctx, img_ctx, e, rope_cos, rope_sin, hw: int,
              cfg: DiTConfig, weights: dict | None = None) -> torch.Tensor:
    """One transformer block. x (B, S, dim) stream; e (B, T, 6, dim) fp32
    time projection; hw tokens per latent frame; ``weights`` maps a linear
    layer to the weight that stands in for its own (LoRA-merged)."""
    mods = e + p.scale_shift_table.float()[None, None]
    shift_msa, scale_msa, gate_msa, c_shift, c_scale, c_gate = (
        mods[:, :, i].contiguous() for i in range(6))

    norm_x = layer_norm_modulate(x, scale_msa, shift_msa, hw, cfg.eps)
    attn = _self_attention(p.self_attn, norm_x, rope_cos, rope_sin, cfg, weights)
    x = gated_residual(x, attn, gate_msa, hw)

    # cross-attention: affine fp32 LayerNorm, plain residual add
    norm2 = getattr(p, "norm2", None)
    norm_x = L.layer_norm(norm2, x, cfg.eps, out_dtype=x.dtype)
    x = x + _cross_attention(p.cross_attn, norm_x, text_ctx, img_ctx, cfg, weights)

    norm_x = layer_norm_modulate(x, c_scale, c_shift, hw, cfg.eps)
    ff = _lin(p.ffn.fc2, L.gelu_tanh(_lin(p.ffn.fc1, norm_x, weights)), weights)
    return gated_residual(x, ff, c_gate, hw)


def _lora_block(p: DiTBlock, adapters, scaling: float, x, text_ctx, img_ctx, e,
                rope_cos, rope_sin, hw: int, cfg: DiTConfig) -> torch.Tensor:
    """A block with its LoRA targets merged first (inside whatever
    checkpoint wraps it, so merged weights live one block at a time)."""
    weights = None if adapters is None else lora_lib.merged_weights(p, adapters, scaling)
    return dit_block(p, x, text_ctx, img_ctx, e, rope_cos, rope_sin, hw, cfg, weights)


def _run_block(cfg: DiTConfig, *args) -> torch.Tensor:
    """``_lora_block(*args)`` under ``cfg.remat`` when autograd records."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return _lora_block(*args)
    if cfg.remat == "full":
        return ckpt.checkpoint(_lora_block, *args, use_reentrant=False,
                               preserve_rng_state=False)
    raise ValueError(f"unknown remat mode {cfg.remat!r}")


# ================================================================= forward

def _patchify(x: torch.Tensor, cfg: DiTConfig):
    """(B, C, T, H, W) -> (B, S, C*pt*ph*pw) tokens, feature order
    (c, kt, kh, kw), plus the post-patch grid."""
    pt, ph, pw = cfg.patch_size
    b, c, t, h, w = x.shape
    gt, gh, gw = t // pt, h // ph, w // pw
    x = x.reshape(b, c, gt, pt, gh, ph, gw, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, gt * gh * gw, c * pt * ph * pw), (gt, gh, gw)


def _unpatchify(tokens: torch.Tensor, grid, cfg: DiTConfig) -> torch.Tensor:
    """(B, S, pt*ph*pw*out) -> (B, out, T, H, W), feature order (pt, ph, pw, c)."""
    pt, ph, pw = cfg.patch_size
    gt, gh, gw = grid
    b = tokens.shape[0]
    x = tokens.reshape(b, gt, gh, gw, pt, ph, pw, cfg.out_channels)
    x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, cfg.out_channels, gt * pt, gh * ph, gw * pw)


def _condition_embeddings(m: DiT, cfg: DiTConfig, timesteps, text_emb, image_emb):
    """Returns (temb (B,T,dim) fp32, t_proj (B,T,6,dim) fp32, text_ctx, img_ctx)."""
    sin_emb = L.sinusoidal_timestep_embedding(timesteps, cfg.freq_dim)
    te = m.time_embed
    temb = L.linear(te.fc2, F.silu(L.linear(te.fc1, sin_emb.float())))
    # the reference casts temb to the stream dtype before time_proj and the
    # blocks upcast again: kept for parity
    t_proj = L.linear(m.time_proj, F.silu(temb.to(cfg.dtype)))
    t_proj = t_proj.float().reshape(*temb.shape[:-1], 6, cfg.dim)

    tx = m.text_embed
    text_ctx = L.linear(tx.fc2, L.gelu_tanh(L.linear(tx.fc1, text_emb.to(cfg.dtype))))

    img_ctx = None
    if image_emb is not None and cfg.image_dim is not None:
        ie = m.img_embed
        # fp32 LayerNorm (eps 1e-5) -> linear -> exact GELU -> linear -> norm
        h = L.layer_norm(ie.norm1, image_emb, eps=1e-5, out_dtype=cfg.dtype)
        h = L.linear(ie.fc2, F.gelu(L.linear(ie.fc1, h)))
        img_ctx = L.layer_norm(ie.norm2, h, eps=1e-5, out_dtype=cfg.dtype)
    return temb.float(), t_proj, text_ctx, img_ctx


def dit_forward(model: DiT, x: torch.Tensor, timesteps: torch.Tensor,
                text_emb: torch.Tensor, image_emb: torch.Tensor | None = None,
                layer_mask=None, lora: lora_lib.LoRA | None = None,
                cache_blocks: tuple[int, int] | None = None,
                cache: torch.Tensor | None = None, cache_refresh: bool = True):
    """Velocity prediction.

    Args:
      x: (B, C_in, T, H, W) noisy latents plus condition channels.
      timesteps: (B,) shared or (B, T) per latent frame, in [0, 1000).
      text_emb: (B, L, text_dim); image_emb: (B, 257, image_dim) or None.
      layer_mask: optional (num_layers,) 0/1 values on the host (a sequence;
        a tensor is read to the host once); 0 skips a block (skip-layer
        guidance).
      lora: optional adapters, merged block by block as
        ``W + (alpha / r) * a @ b``.
      cache_blocks, cache, cache_refresh: the Δ-DiT step cache
        (arXiv:2406.01125). Blocks [a, b) contribute a token delta that
        changes slowly across solver steps. With ``cache_refresh`` (a host
        bool) every block runs and the sum of blocks [a, b)'s deltas
        ``out - in``, accumulated block by block in the stream dtype, is
        the new cache; otherwise blocks [a, b) are skipped and ``cache``
        (zeros when None) is added once before block a. Returns ``(out,
        new_cache)`` when ``cache_blocks`` is set. Exact when every step
        refreshes.
    Returns:
      (B, C_out, T, H, W) in cfg.dtype (and the cache when active).
    """
    cfg = model.cfg
    b = x.shape[0]
    if isinstance(layer_mask, torch.Tensor):
        layer_mask = layer_mask.tolist()
    if cache_blocks is not None:
        if layer_mask is not None:
            raise ValueError("cache_blocks is incompatible with SLG layer masks")
        lo, hi = cache_blocks
        if not 0 <= lo <= hi <= cfg.num_layers:
            raise ValueError(f"cache_blocks {cache_blocks} out of range")
    tokens, grid = _patchify(x.to(cfg.dtype), cfg)
    gt, gh, gw = grid
    hw = gh * gw
    tokens = L.linear(model.patch_embed, tokens)
    if cache_blocks is not None and not cache_refresh and cache is None:
        cache = torch.zeros_like(tokens)

    if timesteps.dim() == 1:
        timesteps = timesteps[:, None].expand(b, gt)
    temb, t_proj, text_ctx, img_ctx = _condition_embeddings(
        model, cfg, timesteps, text_emb, image_emb)

    tables = temporal_skip_rope_tables if cfg.temporal_skip else rope_3d_tables
    cos, sin = tables(cfg.rope, gt, gh, gw, device=x.device)

    delta = None
    for i, blk in enumerate(model.blocks):
        if layer_mask is not None and float(layer_mask[i]) <= 0.5:
            continue
        cached = cache_blocks is not None and lo <= i < hi
        if cache_blocks is not None and i == lo and not cache_refresh:
            tokens = tokens + cache
        if cached and not cache_refresh:
            continue
        adapters = None if lora is None else lora.blocks[i]
        scaling = 0.0 if lora is None else lora.cfg.scaling
        out = _run_block(cfg, blk, adapters, scaling, tokens, text_ctx, img_ctx,
                         t_proj, cos, sin, hw, cfg)
        if cached:
            delta = out - tokens if delta is None else delta + (out - tokens)
        tokens = out

    head = model.head
    mods = head.scale_shift_table.float()[None, None] + temb[:, :, None, :]
    shift, scale = mods[:, :, 0].contiguous(), mods[:, :, 1].contiguous()
    normed = layer_norm_modulate(tokens, scale, shift, hw, cfg.eps)
    out = _unpatchify(L.linear(head.proj, normed), grid, cfg)
    if cache_blocks is None:
        return out
    if not cache_refresh:
        return out, cache
    return out, torch.zeros_like(tokens) if delta is None else delta
