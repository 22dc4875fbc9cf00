"""Wan 2.1 causal-3D-conv video VAE (16-channel latents), PyTorch.

The full-sequence encode/decode of ``chronoedit_tpu/models/vae.py`` for the
5-frame edit clip: every temporal op is causal, so one pass over the whole
clip with left zero padding equals the reference's chunked streaming. The
two stride tricks of the streaming path are kept exactly:

- temporal downsample: the first frame bypasses the stride-2 kernel-3 conv;
- temporal upsample: frame 0 bypasses the doubling and is zero-masked out
  of later windows; the conv's 2C channels split into 2 frames, channel
  index = k*C + c for output frame 2*t + k.

Layout: (B, C, T, H, W) at the public functions, as in JAX, and inside too
(NCDHW, torch's Conv3d layout); the JAX code is channels-last inside.
Convolutions are ``F.conv3d``. The streaming and W-tiled paths of the JAX
module (reasoning mode) are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from chronoedit_tpu_torch.ops.layers import empty_param

# Wan 2.1 latent statistics (wan2pt1.py:697-732).
WAN_LATENT_MEAN = np.array([
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
], np.float32)
WAN_LATENT_STD = np.array([
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
], np.float32)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    dim: int = 96
    z_dim: int = 16
    dim_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_downsample: tuple[bool, ...] = (False, True, True)
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    @property
    def temporal_factor(self) -> int:
        return 2 ** sum(self.temporal_downsample)

    @property
    def spatial_factor(self) -> int:
        return 2 ** (len(self.dim_mult) - 1)

    def latent_frames(self, pixel_frames: int) -> int:
        return 1 + (pixel_frames - 1) // self.temporal_factor

    def pixel_frames(self, latent_frames: int) -> int:
        return (latent_frames - 1) * self.temporal_factor + 1


# ------------------------------------------------------------- parameters

class Conv(nn.Module):
    """3D conv weight (cout, cin, kt, kh, kw) and bias; U(+-1/sqrt(fan_in))
    init with zero bias (``zero=True``: all zero)."""

    def __init__(self, kt, kh, kw, cin, cout, *, device, dtype, generator,
                 zero: bool = False):
        super().__init__()
        self.weight = empty_param((cout, cin, kt, kh, kw), device, dtype)
        self.bias = empty_param((cout,), device, dtype)
        if generator is None:
            return
        with torch.no_grad():
            if zero:
                self.weight.zero_()
            else:
                limit = math.sqrt(1.0 / (kt * kh * kw * cin))
                self.weight.uniform_(-limit, limit, generator=generator)
            self.bias.zero_()


class RMS(nn.Module):
    def __init__(self, dim, *, device, dtype, generator):
        super().__init__()
        self.gamma = empty_param((dim,), device, dtype)
        if generator is not None:
            with torch.no_grad():
                self.gamma.fill_(1.0)


class ResBlock(nn.Module):
    def __init__(self, cin, cout, **kw):
        super().__init__()
        self.norm1 = RMS(cin, **kw)
        self.conv1 = Conv(3, 3, 3, cin, cout, **kw)
        self.norm2 = RMS(cout, **kw)
        self.conv2 = Conv(3, 3, 3, cout, cout, **kw)
        if cin != cout:
            self.shortcut = Conv(1, 1, 1, cin, cout, **kw)


class AttnBlock(nn.Module):
    def __init__(self, dim, **kw):
        super().__init__()
        self.norm = RMS(dim, **kw)
        self.qkv = Conv(1, 1, 1, dim, dim * 3, **kw)
        self.proj = Conv(1, 1, 1, dim, dim, zero=True, **kw)


class VAE(nn.Module):
    """Encoder + decoder parameters, named as in the JAX parameter tree."""

    def __init__(self, cfg: VAEConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=cfg.param_dtype, generator=generator)
        dims = [cfg.dim * m for m in (1,) + tuple(cfg.dim_mult)]

        stages = []
        for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
            blocks, c = [], cin
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResBlock(c, cout, **kw))
                c = cout
            stage = nn.ModuleDict(dict(blocks=nn.ModuleList(blocks)))
            if i != len(cfg.dim_mult) - 1:
                stage.down = Conv(1, 3, 3, cout, cout, **kw)
                if cfg.temporal_downsample[i]:
                    stage.time_down = Conv(3, 1, 1, cout, cout, **kw)
            stages.append(stage)
        mid = dims[-1]
        self.encoder = nn.ModuleDict(dict(
            conv_in=Conv(3, 3, 3, 3, dims[0], **kw),
            stages=nn.ModuleList(stages),
            mid=nn.ModuleDict(dict(res1=ResBlock(mid, mid, **kw), attn=AttnBlock(mid, **kw),
                                   res2=ResBlock(mid, mid, **kw))),
            head_norm=RMS(mid, **kw),
            head_conv=Conv(3, 3, 3, mid, cfg.z_dim * 2, **kw)))

        ddims = [cfg.dim * m for m in (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))]
        t_up = tuple(reversed(cfg.temporal_downsample))
        dstages = []
        for i, (cin, cout) in enumerate(zip(ddims[:-1], ddims[1:])):
            if i > 0:
                cin = cin // 2  # the previous upsample halved the channels
            blocks, c = [], cin
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResBlock(c, cout, **kw))
                c = cout
            stage = nn.ModuleDict(dict(blocks=nn.ModuleList(blocks)))
            if i != len(cfg.dim_mult) - 1:
                if t_up[i]:
                    stage.time_up = Conv(3, 1, 1, cout, cout * 2, **kw)
                stage.up = Conv(1, 3, 3, cout, cout // 2, **kw)
            dstages.append(stage)
        self.decoder = nn.ModuleDict(dict(
            conv_in=Conv(3, 3, 3, cfg.z_dim, ddims[0], **kw),
            mid=nn.ModuleDict(dict(res1=ResBlock(ddims[0], ddims[0], **kw),
                                   attn=AttnBlock(ddims[0], **kw),
                                   res2=ResBlock(ddims[0], ddims[0], **kw))),
            stages=nn.ModuleList(dstages),
            head_norm=RMS(ddims[-1], **kw),
            head_conv=Conv(3, 3, 3, ddims[-1], 3, **kw)))
        self.quant_conv = Conv(1, 1, 1, cfg.z_dim * 2, cfg.z_dim * 2, **kw)
        self.post_quant_conv = Conv(1, 1, 1, cfg.z_dim, cfg.z_dim, **kw)


def init_vae_params(cfg: VAEConfig, generator: torch.Generator,
                    device=None) -> VAE:
    """A VAE with random weights drawn from ``generator`` in
    ``cfg.param_dtype`` on ``device`` (the JAX ``init_vae_params``
    distributions)."""
    return VAE(cfg, device=device, generator=generator)


# ------------------------------------------------------------- primitives

def causal_conv3d(p: Conv, x: torch.Tensor, stride=(1, 1, 1),
                  time_pad: int | None = None) -> torch.Tensor:
    """3D conv with causal (left-only, zero) temporal padding, default
    ``2 * (kt // 2)``; ``time_pad=0`` for the no-pad stride convs."""
    kt, kh, kw = p.weight.shape[2:]
    tp = 2 * (kt // 2) if time_pad is None else time_pad
    if tp:
        x = F.pad(x, (0, 0, 0, 0, tp, 0))
    return F.conv3d(x, p.weight.to(x.dtype), p.bias.to(x.dtype), stride=stride,
                    padding=(0, kh // 2, kw // 2))


def _rms(p: RMS, x: torch.Tensor) -> torch.Tensor:
    """Channel L2 normalisation * sqrt(C) * gamma (F.normalize eps 1e-12)."""
    xf = x.float()
    norm = xf.square().sum(dim=1, keepdim=True).sqrt()
    y = xf / norm.clamp_min(1e-12) * math.sqrt(x.shape[1])
    return (y * p.gamma.float()[:, None, None, None]).to(x.dtype)


def _res_block(p: ResBlock, x: torch.Tensor) -> torch.Tensor:
    h = causal_conv3d(p.conv1, F.silu(_rms(p.norm1, x)))
    h = causal_conv3d(p.conv2, F.silu(_rms(p.norm2, h)))
    s = causal_conv3d(p.shortcut, x) if hasattr(p, "shortcut") else x
    return h + s


def _attn_block(p: AttnBlock, x: torch.Tensor) -> torch.Tensor:
    """Single-head per-frame spatial self-attention, fp32 logits and softmax."""
    b, c, t, h, w = x.shape
    qkv = causal_conv3d(p.qkv, _rms(p.norm, x))
    qkv = qkv.permute(0, 2, 3, 4, 1).reshape(b, t, h * w, 3 * c)
    q, k, v = qkv.chunk(3, dim=-1)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(c)
    weights = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.matmul(weights, v).reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)
    return causal_conv3d(p.proj, out) + x


def _spatial_down(p: Conv, x: torch.Tensor) -> torch.Tensor:
    """Zero pad right and bottom by one, then a 3x3 stride-2 conv."""
    x = F.pad(x, (0, 1, 0, 1))
    return F.conv3d(x, p.weight.to(x.dtype), p.bias.to(x.dtype), stride=(1, 2, 2))


def _temporal_down(p: Conv, x: torch.Tensor) -> torch.Tensor:
    """First frame identity; the rest through the stride-2 no-pad conv."""
    rest = causal_conv3d(p, x, stride=(2, 1, 1), time_pad=0)
    return torch.cat([x[:, :, :1], rest], dim=2)


def _spatial_up(p: Conv, x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample, then a 3x3 conv halving the channels."""
    x = F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
    return F.conv3d(x, p.weight.to(x.dtype), p.bias.to(x.dtype), padding=(0, 1, 1))


def _temporal_up(p: Conv, x: torch.Tensor) -> torch.Tensor:
    """Frame 0 identity; frames 1.. doubled by the 2C-channel causal conv
    with frame 0 zero-masked out of its windows."""
    b, c, t, h, w = x.shape
    masked = torch.cat([torch.zeros_like(x[:, :, :1]), x[:, :, 1:]], dim=2)
    y = causal_conv3d(p, masked)[:, :, 1:]  # (B, 2C, T-1, H, W)
    # channel k*C + c of input frame i -> channel c of output frame 2i + k
    y = y.reshape(b, 2, c, t - 1, h, w).permute(0, 2, 3, 1, 4, 5)
    y = y.reshape(b, c, 2 * (t - 1), h, w)
    return torch.cat([x[:, :, :1], y], dim=2)


def _encoder(p, x: torch.Tensor) -> torch.Tensor:
    h = causal_conv3d(p.conv_in, x)
    for stage in p.stages:
        for blk in stage.blocks:
            h = _res_block(blk, h)
        if hasattr(stage, "down"):
            h = _spatial_down(stage.down, h)
            if hasattr(stage, "time_down"):
                h = _temporal_down(stage.time_down, h)
    h = _res_block(p.mid.res1, h)
    h = _attn_block(p.mid.attn, h)
    h = _res_block(p.mid.res2, h)
    h = F.silu(_rms(p.head_norm, h))
    return causal_conv3d(p.head_conv, h)


def _decoder(p, z: torch.Tensor) -> torch.Tensor:
    h = causal_conv3d(p.conv_in, z)
    h = _res_block(p.mid.res1, h)
    h = _attn_block(p.mid.attn, h)
    h = _res_block(p.mid.res2, h)
    for stage in p.stages:
        for blk in stage.blocks:
            h = _res_block(blk, h)
        if hasattr(stage, "up"):
            if hasattr(stage, "time_up"):
                h = _temporal_up(stage.time_up, h)
            h = _spatial_up(stage.up, h)
    h = F.silu(_rms(p.head_norm, h))
    return causal_conv3d(p.head_conv, h)


def _latent_stats(cfg: VAEConfig, like: torch.Tensor):
    shape = (1, cfg.z_dim, 1, 1, 1)
    mean = torch.as_tensor(WAN_LATENT_MEAN, device=like.device).to(like.dtype)
    std = torch.as_tensor(WAN_LATENT_STD, device=like.device).to(like.dtype)
    return mean.reshape(shape), std.reshape(shape)


# ------------------------------------------------------------- public API

def vae_encode(vae: VAE, video: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Pixels in [-1, 1] (B, 3, T, H, W), T = 4k+1 -> latents
    (B, z_dim, 1+(T-1)//4, H/8, W/8), normalised when z_dim is 16.
    Only the mean of the moments is kept."""
    cfg = vae.cfg
    moments = causal_conv3d(vae.quant_conv, _encoder(vae.encoder, video.to(cfg.dtype)))
    mu = moments[:, : cfg.z_dim]
    if normalize and cfg.z_dim == WAN_LATENT_MEAN.size:
        mean, std = _latent_stats(cfg, mu)
        mu = (mu - mean) / std
    return mu


def vae_decode(vae: VAE, latents: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Latents -> pixels (B, 3, (Tl-1)*4+1, H*8, W*8)."""
    cfg = vae.cfg
    z = latents.to(cfg.dtype)
    if normalize and cfg.z_dim == WAN_LATENT_MEAN.size:
        mean, std = _latent_stats(cfg, z)
        z = z * std + mean
    z = causal_conv3d(vae.post_quant_conv, z)
    return _decoder(vae.decoder, z)
