"""Wan 2.1 causal-3D-conv video VAE (16-channel latents), PyTorch.

The encode/decode of ``chronoedit_tpu/models/vae.py``. Every temporal op is
causal and written once, over a chunk of frames with an explicit cache of
the last input frames of each conv (plain dicts, a Python loop over
chunks). The first chunk has no cache: the causal zero pad. So the whole
clip as one chunk is the full-sequence pass (the 5-frame edit clip), and
long clips (the 29-frame reasoning volume) stream 1+tfac pixel frames (or
one latent frame) at a time with peak memory of one chunk's features,
computing the same sums. The two stride tricks of the reference are kept
exactly:

- temporal downsample: the first frame bypasses the stride-2 kernel-3 conv;
- temporal upsample: frame 0 bypasses the doubling and is zero-masked out
  of later windows; the conv's 2C channels split into 2 frames, channel
  index = k*C + c for output frame 2*t + k.

W-tiling runs the purely
convolutional part (pre-mid encoder, post-mid decoder) on overlapping
W-slices whose halo covers its receptive field, and keeps the interiors;
the mid blocks' global attention runs untiled at the bottleneck scale.

Layout: (B, C, T, H, W) at the public functions, as in JAX, and inside too
(NCDHW, torch's Conv3d layout), so every cache slice is on dim 2; the JAX
code is channels-last inside. Convolutions are ``F.conv3d``.
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


def _spatial_up(p: Conv, x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample, then a 3x3 conv halving the channels."""
    x = F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
    return F.conv3d(x, p.weight.to(x.dtype), p.bias.to(x.dtype), padding=(0, 1, 1))


def _latent_stats(cfg: VAEConfig, like: torch.Tensor):
    shape = (1, cfg.z_dim, 1, 1, 1)
    mean = torch.as_tensor(WAN_LATENT_MEAN, device=like.device).to(like.dtype)
    std = torch.as_tensor(WAN_LATENT_STD, device=like.device).to(like.dtype)
    return mean.reshape(shape), std.reshape(shape)


# ------------------------------------------------------------- chunked ops
#
# Each ``*_stream`` function takes one chunk of frames and the cache its
# previous call returned (None on the first chunk: the causal zero pad) and
# returns (out, new cache). The whole clip as one chunk with no cache is the
# full-sequence pass. With ``keep`` the cached frames are copied out of the
# chunk's tensors, so that a chunk's features are freed once the next chunk
# starts; without it (the last chunk) no cache is made.

def _tail(x: torch.Tensor, start: int, keep: bool):
    return x[:, :, start:].clone() if keep else None


def _conv_stream(p: Conv, x: torch.Tensor, cache, keep: bool):
    """Chunked causal conv; the cache holds the last kt-1 input frames.
    kt == 1 convs are frame-local and carry none."""
    kt = p.weight.shape[2]
    if kt == 1:
        return causal_conv3d(p, x), None
    if cache is None:
        xin = F.pad(x, (0, 0, 0, 0, kt - 1, 0))
    else:
        xin = torch.cat([cache.to(x.dtype), x], dim=2)
    out = causal_conv3d(p, xin, time_pad=0)
    return out, _tail(xin, x.shape[2], keep)


def _res_block_stream(p: ResBlock, x: torch.Tensor, c, keep: bool):
    c = c or {}
    h, c1 = _conv_stream(p.conv1, F.silu(_rms(p.norm1, x)), c.get("conv1"), keep)
    h, c2 = _conv_stream(p.conv2, F.silu(_rms(p.norm2, h)), c.get("conv2"), keep)
    s = causal_conv3d(p.shortcut, x) if hasattr(p, "shortcut") else x  # kt=1
    return h + s, {"conv1": c1, "conv2": c2}


def _temporal_up_stream(p: Conv, x: torch.Tensor, cache, keep: bool):
    """Temporal 2x upsample: frame 0 passes through unchanged; frames 1..
    are doubled by the 2C-channel causal conv, channel k*C + c of input
    frame i becoming channel c of output frame 2i + k. On the first chunk
    frame 0 is zero-masked out of the conv's input and the window at global
    position 0 is dropped; later chunks are plain cached windows."""
    b, c, t, h, w = x.shape
    first = cache is None
    if first:
        masked = torch.cat([torch.zeros_like(x[:, :, :1]), x[:, :, 1:]], dim=2)
        xin = F.pad(masked, (0, 0, 0, 0, 2, 0))
    else:
        xin = torch.cat([cache.to(x.dtype), x], dim=2)
    y = causal_conv3d(p, xin, time_pad=0)  # (B, 2C, t, H, W)
    if first:
        y = y[:, :, 1:]
    m = y.shape[2]
    y = y.reshape(b, 2, c, m, h, w).permute(0, 2, 3, 1, 4, 5).reshape(b, c, 2 * m, h, w)
    if first:
        y = torch.cat([x[:, :, :1], y], dim=2)
    return y, _tail(xin, t, keep)


def _temporal_down_stream(p: Conv, x: torch.Tensor, cache, keep: bool):
    """Temporal 2x downsample by the stride-2 no-pad conv. On the first
    chunk frame 0 passes through unchanged and the conv runs over the
    chunk (a chunk shorter than the kernel, a streamed frame 0, gives frame
    0 alone). The windows start at even global indices; the cache keeps
    the input from the next window's start on (one frame under the
    1+tfac*k pixel chunking)."""
    if cache is None:
        xin, out = x, x[:, :, :1]
        if x.shape[2] >= p.weight.shape[2]:
            rest = causal_conv3d(p, x, stride=(2, 1, 1), time_pad=0)
            out = torch.cat([out, rest], dim=2)
    else:
        xin = torch.cat([cache.to(x.dtype), x], dim=2)
        out = causal_conv3d(p, xin, stride=(2, 1, 1), time_pad=0)
    return out, _tail(xin, 2 * ((xin.shape[2] - 1) // 2), keep)


def _encoder_stages_stream(p, x: torch.Tensor, cache, keep: bool):
    """conv_in and the down stages on one pixel chunk. Purely convolutional,
    so it can run on W-tiles (:func:`_encoder_halo`)."""
    c = {} if cache is None else dict(cache)
    h, c["conv_in"] = _conv_stream(p.conv_in, x, c.get("conv_in"), keep)
    for i, stage in enumerate(p.stages):
        for j, blk in enumerate(stage.blocks):
            h, c[f"s{i}b{j}"] = _res_block_stream(blk, h, c.get(f"s{i}b{j}"), keep)
        if hasattr(stage, "down"):
            h = _spatial_down(stage.down, h)  # frame-local
            if hasattr(stage, "time_down"):
                h, c[f"s{i}td"] = _temporal_down_stream(stage.time_down, h,
                                                        c.get(f"s{i}td"), keep)
    return h, c


def _encoder_mid_stream(p, h: torch.Tensor, cache, keep: bool):
    """Mid block (res, global spatial attention, res) and the moment head
    at the bottleneck scale; the attention sees the whole grid, so this
    part runs untiled."""
    c = {} if cache is None else dict(cache)
    h, c["mid_res1"] = _res_block_stream(p.mid.res1, h, c.get("mid_res1"), keep)
    h = _attn_block(p.mid.attn, h)  # frame-local
    h, c["mid_res2"] = _res_block_stream(p.mid.res2, h, c.get("mid_res2"), keep)
    h = F.silu(_rms(p.head_norm, h))
    h, c["head"] = _conv_stream(p.head_conv, h, c.get("head"), keep)
    return h, c


def _encoder_stream(p, x: torch.Tensor, cache, keep: bool):
    """One pixel chunk through the whole encoder; the first chunk must
    hold global frame 0."""
    cs, cm = (None, None) if cache is None else (cache["stages"], cache["mid"])
    h, cs = _encoder_stages_stream(p, x, cs, keep)
    h, cm = _encoder_mid_stream(p, h, cm, keep)
    return h, {"stages": cs, "mid": cm}


def _decoder_mid_stream(p, z: torch.Tensor, cache, keep: bool):
    """conv_in and the mid block on one latent chunk (untiled: global
    attention, at the cheap latent scale)."""
    c = {} if cache is None else dict(cache)
    h, c["conv_in"] = _conv_stream(p.conv_in, z, c.get("conv_in"), keep)
    h, c["mid_res1"] = _res_block_stream(p.mid.res1, h, c.get("mid_res1"), keep)
    h = _attn_block(p.mid.attn, h)  # frame-local
    h, c["mid_res2"] = _res_block_stream(p.mid.res2, h, c.get("mid_res2"), keep)
    return h, c


def _decoder_stages_stream(p, h: torch.Tensor, cache, keep: bool):
    """The up stages and the pixel head on one chunk. Purely
    convolutional, so it can run on W-tiles (:func:`_decoder_halo`)."""
    c = {} if cache is None else dict(cache)
    for i, stage in enumerate(p.stages):
        for j, blk in enumerate(stage.blocks):
            h, c[f"s{i}b{j}"] = _res_block_stream(blk, h, c.get(f"s{i}b{j}"), keep)
        if hasattr(stage, "up"):
            if hasattr(stage, "time_up"):
                h, c[f"s{i}tu"] = _temporal_up_stream(stage.time_up, h,
                                                      c.get(f"s{i}tu"), keep)
            h = _spatial_up(stage.up, h)
    h = F.silu(_rms(p.head_norm, h))
    h, c["head"] = _conv_stream(p.head_conv, h, c.get("head"), keep)
    return h, c


def _decoder_stream(p, z: torch.Tensor, cache, keep: bool):
    """One latent chunk through the whole decoder; the first chunk must
    hold global frame 0."""
    cm, cs = (None, None) if cache is None else (cache["mid"], cache["stages"])
    h, cm = _decoder_mid_stream(p, z, cm, keep)
    h, cs = _decoder_stages_stream(p, h, cs, keep)
    return h, {"mid": cm, "stages": cs}


def _stream(step, p, chunks) -> torch.Tensor:
    """``step(p, chunk, cache, keep) -> (out, cache)`` over the chunks in
    order, starting from no cache and keeping none after the last; the
    outputs joined along time."""
    outs, cache = [], None
    for i, chunk in enumerate(chunks):
        out, cache = step(p, chunk, cache, i < len(chunks) - 1)
        outs.append(out)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def _chunks(x: torch.Tensor, streaming: bool, size: int = 1) -> list[torch.Tensor]:
    """The whole clip as one chunk; streaming, frame 0 and then chunks of
    ``size`` frames (one latent frame each)."""
    if not streaming or x.shape[2] == 1:
        return [x]
    return [x[:, :, :1], *x[:, :, 1:].split(size, dim=2)]


# ------------------------------------------------------------- W-tiling

def _tile_plan(w: int, tiles: int, halo: int) -> tuple[int, int, list[int]]:
    """(tile, padded tile width, start offsets clamped into [0, w - wt]):
    every tile has the same width."""
    tile = w // tiles
    wt = min(tile + 2 * halo, w)
    starts = [min(max(k * tile - halo, 0), w - wt) for k in range(tiles)]
    return tile, wt, starts


def _over_w_tiles(fn, x: torch.Tensor, tiles: int, halo: int,
                  up: int = 1, down: int = 1) -> torch.Tensor:
    """``fn`` on ``tiles`` overlapping W-slices of ``x`` (``halo`` columns
    either side), keeping each tile's interior; ``fn`` scales W by up/down."""
    tile, wt, starts = _tile_plan(x.shape[-1], tiles, halo)
    parts = []
    for k, s in enumerate(starts):
        out = fn(x[..., s:s + wt])
        v0 = (k * tile - s) * up // down
        parts.append(out[..., v0:v0 + tile * up // down])
    return torch.cat(parts, dim=-1)


def _encoder_halo(cfg: VAEConfig) -> int:
    """Receptive-field halo (input px) of the pre-mid encoder, rounded up
    to the spatial factor: each 3x3 conv at scale s adds +-s px, each
    stride-2 down conv +-2s. 14B geometry: 75 -> 80."""
    rf, scale = 1, 1  # conv_in
    for i in range(len(cfg.dim_mult)):
        rf += 2 * cfg.num_res_blocks * scale
        if i < len(cfg.dim_mult) - 1:
            rf += 2 * scale
            scale *= 2
    sf = cfg.spatial_factor
    return -(-rf // sf) * sf


def _decoder_halo(cfg: VAEConfig) -> int:
    """Receptive-field halo (latent px) of the post-mid decoder: a 3x3 conv
    at up-scale s adds +-1/s latent px, stages carry num_res_blocks+1
    blocks. 14B geometry: 12.25 -> 14 (one px spare)."""
    rf, scale = 0.0, 1.0
    n = len(cfg.dim_mult)
    for i in range(n):
        rf += 2 * (cfg.num_res_blocks + 1) / scale
        if i < n - 1:
            scale *= 2
            rf += 1.0 / scale  # the conv after the upsample
    rf += 1.0 / scale  # head conv
    return math.ceil(rf) + 1


# ------------------------------------------------------------- public API

def vae_encode(vae: VAE, video: torch.Tensor, normalize: bool = True,
               streaming: bool | None = None,
               spatial_tiles: int | None = None) -> torch.Tensor:
    """Pixels in [-1, 1] (B, 3, T, H, W), T = 4k+1 -> latents
    (B, z_dim, 1+(T-1)//4, H/8, W/8), normalised when z_dim is 16.
    Only the mean of the moments is kept.

    ``streaming=None`` streams when T > 5 (the reasoning volume; the 5-frame
    edit clip runs full-sequence). ``spatial_tiles=None`` tiles the pre-mid
    encoder 4 ways when streaming at W >= 1024, else not at all."""
    cfg = vae.cfg
    enc = vae.encoder
    x = video.to(cfg.dtype)
    t, w = x.shape[2], x.shape[-1]
    sf, tfac = cfg.spatial_factor, cfg.temporal_factor
    if streaming is None:
        streaming = t > 5
    if spatial_tiles is None:
        spatial_tiles = 4 if streaming and w >= 1024 and w % (4 * sf) == 0 else 1
    if spatial_tiles > 1 and w % (spatial_tiles * sf):
        raise ValueError(f"W={w} not divisible by spatial_tiles*{sf}")
    if streaming and (t - 1) % tfac:
        raise ValueError(f"streamed encode needs T = 1 + {tfac}k, got {t}")
    if spatial_tiles > 1:
        hmid = _over_w_tiles(
            lambda xt: _stream(_encoder_stages_stream, enc, _chunks(xt, streaming, tfac)),
            x, spatial_tiles, _encoder_halo(cfg), down=sf)
        moments = _stream(_encoder_mid_stream, enc, _chunks(hmid, streaming))
    else:
        moments = _stream(_encoder_stream, enc, _chunks(x, streaming, tfac))
    moments = causal_conv3d(vae.quant_conv, moments)
    mu = moments[:, : cfg.z_dim]
    if normalize and cfg.z_dim == WAN_LATENT_MEAN.size:
        mean, std = _latent_stats(cfg, mu)
        mu = (mu - mean) / std
    return mu


def vae_decode(vae: VAE, latents: torch.Tensor, normalize: bool = True,
               streaming: bool | None = None,
               spatial_tiles: int | None = None) -> torch.Tensor:
    """Latents -> pixels (B, 3, (Tl-1)*4+1, H*8, W*8).

    ``streaming=None`` streams one latent frame at a time when Tl > 2 (the
    reasoning trajectory; the 2-frame edit decode runs full-sequence).
    ``spatial_tiles=None`` tiles the post-mid decoder 4 ways when streaming
    at latent W >= 128, else not at all."""
    cfg = vae.cfg
    dec = vae.decoder
    z = latents.to(cfg.dtype)
    if normalize and cfg.z_dim == WAN_LATENT_MEAN.size:
        mean, std = _latent_stats(cfg, z)
        z = z * std + mean
    z = causal_conv3d(vae.post_quant_conv, z)  # kt=1, frame-local
    tl, wl = z.shape[2], z.shape[-1]
    sf = cfg.spatial_factor
    if streaming is None:
        streaming = tl > 2
    if spatial_tiles is None:
        spatial_tiles = 4 if streaming and wl >= 128 and wl % 4 == 0 else 1
    if spatial_tiles > 1 and wl % spatial_tiles:
        raise ValueError(f"latent W={wl} not divisible by spatial_tiles")
    frames = _chunks(z, streaming)
    if spatial_tiles > 1:
        hmid = _stream(_decoder_mid_stream, dec, frames)
        return _over_w_tiles(
            lambda ht: _stream(_decoder_stages_stream, dec, _chunks(ht, streaming)),
            hmid, spatial_tiles, _decoder_halo(cfg), up=sf)
    return _stream(_decoder_stream, dec, frames)
