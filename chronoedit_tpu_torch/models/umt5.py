"""UMT5-xxl text encoder, PyTorch.

The port of ``chronoedit_tpu/models/umt5.py``: vocab 256,384, dim 4,096,
ffn 10,240 (gated tanh GELU), 64 heads, 24 layers, 32 relative-position
buckets with a relative embedding per layer (UMT5's difference from T5),
T5 RMS norms, unscaled attention logits and an fp32 softmax. The public
call returns 512-token embeddings zero-padded past each prompt's length.

Arithmetic kept from JAX (``umt5.py:121-162``):

- the logits are q·kᵀ in fp32 from the stream dtype's q and k (JAX's
  ``preferred_element_type=float32``), unscaled, plus the fp32 position
  and mask bias, softmaxed in fp32 and cast to the stream dtype before
  the product with v;
- masked keys get ``finfo(float32).min``;
- the T5 norm multiplies by its weight in fp32 and casts after; the DiT's
  K4 casts, then applies its weight, so K4 is not this norm: plain torch,
  as JAX's is plain XLA.

No Pallas kernel lies here, and no hand-written kernel either. The
relative-position buckets come from the host in numpy, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from chronoedit_tpu_torch.models import weights as w
from chronoedit_tpu_torch.ops import layers as L
from chronoedit_tpu_torch.ops.layers import empty_param


@dataclasses.dataclass(frozen=True)
class UMT5Config:
    vocab_size: int = 256_384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10_240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    rel_max_dist: int = 128
    eps: float = 1e-6
    text_len: int = 512
    dtype: torch.dtype = torch.bfloat16
    # the reference file is bf16 (models_t5_umt5-xxl-enc-bf16.pth): JAX's
    # fp32 parameters hold exactly these values
    param_dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim_attn // self.num_heads


def umt5_xxl_config(**kw) -> UMT5Config:
    return UMT5Config(**kw)


# ------------------------------------------------------------- rel buckets

def relative_position_buckets(length: int, num_buckets: int = 32,
                              max_dist: int = 128) -> np.ndarray:
    """Bidirectional T5 bucket matrix (length, length) int32, on the host
    (a copy of JAX's)."""
    rel_pos = np.arange(length)[None, :] - np.arange(length)[:, None]
    nb = num_buckets // 2
    buckets = (rel_pos > 0).astype(np.int64) * nb
    rel = np.abs(rel_pos)
    max_exact = nb // 2
    with np.errstate(divide="ignore"):
        large = max_exact + (
            np.log(np.maximum(rel, 1) / max_exact) / math.log(max_dist / max_exact)
            * (nb - max_exact)
        ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets += np.where(rel < max_exact, rel, large)
    return buckets.astype(np.int32)


# ------------------------------------------------------------- modules

class _Scale(nn.Module):
    """A T5 norm's weight (``scale``); ones init."""

    def __init__(self, dim, device, dtype, generator):
        super().__init__()
        self.scale = empty_param((dim,), device, dtype)
        if generator is not None:
            with torch.no_grad():
                self.scale.fill_(1.0)


class UMT5Block(nn.Module):
    def __init__(self, cfg: UMT5Config, device, generator):
        super().__init__()
        d, da, df, h = cfg.dim, cfg.dim_attn, cfg.dim_ffn, cfg.num_heads
        dt = cfg.param_dtype

        def lin(din, dout, std):
            return L.Linear(din, dout, device=device, dtype=dt, generator=generator,
                            std=std, bias=False)

        self.norm1 = _Scale(d, device, dt, generator)
        self.attn = nn.ModuleDict(dict(
            q=lin(d, da, (d * da) ** -0.5), k=lin(d, da, d ** -0.5),
            v=lin(d, da, d ** -0.5), o=lin(da, d, (h * cfg.head_dim) ** -0.5)))
        self.norm2 = _Scale(d, device, dt, generator)
        self.ffn = nn.ModuleDict(dict(
            gate=lin(d, df, d ** -0.5), fc1=lin(d, df, d ** -0.5), fc2=lin(df, d, df ** -0.5)))
        # the relative embedding of this layer, (buckets, heads)
        self.rel_emb = empty_param((cfg.num_buckets, h), device, dt)
        if generator is not None:
            with torch.no_grad():
                self.rel_emb.normal_(0.0, (2 * cfg.num_buckets * h) ** -0.5,
                                     generator=generator)


class UMT5(nn.Module):
    """The encoder's parameters, named as in the JAX parameter tree."""

    def __init__(self, cfg: UMT5Config, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = empty_param((cfg.vocab_size, cfg.dim), device, cfg.param_dtype)
        if generator is not None:
            with torch.no_grad():
                self.token_embedding.normal_(0.0, 1.0, generator=generator)
        self.blocks = nn.ModuleList(UMT5Block(cfg, device, generator)
                                    for _ in range(cfg.num_layers))
        self.norm = _Scale(cfg.dim, device, cfg.param_dtype, generator)


def init_umt5_params(cfg: UMT5Config, generator: torch.Generator, device=None) -> UMT5:
    """An encoder with random weights drawn from ``generator`` in
    ``cfg.param_dtype`` on ``device``, with JAX's distributions: N(0, 1)
    embeddings, N(0, std) projections, unit norms."""
    return UMT5(cfg, device=device, generator=generator)


# ------------------------------------------------------------- forward

def _t5_norm(p: _Scale, x: torch.Tensor, eps: float) -> torch.Tensor:
    """T5 RMS norm: fp32 statistics, times the weight in fp32, then the
    cast."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * p.scale.float()).to(x.dtype)


def _t5_attention(p: nn.ModuleDict, x: torch.Tensor, bias: torch.Tensor,
                  cfg: UMT5Config) -> torch.Tensor:
    """Unscaled attention with an additive fp32 bias, fp32 logits and
    softmax."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v = (L.linear(p[n], x).reshape(b, s, h, hd).transpose(1, 2) for n in "qkv")
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias
    weights = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.matmul(weights, v).transpose(1, 2).reshape(b, s, h * hd)
    return L.linear(p["o"], out)


def _t5_ffn(p: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    return L.linear(p["fc2"], L.gelu_tanh(L.linear(p["gate"], x)) * L.linear(p["fc1"], x))


def umt5_encode(model: UMT5, ids: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token ids (B, S) -> embeddings (B, S, dim) in ``cfg.dtype``.
    ``mask`` (B, S) of 1/0 masks keys only, as the reference does: queries
    at pad positions still produce (later zeroed) outputs."""
    cfg = model.cfg
    b, s = ids.shape
    dev = model.token_embedding.device
    ids = ids.to(dev)
    x = model.token_embedding[ids].to(cfg.dtype)
    buckets = torch.as_tensor(relative_position_buckets(s, cfg.num_buckets, cfg.rel_max_dist),
                              device=dev).long()
    if mask is None:
        mask_bias = torch.zeros((b, 1, 1, s), device=dev)
    else:
        key_mask = (mask.to(dev) == 0)[:, None, None, :]
        mask_bias = torch.where(key_mask, torch.finfo(torch.float32).min, 0.0)
    for blk in model.blocks:
        pos_bias = blk.rel_emb[buckets].permute(2, 0, 1)[None].float()  # (1, H, S, S)
        bias = pos_bias + mask_bias
        x = x + _t5_attention(blk.attn, _t5_norm(blk.norm1, x, cfg.eps), bias, cfg)
        x = x + _t5_ffn(blk.ffn, _t5_norm(blk.norm2, x, cfg.eps))
    return _t5_norm(model.norm, x, cfg.eps)


class UMT5TextEncoder:
    """Prompt -> (B, text_len, dim) embeddings, zero-padded past each
    prompt's length, on the encoder's device. Tokenizing goes through the
    HF "google/umt5-xxl" tokenizer when its files are there (a download);
    token ids are always accepted (:meth:`encode_ids`)."""

    def __init__(self, model: UMT5, tokenizer=None, tokenizer_path: str = "google/umt5-xxl"):
        self.model = model
        self.cfg = model.cfg
        self._tokenizer = tokenizer
        self._tokenizer_path = tokenizer_path

    @property
    def tokenizer(self):
        if self._tokenizer is None:
            from transformers import AutoTokenizer

            self._tokenizer = AutoTokenizer.from_pretrained(self._tokenizer_path)
        return self._tokenizer

    @torch.inference_mode()
    def encode_ids(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        ctx = umt5_encode(self.model, ids, mask)
        return ctx * mask.to(ctx.device)[:, :, None].to(ctx.dtype)

    def __call__(self, texts: list[str]) -> torch.Tensor:
        enc = self.tokenizer(texts, padding="max_length", truncation=True,
                             max_length=self.cfg.text_len, return_tensors="pt",
                             add_special_tokens=True)
        return self.encode_ids(enc["input_ids"], enc["attention_mask"])


# ------------------------------------------------------------- weights

# models_t5_umt5-xxl-enc-bf16.pth name -> UMT5 parameter name; "{i}" is the
# layer
REFERENCE_NAMES = {
    "token_embedding.weight": "token_embedding",
    "norm.weight": "norm.scale",
}
REFERENCE_BLOCK_NAMES = {
    "blocks.{i}.norm1.weight": "blocks.{i}.norm1.scale",
    "blocks.{i}.norm2.weight": "blocks.{i}.norm2.scale",
    **{f"blocks.{{i}}.attn.{n}.weight": f"blocks.{{i}}.attn.{n}.weight" for n in "qkvo"},
    "blocks.{i}.ffn.gate.0.weight": "blocks.{i}.ffn.gate.weight",
    "blocks.{i}.ffn.fc1.weight": "blocks.{i}.ffn.fc1.weight",
    "blocks.{i}.ffn.fc2.weight": "blocks.{i}.ffn.fc2.weight",
    "blocks.{i}.pos_embedding.embedding.weight": "blocks.{i}.rel_emb",
}


def reference_names(cfg: UMT5Config) -> dict[str, str]:
    """{reference name: UMT5 parameter name} for ``cfg``'s layers."""
    names = dict(REFERENCE_NAMES)
    for i in range(cfg.num_layers):
        names.update({r.format(i=i): p.format(i=i) for r, p in REFERENCE_BLOCK_NAMES.items()})
    return names


def convert_umt5_checkpoint(sd: w.StateDict, cfg: UMT5Config | None = None,
                            device=None) -> UMT5:
    """Reference ``models_t5_umt5-xxl-enc-bf16.pth`` state dict -> an
    encoder in ``cfg.param_dtype`` on ``device``; other keys are ignored,
    as JAX ignores them."""
    cfg = cfg or UMT5Config()
    return w.fill_module(UMT5(cfg, device=device), sd, reference_names(cfg), strict=False)
