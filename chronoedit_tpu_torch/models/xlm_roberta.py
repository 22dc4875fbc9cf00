"""XLM-Roberta text tower (the CLIP text encoder of Wan2.1's XLM-R CLIP),
PyTorch.

The port of ``chronoedit_tpu/models/xlm_roberta.py``: a BERT-style encoder
(post-norm, or pre-norm with ``post_norm=False``) with padding-aware
position ids (pad id 1, positions ``pad_id + cumsum(mask) * mask``), and
the ``XLMRobertaWithHead`` variant: a masked mean pool, then a bias-free
two-layer exact-GELU MLP to the CLIP joint dim. One padding mask drives
both the additive attention bias (``finfo(float32).min`` on pad keys) and
the pool. ChronoEdit's edit never runs it (only CLIP's vision features
feed the DiT); it is here because the reference ships it with the CLIP
stack. It computes in its parameters' dtype, plain torch as JAX's is
plain XLA; the head's projections are stored the PyTorch way, (out, in).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from chronoedit_tpu_torch.models import weights as w
from chronoedit_tpu_torch.ops import layers as L
from chronoedit_tpu_torch.ops.layers import empty_param


@dataclasses.dataclass(frozen=True)
class XLMRobertaConfig:
    """xlm_roberta_large defaults."""

    vocab_size: int = 250002
    max_seq_len: int = 514
    type_size: int = 1
    pad_id: int = 1
    dim: int = 1024
    num_heads: int = 16
    num_layers: int = 24
    post_norm: bool = True
    eps: float = 1e-5
    out_dim: int | None = None  # set -> the WithHead variant (CLIP joint dim)
    param_dtype: torch.dtype = torch.float32


class XLMRobertaBlock(nn.Module):
    def __init__(self, cfg: XLMRobertaConfig, **kw):
        super().__init__()
        d = cfg.dim
        self.attn = nn.ModuleDict({n: L.Linear(d, d, **kw) for n in "qkvo"})
        self.ln1 = L.LayerNorm(d, **kw)
        self.fc1 = L.Linear(d, 4 * d, **kw)
        self.fc2 = L.Linear(4 * d, d, **kw)
        self.ln2 = L.LayerNorm(d, **kw)


class XLMRoberta(nn.Module):
    """The tower's parameters, named as in the JAX parameter tree."""

    def __init__(self, cfg: XLMRobertaConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        pd = cfg.param_dtype
        kw = dict(device=device, dtype=pd, generator=generator)
        self.token_embed = empty_param((cfg.vocab_size, cfg.dim), device, pd)
        self.type_embed = empty_param((cfg.type_size, cfg.dim), device, pd)
        self.pos_embed = empty_param((cfg.max_seq_len, cfg.dim), device, pd)
        if generator is not None:
            with torch.no_grad():
                for p in (self.token_embed, self.type_embed, self.pos_embed):
                    p.normal_(0.0, 0.02, generator=generator)
        self.norm = L.LayerNorm(cfg.dim, **kw)
        self.blocks = nn.ModuleList(XLMRobertaBlock(cfg, **kw) for _ in range(cfg.num_layers))
        if cfg.out_dim is not None:
            mid = (cfg.dim + cfg.out_dim) // 2
            self.head = nn.ModuleDict(dict(fc1=L.Linear(cfg.dim, mid, bias=False, **kw),
                                           fc2=L.Linear(mid, cfg.out_dim, bias=False, **kw)))


def init_xlm_roberta_params(cfg: XLMRobertaConfig, generator: torch.Generator,
                            device=None) -> XLMRoberta:
    """A tower with random weights from ``generator`` on ``device``:
    N(0, 0.02) embeddings, xavier-uniform linears, unit LayerNorms (JAX has
    no initializer; its tests draw their own)."""
    return XLMRoberta(cfg, device=device, generator=generator)


def _ln(p: L.LayerNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p.scale + p.bias


def _attention(p: nn.ModuleDict, x: torch.Tensor, bias: torch.Tensor,
               num_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    hd = d // num_heads
    q, k, v = (L.linear(p[n], x).reshape(b, s, num_heads, hd).transpose(1, 2) for n in "qkv")
    logits = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5 + bias
    out = torch.matmul(torch.softmax(logits, dim=-1), v)
    return L.linear(p["o"], out.transpose(1, 2).reshape(b, s, d))


def xlm_roberta_encode(model: XLMRoberta, ids: torch.Tensor) -> torch.Tensor:
    """Token ids (B, L) -> hidden states (B, L, dim); with ``cfg.out_dim``
    set, the masked-mean-pooled head features (B, out_dim)."""
    cfg = model.cfg
    ids = ids.to(model.token_embed.device)
    mask = (ids != cfg.pad_id).long()
    pos = cfg.pad_id + torch.cumsum(mask, dim=1) * mask
    x = model.token_embed[ids] + model.type_embed[torch.zeros_like(ids)] + model.pos_embed[pos]
    if cfg.post_norm:
        x = _ln(model.norm, x, cfg.eps)
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, torch.finfo(torch.float32).min)
    bias = bias.to(x.dtype)
    for blk in model.blocks:
        if cfg.post_norm:
            x = _ln(blk.ln1, x + _attention(blk.attn, x, bias, cfg.num_heads), cfg.eps)
            h = L.linear(blk.fc2, F.gelu(L.linear(blk.fc1, x)))
            x = _ln(blk.ln2, x + h, cfg.eps)
        else:
            x = x + _attention(blk.attn, _ln(blk.ln1, x, cfg.eps), bias, cfg.num_heads)
            h = _ln(blk.ln2, x, cfg.eps)
            x = x + L.linear(blk.fc2, F.gelu(L.linear(blk.fc1, h)))
    if not cfg.post_norm:
        x = _ln(model.norm, x, cfg.eps)
    if cfg.out_dim is None:
        return x
    m = mask[..., None].to(x.dtype)
    pooled = (x * m).sum(dim=1) / m.sum(dim=1)
    return L.linear(model.head.fc2, F.gelu(L.linear(model.head.fc1, pooled)))


# reference XLMRoberta / XLMRobertaWithHead name -> XLMRoberta parameter
# name; "{i}" is the layer
REFERENCE_NAMES = {
    "token_embedding.weight": "token_embed",
    "type_embedding.weight": "type_embed",
    "pos_embedding.weight": "pos_embed",
    "norm.weight": "norm.scale",
    "norm.bias": "norm.bias",
}
REFERENCE_BLOCK_NAMES = {
    **{f"blocks.{{i}}.attn.{n}.{s}": f"blocks.{{i}}.attn.{n}.{s}"
       for n in "qkvo" for s in ("weight", "bias")},
    "blocks.{i}.norm1.weight": "blocks.{i}.ln1.scale",
    "blocks.{i}.norm1.bias": "blocks.{i}.ln1.bias",
    "blocks.{i}.ffn.0.weight": "blocks.{i}.fc1.weight",
    "blocks.{i}.ffn.0.bias": "blocks.{i}.fc1.bias",
    "blocks.{i}.ffn.2.weight": "blocks.{i}.fc2.weight",
    "blocks.{i}.ffn.2.bias": "blocks.{i}.fc2.bias",
    "blocks.{i}.norm2.weight": "blocks.{i}.ln2.scale",
    "blocks.{i}.norm2.bias": "blocks.{i}.ln2.bias",
}
REFERENCE_HEAD_NAMES = {"head.0.weight": "head.fc1.weight", "head.2.weight": "head.fc2.weight"}


def reference_names(cfg: XLMRobertaConfig) -> dict[str, str]:
    """{reference name: XLMRoberta parameter name} for ``cfg``."""
    names = dict(REFERENCE_NAMES)
    for i in range(cfg.num_layers):
        names.update({r.format(i=i): p.format(i=i) for r, p in REFERENCE_BLOCK_NAMES.items()})
    if cfg.out_dim is not None:
        names.update(REFERENCE_HEAD_NAMES)
    return names


def convert_xlm_roberta(sd: w.StateDict, cfg: XLMRobertaConfig, device=None) -> XLMRoberta:
    """Reference ``XLMRoberta`` / ``XLMRobertaWithHead`` state dict -> the
    tower in ``cfg.param_dtype`` on ``device``; other keys are ignored, as
    JAX ignores them."""
    return w.fill_module(XLMRoberta(cfg, device=device), sd, reference_names(cfg), strict=False)
