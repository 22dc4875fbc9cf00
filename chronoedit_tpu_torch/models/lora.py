"""LoRA adapters over the DiT's block projections.

The port of ``chronoedit_tpu/models/lora.py`` (the reference recipe: rank
32 on q, k, v, o of both attentions and the two FFN projections of every
block). An adapter holds ``a`` (d_in, r) and ``b`` (r, d_out) in fp32, the
JAX layout of one layer's slice of its stacked (L, d_in, r) / (L, r, d_out)
leaves. Merging is ``W + scale * (alpha / r) * a @ b``, computed in fp32
and cast to W's dtype; JAX's (in, out) kernel is the transpose of the
port's (out, in) weight, so the port adds ``(a @ b).T``.

Training merges each block's adapters inside that block's function
(:func:`merged_weights`, called by ``models/dit.py`` under the block's
checkpoint), so merged weights live one block at a time and are recomputed
in the backward. The math is the same as merging the whole tree first, as
JAX does: each block reads only its own merged weights.

A quantized projection (``ops/quant.py``) has no float weight to merge
into: building adapters over it or merging into it raises. Not here yet:
``attach_lora`` / ``base_is_quantized`` (QLoRA's side adapters over a
quantized base) and ``merge_multi_lora`` (with the weights slice).
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

# linear layers inside one block (reference target_modules: q,k,v,o,ffn.0,ffn.2)
DEFAULT_TARGETS = (
    "self_attn/q", "self_attn/k", "self_attn/v", "self_attn/o",
    "cross_attn/q", "cross_attn/k", "cross_attn/v", "cross_attn/o",
    "ffn/fc1", "ffn/fc2",
)


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 32
    alpha: float = 32.0
    targets: tuple[str, ...] = DEFAULT_TARGETS
    init_std: float = 0.02

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


class Adapter(nn.Module):
    """One target's ``a`` (d_in, r) and ``b`` (r, d_out), fp32, trainable."""

    def __init__(self, d_in: int, d_out: int, rank: int, device=None):
        super().__init__()
        self.a = nn.Parameter(torch.zeros((d_in, rank), device=device))
        self.b = nn.Parameter(torch.zeros((rank, d_out), device=device))


class LoRA(nn.Module):
    """Adapters for every block: ``blocks[i][module][layer]`` is the
    :class:`Adapter` of target ``"module/layer"`` in block i."""

    def __init__(self, model: nn.Module, cfg: LoRAConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList()
        for blk in model.blocks:
            adapters = nn.ModuleDict()
            for target in cfg.targets:
                module, layer = target.split("/")
                w = _linear(blk, target).weight  # (d_out, d_in)
                if module not in adapters:
                    adapters[module] = nn.ModuleDict()
                adapters[module][layer] = Adapter(w.shape[1], w.shape[0], cfg.rank,
                                                  device=device)
            self.blocks.append(adapters)


def _linear(block: nn.Module, target: str) -> nn.Module:
    """The float linear layer of ``target`` in ``block``; raises for a
    quantized one."""
    lin = block.get_submodule(target.replace("/", "."))
    if not hasattr(lin, "weight"):
        raise ValueError(f"LoRA target {target} is quantized ({type(lin).__name__}): "
                         "there is no float weight to merge into")
    return lin


def iter_adapters(adapters: nn.ModuleDict):
    """(target, Adapter) pairs of one block."""
    for module, layers in adapters.items():
        for layer, ad in layers.items():
            yield f"{module}/{layer}", ad


def init_lora_params(generator: torch.Generator, model: nn.Module, cfg: LoRAConfig,
                     device=None) -> LoRA:
    """Zero-effect init: a ~ N(0, init_std), b = 0, fp32, on ``device``
    (default: the model's). Each target's ``a`` is drawn for all layers at
    once, (L, d_in, r), target by target in ``cfg.targets`` order."""
    if device is None:
        device = next(model.parameters()).device
    lora = LoRA(model, cfg, device=device)
    with torch.no_grad():
        for target in cfg.targets:
            module, layer = target.split("/")
            ads = [blk[module][layer] for blk in lora.blocks]
            a = torch.randn((len(ads),) + tuple(ads[0].a.shape), generator=generator,
                            device=generator.device)
            for ad, a_l in zip(ads, a):
                ad.a.copy_(a_l * cfg.init_std)
    return lora


def merged_weights(block: nn.Module, adapters: nn.ModuleDict,
                   scaling: float) -> dict[nn.Module, torch.Tensor]:
    """{linear layer: its merged weight} for one block's targets:
    ``(W.float() + scaling * (a @ b).T).to(W.dtype)``; differentiable in
    the adapters (and in W, when W requires a gradient)."""
    out = {}
    for target, ad in iter_adapters(adapters):
        lin = _linear(block, target)
        delta = (ad.a.float() @ ad.b.float()) * scaling
        out[lin] = (lin.weight.float() + delta.T).to(lin.weight.dtype)
    return out


def merge_lora(model: nn.Module, lora: LoRA, scale: float = 1.0) -> nn.Module:
    """A copy of ``model`` with ``W + scale * (alpha / r) * a @ b`` fused
    into every target (the reference's ``fuse_lora``); ``model`` is not
    changed."""
    merged = copy.deepcopy(model)
    with torch.no_grad():
        for blk, adapters in zip(merged.blocks, lora.blocks):
            for lin, w in merged_weights(blk, adapters, lora.cfg.scaling * scale).items():
                lin.weight.copy_(w)
    return merged
