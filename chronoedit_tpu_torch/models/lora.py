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

Several adapters fuse one after another (:func:`merge_multi_lora`), each
rounded to W's dtype before the next, as in JAX. Files of the reference's
LoRA dialects convert through ``models/weights.py``.

QLoRA: a quantized projection (``ops/quant.py``) has no float weight to
merge into, and merging into one raises. Over a quantized base
(:func:`base_is_quantized`) the adapters ride unmerged as side branches,
``y += (x @ a) @ (scaling * b)`` in fp32 after the quantized product
(:func:`attached_weights`, JAX's ``attach_lora`` one block at a time; the
scaling folds into b), on every target, as JAX attaches every target once
any is quantized. Adapters over a quantized leaf take the float layer's
dims (an int4 leaf records its unpadded in-dim).
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
        for i, blk in enumerate(model.blocks):
            adapters = nn.ModuleDict()
            for target in cfg.targets:
                module, layer = target.split("/")
                d_in, d_out = _dims(model, f"blocks.{i}.{module}.{layer}",
                                    blk.get_submodule(target.replace("/", ".")), target)
                if module not in adapters:
                    adapters[module] = nn.ModuleDict()
                adapters[module][layer] = Adapter(d_in, d_out, cfg.rank, device=device)
            self.blocks.append(adapters)


def _dims(model: nn.Module, name: str, lin: nn.Module, target: str) -> tuple[int, int]:
    """(d_in, d_out) of a float or quantized linear layer ``name`` of
    ``model``; of the whole layer when a sharded model holds a block of its
    float weight (``parallel/sharding.py``)."""
    from chronoedit_tpu_torch.ops import quant
    from chronoedit_tpu_torch.parallel.sharding import local_box

    if isinstance(lin, quant.QuantLinear8):
        return lin.weight_q.shape[1], lin.weight_q.shape[0]
    if isinstance(lin, quant.QuantLinear4):
        if lin.in_features is None:
            raise ValueError(f"LoRA target {target}: the int4 leaf does not record its in-dim")
        return lin.in_features, lin.packed.shape[0]
    d_out, d_in = local_box(model, f"{name}.weight", tuple(lin.weight.shape))[0]
    return d_in, d_out


def _linear(block: nn.Module, target: str) -> nn.Module:
    """The float linear layer of ``target`` in ``block``; raises for a
    quantized one."""
    lin = block.get_submodule(target.replace("/", "."))
    if not hasattr(lin, "weight"):
        raise ValueError(f"LoRA target {target} is quantized ({type(lin).__name__}): "
                         "there is no float weight to merge into")
    return lin


def base_is_quantized(model: nn.Module, cfg: LoRAConfig | None = None) -> bool:
    """True when any LoRA target of any block of ``model`` is a quantized
    leaf: such a base takes its adapters as side branches
    (:func:`attached_weights`), not merged."""
    from chronoedit_tpu_torch.ops import quant

    targets = cfg.targets if cfg else DEFAULT_TARGETS
    for blk in model.blocks:
        for target in targets:
            module, layer = target.split("/")
            parent = getattr(blk, module, None)
            if parent is not None and quant.is_quantized(getattr(parent, layer, None)):
                return True
    return False


def lora_trainable_filter(lora: LoRA) -> dict[str, bool]:
    """{parameter name: trainable} of ``lora``: every adapter tensor (JAX's
    optax mask of the same name)."""
    return {name: True for name, _ in lora.named_parameters()}


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


def _local(target: str, ad: Adapter, tp, summed=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, b) of ``ad`` as a tensor rank applies them (``tp``, a
    ``sharding.TensorSplit``; None: whole): a column-split target takes its
    columns of b, a row-split one its rows of a. Both are replicated and
    each rank uses its share, so their gradients are summed over the
    group. ``summed`` is the fsdp group when each of its ranks ran its own
    rows of the batch: the adapters' gradients are summed over it too."""
    from chronoedit_tpu_torch.parallel import collectives as C

    a, b = ad.a, ad.b
    if summed is not None:
        a, b = C.sum_grad_autograd(a, summed), C.sum_grad_autograd(b, summed)
    if tp is None:
        return a, b
    from chronoedit_tpu_torch.parallel.sharding import TP_ROW

    a, b = C.sum_grad_autograd(a, tp.group), C.sum_grad_autograd(b, tp.group)
    if tuple(target.split("/")) in TP_ROW:
        n = a.shape[0] // tp.size
        return a.narrow(0, tp.index * n, n), b
    n = b.shape[1] // tp.size
    return a, b.narrow(1, tp.index * n, n)


def merged_weights(block: nn.Module, adapters: nn.ModuleDict, scaling: float,
                   tp=None, summed=None) -> dict[nn.Module, torch.Tensor]:
    """{linear layer: its merged weight} for one block's targets:
    ``(W.float() + scaling * (a @ b).T).to(W.dtype)``; differentiable in
    the adapters (and in W, when W requires a gradient). Under tensor
    parallelism (``tp``) W is this rank's block of the whole weight and
    the delta this rank's block of the whole delta; ``summed``: the fsdp
    group whose ranks ran their own rows (:func:`_local`)."""
    out = {}
    for target, ad in iter_adapters(adapters):
        lin = _linear(block, target)
        a, b = _local(target, ad, tp, summed)
        delta = (a.float() @ b.float()) * scaling
        out[lin] = (lin.weight.float() + delta.T).to(lin.weight.dtype)
    return out


def attached_weights(block: nn.Module, adapters: nn.ModuleDict, scaling: float, tp=None,
                     summed=None) -> dict[nn.Module, tuple[torch.Tensor, torch.Tensor]]:
    """{linear layer: (a, b * scaling)} for one block's targets, the side
    branches ``ops/layers.linear`` adds after the layer's own (float or
    quantized) product; b scaled in fp32, differentiable in the adapters.
    Under tensor parallelism (``tp``) each rank's share (:func:`_local`):
    a row-split layer's branch is then a partial sum, added to its partial
    product before the sum over the group; ``summed`` as for
    :func:`merged_weights`."""
    out = {}
    for target, ad in iter_adapters(adapters):
        a, b = _local(target, ad, tp, summed)
        out[block.get_submodule(target.replace("/", "."))] = (a, b.float() * scaling)
    return out


def merge_lora(model: nn.Module, lora: LoRA, scale: float = 1.0,
               in_place: bool = False) -> nn.Module:
    """``model`` with ``W + scale * (alpha / r) * a @ b`` fused into every
    target (the reference's ``fuse_lora``), in fp32 and rounded once to W's
    dtype. A copy, unless ``in_place`` (the loader's, for a 14B model that
    has no room for a second copy). Into a model sharded over fsdp
    (``model.fsdp``) each target's whole delta is computed as in one
    process, one target at a time, and this rank's slice of it is added
    to the shard: the fused shard is bitwise the slice of the one-process
    fused weight (a product over half the rows could round otherwise). The
    same holds for a model split over tensor (``model.tensor``): its
    tensor block of the delta, then its fsdp block of that."""
    from chronoedit_tpu_torch.parallel.sharding import local_of

    merged = model if in_place else copy.deepcopy(model)
    scaling = lora.cfg.scaling * scale
    with torch.no_grad():
        for j, (blk, adapters) in enumerate(zip(merged.blocks, lora.blocks)):
            for target, ad in iter_adapters(adapters):
                lin = _linear(blk, target)
                delta = ((ad.a.float() @ ad.b.float()) * scaling).T
                delta = local_of(merged, f"blocks.{j}.{target.replace('/', '.')}.weight", delta)
                lin.weight.copy_((lin.weight.float() + delta).to(lin.weight.dtype))
    return merged


def merge_multi_lora(model: nn.Module, adapters: dict[str, tuple[LoRA, float]]) -> nn.Module:
    """A copy of ``model`` with several adapters, ``{name: (adapters,
    scale)}``, fused one after another (multi-adapter activation): each
    merge adds in fp32 and rounds to W's dtype before the next, as JAX's
    ``merge_multi_lora`` does, so the result is not the deltas' sum rounded
    once."""
    out = copy.deepcopy(model)
    for lora, scale in adapters.values():
        merge_lora(out, lora, scale, in_place=True)
    return out
