"""Weight bridge: JAX parameter trees (as nested dicts of numpy arrays) into
the port's modules.

The caller converts the JAX pytree to numpy first
(``jax.tree.map(np.asarray, params)``), so this module never imports jax.
The module attribute names follow the JAX tree's keys, so the walk is
structural:

- a linear ``kernel`` (in, out) becomes ``weight`` (out, in);
- a VAE conv ``kernel`` (kt, kh, kw, cin, cout) becomes ``weight``
  (cout, cin, kt, kh, kw);
- the DiT's stacked ``blocks`` (leading layer axis) unstack into the
  ``nn.ModuleList``;
- lists (the VAE stages and res blocks) map index by index;
- LoRA adapters' stacked ``a`` (L, d_in, r) and ``b`` (L, r, d_out)
  unstack into each block's adapter, in JAX's layout;
- the encoders' trees (``models/umt5.py``, ``clip.py``, ``xlm_roberta.py``)
  walk the same way: UMT5's and CLIP's stacked ``blocks`` unstack,
  XLM-R's block list maps index by index, and XLM-R's bare head matrices
  (in, out) become the head linears' (out, in) weights;
- quantized projections (``ops/quant.py``) map key by key onto the
  port's leaf, which must already be there (quantize the port model in
  the same mode first): ``kernel_q`` (in, out) int8 becomes ``weight_q``
  (out, in), ``kernel_q4`` (in_pad/2, out) becomes ``packed`` (out,
  in_pad/2), ``kernel_scale``, ``kernel_scale4`` (g, out), ``kernel_lut4``
  (15,) and ``kernel_scale8`` are copied as they are into
  ``weight_scale``, ``scales``, ``table`` and ``scale8``; a uniform-grid
  int4 leaf (no ``kernel_lut4``) gets the table -7..7;
- every other leaf is copied by name.

Every parameter and buffer of the module must be written exactly once,
else it raises.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from chronoedit_tpu_torch.models.clip import CLIPVision
from chronoedit_tpu_torch.models.dit import DiT
from chronoedit_tpu_torch.models.lora import LoRA
from chronoedit_tpu_torch.models.umt5 import UMT5
from chronoedit_tpu_torch.models.vae import VAE
from chronoedit_tpu_torch.models.xlm_roberta import XLMRoberta


def _assign(param: torch.Tensor, value: np.ndarray, path: str, seen: set) -> None:
    value = np.asarray(value)
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"{path}: shape {value.shape} != {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(value, order="C")).to(param.dtype))
    seen.add(id(param))


def _kernel_to_weight(kernel: np.ndarray) -> np.ndarray:
    kernel = np.asarray(kernel)
    if kernel.ndim == 2:  # (in, out) -> (out, in)
        return kernel.T
    if kernel.ndim == 5:  # (kt, kh, kw, cin, cout) -> (cout, cin, kt, kh, kw)
        return kernel.transpose(4, 3, 0, 1, 2)
    raise ValueError(f"unexpected kernel rank {kernel.ndim}")


# quantized leaves: JAX key -> (the port leaf's buffer, transposed?)
_QUANT_KEYS = {
    "kernel_q": ("weight_q", True), "kernel_scale": ("weight_scale", False),
    "kernel_q4": ("packed", True), "kernel_scale4": ("scales", False),
    "kernel_lut4": ("table", False), "kernel_scale8": ("scale8", False),
}


def _load(module: nn.Module, tree: Any, path: str, seen: set) -> None:
    if isinstance(tree, (list, tuple)):
        if len(tree) != len(module):
            raise ValueError(f"{path}: {len(tree)} entries != {len(module)}")
        for i, sub in enumerate(tree):
            _load(module[i], sub, f"{path}[{i}]", seen)
        return
    if "kernel_q4" in tree and "kernel_lut4" not in tree:  # the uniform grid
        tree = dict(tree, kernel_lut4=np.arange(-7, 8, dtype=np.float32))
    for key, val in tree.items():
        sub_path = f"{path}.{key}" if path else key
        if key == "kernel":
            _assign(module.weight, _kernel_to_weight(val), sub_path, seen)
        elif key in _QUANT_KEYS:
            name, transpose = _QUANT_KEYS[key]
            target = getattr(module, name, None)
            if target is None:
                raise ValueError(f"{sub_path}: the JAX leaf is quantized but the port's "
                                 f"{type(module).__name__} has no {name}: quantize the port "
                                 "model in the same mode first")
            _assign(target, np.asarray(val).T if transpose else val, sub_path, seen)
        elif isinstance(val, (dict, list, tuple)):
            _load(getattr(module, key), val, sub_path, seen)
        else:
            _assign(getattr(module, key), val, sub_path, seen)


def _check_complete(module: nn.Module, seen: set) -> None:
    missing = [n for n, p in [*module.named_parameters(), *module.named_buffers()]
               if id(p) not in seen]
    if missing:
        raise ValueError(f"parameters not set from the JAX tree: {missing[:8]}")


def _load_stacked(model: nn.Module, params: dict) -> nn.Module:
    """A tree whose ``blocks`` leaves carry a leading layer axis."""
    seen: set = set()
    blocks = params["blocks"]
    for i, blk in enumerate(model.blocks):
        layer = _map_tree(lambda a, i=i: np.asarray(a)[i], blocks)
        _load(blk, layer, f"blocks[{i}]", seen)
    _load(model, {k: v for k, v in params.items() if k != "blocks"}, "", seen)
    _check_complete(model, seen)
    return model


def load_dit(model: DiT, params: dict) -> DiT:
    """Copy a numpy-converted JAX DiT tree into ``model``; returns it."""
    return _load_stacked(model, params)


def load_umt5(model: UMT5, params: dict) -> UMT5:
    """Copy a numpy-converted JAX UMT5 tree into ``model``; returns it."""
    return _load_stacked(model, params)


def load_clip(model: CLIPVision, params: dict) -> CLIPVision:
    """Copy a numpy-converted JAX CLIP vision tree into ``model``; returns
    it."""
    return _load_stacked(model, params)


def load_xlm_roberta(model: XLMRoberta, params: dict) -> XLMRoberta:
    """Copy a numpy-converted JAX XLM-R tree into ``model``; returns it."""
    tree = dict(params)
    if "head" in tree:
        tree["head"] = {k: {"kernel": v} for k, v in tree["head"].items()}
    seen: set = set()
    _load(model, tree, "", seen)
    _check_complete(model, seen)
    return model


def load_lora(lora: LoRA, params: dict) -> LoRA:
    """Copy a numpy-converted JAX LoRA tree (``{"blocks": {module: {layer:
    {"a", "b"}}}}``) into ``lora``; returns it."""
    seen: set = set()
    blocks = params["blocks"]
    for i, adapters in enumerate(lora.blocks):
        layer = _map_tree(lambda a, i=i: np.asarray(a)[i], blocks)
        _load(adapters, layer, f"blocks[{i}]", seen)
    _check_complete(lora, seen)
    return lora


def load_vae(vae: VAE, params: dict) -> VAE:
    """Copy a numpy-converted JAX VAE tree into ``vae``; returns it."""
    seen: set = set()
    _load(vae, params, "", seen)
    _check_complete(vae, seen)
    return vae


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)
