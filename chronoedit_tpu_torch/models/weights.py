"""Checkpoint import: the reference's weight files -> the port's modules.

The port of ``chronoedit_tpu/models/weights.py``. Converters for the weight
dialects the reference ships:

- **diffusers DiT**: the public ChronoEdit-14B safetensors shards
  (``blocks.N.attn1.to_q`` ...), and the native WanModel dialect
  (``blocks.N.self_attn.q`` ...);
- **Wan 2.1 VAE**: the ``Wan2.1_VAE.pth`` torch state dict (Sequential
  index names, ``encoder.downsamples.N...``);
- **LoRA dialects**: diffusers (``lora_A`` / ``lora_B``) and musubi
  (``lora_unet_blocks_N_...lora_down`` / ``lora_up``).

Each converter maps reference names straight onto the parameters of a
port module built uninitialised on the target device, and copies tensor
by tensor into each parameter's dtype there: no host fp32 copy of the
whole model (JAX's ``load_torch`` upcasts every tensor, about 66 GB for
the 14B DiT). Every parameter must be written exactly once, else it
raises. PyTorch's ``Linear.weight`` (out, in) is already the port's
layout; the only reshapes are the ones the reference's shapes need:
Conv3d / Conv2d patch embeddings flatten to (out, in * kernel), the
(1, n, dim) modulation tables drop their leading 1, a Conv2d gains a unit
time axis and the VAE's (dim, 1, 1, 1) RMS gains flatten.

A pipeline stage loads only its blocks (``layers=`` of the DiT and LoRA
converters): the other blocks' tensors are left in their files, unread
(``SafetensorsFiles.bytes_read`` counts what was). An FSDP rank
(``convert_diffusers_dit(..., mesh=)`` with an fsdp axis), and a tensor
rank (a tensor axis: its columns or rows of each block projection),
builds the DiT at its shard shapes and reads from each tensor only its
slice (``get_slice``; a slice of the in-dimension of an (out, in) tensor
is a strided read), so the whole model never exists on one rank.

The name tables are module-level data (``DIFFUSERS_DIT``,
``NATIVE_DIT``, ``LORA_NAMES``, ``MUSUBI_NAMES``, ...) expanded per layer
by :func:`diffusers_dit_names`, :func:`native_dit_names` and
:func:`wan_vae_names`, which tests invert to write reference files.
"""

from __future__ import annotations

import math
from collections import Counter
from collections.abc import Iterable, Mapping
from contextlib import ExitStack

import torch
from torch import nn

from chronoedit_tpu_torch.models import lora as lora_lib
from chronoedit_tpu_torch.models.dit import DiT, DiTConfig
from chronoedit_tpu_torch.models.vae import VAE, VAEConfig

StateDict = Mapping[str, torch.Tensor]


# ----------------------------------------------------------------- loading

def load_torch(path: str) -> dict[str, torch.Tensor]:
    """A torch ``.pth`` state dict, memory-mapped: each tensor is read from
    the file, in the file's dtype, when it is copied."""
    sd = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v if torch.is_tensor(v) else torch.as_tensor(v) for k, v in sd.items()}


class SafetensorsFiles(Mapping):
    """The tensors of one or more safetensors files (bf16 included), in
    file order, each read from its memory-mapped file, in the file's dtype,
    when it is looked up (a key test reads nothing). ``bytes_read`` counts
    the bytes of the tensors looked up; :meth:`nbytes` gives a tensor's
    from the file's header, without reading it. The files stay open until
    :meth:`close` (or the end of a ``with`` block)."""

    def __init__(self, paths: Iterable[str]):
        from safetensors import safe_open

        self._stack = ExitStack()
        self._where = {}
        self.bytes_read = 0
        for p in paths:
            f = self._stack.enter_context(safe_open(p, framework="pt"))
            self._where.update(dict.fromkeys(f.keys(), f))

    def __getitem__(self, key: str) -> torch.Tensor:
        t = self._where[key].get_tensor(key)
        self.bytes_read += t.numel() * t.element_size()
        return t

    def nbytes(self, key: str) -> int:
        """The bytes of tensor ``key``, from its file's header."""
        view = self._where[key].get_slice(key)
        return math.prod(view.get_shape()) * _SAFETENSORS_BYTES[view.get_dtype()]

    def get_slice(self, key: str) -> "_CountedSlice":
        """Tensor ``key`` unread: its ``shape``, and indexing it with
        slices reads (and counts) only that part of the file."""
        return _CountedSlice(self, self._where[key].get_slice(key))

    def __contains__(self, key) -> bool:  # Mapping's would read the tensor
        return key in self._where

    def __iter__(self):
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)

    def close(self) -> None:
        self._stack.close()

    def __enter__(self) -> "SafetensorsFiles":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _CountedSlice:
    def __init__(self, files: SafetensorsFiles, view):
        self._files, self._view = files, view
        self.shape = tuple(view.get_shape())

    def __getitem__(self, index) -> torch.Tensor:
        t = self._view[index]
        self._files.bytes_read += t.numel() * t.element_size()
        return t


_SAFETENSORS_BYTES = {"F64": 8, "F32": 4, "F16": 2, "BF16": 2, "I64": 8, "I32": 4, "I16": 2,
                      "I8": 1, "U8": 1, "BOOL": 1, "F8_E4M3": 1, "F8_E5M2": 1}


def block_index(key: str) -> int | None:
    """The block index of a ``blocks.N....`` name, else None."""
    if not key.startswith("blocks."):
        return None
    return int(key.split(".", 2)[1])


def _stage_view(sd: StateDict, num_layers: int, layers: range | None) -> StateDict:
    """``sd`` without the tensors of the model's blocks outside ``layers``
    (a pipeline stage's), which are never read; blocks past the model's
    ``num_layers`` stay, so that a checkpoint deeper than the config still
    fails as unconsumed."""
    if layers is None:
        return sd
    keep = [k for k in sd if (i := block_index(k)) is None or i in layers or i >= num_layers]
    return _View(sd, dict(zip(keep, keep)))


def load_safetensors(paths: str | Iterable[str]) -> SafetensorsFiles:
    """The tensors of one safetensors file or several shards, read lazily."""
    return SafetensorsFiles([paths] if isinstance(paths, str) else list(paths))


# ----------------------------------------------------------------- filling

def _reshapes_to(src: tuple, dst: tuple) -> bool:
    """The reshapes a reference tensor may need: equal after dropping unit
    axes, or a conv kernel (out, in, k...) flattened to (out, in * k)."""
    if [d for d in src if d != 1] == [d for d in dst if d != 1]:
        return True
    return (len(dst) == 2 and len(src) > 2 and src[0] == dst[0]
            and math.prod(src) == math.prod(dst))


def copy_into(param: torch.Tensor, value: torch.Tensor, name: str) -> None:
    """Copy ``value`` into ``param`` (its device and dtype), reshaped where
    the reference's shape needs it (:func:`_reshapes_to`)."""
    if tuple(value.shape) != tuple(param.shape):
        if not _reshapes_to(tuple(value.shape), tuple(param.shape)):
            raise ValueError(f"{name}: shape {tuple(value.shape)} does not fit "
                             f"{tuple(param.shape)}")
        value = value.reshape(param.shape)
    with torch.no_grad():
        param.copy_(value)


def read_shard(sd: StateDict, ref: str, shape: tuple[int, ...],
               splits: Iterable[tuple[int, int, int]]) -> torch.Tensor:
    """This rank's block of the reference tensor ``ref``, which the port
    holds whole at ``shape``: ``splits`` lists (dim, index, size), each
    taking block ``index`` of ``size`` along ``dim`` of what the ones
    before it left (a tensor rank's slice, then its fsdp slice of that).
    Only the block is read, through ``sd.get_slice`` (a mapping without it
    raises): the file's tensor may carry unit axes that the port drops, or
    be a conv kernel (out, in, k...) that the port flattens to (out, in *
    k), whose in-dimension block is read in the whole input channels that
    hold it."""
    start, size = [0] * len(shape), list(shape)
    for dim, index, n in splits:
        size[dim] //= n
        start[dim] += index * size[dim]
    view = sd.get_slice(ref)
    src = tuple(view.shape)
    if len(shape) == 2 and len(src) > 2 and src[0] == shape[0]:  # a flattened conv kernel
        k = math.prod(src[2:])
        lo, hi = start[1] // k, -(-(start[1] + size[1]) // k)
        block = view[(slice(start[0], start[0] + size[0]), slice(lo, hi),
                      *[slice(None)] * (len(src) - 2))]
        return block.reshape(size[0], (hi - lo) * k).narrow(1, start[1] - lo * k, size[1])
    # the same axes but for unit ones
    fdims = [i for i, d in enumerate(src) if d != 1]
    pdims = [i for i, d in enumerate(shape) if d != 1]
    index = [slice(None)] * len(src)
    for d in range(len(shape)):
        if size[d] != shape[d]:
            index[fdims[pdims.index(d)]] = slice(start[d], start[d] + size[d])
    return view[tuple(index)].reshape(size)


def fill_module(module: nn.Module, sd: StateDict, names: Mapping[str, str],
                strict: bool = True, ignore: tuple[str, ...] = (),
                shards: Iterable = ()) -> nn.Module:
    """Write ``module``'s parameters from ``sd`` by ``names`` ({reference
    name: parameter name}), in ``sd``'s order (file by file, front to back);
    every parameter exactly once. With ``strict``, a reference key that no
    name consumes raises unless it ends with one of ``ignore``. With
    ``shards`` (``parallel.sharding.Shards`` or None, outer axis first: the
    module is built at this rank's shard shapes) a split parameter takes
    its block of the reference tensor (:func:`read_shard`). Returns the
    module."""
    shards = [s for s in shards if s is not None]
    params = dict(module.named_parameters())
    for ref, name in names.items():
        if name not in params:
            raise ValueError(f"{ref}: the module has no parameter {name}")
        if ref not in sd:
            raise ValueError(f"{ref} is missing from the checkpoint (for {name})")
    counts = Counter(names.values())
    twice = [n for n, c in counts.items() if c > 1]
    missing = [n for n in params if n not in counts]
    if twice or missing:
        raise ValueError(f"parameters written twice {sorted(twice)[:8]} or not in the "
                         f"checkpoint {missing[:8]}")
    leftovers = [k for k in sd if k not in names and not k.endswith(ignore)]
    if strict and leftovers:
        raise ValueError(f"unconsumed checkpoint keys: {leftovers[:8]}...")
    for ref in sd:
        if ref not in names:
            continue
        name = names[ref]
        splits = [(s.dims[name], s.index, s.size) for s in shards
                  if s.dims.get(name) is not None]
        if not splits:
            copy_into(params[name], sd[ref], ref)
            continue
        shape = list(params[name].shape)
        for dim, _, n in splits:
            shape[dim] *= n
        copy_into(params[name], read_shard(sd, ref, tuple(shape), splits), ref)
    return module


class _View(Mapping):
    """``sd`` under other names ({name: the name in ``sd``}), without
    reading any tensor."""

    def __init__(self, sd: StateDict, names: Mapping[str, str]):
        self._sd, self._names = sd, names

    def __getitem__(self, key):
        return self._sd[self._names[key]]

    def __contains__(self, key) -> bool:
        return key in self._names

    def get_slice(self, key):
        return self._sd.get_slice(self._names[key])

    def __iter__(self):
        return iter(self._names)

    def __len__(self):
        return len(self._names)


def _renamed(sd: StateDict, prefixes: tuple[str, ...]) -> _View:
    """``sd`` under JAX's prefix handling: each prefix that some key carries
    is dropped from every key that carries it, in order."""
    names = {k: k for k in sd}
    for prefix in prefixes:
        if any(k.startswith(prefix) for k in names):
            names = {k[len(prefix):] if k.startswith(prefix) else k: v
                     for k, v in names.items()}
    return _View(sd, names)


def _linears(table: Mapping[str, str]) -> dict[str, str]:
    """{module: module} of linear layers -> their weight and bias names."""
    return {f"{r}.{s}": f"{p}.{s}" for r, p in table.items() for s in ("weight", "bias")}


# ----------------------------------------------------------------- DiT

# diffusers ChronoEditTransformer3DModel: linears (weight, bias), then the
# rest by parameter; "{i}" is the block index
DIFFUSERS_DIT = {
    **_linears({"patch_embedding": "patch_embed",
                "condition_embedder.time_embedder.linear_1": "time_embed.fc1",
                "condition_embedder.time_embedder.linear_2": "time_embed.fc2",
                "condition_embedder.time_proj": "time_proj",
                "condition_embedder.text_embedder.linear_1": "text_embed.fc1",
                "condition_embedder.text_embedder.linear_2": "text_embed.fc2",
                "proj_out": "head.proj"}),
    "scale_shift_table": "head.scale_shift_table",
}
DIFFUSERS_DIT_IMAGE = {
    **_linears({"condition_embedder.image_embedder.ff.net.0.proj": "img_embed.fc1",
                "condition_embedder.image_embedder.ff.net.2": "img_embed.fc2"}),
    "condition_embedder.image_embedder.norm1.weight": "img_embed.norm1.scale",
    "condition_embedder.image_embedder.norm1.bias": "img_embed.norm1.bias",
    "condition_embedder.image_embedder.norm2.weight": "img_embed.norm2.scale",
    "condition_embedder.image_embedder.norm2.bias": "img_embed.norm2.bias",
}
DIFFUSERS_DIT_BLOCK = {
    "blocks.{i}.scale_shift_table": "blocks.{i}.scale_shift_table",
    **_linears({f"blocks.{{i}}.{r}": f"blocks.{{i}}.{p}" for r, p in {
        "attn1.to_q": "self_attn.q", "attn1.to_k": "self_attn.k",
        "attn1.to_v": "self_attn.v", "attn1.to_out.0": "self_attn.o",
        "attn2.to_q": "cross_attn.q", "attn2.to_k": "cross_attn.k",
        "attn2.to_v": "cross_attn.v", "attn2.to_out.0": "cross_attn.o",
        "ffn.net.0.proj": "ffn.fc1", "ffn.net.2": "ffn.fc2"}.items()}),
    "blocks.{i}.attn1.norm_q.weight": "blocks.{i}.self_attn.q_norm.scale",
    "blocks.{i}.attn1.norm_k.weight": "blocks.{i}.self_attn.k_norm.scale",
    "blocks.{i}.attn2.norm_q.weight": "blocks.{i}.cross_attn.q_norm.scale",
    "blocks.{i}.attn2.norm_k.weight": "blocks.{i}.cross_attn.k_norm.scale",
    "blocks.{i}.norm2.weight": "blocks.{i}.norm2.scale",
    "blocks.{i}.norm2.bias": "blocks.{i}.norm2.bias",
}
DIFFUSERS_DIT_BLOCK_IMAGE = {
    **_linears({"blocks.{i}.attn2.add_k_proj": "blocks.{i}.cross_attn.k_img",
                "blocks.{i}.attn2.add_v_proj": "blocks.{i}.cross_attn.v_img"}),
    "blocks.{i}.attn2.norm_added_k.weight": "blocks.{i}.cross_attn.k_img_norm.scale",
}

# the native WanModel dialect (wan2pt1.py names); native norm3 is the
# cross-attention norm, the port's norm2
NATIVE_DIT = {
    **_linears({"patch_embedding": "patch_embed", "time_embedding.0": "time_embed.fc1",
                "time_embedding.2": "time_embed.fc2", "time_projection.1": "time_proj",
                "text_embedding.0": "text_embed.fc1", "text_embedding.2": "text_embed.fc2",
                "head.head": "head.proj"}),
    "head.modulation": "head.scale_shift_table",
}
NATIVE_DIT_IMAGE = {
    **_linears({"img_emb.proj.1": "img_embed.fc1", "img_emb.proj.3": "img_embed.fc2"}),
    "img_emb.proj.0.weight": "img_embed.norm1.scale", "img_emb.proj.0.bias": "img_embed.norm1.bias",
    "img_emb.proj.4.weight": "img_embed.norm2.scale", "img_emb.proj.4.bias": "img_embed.norm2.bias",
}
NATIVE_DIT_BLOCK = {
    "blocks.{i}.modulation": "blocks.{i}.scale_shift_table",
    **_linears({f"blocks.{{i}}.{r}": f"blocks.{{i}}.{p}" for r, p in {
        "self_attn.q": "self_attn.q", "self_attn.k": "self_attn.k",
        "self_attn.v": "self_attn.v", "self_attn.o": "self_attn.o",
        "cross_attn.q": "cross_attn.q", "cross_attn.k": "cross_attn.k",
        "cross_attn.v": "cross_attn.v", "cross_attn.o": "cross_attn.o",
        "ffn.0": "ffn.fc1", "ffn.2": "ffn.fc2"}.items()}),
    "blocks.{i}.self_attn.norm_q.weight": "blocks.{i}.self_attn.q_norm.scale",
    "blocks.{i}.self_attn.norm_k.weight": "blocks.{i}.self_attn.k_norm.scale",
    "blocks.{i}.cross_attn.norm_q.weight": "blocks.{i}.cross_attn.q_norm.scale",
    "blocks.{i}.cross_attn.norm_k.weight": "blocks.{i}.cross_attn.k_norm.scale",
    "blocks.{i}.norm3.weight": "blocks.{i}.norm2.scale",
    "blocks.{i}.norm3.bias": "blocks.{i}.norm2.bias",
}
NATIVE_DIT_BLOCK_IMAGE = {
    **_linears({"blocks.{i}.cross_attn.k_img": "blocks.{i}.cross_attn.k_img",
                "blocks.{i}.cross_attn.v_img": "blocks.{i}.cross_attn.v_img"}),
    "blocks.{i}.cross_attn.norm_k_img.weight": "blocks.{i}.cross_attn.k_img_norm.scale",
}


def _dit_names(cfg: DiTConfig, top, image, block, block_image,
               layers: range | None = None) -> dict[str, str]:
    names = dict(top)
    if cfg.image_dim is not None:
        names.update(image)
    per_block = {**block, **(block_image if cfg.image_dim is not None else {})}
    layers = range(cfg.num_layers) if layers is None else layers
    for i in layers:
        names.update({r.format(i=i): p.format(i=i - layers.start)
                      for r, p in per_block.items()})
    return names


def diffusers_dit_names(cfg: DiTConfig, layers: range | None = None) -> dict[str, str]:
    """{diffusers name: DiT parameter name} for ``cfg``'s layers, or for
    the blocks of ``layers`` only, as a stage-local DiT names them."""
    return _dit_names(cfg, DIFFUSERS_DIT, DIFFUSERS_DIT_IMAGE, DIFFUSERS_DIT_BLOCK,
                      DIFFUSERS_DIT_BLOCK_IMAGE, layers)


def native_dit_names(cfg: DiTConfig) -> dict[str, str]:
    """{native WanModel name: DiT parameter name} for ``cfg``'s layers."""
    return _dit_names(cfg, NATIVE_DIT, NATIVE_DIT_IMAGE, NATIVE_DIT_BLOCK,
                      NATIVE_DIT_BLOCK_IMAGE)


def convert_diffusers_dit(sd: StateDict, cfg: DiTConfig, device=None,
                          layers: range | None = None, mesh=None) -> DiT:
    """diffusers ChronoEditTransformer3DModel state dict -> a DiT in
    ``cfg.param_dtype`` on ``device``. ``model.diffusion_model.``,
    ``transformer.`` and ``model.`` prefixes are dropped; the unused
    ``norm_added_q`` weights are ignored. With ``layers`` (a pipeline
    stage's, ``parallel.pipeline_parallel.stage_range``) the DiT holds
    those blocks only, and the other blocks' tensors are not read. With a
    ``mesh`` whose tensor or fsdp axis is above 1 the DiT is built at this
    rank's shard shapes (``parallel.sharding.materialize_shards``; placed
    by ``dit_param_sharding``: a tensor rank's columns or rows of each
    block projection, then its fsdp slice of that) and each tensor's slice
    alone is read; with both (a pipe x fsdp mesh) the stage's blocks are
    built at their fsdp shard shapes, and only their slices and the
    non-block tensors' slices are read."""
    from chronoedit_tpu_torch.parallel import sharding

    sd = _stage_view(_renamed(sd, ("model.diffusion_model.", "transformer.", "model.")),
                     cfg.num_layers, layers)
    if mesh is None or (sharding.tensor_degree(mesh) == 1 and mesh.shape.get("fsdp", 1) == 1):
        model = DiT(cfg, device=device, layers=layers)
    else:
        model = sharding.materialize_shards(DiT(cfg, device="meta", layers=layers), mesh,
                                            device)
    return fill_module(model, sd, diffusers_dit_names(cfg, layers),
                       ignore=("norm_added_q.weight",), shards=(model.tensor, model.fsdp))


def export_diffusers_dit(model: DiT) -> dict[str, torch.Tensor]:
    """Inverse of :func:`convert_diffusers_dit`: the model's parameters
    under diffusers names (the patch embedding in its flat (out, in * p)
    form, the modulation tables as (1, n, dim)), on the model's device;
    a stage-local model's blocks under their global indices."""
    return diffusers_dit_state(dict(model.named_parameters()), model.cfg, model.layers)


def diffusers_dit_state(params: Mapping[str, torch.Tensor], cfg: DiTConfig,
                        layers: range | None = None) -> dict[str, torch.Tensor]:
    """{DiT parameter name: tensor} (a model's, or a checkpoint's) -> the
    diffusers state dict :func:`export_diffusers_dit` writes, for ``cfg``'s
    layers (or ``layers``), without building a model."""
    return {ref: (params[name].detach().unsqueeze(0) if ref.endswith("scale_shift_table")
                  else params[name].detach())
            for ref, name in diffusers_dit_names(cfg, layers).items()}


def convert_native_dit(sd: StateDict, cfg: DiTConfig, device=None) -> DiT:
    """Native ("imaginaire") WanModel / EditWanModel state dict -> DiT; the
    ``model.`` / ``net.`` prefixes, the ``accum_*`` training counters and
    the ``._extra_state`` blobs are dropped."""
    sd = _renamed(sd, ("model.", "net."))
    keep = {k: k for k in sd if not k.startswith("accum_") and "._extra_state" not in k}
    return fill_module(DiT(cfg, device=device), _View(sd, keep), native_dit_names(cfg))


# ----------------------------------------------------------------- LoRA

# diffusers module name -> the port's target ("module/layer" in a block)
LORA_NAMES = {
    "attn1.to_q": "self_attn/q", "attn1.to_k": "self_attn/k",
    "attn1.to_v": "self_attn/v", "attn1.to_out.0": "self_attn/o",
    "attn2.to_q": "cross_attn/q", "attn2.to_k": "cross_attn/k",
    "attn2.to_v": "cross_attn/v", "attn2.to_out.0": "cross_attn/o",
    "ffn.net.0.proj": "ffn/fc1", "ffn.net.2": "ffn/fc2",
}
# musubi / non-diffusers module name -> the port's target
MUSUBI_NAMES = {
    "self_attn_q": "self_attn/q", "self_attn_k": "self_attn/k",
    "self_attn_v": "self_attn/v", "self_attn_o": "self_attn/o",
    "cross_attn_q": "cross_attn/q", "cross_attn_k": "cross_attn/k",
    "cross_attn_v": "cross_attn/v", "cross_attn_o": "cross_attn/o",
    "ffn_0": "ffn/fc1", "ffn_2": "ffn/fc2",
}


def convert_diffusers_lora(sd: StateDict, cfg: DiTConfig, device=None,
                           layers: range | None = None) -> tuple[lora_lib.LoRA, float]:
    """diffusers-style LoRA (``blocks.N.<module>.lora_A.weight`` (r, in),
    ``lora_B.weight`` (out, r), optional ``alpha``) -> (adapters in fp32 on
    ``device`` over ``cfg``'s DiT, alpha / rank or 1.0 without alpha). The
    adapters' own scaling is 1: the caller applies the returned one, as
    JAX's loader does. Layers the file leaves out get zero adapters.
    Raises ValueError for an unknown target, and for a state dict with no
    diffusers LoRA key at all (so that a loader can try another dialect;
    JAX's converter returns an empty adapter there). With ``layers`` (a
    pipeline stage's) the adapters cover those blocks only, as a
    stage-local DiT holds them, and the other blocks' tensors are not
    read."""
    sd = _renamed(sd, ("transformer.", "diffusion_model."))
    layers = range(cfg.num_layers) if layers is None else layers
    keys: dict[tuple[str, int], str] = {}
    for key in sd:
        if not key.startswith("blocks.") or "lora_A" not in key:
            continue
        _, idx, rest = key.split(".", 2)
        mod = rest[: rest.index(".lora_A")]
        if mod not in LORA_NAMES:
            raise ValueError(f"unknown LoRA target module {mod!r}")
        keys[(LORA_NAMES[mod], int(idx))] = key
    if not keys:
        raise ValueError("no diffusers LoRA keys (blocks.N.<module>.lora_A.weight)")
    found: dict[tuple[str, int], tuple[torch.Tensor, torch.Tensor]] = {}
    alpha = None
    for (target, i), key in keys.items():
        if i not in layers and i < cfg.num_layers:
            continue
        alpha_key = key.replace("lora_A.weight", "alpha")
        if alpha_key in sd:
            alpha = float(sd[alpha_key])
        found[(target, i)] = (sd[key], sd[key.replace("lora_A", "lora_B")])
    # a stage whose blocks the file leaves out reads one other block's rank
    rank = (next(reversed(found.values()))[0] if found
            else sd[next(reversed(keys.values()))]).shape[0]
    present = {target for target, _ in keys}
    targets = tuple(t for t in lora_lib.DEFAULT_TARGETS if t in present)
    lcfg = lora_lib.LoRAConfig(rank=rank, alpha=float(rank), targets=targets)
    lora = lora_lib.LoRA(DiT(cfg, device="meta", layers=layers), lcfg, device=device)
    for (target, i), (a, b) in found.items():
        module, layer = target.split("/")
        ad = lora.blocks[i - layers.start][module][layer]
        copy_into(ad.a, a.T, f"blocks.{i}.{target} lora_A")
        copy_into(ad.b, b.T, f"blocks.{i}.{target} lora_B")
    scaling = (alpha / rank) if (alpha and rank) else 1.0
    return lora, scaling


def export_diffusers_lora(lora: lora_lib.LoRA, alpha: float | None = None
                          ) -> dict[str, torch.Tensor]:
    """Adapters -> diffusers-dialect LoRA state dict (inverse of
    :func:`convert_diffusers_lora`), every layer of every target."""
    inv = {v: k for k, v in LORA_NAMES.items()}
    sd: dict[str, torch.Tensor] = {}
    for target in lora.cfg.targets:
        module, layer = target.split("/")
        for i, blk in enumerate(lora.blocks):
            ad = blk[module][layer]
            prefix = f"transformer.blocks.{i}.{inv[target]}"
            sd[f"{prefix}.lora_A.weight"] = ad.a.detach().T.contiguous()
            sd[f"{prefix}.lora_B.weight"] = ad.b.detach().T.contiguous()
            if alpha is not None:
                sd[f"{prefix}.alpha"] = torch.tensor(alpha, dtype=torch.float32)
    return sd


def convert_musubi_lora(sd: StateDict, cfg: DiTConfig, device=None,
                        layers: range | None = None) -> tuple[lora_lib.LoRA, float]:
    """musubi-tuner dialect: ``lora_unet_blocks_{i}_{module}.lora_down.weight``
    / ``lora_up.weight`` renamed to the diffusers dialect, then
    :func:`convert_diffusers_lora` (``layers`` as there)."""
    inv = {v: k for k, v in LORA_NAMES.items()}
    keep = {}
    for key in sd:
        if not key.startswith("lora_unet_blocks_"):
            continue
        idx, modkey = key[len("lora_unet_blocks_"):].split("_", 1)
        name, suffix = modkey.split(".", 1)
        if name not in MUSUBI_NAMES:
            raise ValueError(f"unknown musubi LoRA target {name!r}")
        suffix = suffix.replace("lora_down", "lora_A").replace("lora_up", "lora_B")
        keep[f"blocks.{idx}.{inv[MUSUBI_NAMES[name]]}.{suffix}"] = key
    return convert_diffusers_lora(_View(sd, keep), cfg, device, layers)


# ----------------------------------------------------------------- VAE

def wan_vae_names(cfg: VAEConfig) -> dict[str, str]:
    """{Wan2.1_VAE.pth name: VAE parameter name} for ``cfg``: the
    reference's Sequential indices (tokenizers/wan2pt1.py Encoder3d /
    Decoder3d) walked as JAX's ``convert_wan_vae`` walks them."""
    vae = VAE(cfg, device="meta")
    names: dict[str, str] = {}

    def conv(ref, port):
        names.update({f"{ref}.weight": f"{port}.weight", f"{ref}.bias": f"{port}.bias"})

    def rms(ref, port):
        names[f"{ref}.gamma"] = f"{port}.gamma"

    def res(ref, port, block):
        rms(f"{ref}.residual.0", f"{port}.norm1")
        conv(f"{ref}.residual.2", f"{port}.conv1")
        rms(f"{ref}.residual.3", f"{port}.norm2")
        conv(f"{ref}.residual.6", f"{port}.conv2")
        if hasattr(block, "shortcut"):
            conv(f"{ref}.shortcut", f"{port}.shortcut")

    def mid(ref, port):
        res(f"{ref}.middle.0", f"{port}.mid.res1", getattr(vae, port).mid.res1)
        rms(f"{ref}.middle.1.norm", f"{port}.mid.attn.norm")
        conv(f"{ref}.middle.1.to_qkv", f"{port}.mid.attn.qkv")
        conv(f"{ref}.middle.1.proj", f"{port}.mid.attn.proj")
        res(f"{ref}.middle.2", f"{port}.mid.res2", getattr(vae, port).mid.res2)
        rms(f"{ref}.head.0", f"{port}.head_norm")
        conv(f"{ref}.head.2", f"{port}.head_conv")

    conv("encoder.conv1", "encoder.conv_in")
    idx = 0
    for i, stage in enumerate(vae.encoder.stages):
        for j, blk in enumerate(stage.blocks):
            res(f"encoder.downsamples.{idx}", f"encoder.stages.{i}.blocks.{j}", blk)
            idx += 1
        if hasattr(stage, "down"):
            conv(f"encoder.downsamples.{idx}.resample.1", f"encoder.stages.{i}.down")
            if hasattr(stage, "time_down"):
                conv(f"encoder.downsamples.{idx}.time_conv", f"encoder.stages.{i}.time_down")
            idx += 1
    mid("encoder", "encoder")
    conv("decoder.conv1", "decoder.conv_in")
    idx = 0
    for i, stage in enumerate(vae.decoder.stages):
        for j, blk in enumerate(stage.blocks):
            res(f"decoder.upsamples.{idx}", f"decoder.stages.{i}.blocks.{j}", blk)
            idx += 1
        if hasattr(stage, "up"):
            if hasattr(stage, "time_up"):
                conv(f"decoder.upsamples.{idx}.time_conv", f"decoder.stages.{i}.time_up")
            conv(f"decoder.upsamples.{idx}.resample.1", f"decoder.stages.{i}.up")
            idx += 1
    mid("decoder", "decoder")
    conv("conv1", "quant_conv")
    conv("conv2", "post_quant_conv")
    return names


def convert_wan_vae(sd: StateDict, cfg: VAEConfig, device=None) -> VAE:
    """Wan2.1_VAE.pth state dict -> a VAE in ``cfg.param_dtype`` on
    ``device``."""
    return fill_module(VAE(cfg, device=device), sd, wan_vae_names(cfg))

