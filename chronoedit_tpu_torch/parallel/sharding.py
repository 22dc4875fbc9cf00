"""The DiT's parameters sharded over a mesh's ``tensor`` and ``fsdp`` axes.

The port of ``chronoedit_tpu/parallel/sharding.py``. JAX declares a
``PartitionSpec`` per leaf and lets XLA insert the collectives; the port
keeps each rank's slice of every leaf in the model itself:

- :func:`dit_param_sharding`: JAX's placement rule, a (tensor, fsdp)
  dimension per leaf (:class:`Spec`). ``tensor`` first, Megatron's layout
  of the blocks (:func:`tensor_dim`): q / k / v of both attentions,
  k_img / v_img and fc1 column-split (their weights' out-dimension, their
  biases and per-output scales), o of both attentions and fc2 row-split
  (their in-dimension; biases and per-output scales whole), everything
  else whole. Then ``fsdp`` (:func:`fsdp_dim`): the largest remaining
  dimension that the fsdp degree divides, ties going to the earlier one;
  never the stacked layer axis of a block leaf, never ``kernel_q4``'s
  packed in-axis; whole on every rank when none qualifies. The rule is
  decided in JAX's layout and mapped back through ``models/from_jax.py``'s
  transposition: a port ``weight`` (and ``weight_q``, ``packed``) is (out,
  in) where JAX's kernel is (in, out), and a block's leaves carry no
  stacked axis. On the port's own shapes the fsdp rule would pick the
  out-dimension of every square projection, where JAX picks the
  in-dimension.
- :func:`shard_params` keeps this rank's slice of every leaf of a whole
  model (contiguous, in place): its tensor slice, then its fsdp slice of
  that; the plans are recorded in ``model.tensor`` and ``model.fsdp``
  (:class:`Shards`, one an axis), and :func:`local_box` places a rank's
  block in the whole leaf (a sharded checkpoint's layout). A row-split int4 leaf is not a slice of
  the packed bytes: it holds its contiguous rows repacked
  (``ops/quant.int4_rows``). :func:`materialize_shards` makes a model
  built on ``meta`` shard-shaped on a device, for a loader that reads only
  its slices (``models/weights.py``). :func:`param_spec_tree` maps every
  parameter and buffer name to its :class:`Spec`.
- :class:`Gather`: a context manager over one module at a time (a block,
  an embedder, the head) that puts the fsdp-gathered leaves in place of
  the shards for its duration, through ``collectives.gather_shard_autograd``
  (over the fsdp group: a tensor x fsdp rank gathers inside its own tensor
  slice): the gradient lands in the shard parameters. When each rank ran
  its own part of the batch the backward sums the ranks' partial
  gradients (reduce-scatter, and an all-reduce for a leaf that is whole);
  when every rank ran the whole batch it takes this rank's slice of the
  one gradient (always under a pipe axis, :func:`fsdp_gather`).
- Under a pipe axis the model is a stage's (``DiT(layers=)``): the plans
  are keyed by the local block index, as the model names its blocks, and
  each of the stage's block leaves is split over the stage's fsdp group by
  the same rule (``fsdp_dim`` never reads the block's index). A rank
  holds 1 / (pipe x fsdp) of the blocks; JAX holds every block's fsdp
  shard on every pipe rank and gathers the stage's whole at the
  pipeline's entry. Make the stage first (``DiT.keep_layers``), then
  shard.
- :func:`tensor_plan`: how ``dit_forward`` runs a model split over the
  tensor axis (the group, this rank's index, the degree); the block's
  column / row products and their collectives are ``models/dit.py``'s.
  Under a pipe axis the stages hold their blocks whole over ``tensor``
  (JAX's ``gpipe_scan`` replicates it and warns), so nothing splits.

JAX's ``replicate`` has no counterpart: every rank holds its own whole
VAE and encoders.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterator, NamedTuple

import torch
from torch import nn

from chronoedit_tpu_torch.parallel import collectives as C
from chronoedit_tpu_torch.parallel.mesh import AXIS_FSDP, AXIS_PIPE, AXIS_TENSOR

# port leaves stored transposed against JAX's: (out, in) for (in, out)
_TRANSPOSED = ("weight", "weight_q", "packed")
# Megatron's layout of a block's projections, (module, layer): JAX's
# ``_TP_COL`` (with ``_TP_COL_BIAS``) and ``_TP_ROW``
TP_COL = (("self_attn", "q"), ("self_attn", "k"), ("self_attn", "v"),
          ("cross_attn", "q"), ("cross_attn", "k"), ("cross_attn", "v"),
          ("cross_attn", "k_img"), ("cross_attn", "v_img"), ("ffn", "fc1"))
TP_ROW = (("self_attn", "o"), ("cross_attn", "o"), ("ffn", "fc2"))


class Spec(NamedTuple):
    """A leaf's placement: the port dimension split over ``tensor`` and the
    one split over ``fsdp`` (None: whole along that axis)."""

    tensor: int | None
    fsdp: int | None


def tp_kind(name: str) -> str | None:
    """"col" or "row" for a leaf of a block projection that tensor
    parallelism splits (``blocks.N.<module>.<layer>.<leaf>``), else None."""
    parts = name.split(".")
    if len(parts) < 5 or parts[0] != "blocks":
        return None
    key = (parts[-3], parts[-2])
    return "col" if key in TP_COL else "row" if key in TP_ROW else None


def tensor_dim(name: str, shape: tuple[int, ...], tp: int, guard: bool = True) -> int | None:
    """The dimension of the port leaf ``name`` (of the whole model's
    ``shape``) that JAX's ``dit_param_sharding`` splits over ``tp`` tensor
    ranks, or None (whole). A column-split layer splits JAX's d_out (the
    weight's dim 0), its bias, ``weight_scale`` and ``scale8`` (per output)
    and its int4 ``scales``' output axis (dim 1); a row-split layer splits
    JAX's d_in (dim 1 of ``weight``, ``weight_q`` and ``packed``) and its
    ``scales``' group axis (dim 0), and keeps its bias and per-output
    scales whole. JAX splits a row layer's packed in-axis and its group
    axis only where ``tp`` divides them (``guard``; the port's own split of
    an int4 row leaf, whole 128-row groups a rank, always does)."""
    kind = tp_kind(name)
    if tp == 1 or kind is None:
        return None
    leaf = name.rsplit(".", 1)[-1]
    if kind == "col":
        return {"weight": 0, "weight_q": 0, "packed": 0, "bias": 0, "weight_scale": 0,
                "scale8": 0, "scales": 1}.get(leaf)
    if leaf in ("weight", "weight_q"):
        return 1
    if leaf == "packed":
        return 1 if not guard or shape[1] % tp == 0 else None
    if leaf == "scales":
        return 0 if not guard or shape[0] % tp == 0 else None
    return None


def fsdp_dim(name: str, shape: tuple[int, ...], fsdp: int,
             taken: int | None = None) -> int | None:
    """The dimension of the port leaf ``name`` (of ``shape``) that JAX's
    ``dit_param_sharding`` splits over ``fsdp`` ranks, or None (whole);
    ``taken`` is the dimension tensor parallelism already split, which
    fsdp leaves alone. JAX's block leaves carry a leading stacked axis that
    the rule never takes; the port's have none, so it does not enter the
    choice. The other dimensions have the same size in the whole leaf and
    in a tensor rank's, so the rule reads either."""
    leaf = name.rsplit(".", 1)[-1]
    axes = list(range(len(shape)))  # the port's dims in JAX's axis order
    if leaf in _TRANSPOSED and len(shape) == 2:
        axes.reverse()
    jax_shape = [shape[d] for d in axes]
    # a stable sort: ties go to the earlier axis
    for i in sorted(range(len(jax_shape)), key=lambda i: -jax_shape[i]):
        if axes[i] == taken or jax_shape[i] % fsdp or jax_shape[i] < fsdp:
            continue
        if leaf == "packed" and i == len(jax_shape) - 2:
            continue  # kernel_q4's packed in-axis
        return axes[i]
    return None


def leaf_spec(name: str, shape: tuple[int, ...], tp: int, fsdp: int) -> Spec:
    """JAX's placement of one leaf of the whole model: tensor first, then
    fsdp on what is left."""
    t = tensor_dim(name, shape, tp)
    return Spec(t, None if fsdp == 1 else fsdp_dim(name, shape, fsdp, t))


def dit_param_sharding(mesh) -> Callable[[str, torch.Tensor], Spec]:
    """JAX's placement for ``mesh`` as JAX names it: a function of (leaf
    name, whole tensor) giving its :class:`Spec`, the dimensions split over
    ``tensor`` and over ``fsdp`` (:func:`leaf_spec`)."""
    tp, fsdp = mesh.shape.get(AXIS_TENSOR, 1), mesh.shape.get(AXIS_FSDP, 1)
    return lambda name, leaf: leaf_spec(name, tuple(leaf.shape), tp, fsdp)


def _slots(module: nn.Module, prefix: str = "") -> Iterator[tuple[str, nn.Module, str, bool]]:
    """(full name, owning module, attribute, is a parameter) of every
    parameter and buffer under ``module`` (None buffers left out)."""
    for mod_name, mod in module.named_modules(prefix=prefix):
        for attr, t in list(mod._parameters.items()) + list(mod._buffers.items()):
            if t is not None:
                yield (f"{mod_name}.{attr}" if mod_name else attr, mod, attr,
                       attr in mod._parameters)


def _get(mod: nn.Module, attr: str, is_param: bool) -> torch.Tensor:
    return (mod._parameters if is_param else mod._buffers)[attr]


def _set(mod: nn.Module, attr: str, is_param: bool, t: torch.Tensor) -> None:
    """Put ``t`` in the slot as it is (a gathered tensor in a parameter's
    slot for a forward: ``nn.Module.__setattr__`` would refuse it)."""
    (mod._parameters if is_param else mod._buffers)[attr] = t


def _specs(model: nn.Module, tp: int, fsdp: int) -> dict[str, Spec]:
    return {name: leaf_spec(name, tuple(_get(mod, attr, p).shape), tp, fsdp)
            for name, mod, attr, p in _slots(model)}


def param_spec_tree(model: nn.Module, mesh) -> dict[str, Spec]:
    """{parameter or buffer name: its :class:`Spec`} for a whole model
    (JAX's spec tree; :func:`leaf_spec` for each leaf)."""
    return _specs(model, mesh.shape.get(AXIS_TENSOR, 1), mesh.shape.get(AXIS_FSDP, 1))


@dataclasses.dataclass
class Shards:
    """How a model is split over ``size`` ranks of one axis: this rank's
    ``index`` and each leaf's dimension (None: whole on every rank).
    ``model.tensor`` and ``model.fsdp`` hold one each; None there means
    whole along that axis."""

    size: int
    index: int
    dims: dict[str, int | None]

    def local(self, t: torch.Tensor, dim: int | None) -> torch.Tensor:
        """This rank's block of the whole ``t`` along ``dim`` (a view)."""
        if dim is None:
            return t
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.index * n, n)

    def shape(self, shape: tuple[int, ...], dim: int | None) -> tuple[int, ...]:
        """The shard shape of a leaf of the whole ``shape``."""
        if dim is None:
            return tuple(shape)
        return tuple(n // self.size if d == dim else n for d, n in enumerate(shape))


def local_of(model: nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
    """This rank's slice of ``t``, the whole value of the float leaf
    ``name`` of the sharded ``model``: its tensor block, then its fsdp
    block of that (a view)."""
    for shards in (getattr(model, "tensor", None), getattr(model, "fsdp", None)):
        if shards is not None:
            t = shards.local(t, shards.dims.get(name))
    return t


def local_box(model: nn.Module, name: str, shape: tuple[int, ...]
              ) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(the whole leaf's shape, where this rank's block of it starts) for
    the float leaf ``name`` of ``model`` held at ``shape``: its tensor
    block, then its fsdp block of that (:func:`local_of`); a leaf the plans
    keep whole, or a module that is not sharded: ``shape`` at 0."""
    whole, start = list(shape), [0] * len(shape)
    # the fsdp block lies inside the tensor block: undo it first
    for shards in (getattr(model, "fsdp", None), getattr(model, "tensor", None)):
        dim = None if shards is None else shards.dims.get(name)
        if dim is not None:
            start[dim] += shards.index * whole[dim]
            whole[dim] *= shards.size
    return tuple(whole), tuple(start)


def _keep_local(shards: Shards, mod: nn.Module, attr: str, is_param: bool,
                dim: int | None) -> None:
    """Replace the whole leaf in the slot by a contiguous copy of this
    rank's block along ``dim`` (nothing for None), freeing the whole one."""
    if dim is None:
        return
    t = _get(mod, attr, is_param)
    with torch.no_grad():
        local = shards.local(t.detach(), dim).clone(memory_format=torch.contiguous_format)
    _set(mod, attr, is_param,
         nn.Parameter(local, requires_grad=t.requires_grad) if is_param else local)


def tensor_degree(mesh) -> int:
    """The tensor degree a DiT is split over under ``mesh``: 1 without a
    mesh or under a pipe axis (stages hold their blocks whole over
    ``tensor``, as JAX's ``gpipe_scan`` replicates it)."""
    if mesh is None or mesh.shape.get(AXIS_PIPE, 1) > 1:
        return 1
    return mesh.shape.get(AXIS_TENSOR, 1)


def check_tensor_split(cfg, tp: int) -> None:
    """Raise ValueError unless the DiT of ``cfg`` splits over ``tp``
    tensor ranks: whole heads a rank (JAX's GSPMD would gather heads that
    do not divide; the port does not) and whole FFN columns a rank."""
    if cfg.num_heads % tp or cfg.ffn_dim % tp:
        raise ValueError(f"tensor={tp}: the DiT's {cfg.num_heads} heads and ffn_dim "
                         f"{cfg.ffn_dim} must divide into whole heads and columns a rank")


def _plans(model: nn.Module, mesh) -> tuple[Shards | None, Shards | None]:
    """The (tensor, fsdp) plans of ``mesh`` for the whole ``model``, each
    None where its axis is 1 (the tensor axis also under a pipe axis)."""
    if getattr(model, "fsdp", None) is not None or getattr(model, "tensor", None) is not None:
        raise ValueError("the model is already sharded")
    tp, fsdp = tensor_degree(mesh), mesh.shape.get(AXIS_FSDP, 1)
    if tp > 1:
        check_tensor_split(model.cfg, tp)
    specs = _specs(model, tp, fsdp)
    tensor = (Shards(tp, mesh.index(AXIS_TENSOR), {n: s.tensor for n, s in specs.items()})
              if tp > 1 else None)
    shards = (Shards(fsdp, mesh.index(AXIS_FSDP), {n: s.fsdp for n, s in specs.items()})
              if fsdp > 1 else None)
    return tensor, shards


def _split_tensor(model: nn.Module, tensor: Shards) -> None:
    """Keep this rank's columns / rows of every block projection that
    Megatron's layout splits. A row-split int4 leaf holds its contiguous
    rows, repacked (``ops/quant.int4_rows``)."""
    from chronoedit_tpu_torch.ops import quant

    for j, blk in enumerate(model.blocks):
        for mod_name, layer in TP_COL + TP_ROW:
            parent = getattr(blk, mod_name, None)
            lin = getattr(parent, layer, None) if parent is not None else None
            if lin is None:
                continue
            if isinstance(lin, quant.QuantLinear4) and (mod_name, layer) in TP_ROW:
                setattr(parent, layer, quant.int4_rows(lin, tensor.index, tensor.size))
                continue
            for name, mod, attr, is_param in _slots(lin, f"blocks.{j}.{mod_name}.{layer}"):
                _keep_local(tensor, mod, attr, is_param, tensor.dims[name])


def shard_params(model: nn.Module, mesh) -> nn.Module:
    """Keep this rank's slice of every leaf of the whole ``model`` that
    JAX's placement (:func:`param_spec_tree`) splits, as a contiguous
    tensor in its slot: its tensor slice first, then its fsdp slice of
    that; record the plans in ``model.tensor`` and ``model.fsdp``. In
    place; returns the model. A mesh whose tensor and fsdp axes are 1
    leaves it whole. Raises ValueError when the heads do not divide the
    tensor degree."""
    tensor, shards = _plans(model, mesh)
    if tensor is not None:
        _split_tensor(model, tensor)
        model.tensor = tensor
    if shards is not None:
        for name, mod, attr, is_param in _slots(model):
            _keep_local(shards, mod, attr, is_param, shards.dims[name])
        model.fsdp = shards
    return model


def materialize_shards(model: nn.Module, mesh, device) -> nn.Module:
    """A float model built on ``meta`` made real on ``device`` at this
    rank's shard shapes for ``mesh``'s tensor and fsdp axes (uninitialised,
    the whole leaves for those the plans keep whole), the plans recorded
    in ``model.tensor`` and ``model.fsdp``: a loader fills the slots with
    the slices it reads. Returns the model."""
    tensor, shards = _plans(model, mesh)
    for name, mod, attr, is_param in _slots(model):
        t = _get(mod, attr, is_param)
        shape = tuple(t.shape)
        for plan in (tensor, shards):
            if plan is not None:
                shape = plan.shape(shape, plan.dims[name])
        empty = torch.empty(shape, dtype=t.dtype, device=device)
        _set(mod, attr, is_param,
             nn.Parameter(empty, requires_grad=t.requires_grad) if is_param else empty)
    model.tensor, model.fsdp = tensor, shards
    return model


def leaves(module: nn.Module) -> dict[int, torch.Tensor]:
    """{id: tensor} of every parameter and buffer under ``module``: what
    :func:`shard_new_leaves` takes as the leaves already sharded (holding
    them keeps their ids from being reused)."""
    return {id(t): t for t in (*module.parameters(), *module.buffers())}


def shard_new_leaves(model: nn.Module, module: nn.Module, prefix: str,
                     old: dict[int, torch.Tensor]) -> None:
    """After ``module`` (at ``prefix`` in the sharded ``model``) took new
    leaves in place of some of ``old`` (its :func:`leaves` before; a
    quantization run on its fsdp-gathered, tensor-local weights): record
    each new leaf's tensor dimension (it is already this rank's tensor
    slice), split it over fsdp by the rule keeping this rank's slice, and
    drop the plans' names under ``prefix`` that are gone."""
    tensor, shards = getattr(model, "tensor", None), getattr(model, "fsdp", None)
    names = set()
    for name, mod, attr, is_param in _slots(module, prefix):
        names.add(name)
        t = _get(mod, attr, is_param)
        if id(t) in old:
            continue
        dim = None
        if tensor is not None:
            dim = tensor.dims[name] = tensor_dim(name, tuple(t.shape), tensor.size, guard=False)
        if shards is not None:
            shards.dims[name] = fsdp_dim(name, tuple(t.shape), shards.size, dim)
            _keep_local(shards, mod, attr, is_param, shards.dims[name])
    for plan in (tensor, shards):
        if plan is not None:
            for name in [n for n in plan.dims if n.startswith(prefix + ".") and n not in names]:
                del plan.dims[name]


class Gather:
    """The forward's view of a model sharded over ``group`` (``model.fsdp``):
    ``with gather(module):`` puts each of the module's gathered leaves in
    place of its shard and puts the shards back after. ``summed``: each
    rank ran its own part of the batch, so the backward sums the ranks'
    gradients (``collectives.gather_shard_autograd``; a whole leaf that
    requires a gradient goes through ``sum_grad_autograd``); otherwise
    every rank ran the whole batch and a shard takes its slice of the one
    gradient."""

    def __init__(self, model: nn.Module, group, summed: bool):
        self.group, self.summed, self.dims = group, summed, model.fsdp.dims
        self.names = {m: name for name, m in model.named_modules()}

    @contextlib.contextmanager
    def __call__(self, module: nn.Module):
        swapped = []
        try:
            for name, mod, attr, is_param in _slots(module, self.names[module]):
                t = _get(mod, attr, is_param)
                dim = self.dims.get(name)
                if dim is not None:
                    full = C.gather_shard_autograd(t, self.group, dim, self.summed)
                elif self.summed and t.requires_grad and torch.is_grad_enabled():
                    full = C.sum_grad_autograd(t, self.group)
                else:
                    continue
                swapped.append((mod, attr, is_param, t))
                _set(mod, attr, is_param, full)
            yield
        finally:
            for mod, attr, is_param, t in reversed(swapped):
                _set(mod, attr, is_param, t)


def fsdp_gather(model: nn.Module, mesh, batch: int) -> Gather | None:
    """How ``dit_forward`` reads ``model`` under ``mesh``: None for a whole
    model under no fsdp axis; a :class:`Gather` over the fsdp group for a
    model sharded over it, ``summed`` when the fsdp degree divides the
    batch and there is no pipe axis (each rank then runs its ``batch /
    fsdp`` rows). Under a pipe axis every fsdp rank of a stage runs the
    stage's microbatches whole, as in JAX's ``gpipe_scan`` (the batch
    splits over data only), so the gather's backward takes this rank's
    slice of the one gradient. Raises ValueError when the model's sharding
    and the mesh's fsdp axis differ."""
    fsdp = 1 if mesh is None else mesh.shape.get(AXIS_FSDP, 1)
    shards = getattr(model, "fsdp", None)
    if shards is None and fsdp == 1:
        return None
    if shards is None or shards.size != fsdp or shards.index != mesh.index(AXIS_FSDP):
        raise ValueError(f"the DiT is {'whole' if shards is None else f'sharded {shards.size} ways'}"
                         f" but the mesh's fsdp axis is {fsdp}: shard it with "
                         f"parallel.sharding.shard_params(model, mesh) (or load it with the "
                         f"mesh)")
    return Gather(model, mesh.group(AXIS_FSDP),
                  batch % fsdp == 0 and mesh.shape.get(AXIS_PIPE, 1) == 1)


@dataclasses.dataclass(frozen=True)
class TensorSplit:
    """How ``dit_forward`` runs a DiT split over the tensor axis: the
    tensor group, this rank's index along it and the degree."""

    group: object
    index: int
    size: int


def tensor_plan(model: nn.Module, mesh) -> TensorSplit | None:
    """None for a model whole over ``mesh``'s tensor axis (no mesh, a
    tensor axis of 1, or a pipe axis, inside whose stages tensor is
    replicated); the :class:`TensorSplit` of a model split over it. Raises
    ValueError when the model's split and the mesh's tensor axis differ."""
    tp = tensor_degree(mesh)
    tensor = getattr(model, "tensor", None)
    if tensor is None and tp == 1:
        return None
    if tensor is None or tensor.size != tp or tensor.index != mesh.index(AXIS_TENSOR):
        raise ValueError(
            f"the DiT is {'whole' if tensor is None else f'split {tensor.size} ways'} over "
            f"tensor but the mesh runs it {tp} ways: shard it with "
            f"parallel.sharding.shard_params(model, mesh) (or load it with the mesh)")
    return TensorSplit(mesh.group(AXIS_TENSOR), tensor.index, tensor.size)
