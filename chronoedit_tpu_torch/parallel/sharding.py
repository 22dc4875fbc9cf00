"""FSDP: the DiT's parameters sharded over a mesh's ``fsdp`` axis.

The port of ``chronoedit_tpu/parallel/sharding.py`` for the ``fsdp`` axis.
JAX declares a ``PartitionSpec`` per leaf and lets XLA insert the
all-gathers; the port keeps each rank's slice of every leaf in the model
itself and gathers a module's leaves where the forward uses them:

- :func:`dit_param_sharding`: JAX's placement rule. A leaf splits along its
  largest dimension that the fsdp degree divides, ties going to the
  earlier one; never the stacked layer axis of a block leaf, never
  ``kernel_q4``'s packed in-axis; whole on every rank when none qualifies.
  The rule is decided in JAX's layout and mapped back through
  ``models/from_jax.py``'s transposition: a port ``weight`` (and
  ``weight_q``, ``packed``) is (out, in) where JAX's kernel is (in, out),
  and a block's leaves carry no stacked axis. On the port's own shapes the
  rule would pick the out-dimension of every square projection, where JAX
  picks the in-dimension.
- :func:`shard_params` keeps this rank's slice of every leaf of a whole
  model (contiguous, in place) and records the plan in ``model.fsdp``
  (:class:`Shards`); :func:`materialize_shards` makes a model built on
  ``meta`` shard-shaped on a device, for a loader that reads only its
  slices (``models/weights.py``). :func:`param_spec_tree` maps every
  parameter and buffer name to its dimension (None: whole).
- :class:`Gather`: a context manager over one module at a time (a block,
  an embedder, the head) that puts the gathered leaves in place of the
  shards for its duration, through ``collectives.gather_shard_autograd``:
  the gradient lands in the shard parameters. When each rank ran its own
  part of the batch the backward sums the ranks' partial gradients
  (reduce-scatter, and an all-reduce for a leaf that is whole); when
  every rank ran the whole batch it takes this rank's slice of the one
  gradient.

JAX's ``replicate`` has no counterpart: every rank holds its own whole
VAE and encoders. The ``tensor`` axis (Megatron column / row blocks) is
not ported here.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterator

import torch
from torch import nn

from chronoedit_tpu_torch.parallel import collectives as C
from chronoedit_tpu_torch.parallel.mesh import AXIS_FSDP

# port leaves stored transposed against JAX's: (out, in) for (in, out)
_TRANSPOSED = ("weight", "weight_q", "packed")


def fsdp_dim(name: str, shape: tuple[int, ...], fsdp: int) -> int | None:
    """The dimension of the port leaf ``name`` (of ``shape``) that JAX's
    ``dit_param_sharding`` splits over ``fsdp`` ranks, or None (whole).
    JAX's block leaves carry a leading stacked axis that the rule never
    takes; the port's have none, so it does not enter the choice."""
    leaf = name.rsplit(".", 1)[-1]
    axes = list(range(len(shape)))  # the port's dims in JAX's axis order
    if leaf in _TRANSPOSED and len(shape) == 2:
        axes.reverse()
    jax_shape = [shape[d] for d in axes]
    # a stable sort: ties go to the earlier axis
    for i in sorted(range(len(jax_shape)), key=lambda i: -jax_shape[i]):
        if jax_shape[i] % fsdp or jax_shape[i] < fsdp:
            continue
        if leaf == "packed" and i == len(jax_shape) - 2:
            continue  # kernel_q4's packed in-axis
        return axes[i]
    return None


def dit_param_sharding(mesh) -> Callable[[str, torch.Tensor], int | None]:
    """JAX's placement for ``mesh``'s fsdp axis as JAX names it: a function
    of (leaf name, tensor) giving the dimension split over ``fsdp`` or
    None (:func:`fsdp_dim` for each leaf)."""
    fsdp = mesh.shape.get(AXIS_FSDP, 1)
    return lambda name, leaf: None if fsdp == 1 else fsdp_dim(name, tuple(leaf.shape), fsdp)


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


def param_spec_tree(model: nn.Module, mesh) -> dict[str, int | None]:
    """{parameter or buffer name: the dimension split over fsdp, or None}
    for a whole model (JAX's spec tree; :func:`fsdp_dim` for each leaf)."""
    fsdp = mesh.shape.get(AXIS_FSDP, 1)
    return {name: None if fsdp == 1 else fsdp_dim(name, tuple(_get(mod, attr, p).shape), fsdp)
            for name, mod, attr, p in _slots(model)}


@dataclasses.dataclass
class Shards:
    """How a model is split over ``size`` fsdp ranks: this rank's
    ``index`` and each leaf's dimension (None: whole on every rank).
    ``model.fsdp`` holds it; None there means a whole model."""

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


def _fsdp_shards(model: nn.Module, mesh) -> Shards:
    if getattr(model, "fsdp", None) is not None:
        raise ValueError("the model is already sharded over fsdp")
    return Shards(mesh.shape.get(AXIS_FSDP, 1), mesh.index(AXIS_FSDP), {})


def shard_params(model: nn.Module, mesh) -> nn.Module:
    """Keep this rank's slice of every leaf of the whole ``model`` that
    JAX's placement (:func:`param_spec_tree`) splits, as a contiguous
    tensor in its slot, and record the plan in ``model.fsdp``. In place;
    returns the model. A mesh whose fsdp axis is 1 leaves it whole."""
    shards = _fsdp_shards(model, mesh)
    if shards.size == 1:
        return model
    shards.dims = param_spec_tree(model, mesh)
    for name, mod, attr, is_param in _slots(model):
        _keep_local(shards, mod, attr, is_param, shards.dims[name])
    model.fsdp = shards
    return model


def materialize_shards(model: nn.Module, mesh, device) -> nn.Module:
    """A model built on ``meta`` made real on ``device`` at this rank's
    shard shapes for ``mesh``'s fsdp axis (above 1; uninitialised, the
    whole leaves for those the plan keeps whole), the plan recorded in
    ``model.fsdp``: a loader fills the slots with the slices it reads.
    Returns the model."""
    shards = _fsdp_shards(model, mesh)
    shards.dims = param_spec_tree(model, mesh)
    for name, mod, attr, is_param in _slots(model):
        t = _get(mod, attr, is_param)
        empty = torch.empty(shards.shape(t.shape, shards.dims[name]), dtype=t.dtype,
                            device=device)
        _set(mod, attr, is_param,
             nn.Parameter(empty, requires_grad=t.requires_grad) if is_param else empty)
    model.fsdp = shards
    return model


def leaves(module: nn.Module) -> dict[int, torch.Tensor]:
    """{id: tensor} of every parameter and buffer under ``module``: what
    :func:`shard_new_leaves` takes as the leaves already sharded (holding
    them keeps their ids from being reused)."""
    return {id(t): t for t in (*module.parameters(), *module.buffers())}


def shard_new_leaves(model: nn.Module, module: nn.Module, prefix: str,
                     old: dict[int, torch.Tensor]) -> None:
    """After ``module`` (at ``prefix`` in the sharded ``model``) took new
    whole leaves in place of some of ``old`` (its :func:`leaves` before; a
    quantization run on its gathered weights): split each new leaf by the
    rule and keep this rank's slice, and drop the plan's names under
    ``prefix`` that are gone."""
    shards = model.fsdp
    names = set()
    for name, mod, attr, is_param in _slots(module, prefix):
        names.add(name)
        t = _get(mod, attr, is_param)
        if id(t) not in old:
            shards.dims[name] = fsdp_dim(name, tuple(t.shape), shards.size)
            _keep_local(shards, mod, attr, is_param, shards.dims[name])
    for name in [n for n in shards.dims if n.startswith(prefix + ".") and n not in names]:
        del shards.dims[name]


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
    batch (each rank then runs its ``batch / fsdp`` rows). Raises
    ValueError when the model's sharding and the mesh's fsdp axis differ."""
    fsdp = 1 if mesh is None else mesh.shape.get(AXIS_FSDP, 1)
    shards = getattr(model, "fsdp", None)
    if shards is None and fsdp == 1:
        return None
    if shards is None or shards.size != fsdp or shards.index != mesh.index(AXIS_FSDP):
        raise ValueError(f"the DiT is {'whole' if shards is None else f'sharded {shards.size} ways'}"
                         f" but the mesh's fsdp axis is {fsdp}: shard it with "
                         f"parallel.sharding.shard_params(model, mesh) (or load it with the "
                         f"mesh)")
    return Gather(model, mesh.group(AXIS_FSDP), batch % fsdp == 0)
