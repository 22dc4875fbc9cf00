"""The process mesh: ranks laid out over named parallelism axes.

The port of ``chronoedit_tpu/parallel/mesh.py``. JAX builds one
``jax.sharding.Mesh`` over its devices; the port builds the same layout
over the ranks of the ``torch.distributed`` world (one rank, one device)
and opens one process group per axis and line of ranks along it, created in
the same order on every rank, as ``dist.new_group`` requires:

- ``pipe``    pipeline stages: each rank of a pipe line holds its stage's
              blocks of the DiT (``parallel/pipeline_parallel.py``);
- ``data``    data parallelism: the ranks of one ``data`` line hold the
              same model and, in serving, run the same request (inside a
              pipeline each takes its share of the batch);
- ``fsdp``    fully sharded data parallelism: each rank of an fsdp line
              holds its slice of every DiT parameter, gathers a block's
              just before the block runs, and takes its share of the
              batch when the degree divides it and there is no pipe axis
              (``parallel/sharding.py``); beside a pipe axis it splits
              each stage's blocks, and every fsdp rank of a stage runs
              the stage's microbatches whole;
- ``tensor``  tensor (Megatron) parallelism: each rank of a tensor line
              holds its columns of the DiT blocks' q / k / v / fc1
              projections and its rows of o / fc2, runs its share of the
              heads, and sums the row products over the line
              (``parallel/sharding.py``, ``models/dit.py``); inside
              pipeline stages it is replicated, as in JAX;
- ``context`` context (sequence) parallelism: ring or Ulysses attention
              over the DiT's token blocks (``parallel/context.py``).

Ranks fill the mesh row-major in ``MESH_AXES`` order, as JAX reshapes its
device list, so ``context`` is innermost: a context line is consecutive
ranks, and a pipe line crosses one rank of every data and context line.
Callers read degrees as JAX's do, ``mesh.shape.get("context", 1)``.

The VAE splits its rows over the model-parallel axes ``VAE_AXES``
(``vae_axes``, JAX's ``_spatial_shard`` rule), so besides one group per
axis the mesh opens one group per combination of two or more of those
axes (``Mesh.axes_group``); pipe and data ranks stay VAE replicas.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import math

import torch
import torch.distributed as dist

from chronoedit_tpu_torch.utils.platform import cuda_device

AXIS_PIPE = "pipe"
AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXIS_CONTEXT = "context"
# pipe is outermost; the high-traffic axes (tensor, context) stay innermost
MESH_AXES = (AXIS_PIPE, AXIS_DATA, AXIS_FSDP, AXIS_TENSOR, AXIS_CONTEXT)
# the axes the VAE splits its rows over, in JAX's order of choice
# (``chronoedit_tpu/models/vae.py``, ``_spatial_shard``)
VAE_AXES = (AXIS_CONTEXT, AXIS_TENSOR, AXIS_FSDP)


@dataclasses.dataclass(frozen=True)
class InnerAxes:
    """Passed in place of a mesh to code that already runs on one rank's
    shard and should use collectives over these groups rather than shard
    again: a pipeline stage's blocks run context-parallel attention over
    ``context`` (the rank's context group, or None) inside the stage. It
    answers the mesh calls that code makes (``shape``, ``group``,
    ``index``) for its one axis; ``context_size`` 1 is one rank's view."""

    context: object | None = None
    context_size: int = 1

    @property
    def shape(self) -> dict[str, int]:
        return {AXIS_CONTEXT: self.context_size}

    def group(self, axis: str):
        return self.context if axis == AXIS_CONTEXT and self.context_size > 1 else None

    def index(self, axis: str) -> int:
        group = self.group(axis)
        return 0 if group is None else dist.get_rank(group)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Parallelism degrees. -1 for ``data`` means "all remaining ranks"."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    context: int = 1
    pipe: int = 1

    @property
    def shape(self) -> dict[str, int]:
        """The degrees by axis, as a mesh's (``data`` -1: the rest)."""
        return {axis: getattr(self, axis) for axis in MESH_AXES}

    def resolve(self, num_devices: int) -> tuple[int, int, int, int, int]:
        """(pipe, data, fsdp, tensor, context) for ``num_devices`` ranks;
        raises ValueError when they do not fill the mesh exactly."""
        fixed = self.fsdp * self.tensor * self.context * self.pipe
        data = self.data
        if data == -1:
            if num_devices % fixed:
                raise ValueError(f"{num_devices} devices not divisible by "
                                 f"pipe*fsdp*tensor*context={fixed}")
            data = num_devices // fixed
        total = data * fixed
        if total != num_devices:
            raise ValueError(f"mesh {self.pipe}x{data}x{self.fsdp}x{self.tensor}x"
                             f"{self.context} != {num_devices} devices")
        return self.pipe, data, self.fsdp, self.tensor, self.context


def parse_mesh(spec: str) -> MeshConfig:
    """``"data=2,context=4"`` -> ``MeshConfig(data=2, context=4)`` (the CLI
    form, as JAX's ``run_inference --mesh``)."""
    kv = dict(item.split("=") for item in spec.split(",") if item)
    unknown = set(kv) - set(MESH_AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; have {MESH_AXES}")
    return MeshConfig(**{k: int(v) for k, v in kv.items()})


def mesh_coords(shape: tuple[int, ...], rank: int) -> dict[str, int]:
    """A rank's index along each axis of a row-major mesh of ``shape``
    (``MESH_AXES`` order)."""
    idx = []
    for n in reversed(shape):
        rank, i = divmod(rank, n)
        idx.append(i)
    return dict(zip(MESH_AXES, reversed(idx)))


def axis_lines(shape: tuple[int, ...], axis: str | tuple[str, ...]) -> list[list[int]]:
    """Every line of ranks along ``axis`` (or along several axes together:
    the ranks that differ only along them), in a fixed order: the groups
    that axis needs, each listed by rank in axis order."""
    axes = (axis,) if isinstance(axis, str) else axis
    dims = [MESH_AXES.index(a) for a in axes]
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    lines = ranks.movedim(dims, list(range(-len(dims), 0))).reshape(
        -1, math.prod(shape[d] for d in dims))
    return [row.tolist() for row in lines]


def vae_axes(shape: dict[str, int], rows: int) -> tuple[str, ...]:
    """The axes the VAE splits ``rows`` latent rows over: JAX's choice,
    each of ``VAE_AXES`` above size 1 taken in turn while the product of
    the taken ones divides the rows (``_spatial_shard``). JAX tests the
    divisibility on the array it shards, pixel rows in the encoder; the
    port splits whole latent rows in both directions, so at 720p (90
    latent rows) over 4 ranks it takes 2 where JAX's encode takes 4."""
    taken, product = [], 1
    for axis in VAE_AXES:
        n = shape.get(axis, 1)
        if n > 1 and rows % (product * n) == 0:
            taken.append(axis)
            product *= n
    return tuple(taken)


def _combinations(shape: dict[str, int]) -> list[tuple[str, ...]]:
    """Every combination of two or more ``VAE_AXES`` above size 1 (in
    ``VAE_AXES`` order), in a fixed order."""
    live = [a for a in VAE_AXES if shape.get(a, 1) > 1]
    return [c for n in range(2, len(live) + 1) for c in itertools.combinations(live, n)]


class Mesh:
    """This rank's place in a mesh of the world's ranks, and the process
    group of each axis it spans (None for axes of size 1).

    ``shape`` maps every axis to its degree; ``coords`` gives this rank's
    index along each; ``group(axis)`` is the group of the ranks that differ
    from this one only along ``axis``; ``axes_group(axes)`` the same along
    several axes; ``device`` is this rank's device."""

    def __init__(self, shape: tuple[int, ...], rank: int, device: torch.device,
                 groups: dict[str, object] | None = None,
                 combined: dict[tuple[str, ...], object] | None = None):
        self.shape = dict(zip(MESH_AXES, shape))
        self.rank = rank
        self.coords = mesh_coords(shape, rank)
        self.device = torch.device(device)
        self.groups = groups or {}
        self.combined = combined or {}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis: str):
        """The process group along ``axis``; None when the axis has size 1."""
        if self.shape.get(axis, 1) == 1:
            return None
        return self.groups[axis]

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def axes_group(self, axes: tuple[str, ...]):
        """The group of the ranks that differ from this one only along
        ``axes`` (each above size 1; ``make_mesh`` opens every combination
        of ``VAE_AXES``); None for no axes."""
        axes = tuple(a for a in VAE_AXES if a in axes)
        if not axes:
            return None
        return self.group(axes[0]) if len(axes) == 1 else self.combined[axes]

    def data_line(self) -> "Mesh":
        """This mesh as one data line sees it: the data axis folded to 1
        (no data group, index 0), every other axis as it is. A training
        step's forward runs under it on the line's own rows and averages
        over data afterwards; itself when the data axis is 1."""
        if self.shape.get(AXIS_DATA, 1) == 1:
            return self
        line = copy.copy(self)
        line.shape = {**self.shape, AXIS_DATA: 1}
        line.coords = {**self.coords, AXIS_DATA: 0}
        line.groups = {k: g for k, g in self.groups.items() if k != AXIS_DATA}
        return line

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


def make_mesh(config: MeshConfig | None = None, device: torch.device | None = None) -> Mesh:
    """The mesh of ``config`` over the current ``torch.distributed`` world
    (one process without one), this rank on ``device`` (default
    ``cuda_device()``, which raises without a card: a CPU mesh is asked
    for by passing ``torch.device("cpu")``).

    Raises ValueError when the degrees do not fill the world. A ``tensor``
    axis beside a ``pipe`` axis is replicated inside the stages, as JAX's
    ``gpipe_scan`` does (it warns); an ``fsdp`` axis beside it splits each
    stage's blocks (``parallel/sharding.py``). Every rank must call this
    with the same config, in the same order as its other group creations:
    the groups are opened axis by axis in ``MESH_AXES`` order, each axis's
    lines in ``axis_lines``' order, the same on every rank.
    """
    config = config or MeshConfig()
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    shape = config.resolve(world)
    if device is None:
        device = cuda_device()
    groups, combined = {}, {}
    for axis, n in zip(MESH_AXES, shape):
        if n == 1:
            continue
        for line in axis_lines(shape, axis):
            g = dist.new_group(line)
            if rank in line:
                groups[axis] = g
    # the VAE's row groups: the same combinations, lines and order on every
    # rank (new_group is collective)
    for axes in _combinations(dict(zip(MESH_AXES, shape))):
        for line in axis_lines(shape, axes):
            g = dist.new_group(line)
            if rank in line:
                combined[axes] = g
    return Mesh(shape, rank, device, groups, combined)


def single_device_mesh(device: torch.device | None = None) -> Mesh:
    """A mesh of this one rank (every axis of size 1) on ``device``
    (default ``cuda_device()``)."""
    if device is None:
        device = cuda_device()
    return Mesh((1,) * len(MESH_AXES), 0, device)
