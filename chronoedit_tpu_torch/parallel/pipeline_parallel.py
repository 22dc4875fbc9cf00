"""GPipe pipeline parallelism over the ``pipe`` axis of a mesh.

The port of ``chronoedit_tpu/parallel/pipeline_parallel.py``. JAX shards a
stacked block axis over ``pipe`` inside one ``shard_map`` and scans
``M + S - 1`` ticks with ``ppermute`` handoffs; the port runs the same
schedule on the ranks of a ``torch.distributed`` pipe group:

- each rank holds the blocks of its stage only, ``stage_range``: blocks
  ``[s * L / n, (s + 1) * L / n)`` of ``L`` for stage ``s`` of ``n``;
- the batch splits over ``data`` when it divides (each data line takes
  its share), then into ``m`` microbatches (default ``min(B_local, n)``,
  lowered to a divisor of the local batch); with ``context_axis`` the
  tokens also split over that axis inside the stages;
- at tick ``t`` stage ``s`` runs microbatch ``t - s`` through its blocks
  and every rank hands its output to the next rank of the pipe ring
  (``collectives.RingShift`` under its own tag, ``PIPE_TAG``);
- the last stage's finished microbatches are broadcast to every stage
  (JAX's ``psum`` of zeros and the last stage's values).

**The rule for bubbles.** A tick where a stage has no microbatch (``t - s``
outside ``[0, m)``) skips the stage's blocks (JAX computes them and throws
the result away), but every rank still makes the tick's handoff, of zeros
there: all ranks of a pipe group make the same ``m + n - 2`` shifts in the
same order (the last tick's handoff would reach no one and is left out by
all). So a forward launches each of a stage's blocks ``m`` times, once per
microbatch, and stages ``(m + n - 2)`` handoffs of one microbatch.

**Gradients.** The pipeline is differentiable, as JAX's is for free. Every
tick's handoff and stage-0 input selection is an autograd Function on
every rank, bubble or not, joined in one chain from a zero carry that
requires a gradient, so each rank's backward meets the reverse handoffs in
the same order (the reverse pipeline): a handoff whose output no one used
would never run its backward on one rank and leave its peer waiting. The
final replication's backward gives the loss gradient to the last stage
once (every rank computes the same loss on the replicated output) and
zeros elsewhere: it neither sums the ``n`` copies nor drops them. At the
entry the gradients of ``x`` and of the context tensors are summed over
the pipe group, so every rank of a pipe line ends with the line's whole
gradient of its inputs, bitwise alike, and so with the same gradient of
every parameter that made them (the embedders); a stage's blocks get
theirs on their own rank. Over ``data`` and ``context`` each rank's
gradient is that of its own share (zeros outside it), as in the port's
context parallelism: the trainer sums it over context. Beside an ``fsdp``
axis the stage's blocks are fsdp shards that ``block_fn`` gathers
(``models/dit.py``'s ``_pipeline_blocks``): every fsdp rank of a stage runs
the same ticks on the same microbatches, so each gather's backward runs
inside the same reverse tick on both peers and takes this rank's slice of
the one gradient.

**Training.** ``train/train_step.py`` hands the pipeline its data line's
rows under ``Mesh.data_line`` (the data axis folded to 1), so the batch
does not split over data here, and averages every gradient over data
after the backward. Splitting the line's rows over data again, and then
averaging, would count each gradient wrongly (the tests plant it).
Serving keeps JAX's layout: the global batch on every rank, split over
data inside.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Sequence

import torch

from chronoedit_tpu_torch.parallel import collectives as C
from chronoedit_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_PIPE

# the handoff's tag: apart from the ring attention's shifts (tags 0-3),
# which run inside a stage's blocks at the same time on other groups
PIPE_TAG = 16


def stage_range(num_layers: int, mesh, axis: str = AXIS_PIPE) -> range:
    """The global indices of the blocks this rank's pipeline stage holds:
    all ``num_layers`` without a mesh or a pipe axis; raises ValueError
    when the stages do not divide them (JAX's error)."""
    n = 1 if mesh is None else mesh.shape.get(axis, 1)
    if num_layers % n:
        raise ValueError(f"{num_layers} stacked layers not divisible by {n} pipeline "
                         "stages")
    per = num_layers // n
    s = 0 if n == 1 else mesh.index(axis)
    return range(s * per, (s + 1) * per)


def splits_data(mesh, batch: int) -> bool:
    """Does a pipeline over ``mesh`` split a batch of ``batch`` over its
    data axis (the axis is above 1 and divides it)?"""
    dsize = mesh.shape.get(AXIS_DATA, 1)
    return dsize > 1 and batch % dsize == 0


def _share(t: torch.Tensor, dims: list[tuple[int, int, int]]) -> torch.Tensor:
    """The view of ``t``'s block along each (dim, parts, index)."""
    for dim, parts, index in dims:
        t = t.chunk(parts, dim=dim)[index]
    return t


class _Enter(torch.autograd.Function):
    """The rank's share of ``x`` and of the context tensors; the backward
    puts each gradient in place in zeros of the whole shape and sums it
    over the pipe group (in fp32)."""

    @staticmethod
    def forward(ctx, group, x_dims, ctx_dims, x, *tensors):
        ctx.group, ctx.x_dims, ctx.ctx_dims = group, x_dims, ctx_dims
        ctx.shapes = [x.shape] + [t.shape for t in tensors]
        return (_share(x, x_dims).contiguous(),
                *(_share(t, ctx_dims).contiguous() for t in tensors))

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for i, (g, shape) in enumerate(zip(grads, ctx.shapes)):
            whole = torch.zeros(shape, dtype=torch.float32, device=g.device)
            _share(whole, ctx.x_dims if i == 0 else ctx.ctx_dims).copy_(g)
            out.append(C.all_reduce(whole, ctx.group).to(g.dtype))
        return (None, None, None, *out)


class _Select(torch.autograd.Function):
    """A tick's input: the microbatch on stage 0, the handoff elsewhere.
    Both stay in the graph on every rank; the one not taken gets a zero
    gradient."""

    @staticmethod
    def forward(ctx, first, carry, take_first: bool):
        ctx.take_first = take_first
        return (first if take_first else carry).clone()

    @staticmethod
    def backward(ctx, g):
        zero = torch.zeros_like(g)
        return (g, zero, None) if ctx.take_first else (zero, g, None)


class _Bubble(torch.autograd.Function):
    """A bubble tick's output: zeros, the blocks skipped; a zero gradient
    keeps the chain of handoffs whole."""

    @staticmethod
    def forward(ctx, x):
        return torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


class _Replicate(torch.autograd.Function):
    """The last stage's finished microbatches, concatenated, on every rank
    of the pipe group (a broadcast). The backward hands the gradient to the
    last stage's microbatches once and zeros to every other rank's."""

    @staticmethod
    def forward(ctx, group, src: int, is_last: bool, *outs):
        ctx.is_last, ctx.sizes = is_last, [o.shape[0] for o in outs]
        return C.broadcast(torch.cat(outs, dim=0), group, src)

    @staticmethod
    def backward(ctx, g):
        grads = (g.split(ctx.sizes, dim=0) if ctx.is_last
                 else [torch.zeros_like(p) for p in g.split(ctx.sizes, dim=0)])
        return (None, None, None, *grads)


def _as_list(ctx_batch) -> tuple[list, bool]:
    if ctx_batch is None or isinstance(ctx_batch, torch.Tensor):
        return [ctx_batch], True
    return list(ctx_batch), False


def gpipe_scan(
    block_fn: Callable[[Any, torch.Tensor, Any], torch.Tensor],
    stage_params: Sequence,
    x: torch.Tensor,
    ctx_batch: Any,
    mesh,
    microbatches: int | None = None,
    axis: str = AXIS_PIPE,
    context_axis: str | None = None,
    context_dim: int = 1,
    num_layers: int | None = None,
) -> torch.Tensor:
    """Run a stack of layers as a GPipe pipeline over ``mesh``'s ``axis``.

    Args:
      block_fn: ``block_fn(layer_params, x, ctx) -> x``: one layer, where
        ``layer_params`` is one entry of ``stage_params`` and ``ctx`` the
        microbatch's share of ``ctx_batch`` (in its form: a tensor, or a
        tuple / list of tensors and Nones).
      stage_params: a sequence indexed by layer (a tensor with a leading
        layer axis, a list, an ``nn.ModuleList``): the whole stack of L
        layers, of which each stage takes its own (JAX's contract), or,
        with ``num_layers`` = L, this stage's L / n layers only.
      x: (B, ...) activations, the same on every rank.
      ctx_batch: (B, ...) tensors microbatched along with ``x`` (time
        embeddings, text / image context), the same on every rank.
      mesh: a ``parallel.mesh.Mesh`` with ``axis``.
      microbatches: default ``min(B_local, n)``, lowered to a divisor of
        the local batch.
      context_axis: compose with context parallelism: ``x``'s dim
        ``context_dim`` splits over this axis inside the stages when it
        divides, and ``block_fn`` runs on the rank's block of it (it must
        handle context parallelism itself, as ``dit_forward``'s pipe path
        does); ``ctx_batch`` stays whole (``block_fn`` slices it).
      num_layers: the stack's size when ``stage_params`` holds only this
        stage's layers.

    Returns: this rank's share of the (B, ...) outputs, the same on every
    rank of the pipe group: its rows of the batch when the batch split
    over ``data`` (``splits_data``), its block of ``context_dim`` when the
    tokens split over ``context_axis``; the caller gathers them, as JAX's
    downstream sharding does.

    Raises ValueError when the stages do not divide the layers or the batch
    does not divide into the microbatches; warns when ``tensor`` or
    ``context`` work is replicated inside stages or the batch does not
    split over ``data``.
    """
    n = mesh.shape.get(axis, 1)
    ctx_list, single = _as_list(ctx_batch)
    if n == 1:
        for lp in stage_params:
            x = block_fn(lp, x, ctx_batch)
        return x

    layers = stage_range(len(stage_params) if num_layers is None else num_layers, mesh, axis)
    if num_layers is None:
        local = [stage_params[i] for i in layers]
    elif len(stage_params) != len(layers):
        raise ValueError(f"{len(stage_params)} stage layers given; stage {mesh.index(axis)} "
                         f"of {n} holds {len(layers)} of {num_layers}")
    else:
        local = list(stage_params)
    b = x.shape[0]

    cp = mesh.shape.get(context_axis, 1) if context_axis else 1
    shard_ctx = context_axis is not None and cp > 1 and x.shape[context_dim] % cp == 0
    neutral_axes = ["tensor"]
    if mesh.shape.get("context", 1) > 1 and not shard_ctx:
        neutral_axes.append("context")
    for neutral in neutral_axes:
        if mesh.shape.get(neutral, 1) > 1:
            warnings.warn(
                f"pipeline parallelism replicates the {neutral!r} axis inside stages "
                "(attention runs unsharded per stage); prefer tensor/context meshes "
                "without a pipe axis for that", stacklevel=2)
    dsize = mesh.shape.get(AXIS_DATA, 1)
    shard_data = splits_data(mesh, b)
    if dsize > 1 and not shard_data:
        warnings.warn(f"batch {b} not divisible by data axis {dsize}; running the pipeline "
                      "with a replicated batch", stacklevel=2)
    b_local = b // dsize if shard_data else b

    if microbatches is None:
        m = min(b_local, n)
        while b_local % m:  # largest divisor of the local batch <= n
            m -= 1
    else:
        m = microbatches
        if b % m or (shard_data and (b // m) % dsize):
            raise ValueError(f"batch {b} not divisible into {m} microbatches "
                             f"{'x data ' + str(dsize) if shard_data else ''}")

    group, s = mesh.group(axis), mesh.index(axis)
    batch_dims = [(0, dsize, mesh.index(AXIS_DATA))] if shard_data else []
    x_dims = batch_dims + ([(context_dim, cp, mesh.index(context_axis))] if shard_ctx else [])
    present = [t for t in ctx_list if t is not None]
    x_loc, *ctx_loc = _Enter.apply(group, x_dims, batch_dims, x, *present)
    ctx_loc = iter(ctx_loc)
    ctx_loc = [None if t is None else next(ctx_loc) for t in ctx_list]
    xm = x_loc.chunk(m, dim=0)
    ctxm = [[None] * m if t is None else t.chunk(m, dim=0) for t in ctx_loc]

    def tick_ctx(i):
        parts = [c[i] for c in ctxm]
        return parts[0] if single else type(ctx_batch)(parts)

    # the chain of handoffs starts from a zero carry that needs a gradient
    # whenever autograd records, on every rank alike (see the module notes)
    carry = torch.zeros_like(xm[0], requires_grad=torch.is_grad_enabled())
    finished = []
    total = m + n - 1
    for t in range(total):
        i = t - s
        x_cur = _Select.apply(xm[min(max(i, 0), m - 1)], carry, s == 0)
        if 0 <= i < m:
            y = x_cur
            for lp in local:
                y = block_fn(lp, y, tick_ctx(i))
        else:
            y = _Bubble.apply(x_cur)
        if t >= n - 1:
            finished.append(y)  # the last stage's microbatch t - (n - 1)
        if t != total - 1:
            carry = C.RingShift.apply(y.contiguous(), group, 1, PIPE_TAG)
    return _Replicate.apply(group, n - 1, s == n - 1, *finished)
