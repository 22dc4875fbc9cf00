"""The collectives of context, FSDP and tensor parallelism, over a
``torch.distributed`` process group: the counterparts of JAX's
``ppermute``, tiled ``all_to_all``, ``all_gather``, ``psum_scatter``,
``psum`` and ``pmax`` on a mesh axis.

- :func:`ring_shift_start` / :class:`RingShift`: every rank sends its
  tensors to the next rank of the group and receives the previous rank's
  (``batch_isend_irecv``), so that a ring hop's transfer can run while the
  hop's kernel does;
- :func:`all_to_all`: split one dimension into the group's ranks and
  concatenate what comes back along another, in rank order (JAX's
  ``all_to_all(..., tiled=True)``); :func:`all_to_all_autograd` is the same
  as an autograd Function whose backward is the transposed all-to-all;
- :func:`all_gather`: concatenate every rank's tensor along a dimension,
  in rank order; :func:`gather_sequence_autograd` backs it with the local
  slice of the gradient, :func:`gather_shard_autograd` (FSDP's gather of
  a parameter shard) with that slice or with :func:`reduce_scatter`;
- :func:`reduce_scatter`: the sum over the group, each rank keeping its
  block of one dimension;
- :func:`all_reduce`: the sum (or the maximum) over the group;
  :func:`sum_grad_autograd` is the identity whose backward sums the
  gradient over the group;
- Megatron's conjugate pair for tensor parallelism:
  :func:`copy_to_tensor` (the identity, its backward the sum: at the entry
  of a column-parallel group, whose ranks each take the replicated input
  to their own columns) and :func:`reduce_from_tensor` (the sum, its
  backward the identity: after a row-parallel product, whose partial sums
  every rank then uses alike); :func:`psum_autograd` (the sum, its
  backward the sum: a statistic that each rank uses on its own columns,
  RMSNorm's across the heads);
- :func:`broadcast`: one rank's tensor on every rank of the group (the
  pipeline's final replication, ``parallel/pipeline_parallel.py``).

Under NCCL the tensors stay on their device. Under gloo a CUDA tensor is
staged: copied into pinned host memory, moved by gloo, copied back. Only a
caller that asked for gloo on CUDA tensors gets that (the one-card check,
which runs P ranks as P processes on one GPU, where NCCL refuses two ranks
on a device); every computation stays on the device and only the transport
goes through the host. ``STAGED_BYTES`` counts the bytes copied to the
host, and the first staging prints one line on rank 0.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

STAGED_BYTES = {"bytes": 0}
_said = False
# all_gather_into_tensor's newer name
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    global _said
    if not _said:
        _said = True
        if dist.get_rank() == 0:
            print("collectives: gloo on CUDA tensors, staged through pinned host memory "
                  "(a transport for P processes on one card, not a scaling setup)",
                  flush=True)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    STAGED_BYTES["bytes"] += t.numel() * t.element_size()
    return host


def _outgoing(group, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The tensors as they go on the wire: copied to pinned host memory
    (the copies landed) when gloo moves CUDA tensors, else contiguous."""
    if _staged(group, tensors[0]):
        host = [_to_host(t) for t in tensors]
        torch.cuda.current_stream().synchronize()
        return host
    return [t.contiguous() for t in tensors]


def _empty(like: torch.Tensor, shape=None) -> torch.Tensor:
    """A receive buffer beside ``like``: pinned when ``like`` was staged."""
    return torch.empty(like.shape if shape is None else shape, dtype=like.dtype,
                       device=like.device, pin_memory=like.is_pinned())


def _peer(group, offset: int) -> int:
    """The global rank ``offset`` places along the group's ring."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    return dist.get_global_rank(group, (i + offset) % n)


class _Pending:
    """An in-flight ring shift: :meth:`wait` returns the received tensors
    on the senders' device."""

    def __init__(self, works, recvs, device):
        self.works, self.recvs, self.device = works, recvs, device

    def wait(self) -> list[torch.Tensor]:
        for w in self.works:
            w.wait()
        return [r.to(self.device, non_blocking=True) for r in self.recvs]


def ring_shift_start(tensors: list[torch.Tensor], group, tag: int = 0,
                     offset: int = 1) -> _Pending:
    """Start sending each tensor ``offset`` ranks on along ``group``'s ring
    and receiving the tensor of the same shape sent to this rank;
    ``wait()`` on the result gives the received tensors. The i-th tensor
    travels under tag ``tag + i``: shifts in flight at the same time take
    tags apart."""
    device = tensors[0].device
    sends = _outgoing(group, tensors)
    recvs = [_empty(t) for t in sends]
    to, frm = _peer(group, offset), _peer(group, -offset)
    ops = []
    for i, (s, r) in enumerate(zip(sends, recvs)):
        ops.append(dist.P2POp(dist.isend, s, to, group, tag + i))
        ops.append(dist.P2POp(dist.irecv, r, frm, group, tag + i))
    return _Pending(dist.batch_isend_irecv(ops), recvs, device)


def ring_shift(tensors: list[torch.Tensor], group, tag: int = 0,
               offset: int = 1) -> list[torch.Tensor]:
    """Each tensor moved ``offset`` ranks along the ring (``ppermute``)."""
    return ring_shift_start(tensors, group, tag, offset).wait()


class RingShift(torch.autograd.Function):
    """One tensor moved ``offset`` ranks along the ring under ``tag``; the
    gradient moves back under the same tag."""

    @staticmethod
    def forward(ctx, x, group, offset: int, tag: int = 0):
        ctx.group, ctx.offset, ctx.tag = group, offset, tag
        return ring_shift([x], group, tag=tag, offset=offset)[0]

    @staticmethod
    def backward(ctx, g):
        return (ring_shift([g.contiguous()], ctx.group, tag=ctx.tag, offset=-ctx.offset)[0],
                None, None, None)


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Tiled all-to-all: ``x`` split into the group's n ranks along
    ``split_dim`` (chunk j goes to rank j), the n chunks received
    concatenated along ``concat_dim`` in rank order."""
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} is not "
                         f"divisible by {n} ranks")
    send = _outgoing(group, [torch.stack(x.chunk(n, dim=split_dim))])[0]
    recv = _empty(send)
    dist.all_to_all_single(recv, send, group=group)
    recv = recv.to(x.device, non_blocking=True)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim: int, concat_dim: int):
        ctx.args = group, split_dim, concat_dim
        return all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return all_to_all(g, group, concat_dim, split_dim), None, None, None


def all_to_all_autograd(x: torch.Tensor, group, split_dim: int,
                        concat_dim: int) -> torch.Tensor:
    """:func:`all_to_all`, differentiable: its backward is the all-to-all
    back, with the two dimensions swapped."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` (all the same shape) concatenated along ``dim``
    in rank order."""
    n = dist.get_world_size(group)
    send = _outgoing(group, [x])[0]
    out = _empty(send, (n * x.shape[0], *x.shape[1:]))  # the ranks' tensors along dim 0
    _all_gather_single(out, send, group=group)
    out = out.to(x.device, non_blocking=True)
    return torch.cat(out.unflatten(0, (n, -1)).unbind(0), dim=dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim: int, summed: bool):
        ctx.args = group, dist.get_rank(group), x.shape[dim], dim, summed
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, i, n, dim, summed = ctx.args
        if summed:
            return reduce_scatter(g, group, dim), None, None, None
        return g.narrow(dim, i * n, n), None, None, None


def gather_sequence_autograd(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """:func:`all_gather`, differentiable for a loss that every rank
    computes alike on the gathered tensor: the gradient of this rank's
    block is its slice of the gradient."""
    return _Gather.apply(x, group, dim, False)


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum of ``x`` over the group, split into the group's n ranks
    along ``dim``: this rank's block (JAX's ``psum_scatter(...,
    tiled=True)``), in a new tensor on ``x``'s device."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} is not divisible "
                         f"by {n} ranks")
    blocks = x.chunk(n, dim=dim)
    send = _outgoing(group, [torch.cat(blocks, dim=0)])[0]  # block j for rank j, along dim 0
    out = _empty(send, blocks[0].shape)
    dist.reduce_scatter_tensor(out, send, group=group)
    return out.to(x.device, non_blocking=True)


def gather_shard_autograd(x: torch.Tensor, group, dim: int, summed: bool) -> torch.Tensor:
    """:func:`all_gather` of a parameter shard, differentiable. Its
    backward depends on what the ranks computed from the gathered tensor:
    with ``summed`` each rank ran its own part of the batch, so its
    gradient is a partial one and this rank's shard gets the sum over the
    group of its block (:func:`reduce_scatter`); without, every rank ran
    the same computation and holds the same whole gradient, so the shard
    gets its block of it (a sum would count it n times)."""
    return _Gather.apply(x, group, dim, summed)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


def sum_grad_autograd(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself, with a backward that sums the gradient over the
    group: a replicated parameter read by ranks that each ran their own
    part of the batch."""
    return _SumGrad.apply(x, group)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) of ``x`` over the group, in a new tensor on
    ``x``'s device, in ``x``'s dtype: bf16 partials are summed in bf16, as
    GSPMD reduces a bf16 product's partial sums."""
    buf = _outgoing(group, [x])[0]
    if buf is x:
        buf = x.clone()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device, non_blocking=True)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the group (JAX's ``pmax``), no
    gradient: the global per-token amax of an int8 activation scale."""
    return all_reduce(x.detach().contiguous(), group, dist.ReduceOp.MAX)


# Megatron's ``f``, at the entry of a column-parallel group: ``x`` itself,
# its gradient summed over the tensor group (each rank's columns gave it a
# partial one)
copy_to_tensor = sum_grad_autograd


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad_sum: bool):
        ctx.group, ctx.grad_sum = group, grad_sum
        return all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return (all_reduce(g.contiguous(), ctx.group) if ctx.grad_sum else g), None, None


def reduce_from_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``g``: the sum of the ranks' partial products over the
    tensor group, in ``x``'s dtype; its backward passes the gradient on
    as it is (every rank computed alike from the sum)."""
    return _Reduce.apply(x, group, False)


def psum_autograd(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group whose backward sums the gradient
    too: each rank uses the sum on its own share of the work."""
    return _Reduce.apply(x, group, True)


def broadcast(x: torch.Tensor, group, src_index: int) -> torch.Tensor:
    """The tensor of the group's ``src_index``-th rank on every rank of the
    group, in a new tensor on ``x``'s device (``x`` gives the shape and
    dtype on the other ranks)."""
    buf = _outgoing(group, [x])[0]
    if buf is x:
        buf = x.clone()
    dist.broadcast(buf, src=dist.get_global_rank(group, src_index), group=group)
    return buf.to(x.device, non_blocking=True)
