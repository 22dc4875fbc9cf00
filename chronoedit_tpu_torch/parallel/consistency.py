"""Replica-consistency checking across the ranks of a process world.

The port of ``chronoedit_tpu/parallel/consistency.py``. In a multi-rank run
every replicated tensor must hold bitwise-identical data on every replica;
divergence (a nondeterministic collective, host state leaking into
replicated parameters, a restore race) forks a run silently. JAX compares
the addressable shards of each array that cover the same index range; in
the port each rank holds its replica of a tensor, so
:func:`check_replica_consistency` hashes every tensor on every rank,
gathers the digests with ``all_gather_object`` and returns the paths of
the tensors whose digests differ. In one process no replica can disagree
and it returns ``[]``. :func:`tree_digest` is one deterministic digest of a
whole tree, to compare across ranks or runs. Under a mesh a replica is a
line's: :func:`check_state_replicas` compares a train state's tensors along
each axis, each over the leaves that axis keeps whole (every leaf over a
data or context line, every leaf outside the blocks over a pipe line, the
leaves a tensor or fsdp plan leaves whole over its line), with their EMA
and AdamW's moments. Under pipe x fsdp a pipe line's ranks share an fsdp
index, so the non-block leaves' fsdp slices are alike along it; along an
fsdp line the two peers of a stage hold the same blocks, and the leaves
the plan keeps whole, block or not, are alike.

A "tree" here is what the trainer and the pipeline hold: tensors,
``nn.Module``s (their parameters and buffers), dicts, lists, tuples and
dataclasses of them. The cost is one device-to-host copy of every tensor:
run it every few thousand steps (``ReplicaConsistencyCallback``), not every
step.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Iterator

import torch
import torch.distributed as dist
from torch import nn


def named_tensors(tree: Any, prefix: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    """(path, tensor) pairs of ``tree`` in a deterministic order."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, nn.Module):
        for name, t in tree.state_dict(keep_vars=True).items():
            if isinstance(t, torch.Tensor):
                yield f"{prefix}/{name}" if prefix else name, t
    elif isinstance(tree, dict):
        for k in tree:
            yield from named_tensors(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_tensors(v, f"{prefix}/{i}" if prefix else str(i))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from named_tensors(getattr(tree, f.name),
                                     f"{prefix}/{f.name}" if prefix else f.name)


def _digest(t: torch.Tensor) -> str:
    data = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha256(data.tobytes()).hexdigest()


def check_replica_consistency(tree: Any, group=None) -> list[str]:
    """The paths of tensors whose replicas disagree across the ranks of
    ``group`` (default the whole world), the same list on every rank;
    empty when healthy, and always in one process. Every rank of the group
    must call it with a tree of the same structure."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return []
    mine = [(path, _digest(t)) for path, t in named_tensors(tree)]
    everyone: list = [None] * dist.get_world_size(group)
    dist.all_gather_object(everyone, mine, group=group)
    bad = []
    for i, (path, _) in enumerate(mine):
        if len({theirs[i] for theirs in everyone}) > 1:
            bad.append(path)
    return bad


def tree_digest(tree: Any) -> str:
    """Deterministic sha256 over every tensor's path, dtype, shape and
    bytes: compare it across ranks to find a diverged replica."""
    h = hashlib.sha256()
    for path, t in named_tensors(tree):
        h.update(f"{path}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(_digest(t).encode())
    return h.hexdigest()


def whole_leaves(owner: nn.Module, axis: str) -> list[str]:
    """The names of ``owner``'s parameters that every rank of this rank's
    line along a mesh's ``axis`` holds whole: all of them along
    ``data`` and ``context``; along ``fsdp`` and ``tensor`` those the
    model's plan (``owner.fsdp``, ``owner.tensor``) keeps whole; along
    ``pipe`` those outside the blocks (each stage holds its own blocks;
    beside fsdp, the slices of the rank's fsdp index, which the line
    shares)."""
    names = [n for n, _ in owner.named_parameters()]
    if axis == "pipe":
        return [n for n in names if not n.startswith("blocks.")]
    plan = getattr(owner, axis, None) if axis in ("fsdp", "tensor") else None
    return [n for n in names if plan is None or plan.dims.get(n) is None]


def state_line_trees(state: Any, mesh) -> dict[str, dict[str, torch.Tensor]]:
    """For each axis of ``mesh`` above 1, the train state's tensors that
    every rank of this rank's line along the axis holds alike, by path:
    the parameters, the EMA and AdamW's moments of the leaves the axis
    keeps whole (:func:`whole_leaves`)."""
    owner = state.model if hasattr(state, "model") else state.lora
    adamw = state.optimizer.adamw.state
    index = {n: i for i, (n, _) in enumerate(owner.named_parameters())}
    out = {}
    for axis, n in mesh.shape.items():
        if n == 1:
            continue
        tree = out[axis] = {}
        for name in whole_leaves(owner, axis):
            p = state.params[index[name]]
            tree[f"params/{name}"] = p
            if state.ema_params is not None:
                tree[f"ema_params/{name}"] = state.ema_params[index[name]]
            for key in ("exp_avg", "exp_avg_sq"):
                if key in adamw.get(p, {}):
                    tree[f"opt_state/{key}/{name}"] = adamw[p][key]
    return out


def check_state_replicas(state: Any, mesh) -> dict[str, list[str]]:
    """For each axis of ``mesh`` above 1, the paths of the train state's
    tensors that its line keeps whole (:func:`state_line_trees`) and that
    differ across the line; every rank of the mesh must call it."""
    return {axis: check_replica_consistency(tree, group=mesh.group(axis))
            for axis, tree in state_line_trees(state, mesh).items()}
