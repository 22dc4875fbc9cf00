"""Replica-consistency checking, one process.

The port of ``chronoedit_tpu/parallel/consistency.py``. In a data-parallel
run every replicated tensor must hold bitwise-identical data on every
replica; divergence (a nondeterministic collective, host state leaking
into replicated parameters, a restore race) forks training silently. In
one process each tensor lives once, on one device, with no replica to
disagree, so :func:`check_replica_consistency` returns ``[]``; the
cross-process comparison (the digests of :func:`tree_digest` gathered
from every rank) is the multi-GPU slice's. :func:`tree_digest` is the
deterministic digest a rank would contribute.

A "tree" here is what the trainer holds: tensors, ``nn.Module``s (their
parameters and buffers), dicts, lists, tuples and dataclasses of them.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Iterator

import torch
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


def check_replica_consistency(tree: Any) -> list[str]:
    """The paths of tensors whose replicas disagree (empty: healthy). One
    process holds no replicas, so this is always ``[]``."""
    del tree
    return []


def tree_digest(tree: Any) -> str:
    """Deterministic sha256 over every tensor's path, dtype, shape and
    bytes: compare it across ranks to find a diverged replica."""
    h = hashlib.sha256()
    for path, t in named_tensors(tree):
        h.update(f"{path}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(_digest(t).encode())
    return h.hexdigest()
