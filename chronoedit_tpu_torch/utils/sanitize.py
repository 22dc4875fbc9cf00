"""Runtime sanitizers: non-finite values and host syncs in the hot loop.

The port of ``chronoedit_tpu/utils/sanitize.py``. The failure modes are
the same; the hooks are PyTorch's:

- **non-finite values** escaping a step silently (caught late by the
  trainer's deferred loss check): :func:`debug_numerics` raises
  ``FloatingPointError`` at the first operator whose floating output holds
  a NaN or an Inf, in the forward and in the backward alike (a
  ``TorchDispatchMode`` that reads every output; anomaly mode checks only
  the backward's). It reads each output back to the host, so it is a
  diagnosis mode, not a production default;
- **accidental host syncs** in the hot loop (a stray ``float(x)`` /
  ``.item()`` / ``bool(t)`` that waits for the card, or a blocking copy):
  :func:`no_host_sync` turns every synchronising CUDA call inside the
  block into an error (``torch.cuda.set_sync_debug_mode("error")``). It
  is vacuous without a CUDA device, as JAX's guard is on its CPU backend;
- **replica divergence**: see :mod:`chronoedit_tpu_torch.parallel.consistency`.

``Trainer`` exposes the sync guard as ``TrainerConfig.guard_host_sync``: it
wraps only the micro-batch step calls, not the trainer's own deferred loss
flush or validation, which read back by design.

One difference from JAX's transfer guard: CUDA's debug mode flags every
synchronising copy, host-to-device ones from pageable memory included
(JAX allows the feed), so a guarded step takes its batch on the device
already, and the port's own host tables go to the device with
``non_blocking=True`` copies.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# operators whose output is uninitialised memory: nothing to check
_UNINITIALISED = frozenset({
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
})


class _FiniteOutputs(TorchDispatchMode):
    """Raise at the first operator with a non-finite floating output."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func not in _UNINITIALISED:
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and not bool(torch.isfinite(t).all())):
                    raise FloatingPointError(
                        f"non-finite output of {func} (shape {tuple(t.shape)}, {t.dtype})")
        return out


@contextlib.contextmanager
def debug_numerics():
    """Raise ``FloatingPointError`` at the first operator inside the block,
    forward or backward, whose output holds a NaN or an Inf."""
    with _FiniteOutputs():
        yield


@contextlib.contextmanager
def no_host_sync():
    """Error on any synchronising CUDA call inside the block (a device to
    host read, a blocking copy, a stream synchronise); the previous debug
    mode is restored on exit. Vacuous without a CUDA device."""
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def assert_no_host_sync(fn, *args, **kwargs):
    """Run ``fn`` once under :func:`no_host_sync`; return its result."""
    with no_host_sync():
        return fn(*args, **kwargs)
