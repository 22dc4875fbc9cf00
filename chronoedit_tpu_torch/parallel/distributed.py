"""The process world: joining it, and process-aware helpers.

The port of ``chronoedit_tpu/parallel/distributed.py``. JAX's
``init_distributed`` joins a multi-host world from ``JAX_*`` variables;
the port's joins the world a launcher describes: torchrun's
``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` with ``MASTER_ADDR`` /
``MASTER_PORT`` (the ``env://`` rendezvous), or an explicit
``init_method`` (a ``file://`` path, as the tests and ``chip_smoke.py``
use).

The backend follows the device: NCCL when each rank drives its own CUDA
device, gloo for CPU tensors. ``backend=`` names one explicitly, and only
then does a world run over a backend that the device would not pick: the
one-card check runs P ranks as P processes on one GPU over gloo (NCCL
refuses two ranks on one device), and ``parallel/collectives.py`` stages
their CUDA tensors through host memory. Nothing moves from one backend to
another on its own.

:func:`host_local_to_global` assembles data-parallel training's batch from
each process's rows (JAX's makes global arrays of them; here every rank of
a data line ends up holding the line's rows).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from chronoedit_tpu_torch.parallel.collectives import all_gather, all_reduce
from chronoedit_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_PIPE, MESH_AXES
from chronoedit_tpu_torch.utils.platform import cuda_device, multi_device_world

# a rendezvous or collective that waits longer than this fails instead of
# hanging
TIMEOUT = datetime.timedelta(seconds=600)


def _launched() -> bool:
    return "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ


def init_distributed(backend: str | None = None, device: torch.device | None = None,
                     init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None,
                     timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Join the launcher's process world. Returns True when a process group
    was set up (or already was), False for one process without a launcher.

    ``world_size`` / ``rank`` default from ``WORLD_SIZE`` / ``RANK`` and
    ``init_method`` from torchrun's ``env://``. With no launcher (no
    ``WORLD_SIZE`` and ``MASTER_ADDR``) and no ``init_method`` this is a
    no-op at one process and raises for more, rather than wait on a
    rendezvous that nobody set up. A torchrun world of one process is
    joined like any other.

    ``device`` is this rank's device: by default ``cuda_device()``
    (``cuda:LOCAL_RANK``), which raises without a card; a CPU world is
    asked for by passing ``torch.device("cpu")``. The backend is NCCL for a
    CUDA device, gloo for the CPU, unless ``backend`` says otherwise; on
    CUDA the rank's device becomes the current one. ``timeout`` bounds
    each collective of the process group.
    """
    if dist.is_initialized():
        return True
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if init_method is None:
        if not _launched():
            if world_size <= 1:
                return False
            raise ValueError(
                f"WORLD_SIZE={world_size} without MASTER_ADDR / MASTER_PORT: start the "
                f"processes under torchrun, or pass init_method")
        init_method = "env://"
    device = cuda_device() if device is None else torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timeout, **kw)
    return True


def leave_world() -> None:
    """Leave the process world together at the end of a run: a barrier, so
    that no rank exits while a peer still talks to it, then the process
    group's teardown (a rank that exits with its gloo group open may abort
    in the group's destructor). A no-op without a process group; every rank
    must call it."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """Rank-0 check (the reference's rank0-only logging/checkpoint guard)."""
    return process_index() == 0


def _host_device() -> torch.device:
    """Where a small host value goes for a collective over the world: the
    current card under NCCL (which moves CUDA tensors only), the host
    under gloo."""
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))


def collate_metrics(metrics: dict) -> dict:
    """The cross-process means of scalar metrics (the reference's
    distributed-eval ``collate_batches``): each process evaluates its own
    batches, one ``all_reduce`` in float64 sums them. One process: each
    value as a float."""
    values = {k: float(v) for k, v in metrics.items()}
    n = process_count()
    if n == 1 or not values:
        return values
    t = all_reduce(torch.tensor(list(values.values()), dtype=torch.float64,
                                device=_host_device()), None)
    return {k: float(x) / n for k, x in zip(values, t.tolist())}


def local_batch_size(global_batch: int) -> int:
    """Per-process batch size for a given global batch."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n


def all_gather_float(value: float) -> list[float]:
    """Every process's ``value``, in rank order (one float64 all-gather over
    the world; JAX's ``process_allgather`` of a scalar). One process: the
    value alone."""
    if process_count() == 1:
        return [float(value)]
    t = torch.tensor([float(value)], dtype=torch.float64, device=_host_device())
    return all_gather(t, None, 0).tolist()


def host_local_to_global(batch: dict, mesh) -> dict:
    """The data line's rows from each process's rows (JAX's
    ``host_local_to_global``, which makes global arrays sharded over
    ``data`` from the processes' rows).

    Each process holds ``local_batch_size(global_batch)`` rows of the
    global batch, the processes' rows in rank order making it. Every rank
    of data index ``d`` of ``D`` ends up holding the global batch's rows
    ``[d B / D, (d + 1) B / D)`` in order, JAX's ``P("data")`` layout,
    whatever the other axes: the same inputs on every rank of a data line,
    which is what a training step under the mesh takes (its forward runs
    the line's rows, ``Mesh.data_line``). Without a pipe axis the ranks of
    a data line are consecutive, and they gather their rows along the
    other axes, innermost first. Under a pipe axis (outermost in the rank
    order) a line's ranks are not consecutive: each rank gathers the whole
    global batch over the world and keeps its line's block. Under context
    every rank of a context line holds the line's rows whole (the forward
    splits their tokens). One process: ``batch`` itself. ``None`` values
    stay None; every rank must hold the same keys."""
    if not multi_device_world():
        return batch
    out = dict(batch)
    if mesh.shape.get(AXIS_PIPE, 1) > 1:
        lines, d = mesh.shape.get(AXIS_DATA, 1), mesh.index(AXIS_DATA)
        for key, value in out.items():
            if isinstance(value, torch.Tensor):
                out[key] = all_gather(value.contiguous(), None, 0).chunk(lines)[d]
        return out
    for axis in reversed(MESH_AXES):
        group = None if axis == AXIS_DATA else mesh.group(axis)
        if group is None:
            continue
        for key, value in out.items():
            if isinstance(value, torch.Tensor):
                out[key] = all_gather(value.contiguous(), group, 0)
    return out
