"""Start a ``torch.distributed`` world of local processes and collect what
each rank returns: the launcher of the multi-process tests and of
``chip_smoke.py``'s context-parallel phase.

:func:`run_world` spawns the processes (the ``spawn`` start method: no
forked CUDA or thread state), joins them into one world through a
``file://`` rendezvous in a fresh directory (no port to clash with another
world), calls ``fn(rank, *args)`` in each and returns the results in rank
order; every rank whose process group is still open waits at a barrier
after ``fn`` returns, before it tears the group down. It raises with the
rank's traceback when a rank raises, and after
``timeout`` seconds when the world has not finished, terminating every
process either way, so a rendezvous or collective that never completes
fails instead of hanging. A user's job starts its ranks with torchrun
instead (``scripts/run_inference.py --mesh``).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue as queue_lib
import shutil
import tempfile
import time
import traceback


def _worker(rank: int, world: int, rdv: str, backend: str | None, device: str,
            threads: int, pg_timeout: float | None, out) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    from chronoedit_tpu_torch.parallel.distributed import TIMEOUT, init_distributed

    init_file = os.path.join(rdv, "init")
    try:
        with open(os.path.join(rdv, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        torch.set_num_threads(threads)
        init_distributed(backend=backend, device=torch.device(device),
                         init_method=f"file://{init_file}", world_size=world, rank=rank,
                         timeout=(TIMEOUT if pg_timeout is None
                                  else datetime.timedelta(seconds=pg_timeout)))
        # every rank's connections are up before any rank may finish and
        # exit: a rank that leaves early breaks a peer's still-open connect
        dist.barrier()
        result = fn(rank, *args)
        # and no rank tears its groups down while a peer still connects a
        # group that ``fn`` opened after the first barrier (a served world
        # that ended itself closed its group inside ``fn`` on every rank)
        if dist.is_initialized():
            dist.barrier()
        out.put((rank, True, result))
    except BaseException:  # the parent re-raises it with the rank's traceback
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn, world: int, args: tuple = (), *, backend: str | None = None,
              device: str = "cpu", timeout: float = 120.0, threads: int = 1,
              tmp_dir: str | None = None, pg_timeout: float | None = None) -> list:
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each call in its own
    process of a ``world``-rank process group on ``device`` (every rank the
    same device: the CPU, or one card shared by all ranks), over
    ``backend`` (default by device: NCCL for CUDA, gloo for the CPU).
    ``fn`` and ``args`` must pickle (a module-level function); so must the
    results, which come back through a pipe. ``threads`` is each rank's
    intra-op thread count; the rendezvous directory is made under
    ``tmp_dir`` (default the temporary directory) and removed after.
    ``pg_timeout`` is the process group's collective timeout in seconds
    (default ``parallel/distributed.TIMEOUT``)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    rdv = tempfile.mkdtemp(prefix="rendezvous_", dir=tmp_dir)
    # the call goes through a file: arguments passed to a spawned process
    # travel through a pipe that the parent fills before the next start,
    # which would start the ranks one after another
    with open(os.path.join(rdv, "call.pkl"), "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_worker, args=(r, world, rdv, backend, device, threads,
                                               pg_timeout, out),
                         daemon=True)
             for r in range(world)]
    results: dict[int, object] = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"world of {world} did not finish in {timeout} s; "
                                   f"ranks done: {sorted(results)}")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited with "
                                       f"{[procs[r].exitcode for r in dead]} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.terminate()
        for p in started:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
        out.close()
        shutil.rmtree(rdv, ignore_errors=True)
    return [results[r] for r in range(world)]
