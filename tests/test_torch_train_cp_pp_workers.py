"""The rank bodies of the context and pipeline training tests
(``test_torch_train_cp_pp.py``).

``parallel.launch.run_world`` starts each world with the ``spawn`` method,
so every rank imports this module afresh: it imports torch, numpy and the
port only (and the rank helpers of ``test_torch_train_mesh_workers.py``),
never jax or the JAX package. Each function runs on one rank of a gloo
world on the CPU and returns numpy arrays or plain values, every tensor
under the whole model's name (``DiT.global_name``: a pipeline stage's
blocks by their global index); the JAX side runs in the test's process.

The weights come as numpy trees in JAX's layout, the batch as the global
batch's numpy rows and the draws as the global batch's ``(u, noise)`` per
micro-step: process ``p`` of ``P`` holds rows ``[p B / P, (p + 1) B / P)``,
``host_local_to_global`` gives every rank its data line's rows, and the
step takes the line's rows of the draws. Under a pipe axis each rank keeps
its stage's blocks of the whole model (``DiT.keep_layers``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import torch
import torch.distributed as dist

from test_torch_train_mesh_workers import _mesh, _model, line_batch, line_rows, state_arrays
from test_torch_train_mesh_workers import host_rows  # noqa: F401  (a job by name)


def run_jobs(rank: int, jobs: list[tuple[str, tuple]]) -> list:
    """Each job, (the name of a function here, its arguments after the
    rank), in turn on this rank; their results in order."""
    return [globals()[name](rank, *args) for name, args in jobs]


@contextlib.contextmanager
def plant(fault: str | None):
    """Plant ``fault`` in this process for the duration:
    "context_unsummed" (each rank keeps its token block's share of every
    gradient), "context_averaged" (the shares averaged over the context
    group, not summed), "stage_norm" (the global norm over this rank's
    stage's blocks only: nothing summed over pipe) or "pipe_data_split"
    (under pipe x data the forward runs under the whole mesh, so the
    pipeline splits the line's rows over data again, and the step still
    averages over data). None: nothing."""
    from chronoedit_tpu_torch.train import train_step

    saved = train_step.context_sum, train_step._sum_over, train_step.forward_mesh
    if fault == "context_unsummed":
        train_step.context_sum = lambda tensors, group: list(tensors)
    elif fault == "context_averaged":
        def averaged(tensors, group):
            n = 1 if group is None else dist.get_world_size(group)
            return [t / n for t in saved[0](tensors, group)]
        train_step.context_sum = averaged
    elif fault == "stage_norm":
        train_step._sum_over = lambda partial, group: partial
    elif fault == "pipe_data_split":
        train_step.forward_mesh = lambda mesh: mesh
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        train_step.context_sum, train_step._sum_over, train_step.forward_mesh = saved


def _cfg(cfg, mode: str | None):
    return cfg if mode is None else dataclasses.replace(cfg, context_parallel=mode)


def stage_model(cfg, params, mesh):
    """The whole model of ``params``, cut to this rank's pipeline stage and
    sharded for ``mesh``."""
    from chronoedit_tpu_torch.parallel.pipeline_parallel import stage_range
    from chronoedit_tpu_torch.parallel.sharding import shard_params

    model = _model(cfg, params).keep_layers(stage_range(cfg.num_layers, mesh))
    return shard_params(model, mesh)


def global_arrays(state, model) -> dict:
    """``state_arrays`` of a state over ``model``, by the whole model's
    names."""
    return {kind: {model.global_name(n): v for n, v in by_name.items()}
            for kind, by_name in state_arrays(state, model).items()}


def _run(cfg, params, batch: dict, draws: list, tc, mesh):
    """A full-parameter state over this rank's stage-local, sharded model,
    and a call that runs micro-step ``i`` on its draws (the line's rows)."""
    from chronoedit_tpu_torch.train import train_step

    line = line_batch(batch, mesh)
    rows = line_rows(mesh, len(line["latents"]))
    model = stage_model(cfg, params, mesh)
    state = train_step.make_train_state(model, tc, mesh)
    step = train_step.make_train_step(cfg, tc, mesh)

    def run(i: int) -> dict:
        u, noise = draws[i]
        m = step(state, line, u=torch.from_numpy(u[rows]), noise=torch.from_numpy(noise[rows]))
        return {k: float(v) for k, v in m.items()}

    return state, run, len(line["latents"])


def train(rank: int, cfg, params, batch: dict, draws: list, config: dict, tcfg: dict,
          mode: str | None = None, fault: str | None = None) -> dict:
    """The full-parameter step under a mesh of ``config`` (``mode`` the
    context-parallel mode), one micro-step for each of ``draws``,
    ``fault`` planted. Returns the metrics of every micro-step, the
    state's arrays and boxes by global name, and the replica check along
    every axis (``check_state_replicas``)."""
    from chronoedit_tpu_torch.parallel.consistency import check_state_replicas
    from chronoedit_tpu_torch.train.train_step import TrainConfig

    mesh = _mesh(config)
    state, run, rows = _run(_cfg(cfg, mode), params, batch, draws, TrainConfig(**tcfg), mesh)
    with plant(fault):
        metrics = [run(i) for i in range(len(draws))]
    return {"metrics": metrics, "rows": rows, **global_arrays(state, state.model),
            "replicas": check_state_replicas(state, mesh), "layers": list(state.model.layers)}


def checkpoints(rank: int, cfg, params, batch: dict, draws: list, tcfg: dict,
                directory: str) -> dict:
    """A sharded checkpoint under pipe 2 x context 2 (a world of 4): two
    micro-steps, an async save at 2, a third micro-step (the straight run);
    a fresh state of the same layout restored from step 2 takes the third
    micro-step again. Returns the arrays as saved, straight and resumed,
    and the names and bytes of this rank's file."""
    from safetensors import safe_open

    from chronoedit_tpu_torch.train import checkpoint as ck
    from chronoedit_tpu_torch.train.train_step import TrainConfig

    tc, mesh = TrainConfig(**tcfg), _mesh(dict(pipe=2, context=2))
    state, run, _ = _run(cfg, params, batch, draws, tc, mesh)
    mgr = ck.CheckpointManager(ck.CheckpointConfig(directory=directory))
    run(0)
    run(1)
    mgr.save(2, state)  # async: the host copy is made before it returns
    res = {"saved": global_arrays(state, state.model)}
    run(2)
    mgr.wait_until_finished()
    res["straight"] = global_arrays(state, state.model)
    file = os.path.join(directory, "2", ck.RANK_FILE.format(rank))
    res["file_bytes"] = os.path.getsize(file) if os.path.exists(file) else 0
    res["names"] = []
    if os.path.exists(file):
        with safe_open(file, framework="pt") as f:
            res["names"] = sorted(f.keys())
    state, run, _ = _run(cfg, params, batch, draws, tc, mesh)
    ck.CheckpointManager(ck.CheckpointConfig(directory=directory)).restore(state)
    run(2)
    res["resumed"] = global_arrays(state, state.model)
    return res


def restore(rank: int, cfg, params, config: dict, tcfg: dict, directory: str) -> dict:
    """A fresh state under a mesh of ``config`` restored from the latest
    step in ``directory``: its arrays by global name and its step."""
    from chronoedit_tpu_torch.train import checkpoint as ck
    from chronoedit_tpu_torch.train.train_step import TrainConfig, make_train_state

    mesh = _mesh(config)
    state = make_train_state(stage_model(cfg, params, mesh), TrainConfig(**tcfg), mesh)
    ck.CheckpointManager(ck.CheckpointConfig(directory=directory)).restore(state)
    return {"step": state.step, **global_arrays(state, state.model)}


def trainer_resume(rank: int, cfg, params, batch: dict, tcfg: dict, straight_dir: str,
                   resumed_dir: str) -> dict:
    """The ``Trainer`` under pipe 2 (a world of 2) on the line's rows of
    ``batch`` every iteration: 4 iterations straight (saving at 2 and 4
    into ``straight_dir``), and 2 iterations, then a new ``Trainer``
    resumed from their checkpoint for 2 more (``resumed_dir``); the
    straight run under a ``ReplicaConsistencyCallback`` every iteration
    (it raises on a line whose whole leaves differ). Returns
    both final states' arrays, the replica check and the resumed step."""
    from chronoedit_tpu_torch.parallel.consistency import check_state_replicas
    from chronoedit_tpu_torch.train.callbacks import ReplicaConsistencyCallback
    from chronoedit_tpu_torch.train.checkpoint import CheckpointConfig
    from chronoedit_tpu_torch.train.train_step import TrainConfig
    from chronoedit_tpu_torch.train.trainer import Trainer, TrainerConfig

    mesh = _mesh(dict(pipe=2))
    line = line_batch(batch, mesh)

    def trainer(directory: str, max_iter: int, callbacks=None) -> Trainer:
        return Trainer(cfg, TrainConfig(**tcfg), TrainerConfig(max_iter=max_iter, save_every=2),
                       CheckpointConfig(directory=directory), callbacks, mesh=mesh)

    # the straight run checks every line's replicas after each iteration
    t = trainer(straight_dir, 4, [ReplicaConsistencyCallback(every_n=1)])
    straight = t.train(t.init_state(stage_model(cfg, params, mesh)), iter([line] * 4))
    t = trainer(resumed_dir, 2)
    t.train(t.init_state(stage_model(cfg, params, mesh)), iter([line] * 2))
    t = trainer(resumed_dir, 4)
    state = t.init_state(stage_model(cfg, params, mesh))
    start = state.step
    resumed = t.train(state, iter([line] * 2))
    return {"straight": global_arrays(straight, straight.model),
            "resumed": global_arrays(resumed, resumed.model), "start": start,
            "replicas": check_state_replicas(resumed, mesh)}
