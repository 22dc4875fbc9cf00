"""The rank bodies of the multi-process training tests
(``test_torch_train_mesh.py``).

``parallel.launch.run_world`` starts each world with the ``spawn`` method,
so every rank imports this module afresh: it imports torch, numpy and the
port only, never jax or the JAX package. Each function runs on one rank of
a gloo world on the CPU and returns numpy arrays or plain values; the JAX
side of each comparison runs in the test's own process.

The weights come as numpy trees in JAX's layout (``models/from_jax.py``
loads them), the batch as the global batch's numpy rows and the draws as
the global batch's ``(u, noise)`` per micro-step: process ``p`` of ``P``
holds rows ``[p B / P, (p + 1) B / P)``, ``host_local_to_global`` gives
its data line's rows, and the step takes the line's rows of the draws.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from chronoedit_tpu_torch.parallel.mesh import MeshConfig, make_mesh

CPU = torch.device("cpu")
AXES = ("data", "fsdp", "tensor")


def _mesh(config: dict):
    return make_mesh(MeshConfig(**config), device=CPU)


def run_jobs(rank: int, jobs: list[tuple[str, tuple]]) -> list:
    """Each job, (the name of a function here, its arguments after the
    rank), in turn on this rank; their results in order."""
    return [globals()[name](rank, *args) for name, args in jobs]


@contextlib.contextmanager
def plant(fault: str | None):
    """Plant ``fault`` in this process for the duration: "local_norm" (the
    global norm over this rank's shards alone), "data_sum" (gradients
    summed over data, not averaged), "data_alone" (gradients left as each
    data line computed them) or "tensor_unreduced" (the replicated leaves
    each tensor rank used a slice of, the q / k norm weights, keep the
    rank's own partial gradient). None: nothing."""
    from chronoedit_tpu_torch.parallel import collectives
    from chronoedit_tpu_torch.train import train_step

    saved = train_step._sum_over, train_step.data_mean, collectives.sum_grad_autograd
    if fault == "local_norm":
        train_step._sum_over = lambda partial, group: partial
    elif fault == "data_sum":
        def summed(tensors, mesh):
            group = mesh.group("data")
            return [collectives.all_reduce(t.contiguous(), group) for t in tensors]
        train_step.data_mean = summed
    elif fault == "data_alone":
        train_step.data_mean = lambda tensors, mesh: list(tensors)
    elif fault == "tensor_unreduced":
        collectives.sum_grad_autograd = lambda x, group: x
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        train_step._sum_over, train_step.data_mean, collectives.sum_grad_autograd = saved


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def line_batch(batch: dict, mesh) -> dict:
    """This process's rows of the global ``batch`` (numpy), gathered into
    its data line's rows by ``host_local_to_global``."""
    from chronoedit_tpu_torch.parallel.distributed import host_local_to_global, local_batch_size

    n = local_batch_size(len(batch["latents"]))
    mine = slice(dist.get_rank() * n, (dist.get_rank() + 1) * n)
    return host_local_to_global({k: torch.from_numpy(v[mine]) for k, v in batch.items()}, mesh)


def line_rows(mesh, b: int) -> slice:
    """The global batch's rows of this rank's data line of ``b`` rows."""
    return slice(mesh.index("data") * b, (mesh.index("data") + 1) * b)


def host_rows(rank: int, batch: dict, config: dict) -> dict:
    """``host_local_to_global`` under a mesh of ``config``: whether this
    rank's line rows equal the global batch's rows of its data index, and
    how many it holds."""
    mesh = _mesh(config)
    line = line_batch(batch, mesh)
    b = len(line["latents"])
    rows = line_rows(mesh, b)
    return {"rows": b, "equal": all(np.array_equal(line[k].numpy(), v[rows])
                                    for k, v in batch.items())}


def _model(cfg, params):
    from chronoedit_tpu_torch.models import dit as dit_t
    from chronoedit_tpu_torch.models.from_jax import load_dit

    return load_dit(dit_t.DiT(cfg), params)


def _lora(model, lora_np, rank: int):
    from chronoedit_tpu_torch.models import lora as lora_t
    from chronoedit_tpu_torch.models.from_jax import load_lora

    return load_lora(lora_t.LoRA(model, lora_t.LoRAConfig(rank=rank)), lora_np)


def state_arrays(state, owner) -> dict:
    """{kind: {parameter name: this rank's tensor}} of a train state: the
    parameters, the EMA and AdamW's moments, plus each leaf's box (its
    whole shape and where this rank's block starts)."""
    from chronoedit_tpu_torch.parallel.sharding import local_box

    names = [n for n, _ in owner.named_parameters()]
    adamw = state.optimizer.adamw.state
    out = {"params": {}, "ema": {}, "exp_avg": {}, "exp_avg_sq": {}, "boxes": {}}
    for i, (n, p) in enumerate(zip(names, state.params)):
        out["params"][n] = _numpy(p)
        out["ema"][n] = _numpy(state.ema_params[i])
        for key in ("exp_avg", "exp_avg_sq"):
            out[key][n] = _numpy(adamw[p][key])
        out["boxes"][n] = local_box(owner, n, tuple(p.shape))
    return out


def replica_check(state, owner, mesh) -> dict:
    """For each mesh axis above 1, the state's tensors (parameters, EMA,
    moments) that should be alike on every rank of this rank's line along
    it and are not (``parallel.consistency``): all of them along data,
    those the model keeps whole along fsdp and tensor."""
    from chronoedit_tpu_torch.parallel.consistency import check_replica_consistency

    adamw = state.optimizer.adamw.state
    names = [n for n, _ in owner.named_parameters()]
    out = {}
    for axis in AXES:
        group = mesh.group(axis)
        if group is None:
            continue
        plan = getattr(owner, axis, None) if axis != "data" else None
        tree = {}
        for i, (n, p) in enumerate(zip(names, state.params)):
            if plan is not None and plan.dims.get(n) is not None:
                continue
            tree[f"params/{n}"] = p
            tree[f"ema/{n}"] = state.ema_params[i]
            for key in ("exp_avg", "exp_avg_sq"):
                tree[f"{key}/{n}"] = adamw[p][key]
        out[axis] = check_replica_consistency(tree, group=group)
    return out


def train(rank: int, kind: str, cfg, params, batch: dict, draws: list, config: dict,
          tcfg: dict, fault: str | None = None, lora_np=None, lora_rank: int = 2) -> dict:
    """``kind`` "full" (``make_train_step``) or "lora" (``make_lora_train_step``
    over the frozen base) under a mesh of ``config``: the model of
    ``params`` sharded by ``shard_params``, this data line's rows of
    ``batch``, one micro-step for each of ``draws`` with the line's rows of
    them, ``fault`` planted. Returns the metrics of every micro-step, the
    state's arrays and boxes (``state_arrays``) and the replica check."""
    from chronoedit_tpu_torch.parallel.sharding import shard_params
    from chronoedit_tpu_torch.train import lora_train, train_step

    mesh = _mesh(config)
    line = line_batch(batch, mesh)
    rows = line_rows(mesh, len(line["latents"]))
    model = _model(cfg, params)
    lora = _lora(model, lora_np, lora_rank) if kind == "lora" else None
    shard_params(model, mesh)
    tc = train_step.TrainConfig(**tcfg)
    if kind == "full":
        state = train_step.make_train_state(model, tc, mesh)
        step = train_step.make_train_step(cfg, tc, mesh)
        owner = model
    else:
        state = lora_train.make_lora_train_state(lora, tc, mesh)
        inner = lora_train.make_lora_train_step(cfg, tc, mesh)
        step = lambda st, b, **kw: inner(st, model, b, **kw)  # noqa: E731
        owner = lora
    metrics = []
    with plant(fault):
        for u, noise in draws:
            m = step(state, line, u=torch.from_numpy(u[rows]),
                     noise=torch.from_numpy(noise[rows]))
            metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "rows": len(line["latents"]), **state_arrays(state, owner),
            "replicas": replica_check(state, owner, mesh)}


def _full_run(cfg, params, line, rows, draws, tc, mesh):
    """A sharded full-parameter state under ``mesh``, its step, and a call
    that runs it on the given micro-step's draws."""
    from chronoedit_tpu_torch.parallel.sharding import shard_params
    from chronoedit_tpu_torch.train import train_step

    model = shard_params(_model(cfg, params), mesh)
    state = train_step.make_train_state(model, tc, mesh)
    step = train_step.make_train_step(cfg, tc, mesh)

    def run(i: int) -> None:
        u, noise = draws[i]
        step(state, line, u=torch.from_numpy(u[rows]), noise=torch.from_numpy(noise[rows]))

    return state, run


def checkpoints(rank: int, cfg, params, batch: dict, draws: list, tcfg: dict,
                directory: str, one_process_dir: str) -> dict:
    """Sharded checkpoints in a world of 4. Under fsdp 2 x tensor 2: two
    micro-steps, an async save at 2 (the host copy made before ``save``
    returns), a third micro-step: the straight run. A fresh state under the
    same mesh restored from step 2 takes the third micro-step again. Under
    data 2 x fsdp 2 a fresh state is restored from step 2 (its shards
    returned as restored) and takes the third micro-step. Under fsdp 2 x
    tensor 2 a fresh state is restored from ``one_process_dir``, a
    checkpoint of one process. Returns each state's arrays and this rank's
    file's bytes."""
    from chronoedit_tpu_torch.train import checkpoint as ck
    from chronoedit_tpu_torch.train import train_step

    tc = train_step.TrainConfig(**tcfg)
    res = {}
    for label, config in (("fsdp2_tensor2", dict(fsdp=2, tensor=2)),
                          ("data2_fsdp2", dict(data=2, fsdp=2))):
        mesh = _mesh(config)
        line = line_batch(batch, mesh)
        rows = line_rows(mesh, len(line["latents"]))
        if label == "fsdp2_tensor2":
            state, run = _full_run(cfg, params, line, rows, draws, tc, mesh)
            mgr = ck.CheckpointManager(ck.CheckpointConfig(directory=directory))
            run(0)
            run(1)
            mgr.save(2, state)  # async: the host copy is made before it returns
            res["saved"] = state_arrays(state, state.model)
            run(2)
            mgr.wait_until_finished()
            res["straight"] = state_arrays(state, state.model)
            file = os.path.join(directory, "2", ck.RANK_FILE.format(rank))
            res["file_bytes"] = os.path.getsize(file) if os.path.exists(file) else 0
            res["steps"] = sorted(os.listdir(directory))
            state, run = _full_run(cfg, params, line, rows, draws, tc, mesh)
            ck.CheckpointManager(ck.CheckpointConfig(directory=directory)).restore(state)
            run(2)
            res["resumed"] = state_arrays(state, state.model)
            state, _ = _full_run(cfg, params, line, rows, draws, tc, mesh)
            ck.CheckpointManager(ck.CheckpointConfig(directory=one_process_dir)).restore(state)
            res["from_one_process"] = state_arrays(state, state.model)
        else:
            state, run = _full_run(cfg, params, line, rows, draws, tc, mesh)
            ck.CheckpointManager(ck.CheckpointConfig(directory=directory)).restore(state)
            res["restored_other"] = state_arrays(state, state.model)
            run(2)
            res["resumed_other"] = state_arrays(state, state.model)
            res["step"] = state.step
    return res


def straggler(rank: int, sleep_s: float) -> dict:
    """``StragglerDetector`` with its own gather in a world of 2: rank 1
    sleeps ``sleep_s`` inside its second step. Returns what each gather
    saw, the lines logged and this rank's step time."""
    from chronoedit_tpu_torch.train.callbacks import StragglerDetector

    lines, seen = [], []
    det = StragglerDetector(every_n=1, log_fn=lines.append)
    default = det.gather_fn
    det.gather_fn = lambda v: seen.append(default(v)) or seen[-1]
    for step in range(2):
        det.on_step_start(None, step)
        if step == 1 and rank == 1:
            time.sleep(sleep_s)
        det.on_step_end(None, step, {})
    return {"seen": [s.tolist() for s in seen], "lines": lines}


def collective_callbacks(rank: int, cfg, params) -> str:
    """A ``Trainer`` under data 2 whose ``StragglerDetector`` only rank 0
    holds: ``train`` must refuse on both ranks before the first step.
    Returns the error's message ("" when it did not raise)."""
    from chronoedit_tpu_torch.train.callbacks import StragglerDetector
    from chronoedit_tpu_torch.train.train_step import TrainConfig
    from chronoedit_tpu_torch.train.trainer import Trainer, TrainerConfig

    trainer = Trainer(cfg, TrainConfig(), TrainerConfig(max_iter=1),
                      callbacks=[StragglerDetector()] if rank == 0 else [],
                      mesh=_mesh(dict(data=2)))
    try:
        trainer.train(trainer.init_state(_model(cfg, params)), iter(()))
    except ValueError as e:
        return str(e)
    return ""
