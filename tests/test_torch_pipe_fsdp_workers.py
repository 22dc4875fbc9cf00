"""The rank bodies of the pipe x fsdp tests (``test_torch_pipe_fsdp.py``).

``parallel.launch.run_world`` starts each world with the ``spawn`` method,
so every rank imports this module afresh: it imports torch, numpy and the
port only (and the rank helpers of the other workers' modules), never jax
or the JAX package. Each function runs on one rank of a gloo world on the
CPU and returns numpy arrays or plain values, every tensor under the whole
model's name (``DiT.global_name``: a pipeline stage's blocks by their
global index); the JAX side runs in the test's process.

Every rank builds its model as the port's entry points do: the whole
model of the seeded numpy weights, cut to its stage's blocks
(``DiT.keep_layers``), then sharded over fsdp (``shard_params``). A rank's
one-process reference (the whole model, no mesh) runs in the rank's own
process.
"""

from __future__ import annotations

import contextlib
import os
from collections import Counter

import torch

from test_torch_train_cp_pp_workers import global_arrays, stage_model
from test_torch_train_mesh_workers import _mesh, _model, line_batch, line_rows
from test_torch_pp_workers import mesh_layouts  # noqa: F401  (a job by name)

CPU = torch.device("cpu")


def run_jobs(rank: int, jobs: list[tuple[str, tuple]]) -> list:
    """Each job, (the name of a function here, its arguments after the
    rank), in turn on this rank; their results in order."""
    return [globals()[name](rank, *args) for name, args in jobs]


def held_bytes(module) -> int:
    """The bytes of every parameter and buffer ``module`` holds."""
    return sum(t.numel() * t.element_size() for t in (*module.parameters(), *module.buffers()))


def _plan(model) -> dict:
    """{global name: the fsdp dimension of the leaf, or None}."""
    return {model.global_name(n): d for n, d in model.fsdp.dims.items()}


@contextlib.contextmanager
def count_gathers():
    """Count, for the duration, the modules ``sharding.Gather`` puts whole
    (by the model's own name) and the leaves it gathers."""
    from chronoedit_tpu_torch.parallel import collectives
    from chronoedit_tpu_torch.parallel.sharding import Gather

    modules, leaves = Counter(), Counter()
    call, inner = Gather.__call__, collectives.gather_shard_autograd

    def gather(self, module):
        modules[self.names[module]] += 1
        return call(self, module)

    def leaf(x, *a):
        leaves["n"] += 1
        return inner(x, *a)

    Gather.__call__, collectives.gather_shard_autograd = gather, leaf
    try:
        yield modules, leaves
    finally:
        Gather.__call__, collectives.gather_shard_autograd = call, inner


def forward(rank: int, cfg, params, inputs: tuple, config: dict, mask=None) -> dict:
    """``dit_forward`` of the stage-local, fsdp-sharded model under a mesh
    of ``config``, against the whole model's in this process. Returns both
    outputs, the rank's stage, the bytes it holds against the whole
    model's, its plan, the modules gathered (by global name) and the
    leaves gathered."""
    from chronoedit_tpu_torch.models import dit as dit_t
    from test_torch_cp_workers import count_context_attention

    mesh = _mesh(config)
    args = [torch.from_numpy(a) for a in inputs]
    whole = _model(cfg, params)
    with torch.no_grad():
        one = dit_t.dit_forward(whole, *args, layer_mask=mask).numpy()
    model = stage_model(cfg, params, mesh)
    calls = count_context_attention()
    with torch.no_grad(), count_gathers() as (modules, leaves):
        out = dit_t.dit_forward(model, *args, mesh=mesh, layer_mask=mask).numpy()
    return {"one": one, "out": out, "layers": (model.layers.start, model.layers.stop),
            "held": held_bytes(model), "whole_held": held_bytes(whole),
            "block_held": held_bytes(model.blocks), "whole_block_held": held_bytes(whole.blocks),
            "plan": _plan(model), "calls": dict(calls),
            "gathered": {model.global_name(f"{n}.x").rsplit(".", 1)[0]: k
                         for n, k in modules.items()},
            "leaves": leaves["n"],
            "shapes": {model.global_name(n): tuple(p.shape)
                       for n, p in model.named_parameters()}}


def quantized(rank: int, cfg, params, config: dict, mode: str, inputs: tuple) -> dict:
    """``quantize_dit`` under a mesh of ``config`` on the stage-local,
    sharded model (each of the stage's blocks gathered, quantized whole,
    re-sharded) against quantizing the whole model, then cutting it to the
    stage and sharding it (JAX's order): the leaves bitwise, the plans
    equal; and the quantized forward under the mesh against the whole
    quantized model's in this process. int4 modes take the uniform grid
    (the Lloyd codebook would cost 13-16 s a process; the sharding does not
    depend on the grid)."""
    from chronoedit_tpu_torch.models import dit as dit_t
    from chronoedit_tpu_torch.ops import quant
    from chronoedit_tpu_torch.parallel.pipeline_parallel import stage_range
    from chronoedit_tpu_torch.parallel.sharding import shard_params

    quant.INT4_GRID = "uniform"
    mesh = _mesh(config)
    args = [torch.from_numpy(a) for a in inputs]
    whole = quant.quantize_dit(_model(cfg, params), mode=mode)
    with torch.no_grad():
        one = dit_t.dit_forward(whole, *args).numpy()
    want = shard_params(whole.keep_layers(stage_range(cfg.num_layers, mesh)), mesh)
    model = quant.quantize_dit(stage_model(cfg, params, mesh), mode=mode, mesh=mesh)
    got, ref = model.state_dict(), want.state_dict()
    with torch.no_grad():
        out = dit_t.dit_forward(model, *args, mesh=mesh).numpy()
    return {"names": sorted(got) == sorted(ref), "leaves": len(ref),
            "bitwise": sorted(k for k in ref if k in got and torch.equal(got[k], ref[k])),
            "quantized": sum(quant.is_quantized(m) for m in model.modules()),
            "plan_equal": model.fsdp.dims == want.fsdp.dims, "one": one, "out": out}


def load(rank: int, cfg, ckpt: str, lora: str, config: dict, edit_inputs: dict) -> dict:
    """``load_pipeline`` under a mesh of ``config`` from a checkpoint
    directory with a LoRA file (scale 0.8), against the whole load in this
    process: the leaves bitwise the whole load's stage-then-slice, the
    bytes read from the DiT shards and the LoRA file, the plan by global
    name, and a 2-step edit from each."""
    from chronoedit_tpu_torch.parallel.sharding import local_of
    from chronoedit_tpu_torch.pipeline.loader import load_pipeline

    mesh = _mesh(config)
    whole = load_pipeline(cfg, ckpt, loras=[(lora, 0.8)], device=CPU)
    sharded = load_pipeline(cfg, ckpt, loras=[(lora, 0.8)], device=CPU, mesh=mesh)
    model = sharded.dit
    want = dict(whole.dit.named_parameters())
    got = {n: p for n, p in model.named_parameters()}
    bitwise = sorted(model.global_name(n) for n, p in got.items()
                     if torch.equal(p, local_of(model, n, want[model.global_name(n)])))
    args = {k: torch.from_numpy(v) for k, v in edit_inputs.items()}
    with torch.no_grad():
        one = whole(**args, num_steps=2).numpy()
        out = sharded(**args, num_steps=2).numpy()
    return {"bitwise": bitwise, "params": len(got), "plan": _plan(model),
            "layers": (model.layers.start, model.layers.stop),
            "bytes": dict(sharded.load_bytes), "one": one, "out": out}


def pipeline(rank: int, cfg, dit_params, vae_params, inputs: dict, call: dict,
             config: dict) -> dict:
    """The port's pipeline under a mesh of ``config`` with a stage-local,
    fsdp-sharded DiT: the rank's output."""
    from chronoedit_tpu_torch.models import vae as vae_t
    from chronoedit_tpu_torch.models.from_jax import load_vae
    from chronoedit_tpu_torch.pipeline.edit_pipeline import ChronoEditPipeline

    mesh = _mesh(config)
    pipe_ = ChronoEditPipeline(cfg, stage_model(cfg.dit, dit_params, mesh),
                               load_vae(vae_t.VAE(cfg.vae), vae_params), mesh=mesh)
    args = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.no_grad():
        return {"out": pipe_(**args, **call).numpy()}


# ------------------------------------------------------------ training

@contextlib.contextmanager
def plant(fault: str | None, mesh):
    """Plant ``fault`` in this process for the duration: "fsdp_summed"
    (every fsdp gather's backward sums the ranks' gradients, as if each
    rank had run its own rows, while every rank of a stage ran the same
    ones) or "pipe_norm" (the global norm's sums of squares completed over
    tensor and fsdp but not over pipe). None: nothing."""
    from chronoedit_tpu_torch.parallel import collectives
    from chronoedit_tpu_torch.train import train_step

    saved = collectives.gather_shard_autograd, train_step._sum_over
    if fault == "fsdp_summed":
        collectives.gather_shard_autograd = (
            lambda x, group, dim, summed: saved[0](x, group, dim, True))
    elif fault == "pipe_norm":
        pipe = mesh.group("pipe")
        train_step._sum_over = (
            lambda partial, group: partial if group is pipe else saved[1](partial, group))
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        collectives.gather_shard_autograd, train_step._sum_over = saved


def _run(cfg, params, batch: dict, draws: list, tc, mesh):
    """A full-parameter state over this rank's stage-local, sharded model,
    and a call that runs micro-step ``i`` on its draws (the line's rows)."""
    from chronoedit_tpu_torch.train import train_step

    line = line_batch(batch, mesh)
    rows = line_rows(mesh, len(line["latents"]))
    state = train_step.make_train_state(stage_model(cfg, params, mesh), tc, mesh)
    step = train_step.make_train_step(cfg, tc, mesh)

    def run(i: int) -> dict:
        u, noise = draws[i]
        m = step(state, line, u=torch.from_numpy(u[rows]), noise=torch.from_numpy(noise[rows]))
        return {k: float(v) for k, v in m.items()}

    return state, run, len(line["latents"])


def train(rank: int, cfg, params, batch: dict, draws: list, config: dict, tcfg: dict,
          fault: str | None = None) -> dict:
    """The full-parameter step under a mesh of ``config``, one micro-step
    for each of ``draws``, ``fault`` planted. Returns the metrics of every
    micro-step, the state's arrays and boxes by global name, the replica
    check along every axis and the bytes of the parameters held."""
    from chronoedit_tpu_torch.parallel.consistency import check_state_replicas
    from chronoedit_tpu_torch.train.train_step import TrainConfig

    mesh = _mesh(config)
    state, run, rows = _run(cfg, params, batch, draws, TrainConfig(**tcfg), mesh)
    with plant(fault, mesh):
        metrics = [run(i) for i in range(len(draws))]
    return {"metrics": metrics, "rows": rows, **global_arrays(state, state.model),
            "replicas": check_state_replicas(state, mesh),
            "layers": (state.model.layers.start, state.model.layers.stop),
            "plan": _plan(state.model)}


def checkpoint(rank: int, cfg, params, batch: dict, draws: list, tcfg: dict, config: dict,
               directory: str) -> dict:
    """A sharded checkpoint under a mesh of ``config``: two micro-steps, an
    async save at 2, a third micro-step (the straight run); a fresh state
    of the same layout restored from step 2 takes the third micro-step
    again. Returns the arrays as saved, straight and resumed, and the names
    and bytes of this rank's file."""
    from safetensors import safe_open

    from chronoedit_tpu_torch.train import checkpoint as ck
    from chronoedit_tpu_torch.train.train_step import TrainConfig

    tc, mesh = TrainConfig(**tcfg), _mesh(config)
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
    res["restored"] = global_arrays(state, state.model)
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


def trainer_resume(rank: int, cfg, params, batch: dict, tcfg: dict, config: dict,
                   straight_dir: str, resumed_dir: str) -> dict:
    """The ``Trainer`` under a mesh of ``config`` on the line's rows of
    ``batch`` every iteration: 4 iterations straight (saving at 2 and 4
    into ``straight_dir``) under a ``ReplicaConsistencyCallback`` every
    iteration (it raises on a line whose whole leaves differ), and 2
    iterations, then a new ``Trainer`` resumed from their checkpoint for 2
    more (``resumed_dir``). Returns both final states' arrays, the replica
    check and the resumed start."""
    from chronoedit_tpu_torch.parallel.consistency import check_state_replicas
    from chronoedit_tpu_torch.train.callbacks import ReplicaConsistencyCallback
    from chronoedit_tpu_torch.train.checkpoint import CheckpointConfig
    from chronoedit_tpu_torch.train.train_step import TrainConfig
    from chronoedit_tpu_torch.train.trainer import Trainer, TrainerConfig

    mesh = _mesh(config)
    line = line_batch(batch, mesh)

    def trainer(directory: str, max_iter: int, callbacks=None) -> Trainer:
        return Trainer(cfg, TrainConfig(**tcfg), TrainerConfig(max_iter=max_iter, save_every=2),
                       CheckpointConfig(directory=directory), callbacks, mesh=mesh)

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
