"""Training under context and pipeline parallelism against JAX: the
full-parameter step (clip, AdamW, EMA) under context 2 (``"auto"``, which
takes Ulysses on the tiny preset's heads, and ``"ring"``), pipe 2, data 2 x
pipe 2, pipe 2 x context 2, data 2 x context 2 and context 2 x tensor 2
(``grad_accum`` 1, and 2 under context 2, pipe 2 and data 2 x pipe 2)
against JAX's single-device ``make_train_step``, and under data 2 x pipe 2
x context 2 (a world of 8) against JAX's ``make_train_step(mesh=)`` on
that mesh of its 8 virtual devices, the parameters sharded by its
``dit_param_sharding``; every leaf a line keeps whole bitwise alike across
it; the planted faults (context gradients left unsummed or averaged, the
norm over a stage's own blocks, a pipeline that splits the line's rows
over data again before the mean over data), each failing its comparison;
``host_local_to_global`` under pipe; a sharded checkpoint saved under pipe
2 x context 2 (each block once, under its global name) restored into one
process, into pipe 2 and into its own layout; a pipe-2 ``Trainer`` resumed
bitwise and its checkpoint restored under context 2; ``train --mesh
pipe=2`` and ``--mesh context=2`` under ``torch.distributed.run``, and the
LoRA mode's refusal; JAX's video-prior training batch.

The port's side runs in worlds of 4, 2 and 8 gloo processes on the CPU,
each started once for the file (``test_torch_train_cp_pp_workers.py``
through ``parallel.launch.run_world``), one after another in the
background while this process computes JAX's references; the world of 2
restores the world of 4's checkpoint. The same seeded numpy weights,
batch and JAX's draws (``u``, noise of the global batch per micro-step) go
to both sides; fp32, tiny preset (2 blocks, 2 heads: one block a stage).

Bounds are ``test_torch_train_mesh.py``'s: the loss within rtol 1e-5 of
JAX's, ``grad_norm`` within rtol 1e-4, each rank's parameters and EMA
against JAX's within ``test_torch_train``'s step bound, AdamW's moments
within 1e-4 of the moment's largest magnitude; replicas and restores
bitwise.
"""

import concurrent.futures
import os
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open

from chronoedit_tpu.configs import chronoedit_tiny as tiny_j
from chronoedit_tpu.core import rectified_flow as rf_j
from chronoedit_tpu.models import vae as vae_j
from chronoedit_tpu.parallel.sharding import dit_param_sharding as sharding_j
from chronoedit_tpu.parallel.sharding import shard_params as shard_params_j
from chronoedit_tpu.train import train_step as ts_j
from chronoedit_tpu_torch.configs import chronoedit_tiny as tiny_t
from chronoedit_tpu_torch.models import dit as dit_t
from chronoedit_tpu_torch.models import vae as vae_t
from chronoedit_tpu_torch.models.from_jax import load_dit, load_vae
from chronoedit_tpu_torch.parallel.launch import run_world
from chronoedit_tpu_torch.scripts import train as train_t
from chronoedit_tpu_torch.train import checkpoint as ck_t
from chronoedit_tpu_torch.train import train_step as ts_t
from test_torch_dit import randomize
from test_torch_train import _batch, _jax_draws, _tiny_pair, _tree_t
from test_torch_train_mesh import (REPO, TCFG, _adam, _cli, _jax_mesh, _whole, check_against,
                                   jax_full, micro_steps)
import test_torch_train_cp_pp_workers as W

torch.set_num_threads(2)

TIMEOUT = 120.0
# (name, mesh, global batch, context-parallel mode): a world of 2, of 4, of 8
TWO = (("context2", dict(context=2), 2, None), ("context2_ring", dict(context=2), 2, "ring"),
       ("pipe2", dict(pipe=2), 2, None))
FOUR = (("data2_pipe2", dict(data=2, pipe=2), 4, None),
        ("pipe2_context2", dict(pipe=2, context=2), 4, None),
        ("data2_context2", dict(data=2, context=2), 4, None),
        ("context2_tensor2", dict(tensor=2, context=2), 4, None))
EIGHT = (("data2_pipe2_context2", dict(data=2, pipe=2, context=2), 8, None),)
MESHES = {name: (config, b, mode) for name, config, b, mode in TWO + FOUR + EIGHT}
ACCUM = {name: (1, 2) if name in ("context2", "pipe2", "data2_pipe2") else (1,)
         for name in MESHES}
# each planted fault: the mesh whose comparison it breaks
FAULTS = {"context_unsummed": "context2", "context_averaged": "context2",
          "stage_norm": "pipe2", "pipe_data_split": "data2_pipe2"}
KINDS = ("params", "ema", "exp_avg", "exp_avg_sq")


@pytest.fixture(scope="module")
def inputs():
    """The tiny weights (numpy, JAX's layout), the global batches and
    JAX's draws for each micro-step."""
    cfg_j, cfg_t, params = _tiny_pair()
    batches = {b: _batch(cfg_j, seed=30 + b, b=b) for b in (2, 4, 8)}
    draws = {b: [tuple(t.numpy() for t in _jax_draws(jax.random.PRNGKey(i), batches[b]["latents"],
                                                      rf_j.RectifiedFlowConfig()))
                 for i in range(4)]
             for b in batches}
    return {"cfg_j": cfg_j, "cfg_t": cfg_t, "params": params, "batches": batches,
            "draws": draws}


def _job(x, name: str, accum: int, fault=None):
    config, b, mode = MESHES[name]
    draws = x["draws"][b][:micro_steps(accum)]
    return ("train", (x["cfg_t"], x["params"], x["batches"][b], draws, config,
                      dict(TCFG, grad_accum=accum), mode, fault))


def run_jobs(tmp_dir: str, n: int, jobs: dict) -> dict:
    got = run_world(W.run_jobs, n, (list(jobs.values()),), timeout=TIMEOUT, tmp_dir=tmp_dir)
    return {key: [rank[i] for rank in got] for i, key in enumerate(jobs)}


def jax_on_mesh(x, b: int, config: dict) -> dict:
    """JAX's ``make_train_step(mesh=)`` on the mesh of ``config`` over its 8
    virtual devices (ring / Ulysses and GPipe inside its DiT), the
    parameters sharded by ``dit_param_sharding``, two micro-steps on the
    global batch of ``b`` with the draws of keys 0 and 1: the metrics and
    the final parameters, EMA and moments by port name."""
    from test_torch_train import _flat_by_name

    tcfg = ts_j.TrainConfig(**TCFG)
    mesh = _jax_mesh(config)
    params = shard_params_j(_tree_t(x["params"]), mesh, sharding_j(mesh))
    state = ts_j.make_train_state(params, tcfg)
    step = ts_j.make_train_step(x["cfg_j"], tcfg, donate=False, mesh=mesh)
    batch = {k: jnp.asarray(v) for k, v in x["batches"][b].items()}
    metrics = []
    with mesh:
        for i in range(2):
            state, m = step(state, batch, jax.random.PRNGKey(i))
            metrics.append({k: float(v) for k, v in m.items()})
    model = dit_t.DiT(x["cfg_t"], device="meta")
    mu, nu = _adam(state.opt_state)
    return {"metrics": metrics,
            **{k: _flat_by_name(model, jax.tree.map(np.asarray, tree)) for k, tree in (
                ("params", state.params), ("ema", state.ema_params), ("exp_avg", mu),
                ("exp_avg_sq", nu))}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, inputs):
    """Every world's results by job (each a list by rank) and JAX's
    references: the worlds of 4, 2 and 8 run one after another in the
    background while this process computes JAX's."""
    x = inputs
    cfg, params = x["cfg_t"], x["params"]
    dirs = {k: str(tmp_path_factory.mktemp(k)) for k in (
        "world4", "world2", "world8", "checkpoint", "trainer_straight", "trainer_resumed")}
    four = {(name, accum): _job(x, name, accum) for name, _, _, _ in FOUR for accum in ACCUM[name]}
    four[("fault", "pipe_data_split")] = _job(x, "data2_pipe2", 1, "pipe_data_split")
    four["rows"] = ("host_rows", (x["batches"][4], dict(data=2, pipe=2)))
    four["checkpoints"] = ("checkpoints", (cfg, params, x["batches"][4], x["draws"][4][:3], TCFG,
                                           dirs["checkpoint"]))
    two = {(name, accum): _job(x, name, accum) for name, _, _, _ in TWO for accum in ACCUM[name]}
    two.update({("fault", f): _job(x, m, 1, f) for f, m in FAULTS.items() if MESHES[m][1] == 2})
    two["restore_pipe2"] = ("restore", (cfg, params, dict(pipe=2), TCFG, dirs["checkpoint"]))
    two["trainer"] = ("trainer_resume", (cfg, params, x["batches"][2], TCFG,
                                         dirs["trainer_straight"], dirs["trainer_resumed"]))
    two["trainer_into_context2"] = ("restore", (cfg, params, dict(context=2), TCFG,
                                                dirs["trainer_straight"]))
    eight = {("data2_pipe2_context2", 1): _job(x, "data2_pipe2_context2", 1),
             "rows": ("host_rows", (x["batches"][8], dict(data=2, pipe=2, context=2)))}

    def worlds():  # one after another: at most 8 rank processes at a time
        return {(n, k): v for n, jobs in ((4, four), (2, two), (8, eight))
                for k, v in run_jobs(dirs[f"world{n}"], n, jobs).items()}

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        got = pool.submit(worlds)
        refs = {(b, accum): jax_full(x, b, accum) for b in (2, 4) for accum in (1, 2)}
        refs["eight"] = jax_on_mesh(x, 8, dict(data=2, pipe=2, context=2))
        got = got.result()
    return {"got": got, "refs": refs, "dirs": dirs}


def _world(name: str) -> int:
    return int(np.prod(list(MESHES[name][0].values())))


# ------------------------------------------------------------ the step

@pytest.mark.parametrize("name,accum", [(n, a) for n, *_ in TWO + FOUR for a in ACCUM[n]])
def test_full_step_under_context_and_pipe_matches_jax(runs, name, accum):
    """The full-parameter step under the mesh against JAX's single-device
    step on the same global batch and draws, two optimizer steps
    (``grad_accum`` micro-steps each): the loss, grad_norm, each rank's
    shards (a stage's blocks under their global names) of the parameters,
    EMA and moments; every leaf a line keeps whole alike across it."""
    config, b, _ = MESHES[name]
    ranks = runs["got"][(_world(name), (name, accum))]
    check_against(ranks, runs["refs"][(b, accum)], micro_steps(accum))
    assert [r["rows"] for r in ranks] == [b // config.get("data", 1)] * len(ranks)
    pipe = config.get("pipe", 1)
    held = {n.split(".")[1] for r in ranks for n in r["params"] if n.startswith("blocks.")}
    assert sorted(held) == ["0", "1"]
    for r in ranks:  # a stage holds its own block, under its global name
        assert len({n.split(".")[1] for n in r["params"] if n.startswith("blocks.")}) == 2 // pipe


def test_full_step_over_8_ranks_matches_jax_on_its_mesh(runs):
    """data 2 x pipe 2 x context 2 in a world of 8 (a row a process, four a
    data line) against JAX's ``make_train_step(mesh=)`` on the same mesh of
    its 8 virtual devices: its GPipe scan with the microbatches split over
    data and Ulysses attention over context inside the stages, the
    parameters sharded by its ``dit_param_sharding``."""
    ranks = runs["got"][(8, ("data2_pipe2_context2", 1))]
    check_against(ranks, runs["refs"]["eight"], 2)
    assert [r["rows"] for r in ranks] == [4] * 8


@pytest.mark.parametrize("name", list(MESHES))
def test_every_leaf_a_line_keeps_whole_is_bitwise_alike(runs, name):
    """After the steps, along every axis of the mesh the parameters, EMA
    and moments of every leaf the axis's lines keep whole are bitwise alike
    on every rank of the line (``check_state_replicas``): every leaf over a
    context or data line, every leaf outside the blocks over a pipe line,
    the leaves the tensor plan keeps whole over a tensor line."""
    config = MESHES[name][0]
    for r in runs["got"][(_world(name), (name, 1))]:
        assert sorted(r["replicas"]) == sorted(a for a, n in config.items() if n > 1)
        assert all(not bad for bad in r["replicas"].values()), r["replicas"]


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_fails_its_comparison(runs, fault):
    """Each planted fault, run as the sound case of its mesh is, falls
    outside the bounds that case meets: context gradients left as each
    rank's share or averaged (context 2), the norm over a stage's own
    blocks (pipe 2), the line's rows split over data inside the pipeline
    and then averaged over data (data 2 x pipe 2)."""
    b = MESHES[FAULTS[fault]][1]
    with pytest.raises(AssertionError):
        check_against(runs["got"][(_world(FAULTS[fault]), ("fault", fault))],
                      runs["refs"][(b, 1)], 2)


def test_unsummed_context_gradients_part_the_replicas(runs):
    """The replica check sees the unsummed fault: the two context ranks'
    parameters differ after its steps."""
    for r in runs["got"][(2, ("fault", "context_unsummed"))]:
        assert r["replicas"]["context"]


@pytest.mark.parametrize("world,key", [(4, "rows"), (8, "rows")])
def test_host_local_to_global_under_pipe_gives_each_line_its_block(runs, world, key):
    """Under a pipe axis (outermost, so a data line's processes are not
    consecutive) every rank's rows after ``host_local_to_global`` are the
    global batch's contiguous block of its data index: B / data of them."""
    ranks = runs["got"][(world, key)]
    assert all(r["equal"] for r in ranks)
    assert {r["rows"] for r in ranks} == {world // 2}


# ------------------------------------------------------------ checkpoints

def _ck(runs) -> list[dict]:
    return runs["got"][(4, "checkpoints")]


def _assembled(ranks: list[dict], kind: str = "saved") -> dict:
    return {k: _whole([r[kind] for r in ranks], k) for k in KINDS}


def test_pipe_context_checkpoint_holds_each_block_once_by_global_name(runs, inputs):
    """Under pipe 2 x context 2 (ranks (pipe, context) = (0, 0), (0, 1),
    (1, 0), (1, 1)) rank 0 writes stage 0's block and every leaf outside
    the blocks, rank 2 stage 1's block under its global name ``blocks.1``,
    the context replicas (ranks 1 and 3) nothing: every tensor of the
    whole model's state once, its bytes the file's."""
    ck = _ck(runs)
    names = [set(r["names"]) for r in ck]
    assert not names[1] and not names[3]
    assert not names[0] & names[2]
    model = dit_t.DiT(inputs["cfg_t"], device="meta")
    want = {f"{prefix}/{n}" for n, _ in model.named_parameters()
            for prefix in ("params", "ema_params", "opt_state/exp_avg", "opt_state/exp_avg_sq")}
    assert names[0] | names[2] == want
    assert {n.split("/")[-1].split(".")[1] for n in names[2]} == {"1"}
    assert all(".".join(n.split("/")[-1].split(".")[:2]) != "blocks.1" for n in names[0])
    path = Path(runs["dirs"]["checkpoint"]) / "2"
    assert sorted(os.listdir(path)) == sorted([ck_t.COUNTERS_FILE, ck_t.RANK_FILE.format(0),
                                               ck_t.RANK_FILE.format(2)])
    for r, got in enumerate(ck):
        file = path / ck_t.RANK_FILE.format(r)
        assert got["file_bytes"] == (file.stat().st_size if file.exists() else 0)


def test_pipe_context_checkpoint_restores_into_one_process_bitwise(runs, inputs):
    """Restored by a one-process manager into a whole model's state, every
    tensor is bitwise the whole assembled from the ranks as saved."""
    whole = _assembled(_ck(runs))
    model = load_dit(dit_t.DiT(inputs["cfg_t"]), inputs["params"])
    state = ts_t.make_train_state(model, ts_t.TrainConfig(**TCFG))
    mgr = ck_t.CheckpointManager(ck_t.CheckpointConfig(directory=runs["dirs"]["checkpoint"]))
    assert mgr.restore(state) is state and state.step == 2
    got = W.state_arrays(state, model)
    for kind in KINDS:
        for name, w in whole[kind].items():
            np.testing.assert_array_equal(got[kind][name], w, err_msg=f"{kind} {name}")


def test_pipe_context_checkpoint_restores_into_pipe2_and_resumes_bitwise(runs):
    """Restored under pipe 2 (a world of 2), each rank's stage is bitwise
    the saved whole's; restored under its own layout, the third micro-step
    is bitwise the straight run's on every rank."""
    whole = _assembled(_ck(runs))
    for r in runs["got"][(2, "restore_pipe2")]:
        assert r["step"] == 2
        for kind in KINDS:
            for name, got in r[kind].items():
                np.testing.assert_array_equal(got, whole[kind][name], err_msg=f"{kind} {name}")
    for r in _ck(runs):
        for kind in KINDS:
            for name, got in r["resumed"][kind].items():
                np.testing.assert_array_equal(got, r["straight"][kind][name],
                                              err_msg=f"{kind} {name}")


def test_pipe2_trainer_resumes_bitwise_and_restores_under_context(runs):
    """The ``Trainer`` under pipe 2 (the straight run under a
    ``ReplicaConsistencyCallback`` every iteration, which checks each
    line's whole leaves): 2 iterations, then a new ``Trainer``
    resumed from their checkpoint for 2 more, bitwise the 4 straight ones
    on both stages (parameters, EMA, moments); the straight run's step-4
    checkpoint restored under context 2 (each rank a whole model), bitwise
    the stages' tensors assembled."""
    ranks = runs["got"][(2, "trainer")]
    for r in ranks:
        assert r["start"] == 2 and not any(r["replicas"].values())
        for kind in KINDS:
            for name, got in r["resumed"][kind].items():
                np.testing.assert_array_equal(got, r["straight"][kind][name],
                                              err_msg=f"{kind} {name}")
    whole = {k: _whole([r["straight"] for r in ranks], k) for k in KINDS}
    for r in runs["got"][(2, "trainer_into_context2")]:
        assert r["step"] == 4
        for kind in KINDS:
            assert sorted(r[kind]) == sorted(whole[kind])
            for name, got in r[kind].items():
                np.testing.assert_array_equal(got, whole[kind][name], err_msg=f"{kind} {name}")


def test_render_callback_refuses_a_pipe_mesh():
    """``EveryNDrawSample`` renders on one rank's model: under a trainer's
    pipe axis it raises ``ValueError`` at the start of training (a rank
    holds one stage), and starts under a context axis."""
    from types import SimpleNamespace

    from chronoedit_tpu_torch.train.callbacks import EveryNDrawSample

    cb = EveryNDrawSample(every_n=1, sample_fn=None)
    with pytest.raises(ValueError, match="pipe=2"):
        cb.on_train_start(SimpleNamespace(mesh=SimpleNamespace(shape={"pipe": 2, "context": 1})))
    cb.on_train_start(SimpleNamespace(mesh=SimpleNamespace(shape={"pipe": 1, "context": 2})))
    cb.on_train_start(SimpleNamespace(mesh=None))


# ------------------------------------------------------------ the CLI

def test_train_cli_under_torchrun_trains_under_pipe_and_context(tmp_path):
    """``train --mesh pipe=2 --smoke`` and ``--mesh context=2 --smoke``
    under ``torch.distributed.run --nproc-per-node 2`` on the CPU (gloo),
    both at once: each ends rc 0, rank 0 reporting the mesh and the last
    step once; under pipe with ``--checkpoint-dir`` its checkpoint holds
    each block once under its global name."""
    flags = {"pipe": ["--mesh", "pipe=2", "--max-iter", "2", "--save-every", "2",
                      "--checkpoint-dir", str(tmp_path / "pipe")],
             "context": ["--mesh", "context=2", "--smoke"]}
    procs = {k: subprocess.Popen(_cli(f, 2), cwd=REPO, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for k, f in flags.items()}
    outs = {k: p.communicate(timeout=240) for k, p in procs.items()}
    for k, p in procs.items():
        assert p.returncode == 0, outs[k][0][-3000:] + outs[k][1][-3000:]
        assert outs[k][0].count("done at step 2") == 1 and "over gloo, 2 ranks" in outs[k][0]
    assert "'pipe': 2" in outs["pipe"][0] and "'context': 2" in outs["context"][0]
    step = tmp_path / "pipe" / "2"
    names = []
    for r in range(2):
        with safe_open(str(step / ck_t.RANK_FILE.format(r)), framework="pt") as f:
            names += [n for n in f.keys() if n.startswith("params/blocks.")]
    assert len(names) == len(set(names))
    assert {n.split(".")[1] for n in names} == {str(i) for i in range(tiny_t().dit.num_layers)}


@pytest.mark.parametrize("mesh", ["context=2", "pipe=2"])
def test_lora_cli_under_context_or_pipe_raises_naming_its_item(mesh):
    """LoRA mode under context or pipe raises ``ValueError`` before any
    process group, naming queue 1's item 3.3, pipe x fsdp among them; the
    full-parameter mode takes pipe x fsdp (in one process it fails only
    for want of the mesh's 4 ranks)."""
    with pytest.raises(ValueError, match=r"LoRA .*item 3\.3"):
        train_t.main(["--smoke", "--device", "cpu", "--lora-rank", "2", "--mesh", mesh])
    with pytest.raises(ValueError, match=r"LoRA training under pipe=2 .*item 3\.3"):
        train_t.main(["--smoke", "--device", "cpu", "--lora-rank", "2", "--mesh",
                      "pipe=2,fsdp=2"])
    with pytest.raises(ValueError, match=r"1 devices not divisible .*=4"):
        train_t.main(["--smoke", "--device", "cpu", "--mesh", "pipe=2,fsdp=2"])


# ------------------------------------------------------------ video prior

def test_video_prior_training_batch_matches_jax():
    """``edit_training_batch(..., is_video_prior=True)`` through the port's
    VAE against JAX's on the same weights and a 6-frame clip (tiny VAE,
    temporal factor 2): the trajectory's first 5 frames encode to 3 latent
    frames, followed by the edit target's latent frame; the condition
    covers the 7 pixel frames of those 4. Values within 1e-4 of scale (the
    VAE comparison's bound in ``test_torch_vae.py``)."""
    pipe_j, pipe_t = tiny_j(), tiny_t()
    vparams = randomize(lambda: vae_j.init_vae_params(jax.random.PRNGKey(0), pipe_j.vae), 4,
                        fan_in=lambda s: int(np.prod(s[:-1])))
    vae = load_vae(vae_t.VAE(pipe_t.vae), vparams)
    video = np.random.default_rng(3).uniform(-1, 1, (1, 3, 6, 8, 8)).astype(np.float32)
    want = ts_j.edit_training_batch(_tree_t(vparams), pipe_j, jnp.asarray(video),
                                    is_video_prior=True)
    with torch.no_grad():
        got = ts_t.edit_training_batch(vae, pipe_t, torch.from_numpy(video), is_video_prior=True)
        plain, _ = ts_t.edit_training_batch(vae, pipe_t, torch.from_numpy(video))
    assert tuple(got[0].shape) == (1, 4, 4, 4, 4) and tuple(got[1].shape) == (1, 6, 4, 4, 4)
    for g, w in zip(got, want):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4 * scale)
    torch.testing.assert_close(got[0][:, :, 3:], plain[:, :, 1:], rtol=0, atol=0)
