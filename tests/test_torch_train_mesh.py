"""Training under a mesh against JAX: the full-parameter step (clip,
AdamW, EMA; ``grad_accum`` 1 and 2) under data 2, fsdp 2, tensor 2, data 2
x fsdp 2 and fsdp 2 x tensor 2 against JAX's single-device
``make_train_step``, and under data 2 x fsdp 2 x tensor 2 (a world of 8)
against JAX's step on that mesh of its 8 virtual devices (JAX's
``tests/test_multihost.py`` case); the LoRA step under data 2, fsdp 2 and
tensor 2 against JAX's over a base sharded by its ``dit_param_sharding``
(as its CLI runs it); ``host_local_to_global``; sharded checkpoints saved
under fsdp 2 x tensor 2 and restored into one process, into data 2 x fsdp
2 and into the same mesh, and a one-process checkpoint restored into a
mesh; the straggler detector's gather and the Trainer's refusal of it
on one rank only; ``train --mesh`` under
``torch.distributed.run``; and the planted faults (the norm over local
shards, gradients summed or left alone over data, a replicated leaf's
gradient left unreduced over tensor), each failing its comparison.

The port's side runs in worlds of 2, 4 and 8 gloo processes on the CPU,
each started once for the file (``test_torch_train_mesh_workers.py``
through ``parallel.launch.run_world``: spawned workers, a ``file://``
rendezvous under the test's temporary directory, each world within its
own timeout, a barrier after joining), one after another in the
background while this process computes JAX's references. The same seeded numpy weights, batch and JAX's draws (``u``,
noise of the global batch per micro-step) go to both sides; fp32, tiny
preset.

Bounds: the loss within rtol 1e-5 of JAX's (JAX's own bound in
``tests/test_multihost.py``), ``grad_norm`` within rtol 1e-4 (the
single-process step's bound, ``tests/test_torch_train.py``: a norm over
sums taken in other orders); each rank's parameters and EMA against the
slice of JAX's within ``test_torch_train``'s step bound (4 x lr at most,
at most 0.1 % of the entries above 1e-6: Adam's update is near lr x sign(g)
and flips where g is rounding noise), AdamW's moments within 1e-4 of the
moment's largest magnitude; every tensor a mesh axis keeps whole bitwise
alike on every rank of its line (``check_replica_consistency``);
checkpoint restores bitwise.
"""

import concurrent.futures
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from safetensors import safe_open

from chronoedit_tpu.core import rectified_flow as rf_j
from chronoedit_tpu.parallel import MeshConfig as MeshConfigJ
from chronoedit_tpu.parallel import make_mesh as make_mesh_j
from chronoedit_tpu.parallel.sharding import dit_param_sharding as sharding_j
from chronoedit_tpu.parallel.sharding import shard_params as shard_params_j
from chronoedit_tpu.train import lora_train as lt_j
from chronoedit_tpu.train import train_step as ts_j
from chronoedit_tpu_torch.configs import chronoedit_tiny as tiny_t
from chronoedit_tpu_torch.models import dit as dit_t
from chronoedit_tpu_torch.models import lora as lora_t
from chronoedit_tpu_torch.models.from_jax import load_dit, load_lora
from chronoedit_tpu_torch.parallel.launch import run_world
from chronoedit_tpu_torch.train import checkpoint as ck_t
from chronoedit_tpu_torch.train import train_step as ts_t
from test_torch_train import (LR, _assert_params_close, _batch, _flat_by_name, _jax_draws,
                              _lora_pair, _tree_t)
import test_torch_train_mesh_workers as W

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
MOMENT_REL = 1e-4
TIMEOUT = 120.0
REPO = Path(__file__).resolve().parents[1]
TCFG = dict(lr=LR, warmup_steps=1, grad_clip=1.0)
# the clip acts on the LoRA steps (their gradient norm is above 0.01), so
# the norm enters their update
LORA_TCFG = dict(lr=LR, warmup_steps=1, grad_clip=0.01)
# (name, mesh, global batch): a world of 2, of 4, of 8
TWO = (("data2", dict(data=2), 2), ("fsdp2", dict(fsdp=2), 2), ("tensor2", dict(tensor=2), 2))
FOUR = (("data2_fsdp2", dict(data=2, fsdp=2), 4), ("fsdp2_tensor2", dict(fsdp=2, tensor=2), 4))
EIGHT = (("data2_fsdp2_tensor2", dict(data=2, fsdp=2, tensor=2), 8),)
MESHES = {name: (config, b) for name, config, b in TWO + FOUR + EIGHT}
# each planted fault: the mesh (of the world of 2) whose comparison it breaks
FAULTS = {"local_norm": "fsdp2", "data_sum": "data2", "data_alone": "data2",
          "tensor_unreduced": "tensor2"}


def micro_steps(accum: int) -> int:
    """Two optimizer steps: the warm-up's (learning rate 0) and one at lr."""
    return 2 * accum


@pytest.fixture(scope="module")
def inputs():
    """The tiny weights and adapters (numpy, JAX's layout), the global
    batches and JAX's draws for each micro-step."""
    cfg_j, cfg_t, params, lcfg_j, lora_np, _, _ = _lora_pair()
    batches = {b: _batch(cfg_j, seed=20 + b, b=b) for b in (2, 4, 8)}
    draws = {b: [tuple(t.numpy() for t in _jax_draws(jax.random.PRNGKey(i), batches[b]["latents"],
                                                      rf_j.RectifiedFlowConfig()))
                 for i in range(4)]
             for b in batches}
    return {"cfg_j": cfg_j, "cfg_t": cfg_t, "params": params, "lcfg_j": lcfg_j,
            "lora_np": lora_np, "batches": batches, "draws": draws}


def _full_job(x, name: str, accum: int, fault=None):
    config, b = MESHES[name]
    steps = micro_steps(accum)
    return ("train", ("full", x["cfg_t"], x["params"], x["batches"][b],
                      x["draws"][b][:steps], config, dict(TCFG, grad_accum=accum), fault))


def _lora_job(x, name: str, fault=None):
    config, b = MESHES[name]
    return ("train", ("lora", x["cfg_t"], x["params"], x["batches"][b], x["draws"][b][:2],
                      config, LORA_TCFG, fault, x["lora_np"]))


def one_process_checkpoint(x, directory: str) -> dict:
    """Two port micro-steps in this process on the whole model (batch of 4,
    JAX's draws), saved by a one-process manager: the format every
    checkpoint had before sharded ones. Returns the saved tensors."""
    model = load_dit(dit_t.DiT(x["cfg_t"]), x["params"])
    tc = ts_t.TrainConfig(**TCFG)
    state = ts_t.make_train_state(model, tc)
    step = ts_t.make_train_step(x["cfg_t"], tc)
    batch = {k: torch.from_numpy(v) for k, v in x["batches"][4].items()}
    for u, noise in x["draws"][4][:2]:
        step(state, batch, u=torch.from_numpy(u), noise=torch.from_numpy(noise))
    mgr = ck_t.CheckpointManager(ck_t.CheckpointConfig(directory=directory, async_save=False))
    mgr.save(2, state)
    return {k: v.detach().clone() for k, v in ck_t.state_tensors(state).items()}


def run_jobs(tmp_dir: str, n: int, jobs: dict) -> dict:
    got = run_world(W.run_jobs, n, (list(jobs.values()),), timeout=TIMEOUT, tmp_dir=tmp_dir)
    return {key: [rank[i] for rank in got] for i, key in enumerate(jobs)}


def _adam(opt_state):
    """The (mu, nu) trees of JAX's AdamW state, inside MultiSteps or not."""
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return found[0].mu, found[0].nu


def _jax_mesh(config: dict):
    return make_mesh_j(MeshConfigJ(**config))


def jax_full(x, b: int, accum: int, mesh_config: dict | None = None) -> dict:
    """JAX's ``make_train_step`` on the global batch of ``b``, the draws of
    keys 0, 1, ...: each micro-step's metrics and the final state's
    parameters, EMA and moments by port name (whole, port layout). With
    ``mesh_config`` its parameters are sharded by ``dit_param_sharding``
    on that mesh of the 8 virtual devices and the step runs under it."""
    cfg_j, tcfg = x["cfg_j"], ts_j.TrainConfig(**TCFG, grad_accum=accum)
    params = _tree_t(x["params"])
    mesh = None
    if mesh_config is not None:
        mesh = _jax_mesh(mesh_config)
        params = shard_params_j(params, mesh, sharding_j(mesh))
    state = ts_j.make_train_state(params, tcfg)
    step = ts_j.make_train_step(cfg_j, tcfg, donate=False)
    batch = {k: jnp.asarray(v) for k, v in x["batches"][b].items()}
    metrics = []
    with mesh if mesh is not None else _null():
        for i in range(micro_steps(accum)):
            state, m = step(state, batch, jax.random.PRNGKey(i))
            metrics.append({k: float(v) for k, v in m.items()})
    model = dit_t.DiT(x["cfg_t"], device="meta")
    mu, nu = _adam(state.opt_state)
    return {"metrics": metrics,
            **{k: _flat_by_name(model, jax.tree.map(np.asarray, tree)) for k, tree in (
                ("params", state.params), ("ema", state.ema_params), ("exp_avg", mu),
                ("exp_avg_sq", nu))}}


def jax_lora(x) -> dict:
    """JAX's ``make_lora_train_step`` over the base sharded by its
    ``dit_param_sharding`` on data 2 x fsdp 2 x tensor 2 (the 8 virtual
    devices), as JAX's CLI shards it, global batch of 2, keys 0 and 1."""
    cfg_j, tcfg = x["cfg_j"], ts_j.TrainConfig(**LORA_TCFG)
    mesh = _jax_mesh(dict(data=2, fsdp=2, tensor=2))
    base = shard_params_j(_tree_t(x["params"]), mesh, sharding_j(mesh))
    state = lt_j.make_lora_train_state(_tree_t(x["lora_np"]), tcfg)
    step = lt_j.make_lora_train_step(cfg_j, tcfg, x["lcfg_j"], donate=False)
    batch = {k: jnp.asarray(v) for k, v in x["batches"][2].items()}
    metrics = []
    with mesh:
        for i in range(2):
            state, m = step(state, base, batch, jax.random.PRNGKey(i))
            metrics.append({k: float(v) for k, v in m.items()})
    base_t = dit_t.DiT(x["cfg_t"])
    mu, nu = _adam(state.opt_state)

    def by_name(tree):
        lora = load_lora(lora_t.LoRA(base_t, lora_t.LoRAConfig(rank=2)),
                         jax.tree.map(np.asarray, tree))
        return {n: p.detach().numpy() for n, p in lora.named_parameters()}

    return {"metrics": metrics, "params": by_name(state.lora_params),
            "ema": by_name(state.ema_params), "exp_avg": by_name(mu), "exp_avg_sq": by_name(nu)}


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


@pytest.fixture(scope="module")
def runs(tmp_path_factory, inputs):
    """Every world's results by job (each a list by rank), and JAX's
    references: the worlds of 2, 4 and 8 run one after another in the
    background while this process computes JAX's."""
    x = inputs
    two = {(name, accum): _full_job(x, name, accum) for name, _, _ in TWO for accum in (1, 2)}
    two.update({("lora", name): _lora_job(x, name) for name, _, _ in TWO})
    two.update({("fault", f): _full_job(x, m, 1, f) for f, m in FAULTS.items()})
    two["straggler"] = ("straggler", (0.3,))
    two["collective_callbacks"] = ("collective_callbacks", (x["cfg_t"], x["params"]))
    four = {(name, accum): _full_job(x, name, accum) for name, _, _ in FOUR for accum in (1, 2)}
    four.update({("rows", name): ("host_rows", (x["batches"][4], config))
                 for name, config in (("data2_fsdp2", dict(data=2, fsdp=2)),
                                      ("data2_tensor2", dict(data=2, tensor=2)))})
    one_dir = str(tmp_path_factory.mktemp("one_process_checkpoint"))
    saved_one = one_process_checkpoint(x, one_dir)
    ck_dir = str(tmp_path_factory.mktemp("sharded_checkpoint"))
    four["checkpoints"] = ("checkpoints", (x["cfg_t"], x["params"], x["batches"][4],
                                           x["draws"][4][:3], TCFG, ck_dir, one_dir))
    eight = {("data2_fsdp2_tensor2", 1): _full_job(x, "data2_fsdp2_tensor2", 1),
             ("rows", "data2_fsdp2_tensor2"): ("host_rows", (x["batches"][8],
                                                             dict(data=2, fsdp=2, tensor=2)))}
    dirs = {n: str(tmp_path_factory.mktemp(f"train_world{n}")) for n in (2, 4, 8)}

    def worlds():  # one after another: at most 8 rank processes at a time
        return {k: v for n, jobs in ((2, two), (4, four), (8, eight))
                for k, v in run_jobs(dirs[n], n, jobs).items()}

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        got = pool.submit(worlds)
        refs = {(b, accum): jax_full(x, b, accum) for b in (2, 4) for accum in (1, 2)}
        refs["eight"] = jax_full(x, 8, 1, dict(data=2, fsdp=2, tensor=2))
        refs["lora"] = jax_lora(x)
        got = got.result()
    return {"got": got, "refs": refs, "one_dir": one_dir, "saved_one": saved_one,
            "ck_dir": ck_dir}


# ------------------------------------------------------------ comparisons

def check_against(ranks: list[dict], want: dict, steps: int) -> None:
    """Every rank's micro-step metrics and final shards against ``want``
    (JAX's, whole): raises AssertionError at the first miss."""
    for r, got in enumerate(ranks):
        for i in range(steps):
            g, w = got["metrics"][i], want["metrics"][i]
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL,
                                       err_msg=f"rank {r} step {i} loss")
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=NORM_RTOL,
                                       err_msg=f"rank {r} step {i} grad_norm")
        for name, (whole, start) in got["boxes"].items():
            block = tuple(slice(s, s + n) for s, n in zip(start, got["params"][name].shape))
            assert tuple(whole) == want["params"][name].shape, name
            for kind in ("params", "ema"):
                _assert_params_close(got[kind][name], want[kind][name][block],
                                     f"rank {r} {kind} {name}")
            for kind in ("exp_avg", "exp_avg_sq"):
                w = want[kind][name]
                np.testing.assert_allclose(got[kind][name], w[block], rtol=0,
                                           atol=MOMENT_REL * np.abs(w).max(),
                                           err_msg=f"rank {r} {kind} {name}")
        assert all(not bad for bad in got["replicas"].values()), (r, got["replicas"])


def _ranks(runs, key):
    return runs["got"][key]


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", [n for n, _, _ in TWO + FOUR])
def test_full_step_under_mesh_matches_jax(runs, name, accum):
    """The full-parameter step (clip, AdamW, EMA) under the mesh against
    JAX's single-device step on the same global batch and draws, two
    optimizer steps (``grad_accum`` micro-steps each): the loss, grad_norm,
    each rank's shards of the parameters, EMA and moments; the leaves an
    axis keeps whole alike on every rank of its line."""
    config, b = MESHES[name]
    ranks = _ranks(runs, (name, accum))
    check_against(ranks, runs["refs"][(b, accum)], micro_steps(accum))
    assert [r["rows"] for r in ranks] == [b // config.get("data", 1)] * len(ranks)


def test_full_step_over_8_ranks_matches_jax_on_its_mesh(runs):
    """data 2 x fsdp 2 x tensor 2 in a world of 8 (a row a process, four a
    data line) against JAX's step on the same mesh of its 8 virtual
    devices, the parameters sharded by its ``dit_param_sharding`` (JAX's
    ``tests/test_multihost.py`` case)."""
    check_against(_ranks(runs, ("data2_fsdp2_tensor2", 1)), runs["refs"]["eight"], 2)


@pytest.mark.parametrize("name", [n for n, _, _ in TWO])
def test_lora_step_under_mesh_matches_jax(runs, name):
    """The LoRA step (adapters whole on every rank over the sharded base)
    against JAX's over its sharded base: metrics, adapters, EMA, moments,
    and the adapters alike on every rank (summed over the tensor slices and
    the fsdp rows, averaged over data)."""
    check_against(_ranks(runs, ("lora", name)), runs["refs"]["lora"], 2)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_fails_its_comparison(runs, fault):
    """Each planted fault, run as the sound case of its mesh is, falls
    outside the bounds that case meets: the norm over local shards only
    (fsdp 2), gradients summed over data or left alone (data 2), the q / k
    norm weights' gradient left unreduced over tensor (tensor 2)."""
    with pytest.raises(AssertionError):
        check_against(_ranks(runs, ("fault", fault)), runs["refs"][(2, 1)], 2)


@pytest.mark.parametrize("key", [("rows", "data2_fsdp2"), ("rows", "data2_tensor2"),
                                 ("rows", "data2_fsdp2_tensor2")])
def test_host_local_to_global_gives_each_line_its_rows(runs, key):
    """Each rank's rows after ``host_local_to_global`` are the global
    batch's rows of its data index: B / data of them."""
    ranks = _ranks(runs, key)
    assert all(r["equal"] for r in ranks)
    assert {r["rows"] for r in ranks} == {len(ranks) // 2}


# ------------------------------------------------------------ checkpoints

def _whole(ranks: list[dict], kind: str) -> dict:
    """The whole tensors assembled from every rank's blocks."""
    out = {}
    for got in ranks:
        for name, (whole, start) in got["boxes"].items():
            t = out.setdefault(name, np.full(whole, np.nan, np.float32))
            t[tuple(slice(s, s + n) for s, n in zip(start, got[kind][name].shape))] = \
                got[kind][name]
    return out


def _blocks_equal(ranks: list[dict], whole: dict, kinds=("params", "ema", "exp_avg",
                                                         "exp_avg_sq")) -> None:
    for r, got in enumerate(ranks):
        for kind in kinds:
            for name, (_, start) in got["boxes"].items():
                block = tuple(slice(s, s + n) for s, n in zip(start, got[kind][name].shape))
                np.testing.assert_array_equal(got[kind][name], whole[kind][name][block],
                                              err_msg=f"rank {r} {kind} {name}")


def _ck(runs) -> list[dict]:
    return _ranks(runs, "checkpoints")


def test_sharded_checkpoint_files_hold_each_block_once(runs):
    """Under fsdp 2 x tensor 2 each rank's file holds the blocks no lower
    rank holds (a leaf whole on every rank is rank 0's, a leaf split over
    tensor only is written by the two tensor ranks of fsdp index 0), and
    its bytes on disk are those blocks' bytes and the header; the step
    directory is in place on every rank once its save has finished."""
    ranks = [r["saved"] for r in _ck(runs)]
    seen, want = set(), []
    for got in ranks:
        mine = 0
        for name, (_, start) in got["boxes"].items():
            if (name, tuple(start)) in seen:
                continue
            seen.add((name, tuple(start)))
            mine += 4 * got["params"][name].size  # params, EMA, exp_avg, exp_avg_sq, fp32
        want.append(4 * mine)
    path = Path(runs["ck_dir"]) / "2"
    for r, got in enumerate(_ck(runs)):
        file = path / ck_t.RANK_FILE.format(r)
        assert got["file_bytes"] == (file.stat().st_size if file.exists() else 0)
        if want[r] == 0:
            assert not file.exists()
            continue
        header = int.from_bytes(file.read_bytes()[:8], "little")
        assert got["file_bytes"] == 8 + header + want[r], r
        assert got["steps"] == ["2"]
    whole = sum(np.prod(w) for w, _ in ranks[0]["boxes"].values())
    assert sum(want) == 16 * whole  # every block of the four fp32 states once
    assert sorted(os.listdir(path)) == sorted(
        [ck_t.COUNTERS_FILE] + [ck_t.RANK_FILE.format(r) for r, w in enumerate(want) if w])


def test_sharded_checkpoint_restores_into_one_process_bitwise(runs, inputs):
    """The sharded step restored by a one-process manager into a whole
    model's state: every tensor bitwise the whole assembled from the
    ranks' blocks as saved; the counters too."""
    saved = [r["saved"] for r in _ck(runs)]
    whole = {kind: _whole(saved, kind) for kind in ("params", "ema", "exp_avg", "exp_avg_sq")}
    model = load_dit(dit_t.DiT(inputs["cfg_t"]), inputs["params"])
    state = ts_t.make_train_state(model, ts_t.TrainConfig(**TCFG))
    mgr = ck_t.CheckpointManager(ck_t.CheckpointConfig(directory=runs["ck_dir"]))
    assert mgr.restore(state) is state and state.step == 2
    assert state.optimizer.gradient_step == 2
    got = W.state_arrays(state, model)
    for kind in whole:
        for name, w in whole[kind].items():
            np.testing.assert_array_equal(got[kind][name], w, err_msg=f"{kind} {name}")
    params = ck_t.load_params(os.path.join(runs["ck_dir"], "2"))
    for name, w in whole["params"].items():
        np.testing.assert_array_equal(params[name].numpy(), w)


def test_sharded_checkpoint_restores_into_another_mesh_bitwise(runs):
    """Restored under data 2 x fsdp 2, each rank's shards are bitwise the
    blocks of the whole that fsdp 2 x tensor 2 saved."""
    saved = [r["saved"] for r in _ck(runs)]
    whole = {kind: _whole(saved, kind) for kind in ("params", "ema", "exp_avg", "exp_avg_sq")}
    _blocks_equal([r["restored_other"] for r in _ck(runs)], whole)
    assert all(r["step"] == 3 for r in _ck(runs))


def test_resumed_step_is_bitwise_on_its_layout_and_close_on_another(runs):
    """One micro-step after the restore: under the saving mesh bitwise the
    straight run's; under data 2 x fsdp 2 within the step bounds of the
    straight run (other sums, other rounding)."""
    straight = [r["straight"] for r in _ck(runs)]
    whole = {kind: _whole(straight, kind) for kind in ("params", "ema", "exp_avg",
                                                       "exp_avg_sq")}
    _blocks_equal([r["resumed"] for r in _ck(runs)], whole)
    for r, got in enumerate(r["resumed_other"] for r in _ck(runs)):
        for name, (_, start) in got["boxes"].items():
            block = tuple(slice(s, s + n) for s, n in zip(start, got["params"][name].shape))
            _assert_params_close(got["params"][name], whole["params"][name][block],
                                 f"rank {r} {name}")


def test_one_process_checkpoint_restores_into_a_mesh(runs):
    """A checkpoint of one process, in the format every checkpoint had
    before sharded ones (``state.safetensors`` with no metadata and
    ``counters.json``), restored under fsdp 2 x tensor 2: each rank's
    shards bitwise the saved tensors' blocks."""
    path = Path(runs["one_dir"]) / "2"
    assert sorted(os.listdir(path)) == [ck_t.COUNTERS_FILE, ck_t.STATE_FILE]
    with safe_open(str(path / ck_t.STATE_FILE), framework="pt") as f:
        assert f.metadata() is None
    saved = runs["saved_one"]
    whole = {kind: {k.rsplit("/", 1)[1]: v.numpy() for k, v in saved.items()
                    if k.startswith(prefix)}
             for kind, prefix in (("params", "params/"), ("ema", "ema_params/"),
                                  ("exp_avg", "opt_state/exp_avg/"),
                                  ("exp_avg_sq", "opt_state/exp_avg_sq/"))}
    _blocks_equal([r["from_one_process"] for r in _ck(runs)], whole)


# ------------------------------------------------------------ straggler, CLI

def test_straggler_gather_sees_every_rank(runs):
    """The detector's own gather over a world of 2: both ranks see both
    step times (each its mean over the two steps since the start), the same
    list; rank 1 slept 0.3 s in one of them and reports itself a
    straggler, rank 0 does not."""
    r0, r1 = _ranks(runs, "straggler")
    assert len(r0["seen"]) == 1 and r0["seen"] == r1["seen"]
    t0, t1 = r0["seen"][0]
    assert t1 >= 0.15 > t0
    assert r0["lines"] == [] and len(r1["lines"]) == 1 and "straggler" in r1["lines"][0]


def test_collective_callback_on_one_rank_is_refused(runs):
    """A ``StragglerDetector`` given to rank 0 alone: ``Trainer.train``
    raises on both ranks at its start, where rank 0 would otherwise wait
    in the detector's gather until the collective timeout."""
    for err in _ranks(runs, "collective_callbacks"):
        assert "must be given to every rank" in err and "[1, 0]" in err


def _cli(extra: list[str], nproc: int) -> list[str]:
    args = ["-m", "chronoedit_tpu_torch.scripts.train", "--experiment", "tiny", "--data",
            "mock", "--device", "cpu", *extra]
    if nproc == 1:
        return [sys.executable, *args]
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
            str(nproc), *args]


def test_train_cli_under_torchrun(tmp_path):
    """``train --mesh data=2 --smoke`` and ``--mesh fsdp=2 --lora-rank 4``
    under ``torch.distributed.run --nproc-per-node 2`` on the CPU (gloo),
    both at once: rank 0 reports, and the exported LoRA equals, within the
    step bounds, the loop run in this process on the same rows: the tiny
    DiT of seed 0 sharded 2 ways, adapters of seed 1, each process's mock
    stream (seeds 0 and 1) gathered into a batch of 2, draws from seed 0."""
    from chronoedit_tpu_torch.data.mock import mock_batch_iterator
    from chronoedit_tpu_torch.models import vae as vae_t
    from chronoedit_tpu_torch.models import weights as w_t
    from chronoedit_tpu_torch.train import lora_train as lt_t

    lora_flags = ["--mesh", "fsdp=2", "--lora-rank", "4", "--max-iter", "2",
                  "--checkpoint-dir", str(tmp_path / "lora")]
    procs = [subprocess.Popen(_cli(flags, 2), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for flags in (["--mesh", "data=2", "--smoke"], lora_flags)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out[-3000:] + err[-3000:]
    assert "mesh {'pipe': 1, 'data': 2" in outs[0][0] and "over gloo, 2 ranks" in outs[0][0]
    assert outs[0][0].count("done at step 2") == 1
    assert "saved LoRA" in outs[1][0]

    cfg = tiny_t()
    base = dit_t.init_dit_params(cfg.dit, torch.Generator().manual_seed(0))
    vae = vae_t.init_vae_params(cfg.vae, torch.Generator().manual_seed(1))
    rows = [next(mock_batch_iterator(vae, cfg, height=32, width=32, seed=s)) for s in (0, 1)]
    batch = {k: torch.cat([r[k] for r in rows]) for k in rows[0]}
    lcfg = lora_t.LoRAConfig(rank=4, alpha=4.0)
    lora = lora_t.init_lora_params(torch.Generator().manual_seed(1), base, lcfg)
    tcfg = ts_t.TrainConfig(lr=1e-5, warmup_steps=1)
    state = lt_t.make_lora_train_state(lora, tcfg)
    step = lt_t.make_lora_train_step(cfg.dit, tcfg)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        step(state, base, batch, gen)
    want = w_t.export_diffusers_lora(state.lora, alpha=lcfg.alpha)
    with safe_open(str(tmp_path / "lora" / "lora.safetensors"), framework="pt") as f:
        assert set(f.keys()) == set(want)
        for k, v in want.items():
            _assert_params_close(f.get_tensor(k).numpy(), v.detach().numpy(), k)
