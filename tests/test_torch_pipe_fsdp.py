"""Pipeline stages whose blocks are sharded over fsdp (pipe x fsdp) against
JAX: the mesh's layout; the DiT's forward under pipe 2 x fsdp 2 (B = 1, B
= 2 as batched CFG gives it, and B = 2 with a skip-layer mask) and under
pipe 2 x fsdp 2 x context 2, against JAX's single-device forward and
against JAX's ``dit_forward`` on the same mesh of its virtual devices with
the parameters placed by its ``shard_params``; the bytes each rank holds
and the blocks it gathers; the guided edit; ``quantize`` under the mesh
(bitwise quantize-then-stage-then-shard); ``load_pipeline`` from a tiny
checkpoint directory (the bytes read exact against the files' headers);
the full-parameter step under pipe 2 x fsdp 2 (``grad_accum`` 1 and 2)
against JAX's single-device step and under data 2 x pipe 2 x fsdp 2
against JAX's ``make_train_step(mesh=)`` on that mesh; every leaf a line
keeps whole bitwise alike; two planted faults; the sharded checkpoint's
contents and its restores (one process, pipe 2, fsdp 2, its own layout);
a resumed ``Trainer``; and ``run_inference``, ``serve`` and ``train``
under ``torch.distributed.run`` with ``--mesh pipe=2,fsdp=2``.

The port's side runs in a world of 4 and a world of 8 gloo processes on
the CPU, each started once for the file (``test_torch_pipe_fsdp_workers.py``
through ``parallel.launch.run_world``), one after the other in the
background while this process computes JAX's references. The same seeded
numpy weights, inputs, batches and JAX's draws go to both sides
(``models/from_jax.py``); fp32, tiny preset (2 blocks: one a stage).

Bounds are those already in the repository: the forward within 2e-4 (rtol
and atol; ``test_torch_pipeline_parallel.py``'s ``DIT_TOL``, JAX's own
pipeline bound), bitwise against the port's one process (every rank runs
the whole rows on the whole model's gathered bits); the guided edit at 60
dB against JAX's pipeline (``test_torch_pipeline_parallel.py``); the steps
at ``test_torch_train_mesh.py``'s bounds (loss rtol 1e-5, grad_norm rtol
1e-4, each rank's parameters and EMA within the step bound, moments within
1e-4 of their largest magnitude); quantized leaves, loaded leaves, the
loader's bytes, replicas, restores and the resumed ``Trainer`` bitwise.
"""

import concurrent.futures
import io
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open

from chronoedit_tpu.configs import chronoedit_tiny as tiny_j
from chronoedit_tpu.core import rectified_flow as rf_j
from chronoedit_tpu.models import dit as dit_j
from chronoedit_tpu.models import vae as vae_j
from chronoedit_tpu.parallel import MeshConfig as MeshConfigJ
from chronoedit_tpu.parallel import make_mesh as make_mesh_j
from chronoedit_tpu.parallel.sharding import dit_param_sharding as sharding_j
from chronoedit_tpu.parallel.sharding import shard_params as shard_params_j
from chronoedit_tpu.pipeline.edit_pipeline import ChronoEditPipeline as PipeJ
from chronoedit_tpu_torch.configs import chronoedit_tiny as tiny_t
from chronoedit_tpu_torch.models import dit as dit_t
from chronoedit_tpu_torch.models import weights as w_t
from chronoedit_tpu_torch.models.from_jax import load_dit
from chronoedit_tpu_torch.parallel.launch import run_world
from chronoedit_tpu_torch.train import checkpoint as ck_t
from chronoedit_tpu_torch.train import train_step as ts_t
from chronoedit_tpu_torch.utils.visualize import to_uint8
from test_torch_dit import randomize
from test_torch_fsdp import jax_plan
from test_torch_fsdp_workers import edit_inputs as loader_edit_inputs
from test_torch_pipeline import psnr
from test_torch_pipeline_parallel import EDIT_CALL, MASK, MIN_PSNR_DB, dit_inputs, edit_inputs
from test_torch_train import _batch, _jax_draws, _tiny_pair, _tree_t
from test_torch_train_cp_pp import jax_on_mesh
from test_torch_train_mesh import REPO, TCFG, _cli, _whole, check_against, jax_full, micro_steps
import test_torch_pipe_fsdp_workers as W

torch.set_num_threads(2)

DIT_TOL = 2e-4
TIMEOUT = 120.0
PF = dict(pipe=2, fsdp=2)
# the forwards of the world of 4: (batch, layer mask); the world of 8's
# under pipe 2 x fsdp 2 x context 2 at batch 2
FORWARDS = {"b1": (1, None), "b2": (2, None), "b2_mask": (2, MASK)}
CONTEXT_MESH = dict(pipe=2, fsdp=2, context=2)
DATA_MESH = dict(data=2, pipe=2, fsdp=2)
# the meshes whose layout each world checks against JAX's
LAYOUTS = {4: [PF], 8: [DATA_MESH, CONTEXT_MESH]}
QUANT_MODES = ("int8", "int4", "int4_a8")
FAULTS = ("fsdp_summed", "pipe_norm")
KINDS = ("params", "ema", "exp_avg", "exp_avg_sq")
# restored in the world of 4: each rank of data 2 x pipe 2 holds what a
# rank of pipe 2 holds, each rank of data 2 x fsdp 2 what a rank of fsdp 2
RESTORES = {"pipe2": dict(data=2, pipe=2), "fsdp2": dict(data=2, fsdp=2), "own": PF}


@pytest.fixture(scope="module")
def inputs():
    """The tiny weights (numpy, JAX's layout), the forwards' inputs, the
    global batches of 4 and 8 and JAX's draws for each micro-step."""
    cfg_j, cfg_t, params = _tiny_pair()
    batches = {b: _batch(cfg_j, seed=40 + b, b=b) for b in (4, 8)}
    draws = {b: [tuple(t.numpy() for t in _jax_draws(jax.random.PRNGKey(i), batches[b]["latents"],
                                                      rf_j.RectifiedFlowConfig()))
                 for i in range(4)]
             for b in batches}
    forwards = {name: dit_inputs(cfg_j, b=b) for name, (b, _) in FORWARDS.items()}
    return {"cfg_j": cfg_j, "cfg_t": cfg_t, "params": params, "batches": batches,
            "draws": draws, "forwards": forwards, "context": dit_inputs(cfg_j, b=2, seed=3)}


@pytest.fixture(scope="module")
def trees():
    """Numpy DiT and VAE trees of the tiny preset (JAX layout)."""
    cfg = tiny_j()
    dit_p = randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg.dit), 51)
    vae_p = randomize(lambda: vae_j.init_vae_params(jax.random.PRNGKey(1), cfg.vae), 52,
                      fan_in=lambda s: int(np.prod(s[:-1])))
    return dit_p, vae_p


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, trees):
    """A tiny checkpoint directory and a diffusers LoRA file (one target in
    block 1 only)."""
    from safetensors.numpy import save_file

    from test_torch_weights import lora_file, write_checkpoint

    root = tmp_path_factory.mktemp("pf_ckpt")
    write_checkpoint(root / "ck", *trees)
    lora = str(root / "edit_lora.safetensors")
    save_file({k: np.asarray(v) for k, v in lora_file("diffusers").items()}, lora)
    return str(root / "ck"), lora


def _train_job(x, config: dict, b: int, accum: int, fault=None):
    return ("train", (x["cfg_t"], x["params"], x["batches"][b],
                      x["draws"][b][:micro_steps(accum)], config,
                      dict(TCFG, grad_accum=accum), fault))


def run_jobs(tmp_dir: str, n: int, jobs: dict) -> dict:
    got = run_world(W.run_jobs, n, (list(jobs.values()),), timeout=TIMEOUT, tmp_dir=tmp_dir)
    return {key: [rank[i] for rank in got] for i, key in enumerate(jobs)}


def jax_forward(params, cfg, inputs, mesh_config: dict | None = None, **kw) -> np.ndarray:
    """JAX's ``dit_forward``: on one device, or with ``mesh_config`` on
    that mesh of its first virtual devices, the parameters placed by its
    ``shard_params(..., dit_param_sharding(mesh))``."""
    args = [jnp.asarray(a) for a in inputs]
    if mesh_config is None:
        return np.asarray(dit_j.dit_forward(params, cfg, *args, **kw))
    n = int(np.prod(list(mesh_config.values())))
    mesh = make_mesh_j(MeshConfigJ(**mesh_config), devices=jax.devices()[:n])
    placed = shard_params_j(_tree_t(params), mesh, sharding_j(mesh))
    with mesh:
        return np.asarray(dit_j.dit_forward(placed, cfg, *args, mesh=mesh, **kw))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, inputs, trees, checkpoint):
    """Every world's results by job (each a list by rank) and JAX's
    references: the worlds of 4 and 8 run one after the other in the
    background while this process computes JAX's."""
    x = inputs
    cfg, params = x["cfg_t"], x["params"]
    dirs = {k: str(tmp_path_factory.mktemp(k)) for k in (
        "world4", "world8", "checkpoint", "trainer_straight", "trainer_resumed")}
    four = {"layouts": ("mesh_layouts", (LAYOUTS[4],))}
    four.update({("forward", name): ("forward", (cfg, params, x["forwards"][name], PF, mask))
                 for name, (_, mask) in FORWARDS.items()})
    four.update({("quant", mode): ("quantized", (cfg, params, PF, mode, x["forwards"]["b1"]))
                 for mode in QUANT_MODES})
    four["loader"] = ("load", (tiny_t(), *checkpoint, PF, loader_edit_inputs(tiny_t())))
    four["pipeline"] = ("pipeline", (tiny_t(), *trees, edit_inputs(tiny_j(), 17), EDIT_CALL, PF))
    four.update({("train", accum): _train_job(x, PF, 4, accum) for accum in (1, 2)})
    four.update({("fault", f): _train_job(x, PF, 4, 1, f) for f in FAULTS})
    four["checkpoint"] = ("checkpoint", (cfg, params, x["batches"][4], x["draws"][4][:3], TCFG,
                                         PF, dirs["checkpoint"]))
    four.update({("restore", name): ("restore", (cfg, params, config, TCFG, dirs["checkpoint"]))
                 for name, config in RESTORES.items()})
    four["trainer"] = ("trainer_resume", (cfg, params, x["batches"][4], TCFG, PF,
                                          dirs["trainer_straight"], dirs["trainer_resumed"]))
    eight = {"layouts": ("mesh_layouts", (LAYOUTS[8],)),
             "forward": ("forward", (cfg, params, x["context"], CONTEXT_MESH)),
             "train": _train_job(x, DATA_MESH, 8, 1)}

    def worlds():  # one after the other: at most 8 rank processes at a time
        return {(n, k): v for n, jobs in ((4, four), (8, eight))
                for k, v in run_jobs(dirs[f"world{n}"], n, jobs).items()}

    cfg_j = x["cfg_j"]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        got = pool.submit(worlds)
        refs = {("forward", name): jax_forward(
            params, cfg_j, x["forwards"][name],
            **({} if mask is None else {"layer_mask": jnp.asarray(mask)}))
            for name, (_, mask) in FORWARDS.items()}
        refs["forward_mesh"] = jax_forward(params, cfg_j, x["forwards"]["b2_mask"], PF,
                                           layer_mask=jnp.asarray(MASK))
        refs["context"] = jax_forward(params, cfg_j, x["context"])
        refs["context_mesh"] = jax_forward(params, cfg_j, x["context"], CONTEXT_MESH)
        refs.update({("train", accum): jax_full(x, 4, accum) for accum in (1, 2)})
        refs["eight"] = jax_on_mesh(x, 8, DATA_MESH)
        refs["pipeline"] = np.asarray(PipeJ(tiny_j(), *trees)(
            **{n: jnp.asarray(a) for n, a in edit_inputs(tiny_j(), 17).items()}, **EDIT_CALL))
        got = got.result()
    return {"got": got, "refs": refs, "dirs": dirs}


# ------------------------------------------------------------ the mesh

@pytest.mark.parametrize("world", [4, 8])
def test_mesh_layout_matches_jax(runs, world):
    """``make_mesh`` builds pipe 2 x fsdp 2 (a world of 4), data 2 x pipe 2
    x fsdp 2 and pipe 2 x fsdp 2 x context 2 (a world of 8): every rank's
    coordinates are those of the JAX device at the same place of JAX's
    mesh, and each of its pipe, data, fsdp and context groups holds the
    ranks of its JAX mesh line, in the line's order (the groups are opened
    in the same order on every rank)."""
    for i, config in enumerate(LAYOUTS[world]):
        mesh = make_mesh_j(MeshConfigJ(**config), devices=jax.devices()[:world])
        ids = np.vectorize(lambda d: d.id)(mesh.devices)
        for rank, layouts in enumerate(runs["got"][(world, "layouts")]):
            layout = layouts[i]
            where = np.argwhere(ids == rank)[0].tolist()
            assert layout["coords"] == dict(zip(mesh.axis_names, where))
            for axis, size in mesh.shape.items():
                if size > 1:
                    row = list(where)
                    row[mesh.axis_names.index(axis)] = slice(None)
                    assert layout["groups"][axis] == ids[tuple(row)].tolist()
            assert set(layout["groups"]) == {a for a, n in mesh.shape.items() if n > 1}


# ------------------------------------------------------------ the forward

@pytest.mark.parametrize("name", list(FORWARDS))
def test_forward_matches_jax(runs, inputs, name):
    """The tiny DiT under pipe 2 x fsdp 2, each rank holding its fsdp half
    of its stage's block (``keep_layers``, then ``shard_params``): every
    rank's output bitwise the port's one process (the ranks run the whole
    rows on the gathered bits) and within 2e-4 of JAX's single-device
    forward; with the mask (block 1, stage 1's, skipped) also within 2e-4
    of JAX's ``dit_forward`` under pipe 2 x fsdp 2 of its devices."""
    got = runs["got"][(4, ("forward", name))]
    want = runs["refs"][("forward", name)]
    for r in got:
        np.testing.assert_array_equal(r["out"], r["one"])
        np.testing.assert_allclose(r["out"], want, rtol=DIT_TOL, atol=DIT_TOL)
        assert r["calls"] == {"ring": 0, "ulysses": 0}
    if name == "b2_mask":
        np.testing.assert_allclose(runs["refs"]["forward_mesh"], want, rtol=DIT_TOL, atol=DIT_TOL)
        np.testing.assert_allclose(got[0]["out"], runs["refs"]["forward_mesh"], rtol=DIT_TOL,
                                   atol=DIT_TOL)


@pytest.mark.parametrize("name", list(FORWARDS))
def test_each_block_is_gathered_once_a_microbatch_it_runs(runs, name):
    """Each rank gathers its stage's block once a microbatch (1 at B = 1,
    2 at B = 2: two microbatches), none of the other stage's, and none
    where the mask skips it (stage 1's block at ``b2_mask``); every
    embedder and the head once a forward; the same modules on both fsdp
    peers of a stage (their gathers pair up)."""
    b, mask = FORWARDS[name]
    embedders = {"patch_embed", "time_embed", "time_proj", "text_embed", "img_embed", "head"}
    got = runs["got"][(4, ("forward", name))]
    for rank, r in enumerate(got):
        stage = rank // 2
        assert r["layers"] == (stage, stage + 1)
        want = dict.fromkeys(embedders, 1)
        if mask is None or mask[stage] > 0.5:
            want[f"blocks.{stage}"] = b
        assert r["gathered"] == want
        assert r["gathered"] == got[rank ^ 1]["gathered"] and r["leaves"] == got[rank ^ 1]["leaves"]


def test_each_rank_holds_its_stage_split_over_fsdp(runs, inputs):
    """Each rank holds only its stage's block, every leaf at its whole's
    shape halved along the dimension JAX's ``dit_param_sharding`` splits
    over fsdp (the whole where it splits none): its blocks' bytes a quarter
    of the whole model's (pipe 2 x fsdp 2), its non-block leaves' half of
    theirs where they split, every leaf but the few whole ones split."""
    plan = jax_plan(inputs["params"], 2)
    model = dit_t.DiT(tiny_t().dit, device="meta")
    whole = {n: tuple(p.shape) for n, p in model.named_parameters()}
    for rank, r in enumerate(runs["got"][(4, ("forward", "b1"))]):
        stage = rank // 2
        assert sorted(r["shapes"]) == sorted(
            n for n in whole if not n.startswith("blocks.") or n.startswith(f"blocks.{stage}."))
        for n, shape in r["shapes"].items():
            assert r["plan"][n] == plan[n], n
            assert shape == tuple(s // 2 if d == plan[n] else s
                                  for d, s in enumerate(whole[n])), n
        assert r["block_held"] * 4 == r["whole_block_held"]
        assert r["held"] < r["whole_held"] / 2


def test_forward_under_pipe_fsdp_context_matches_jax(runs):
    """pipe 2 x fsdp 2 x context 2 in a world of 8 (B = 2, 2 frames: one a
    context rank; Ulysses inside the stages on the tiny preset's 2 heads):
    every rank's output within 2e-4 of JAX's single-device forward and of
    JAX's ``dit_forward`` on the same mesh of its 8 devices, the ranks
    bitwise alike, Ulysses run once a microbatch."""
    got = runs["got"][(8, "forward")]
    want = runs["refs"]["context"]
    np.testing.assert_allclose(runs["refs"]["context_mesh"], want, rtol=DIT_TOL, atol=DIT_TOL)
    for r in got:
        np.testing.assert_array_equal(r["out"], got[0]["out"])
        np.testing.assert_allclose(r["out"], want, rtol=DIT_TOL, atol=DIT_TOL)
        np.testing.assert_allclose(r["out"], runs["refs"]["context_mesh"], rtol=DIT_TOL,
                                   atol=DIT_TOL)
        assert r["calls"] == {"ring": 0, "ulysses": 2}


def test_guided_edit_matches_jax(runs):
    """The edit with batched CFG (guidance 5 and a negative prompt: B = 2,
    two microbatches) under pipe 2 x fsdp 2, every rank's clip alike and
    at 60 dB against JAX's single-device pipeline."""
    got = runs["got"][(4, "pipeline")]
    want = runs["refs"]["pipeline"]
    assert got[0]["out"].shape == want.shape
    for r in got:
        np.testing.assert_array_equal(r["out"], got[0]["out"])
    assert psnr(got[0]["out"], want) >= MIN_PSNR_DB


# ------------------------------------------------------------ quantizing and loading

@pytest.mark.parametrize("mode", QUANT_MODES)
def test_quantize_under_pipe_fsdp_is_quantize_then_stage_then_shard(runs, mode):
    """``quantize`` on the stage-local, sharded DiT (one gathered block at
    a time, each re-split by ``shard_new_leaves``) gives every leaf bitwise
    what quantizing the whole model, cutting it to the stage and sharding
    it gives, with the same plan; the quantized forward under the mesh
    (B = 1: one microbatch, the rows of one process) bitwise the whole
    quantized model's in one process."""
    for r in runs["got"][(4, ("quant", mode))]:
        assert r["names"] and r["plan_equal"] and r["quantized"] > 0
        assert len(r["bitwise"]) == r["leaves"]
        np.testing.assert_array_equal(r["out"], r["one"])


def test_loader_reads_only_its_stage_slices(runs, checkpoint):
    """``load_pipeline`` under pipe 2 x fsdp 2 from a tiny checkpoint
    directory with a diffusers LoRA (scale 0.8; one target in block 1
    only): each rank holds its stage's block, every leaf bitwise its slice
    of the one-process load's (the LoRA merged); the bytes it read from the
    DiT shards exactly its fsdp slices of its stage's block tensors and of
    the non-block tensors, and from the LoRA file its stage's tensors,
    from the files' headers; a 2-step edit bitwise the one process's."""
    ckpt, lora = checkpoint
    shards = [str(p) for p in sorted(Path(ckpt, "transformer").glob("*.safetensors"))]
    names = w_t.diffusers_dit_names(tiny_t().dit)
    with w_t.load_safetensors(shards) as sd, w_t.load_safetensors(lora) as lsd:
        files = {k.removeprefix("transformer."): sd.nbytes(k) for k in sd}
        lora_bytes = [sum(lsd.nbytes(k) for k in lsd
                          if w_t.block_index(k.removeprefix("transformer.")) == s)
                      for s in (0, 1)]
    for rank, r in enumerate(runs["got"][(4, "loader")]):
        stage = rank // 2
        assert r["layers"] == (stage, stage + 1)
        assert len(r["bitwise"]) == r["params"] == len(r["plan"])
        want = sum(n // 2 if r["plan"][names[k]] is not None else n
                   for k, n in files.items()
                   if k in names and w_t.block_index(k) in (None, stage))
        assert r["bytes"]["dit"] == want
        assert r["bytes"]["loras"] == lora_bytes[stage] > 0
        np.testing.assert_array_equal(r["out"], r["one"])


# ------------------------------------------------------------ training

def _train(runs, key, world: int = 4) -> list[dict]:
    return runs["got"][(world, key)]


@pytest.mark.parametrize("accum", [1, 2])
def test_full_step_matches_jax(runs, accum):
    """The full-parameter step (clip, AdamW, EMA) under pipe 2 x fsdp 2
    against JAX's single-device step on the same global batch of 4 and
    draws, two optimizer steps of ``grad_accum`` micro-steps: the loss,
    grad_norm, each rank's shards of the parameters, EMA and moments (its
    stage's block under its global name), every leaf a line keeps whole
    bitwise alike along it (pipe, fsdp)."""
    ranks = _train(runs, ("train", accum))
    check_against(ranks, runs["refs"][("train", accum)], micro_steps(accum))
    for rank, r in enumerate(ranks):
        assert r["rows"] == 4 and r["layers"] == (rank // 2, rank // 2 + 1)
        assert sorted(r["replicas"]) == ["fsdp", "pipe"]


def test_full_step_over_8_ranks_matches_jax_on_its_mesh(runs):
    """data 2 x pipe 2 x fsdp 2 in a world of 8 (a row a process, four a
    data line) against JAX's ``make_train_step(mesh=)`` on the same mesh of
    its 8 virtual devices, the parameters placed by its
    ``dit_param_sharding``; every line's whole leaves alike."""
    ranks = _train(runs, "train", 8)
    check_against(ranks, runs["refs"]["eight"], 2)
    assert [r["rows"] for r in ranks] == [4] * 8
    assert all(sorted(r["replicas"]) == ["data", "fsdp", "pipe"] for r in ranks)


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_fails_its_comparison(runs, fault):
    """Each planted fault, run as the sound pipe 2 x fsdp 2 step is, falls
    outside the bounds that step meets: a gather whose backward sums over
    fsdp while every rank of the stage ran the same rows (each split leaf's
    gradient twice its own), and the global norm completed over fsdp but
    not over pipe (each stage's norm alone)."""
    with pytest.raises(AssertionError):
        check_against(_train(runs, ("fault", fault)), runs["refs"][("train", 1)], 2)


def _ck(runs) -> list[dict]:
    return runs["got"][(4, "checkpoint")]


def test_checkpoint_holds_each_fsdp_piece_of_each_block_once(runs, inputs):
    """Under pipe 2 x fsdp 2 (ranks (pipe, fsdp) = (0, 0), (0, 1), (1, 0),
    (1, 1)) every piece of every tensor of the whole model's state is
    written once: by the lowest rank holding it. Each rank writes its
    stage's block's fsdp pieces under their global names, stage 0's ranks
    the non-block pieces, rank 0 the leaves the plan keeps whole; the
    pieces of each tensor tile its whole shape; each file's bytes are the
    rank's."""
    path = Path(runs["dirs"]["checkpoint"]) / "2"
    pieces, sizes = {}, {}
    for rank, got in enumerate(_ck(runs)):
        file = path / ck_t.RANK_FILE.format(rank)
        assert got["file_bytes"] == file.stat().st_size
        with safe_open(str(file), framework="pt") as f:
            layout = json.loads(f.metadata()[ck_t.LAYOUT_KEY])
            for name in f.keys():
                whole, start = layout[name]
                shape = tuple(f.get_slice(name).get_shape())
                key = (name, tuple(start))
                assert key not in pieces, key
                pieces[key] = rank
                sizes[name] = sizes.get(name, 0) + int(np.prod(shape))
                assert int(np.prod(whole)) >= int(np.prod(shape))
                leaf = name.split("/")[-1]
                if leaf.startswith("blocks."):
                    assert int(leaf.split(".")[1]) == rank // 2, (rank, name)
                else:
                    assert rank < 2, (rank, name)
    model = dit_t.DiT(inputs["cfg_t"], device="meta")
    want = {f"{prefix}/{n}": p.numel() for n, p in model.named_parameters()
            for prefix in ("params", "ema_params", "opt_state/exp_avg", "opt_state/exp_avg_sq")}
    assert sizes == want
    assert sorted(os.listdir(path)) == sorted(
        [ck_t.COUNTERS_FILE] + [ck_t.RANK_FILE.format(r) for r in range(4)])
    assert {r for r in pieces.values()} == {0, 1, 2, 3}


def test_checkpoint_restores_into_one_process_bitwise(runs, inputs):
    """Restored by a one-process manager into a whole model's state, every
    tensor is bitwise the whole assembled from the ranks as saved."""
    whole = {k: _whole([r["saved"] for r in _ck(runs)], k) for k in KINDS}
    model = load_dit(dit_t.DiT(inputs["cfg_t"]), inputs["params"])
    state = ts_t.make_train_state(model, ts_t.TrainConfig(**TCFG))
    mgr = ck_t.CheckpointManager(ck_t.CheckpointConfig(directory=runs["dirs"]["checkpoint"]))
    assert mgr.restore(state) is state and state.step == 2
    from test_torch_train_mesh_workers import state_arrays

    got = state_arrays(state, model)
    for kind in KINDS:
        for name, w in whole[kind].items():
            assert not np.isnan(w).any(), name
            np.testing.assert_array_equal(got[kind][name], w, err_msg=f"{kind} {name}")


@pytest.mark.parametrize("layout", list(RESTORES))
def test_checkpoint_restores_into_each_layout_bitwise(runs, layout):
    """Restored under pipe 2 (each rank of data 2 x pipe 2 holds a pipe-2
    rank's stage), under fsdp 2 (data 2 x fsdp 2) and under its own pipe 2
    x fsdp 2, each rank's tensors are bitwise the saved whole's blocks;
    under its own layout the third micro-step is then bitwise the straight
    run's on every rank."""
    whole = {k: _whole([r["saved"] for r in _ck(runs)], k) for k in KINDS}
    ranks = runs["got"][(4, ("restore", layout))]
    for r in ranks:
        assert r["step"] == 2
        for kind in KINDS:
            for name, got in r[kind].items():
                whole_shape, start = r["boxes"][name]
                block = tuple(slice(s, s + n) for s, n in zip(start, got.shape))
                np.testing.assert_array_equal(got, whole[kind][name][block],
                                              err_msg=f"{kind} {name}")
    if layout == "own":
        for r in _ck(runs):
            for kind in KINDS:
                for name, got in r["restored"][kind].items():
                    np.testing.assert_array_equal(got, r["saved"][kind][name])
                for name, got in r["resumed"][kind].items():
                    np.testing.assert_array_equal(got, r["straight"][kind][name],
                                                  err_msg=f"{kind} {name}")


def test_trainer_resumes_bitwise(runs):
    """The ``Trainer`` under pipe 2 x fsdp 2 (the straight run under a
    ``ReplicaConsistencyCallback`` every iteration): 2 iterations, then a
    new ``Trainer`` resumed from their checkpoint for 2 more, bitwise the 4
    straight ones on every rank (parameters, EMA, moments)."""
    for r in runs["got"][(4, "trainer")]:
        assert r["start"] == 2 and not any(r["replicas"].values())
        for kind in KINDS:
            for name, got in r["resumed"][kind].items():
                np.testing.assert_array_equal(got, r["straight"][kind][name],
                                              err_msg=f"{kind} {name}")


# ------------------------------------------------------------ the CLIs

def _torchrun(module: str, flags: list[str]) -> list[str]:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
            "4", "-m", module, *flags]


def _smoke_request() -> bytes:
    """``run_inference --smoke``'s inputs as a request body."""
    cfg, cpu = tiny_t(), torch.device("cpu")
    image = torch.rand((1, 3, 32, 32), generator=torch.Generator(cpu).manual_seed(7)) * 2 - 1
    emb = [torch.randn((1, 8, cfg.dit.text_dim), generator=torch.Generator(cpu).manual_seed(s))
           for s in (1, 2)]
    image_emb = torch.randn((1, cfg.dit.image_tokens, cfg.dit.image_dim),
                            generator=torch.Generator(cpu).manual_seed(3))
    buf = io.BytesIO()
    np.savez(buf, image=image.numpy(), prompt_emb=emb[0].numpy(),
             neg_prompt_emb=emb[1].numpy(), image_emb=image_emb.numpy())
    return buf.getvalue()


def _serve_one(log_path: Path) -> np.ndarray:
    """``serve --mesh pipe=2,fsdp=2 --smoke`` under torchrun: /healthz
    reports the mesh, one /edit; SIGTERM ends every rank. Returns the
    edit."""
    log = open(log_path, "w+")
    proc = subprocess.Popen(_torchrun("chronoedit_tpu_torch.scripts.serve", [
        "--mesh", "pipe=2,fsdp=2", "--smoke", "--device", "cpu", "--port", "0",
        "--max-wait-ms", "5"]), cwd=REPO, stdout=log, stderr=subprocess.STDOUT, text=True)
    try:
        port = None
        deadline = time.monotonic() + 180
        while port is None and time.monotonic() < deadline and proc.poll() is None:
            time.sleep(0.5)
            log.seek(0)
            for line in log:
                if "listening on" in line:
                    port = int(line.split(":")[1].split()[0])
        assert port is not None, open(log_path).read()[-3000:]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["mesh"]["pipe"] == 2 and health["mesh"]["fsdp"] == 2
        assert health["world"]["ranks"] == 4
        req = urllib.request.Request(f"http://127.0.0.1:{port}/edit?seed=0",
                                     data=_smoke_request(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            with np.load(io.BytesIO(r.read())) as z:
                edit = z["edit"]
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log.seek(0)
    text = log.read()
    for rank in (1, 2, 3):
        assert f"rank {rank}: stopped after 1 batches" in text, text[-3000:]
    return edit


def test_clis_under_torchrun(tmp_path):
    """``run_inference``, ``serve`` and ``train`` (full-parameter) with
    ``--mesh pipe=2,fsdp=2 --smoke --device cpu`` under
    ``torch.distributed.run --nproc-per-node 4``, all at once:
    ``run_inference``'s PNG bitwise the single process's; the served edit
    bitwise that PNG; ``train`` ends rc 0 with rank 0 reporting the mesh and
    step 2 once, and its checkpoint holds each fsdp piece of each block
    once under its global name."""
    from PIL import Image

    args = ["--smoke", "--device", "cpu"]
    procs = {
        "single": [sys.executable, "-m", "chronoedit_tpu_torch.scripts.run_inference", *args,
                   "--output", str(tmp_path / "single.png")],
        "mesh": _torchrun("chronoedit_tpu_torch.scripts.run_inference",
                          [*args, "--mesh", "pipe=2,fsdp=2", "--output",
                           str(tmp_path / "mesh.png")]),
        "train": [a for a in _cli(["--mesh", "pipe=2,fsdp=2", "--max-iter", "2",
                                   "--save-every", "2", "--checkpoint-dir",
                                   str(tmp_path / "ck")], 4)],
    }
    started = {k: subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
               for k, cmd in procs.items()}
    edit = _serve_one(tmp_path / "serve.log")
    outs = {k: p.communicate(timeout=240) for k, p in started.items()}
    for k, p in started.items():
        assert p.returncode == 0, k + outs[k][0][-3000:] + outs[k][1][-3000:]
    assert "mesh {'pipe': 2, 'data': 1, 'fsdp': 2" in outs["mesh"][0]
    single = np.asarray(Image.open(tmp_path / "single.png"))
    assert single.std() > 0
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "mesh.png")), single)
    np.testing.assert_array_equal(to_uint8(edit), single)

    out = outs["train"][0]
    assert out.count("done at step 2") == 1 and "over gloo, 4 ranks" in out
    assert "'pipe': 2" in out and "'fsdp': 2" in out
    step = tmp_path / "ck" / "2"
    pieces = []
    for r in range(4):
        with safe_open(str(step / ck_t.RANK_FILE.format(r)), framework="pt") as f:
            layout = json.loads(f.metadata()[ck_t.LAYOUT_KEY])
            pieces += [(n, tuple(layout[n][1])) for n in f.keys() if n.startswith("params/blocks.")]
    assert len(pieces) == len(set(pieces))
    assert {n.split(".")[1] for n, _ in pieces} == {str(i) for i in range(tiny_t().dit.num_layers)}
