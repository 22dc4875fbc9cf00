"""Pipeline parallelism against JAX: ``gpipe_scan``, the DiT's pipe branch
(alone, with context parallelism inside the stages and with data on the
batch), the stage-local loader, the pipeline and ``run_inference --mesh
pipe=``.

The port's side runs in worlds of 2 and 4 gloo processes on the CPU
(``test_torch_pp_workers.py`` through ``parallel.launch.run_world``: spawned
workers, a ``file://`` rendezvous under ``tmp_path``, each world ended
within its own timeout, a barrier after joining); JAX's runs in this
process, on one device or under its own mesh on the 8 virtual CPU devices,
as its ``tests/test_pipeline_parallel.py`` runs it. The same seeded numpy
weights and inputs go to both (``models/from_jax.py``); fp32.

Bounds, JAX's own (``tests/test_pipeline_parallel.py``): the toy pipeline's
output within 1e-6 and its gradients within 1e-5; the DiT under a pipe
mesh within 2e-4 (rtol and atol) of the single-device forward; the
pipeline at 60 dB PSNR over the [-1, 1] range (``test_torch_pipeline.py``'s
bar); the loader's tensors, the ranks' outputs among themselves and the
CLI's PNG against one process bitwise.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.configs import chronoedit_tiny as tiny_j
from chronoedit_tpu.models import dit as dit_j
from chronoedit_tpu.models import vae as vae_j
from chronoedit_tpu.parallel import MeshConfig as MeshConfigJ
from chronoedit_tpu.parallel import make_mesh as make_mesh_j
from chronoedit_tpu.parallel.pipeline_parallel import gpipe_scan as gpipe_scan_j
from chronoedit_tpu.pipeline.edit_pipeline import ChronoEditPipeline as PipeJ
from chronoedit_tpu_torch.configs import chronoedit_tiny as tiny_t
from chronoedit_tpu_torch.models import dit as dit_t
from chronoedit_tpu_torch.models import weights as w_t
from chronoedit_tpu_torch.parallel import mesh as mesh_t
from chronoedit_tpu_torch.parallel.launch import run_world
from chronoedit_tpu_torch.pipeline.loader import load_pipeline as load_pipeline_t
from test_torch_dit import randomize
from test_torch_pipeline import psnr
import test_torch_pp_workers as W

torch.set_num_threads(2)

OUT_TOL = 1e-6
GRAD_TOL = 1e-5
DIT_TOL = 2e-4
MIN_PSNR_DB = 60.0
TIMEOUT = 120.0
REPO = Path(__file__).resolve().parents[1]


# Every case of a world size runs in one world (``W.run_jobs``), started
# once for the module: a world costs 3-4 s to start, a case well under it.

def tiny(mod, layers=2):
    return dataclasses.replace((tiny_j if mod is dit_j else tiny_t)().dit, num_layers=layers)


def dit_inputs(cfg, b=4, t=2, h=4, w=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cfg.in_channels, t, h, w)).astype(np.float32)
    ts = rng.uniform(0, 1000, (b,)).astype(np.float32)
    text = rng.standard_normal((b, 7, cfg.text_dim)).astype(np.float32)
    img = rng.standard_normal((b, cfg.image_tokens, cfg.image_dim)).astype(np.float32)
    return x, ts, text, img


def toy_inputs(n_layers=8, b=4, d=16):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((n_layers, d, d)) * 0.2).astype(np.float32)
    bctx = rng.standard_normal((b, d)).astype(np.float32)
    x = rng.standard_normal((b, d)).astype(np.float32)
    return w, x, bctx


def edit_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    d, f32, sf = cfg.dit, np.float32, cfg.vae.spatial_factor
    return dict(image=rng.uniform(-1, 1, (1, 3, 16, 16)).astype(f32),
                prompt_emb=rng.standard_normal((1, 6, d.text_dim)).astype(f32),
                neg_prompt_emb=rng.standard_normal((1, 6, d.text_dim)).astype(f32),
                image_emb=rng.standard_normal((1, d.image_tokens, d.image_dim)).astype(f32),
                latents=rng.standard_normal((1, cfg.vae.z_dim, cfg.vae.latent_frames(5),
                                             16 // sf, 16 // sf)).astype(f32))


MASK = np.array([1.0, 0.0], np.float32)  # SLG skips block 1 (stage 1's)
EDIT_CALL = dict(num_frames=5, guidance_scale=5.0)
# (mode, batch, latent frames) under pipe 2 x context 2: the edit geometry
# (8 tokens, one frame a context rank) in both modes, and the reasoning
# geometry (8 frames, four whole frames a context rank)
PIPE_CP_CASES = [("ring", 4, 2), ("ulysses", 4, 2), ("auto", 2, 8)]
LAYOUTS = [dict(pipe=2, context=2), dict(pipe=2, data=2)]


@pytest.fixture(scope="module")
def params():
    return {n: randomize(lambda n=n: dit_j.init_dit_params(jax.random.PRNGKey(0), tiny(dit_j, n)),
                         n + 10) for n in (2, 4)}


@pytest.fixture(scope="module")
def trees():
    """Numpy DiT and VAE trees of the tiny preset (JAX layout)."""
    cfg = tiny_j()
    dit_p = randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg.dit), 21)
    vae_p = randomize(lambda: vae_j.init_vae_params(jax.random.PRNGKey(1), cfg.vae), 22,
                      fan_in=lambda s: int(np.prod(s[:-1])))
    return dit_p, vae_p


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, trees):
    """A tiny checkpoint directory and a diffusers LoRA file (one target in
    block 1 only)."""
    from safetensors.numpy import save_file

    from test_torch_weights import lora_file, write_checkpoint

    root = tmp_path_factory.mktemp("pp_ckpt")
    write_checkpoint(root / "ck", *trees)
    lora = str(root / "edit_lora.safetensors")
    save_file({k: np.asarray(v) for k, v in lora_file("diffusers").items()}, lora)
    return str(root / "ck"), lora


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, params, trees, checkpoint):
    """Every case of a world of 2: results by case, each a list by rank."""
    jobs = {
        "toy": ("gpipe_toy", (*toy_inputs(), 2)),
        "dit": ("dit_pipe", (tiny(dit_t), params[2], dit_inputs(tiny(dit_j)), dict(pipe=2))),
        "dit_mask": ("dit_pipe", (tiny(dit_t), params[2], dit_inputs(tiny(dit_j)),
                                  dict(pipe=2), MASK)),
        "dit_int8": ("dit_pipe", (tiny(dit_t), params[2], dit_inputs(tiny(dit_j)),
                                  dict(pipe=2), None, "int8")),
        "loader": ("load_stage", (tiny_t(), *checkpoint, 2)),
        "pipeline": ("pipeline", (tiny_t(), *trees, edit_inputs(tiny_j(), 17), EDIT_CALL,
                                  dict(pipe=2))),
    }
    return run_jobs(tmp_path_factory, 2, jobs)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, params):
    """Every case of a world of 4: results by case, each a list by rank."""
    jobs = {"toy": ("gpipe_toy", (*toy_inputs(), 4)),
            "dit": ("dit_pipe", (tiny(dit_t, 4), params[4], dit_inputs(tiny(dit_j, 4)),
                                 dict(pipe=4))),
            "data": ("dit_pipe", (tiny(dit_t), params[2], dit_inputs(tiny(dit_j)),
                                  dict(pipe=2, data=2))),
            "unsplit": ("dit_pipe", (tiny(dit_t), params[2], dit_inputs(tiny(dit_j), b=1, t=3),
                                     dict(pipe=2, context=2))),
            "layouts": ("mesh_layouts", (LAYOUTS,))}
    for mode, b, t in PIPE_CP_CASES:
        jobs[mode] = ("dit_pipe", (dataclasses.replace(tiny(dit_t), context_parallel=mode),
                                   params[2], dit_inputs(tiny(dit_j), b=b, t=t),
                                   dict(pipe=2, context=2)))
    return run_jobs(tmp_path_factory, 4, jobs)


def run_jobs(tmp_path_factory, n: int, jobs: dict) -> dict:
    got = run_world(W.run_jobs, n, (list(jobs.values()),), timeout=TIMEOUT,
                    tmp_dir=str(tmp_path_factory.mktemp(f"world{n}")))
    return {key: [rank[i] for rank in got] for i, key in enumerate(jobs)}


# ------------------------------------------------------------ gpipe_scan

@pytest.mark.parametrize("pipe", [2, 4])
def test_gpipe_scan_matches_jax(two_ranks, four_ranks, pipe):
    """Toy per-layer affine blocks (8 layers, batch 4: 2 / 4 microbatches):
    every rank's replicated output against JAX's ``gpipe_scan`` on its mesh
    (data x pipe over 8 devices) and JAX's plain scan; the gradients of
    ``sum(out ** 2)`` against ``jax.grad`` of the plain scan (JAX's test
    holds its pipeline's to them): ``x``'s and ``ctx``'s whole on every
    rank, ``w``'s on each rank in its stage's rows only, summed. The same
    forward from the stage's layers alone, and JAX's errors for layers the
    stages do not divide and an indivisible microbatch count."""
    got = (two_ranks if pipe == 2 else four_ranks)["toy"]
    w, x, bctx = toy_inputs()
    n_layers = w.shape[0]

    def block(lp, x_cur, ctx):
        return jnp.tanh(x_cur @ lp + ctx)

    def plain(w, x, bctx):
        return jax.lax.scan(lambda c, lp: (block(lp, c, bctx), None), x, w)[0]

    mesh = make_mesh_j(MeshConfigJ(data=8 // pipe, pipe=pipe))
    args = [jnp.asarray(a) for a in (w, x, bctx)]
    with mesh:
        want = np.asarray(gpipe_scan_j(block, *args, mesh))
    np.testing.assert_allclose(want, np.asarray(plain(*args)), atol=OUT_TOL)
    dw, dx, dctx = (np.asarray(g) for g in jax.grad(
        lambda *a: jnp.sum(plain(*a) ** 2), argnums=(0, 1, 2))(*args))
    errors = {}
    for name, stack, kw in (("layers", args[0][:-1], {}), ("microbatches", args[0],
                                                             {"microbatches": 3})):
        with pytest.raises(ValueError) as e:
            gpipe_scan_j(block, stack, args[1], args[2], mesh, **kw)
        errors[name] = str(e.value)

    per = n_layers // pipe
    for rank, r in enumerate(got):
        assert r["layers"] == (rank * per, (rank + 1) * per)
        np.testing.assert_array_equal(r["out"], got[0]["out"])
        np.testing.assert_array_equal(r["local"], r["out"])
        np.testing.assert_allclose(r["out"], want, atol=OUT_TOL)
        np.testing.assert_allclose(r["dx"], dx, atol=GRAD_TOL)
        np.testing.assert_allclose(r["dctx"], dctx, atol=GRAD_TOL)
        outside = np.ones(n_layers, bool)
        outside[rank * per:(rank + 1) * per] = False
        assert not r["dw"][outside].any()
        assert r["errors"].keys() == errors.keys()
        assert r["errors"]["layers"] == errors["layers"]
        # JAX names the data axis it does not have here
        assert r["errors"]["microbatches"].split(" microbatches")[0] == \
            errors["microbatches"].split(" microbatches")[0]
    np.testing.assert_allclose(sum(r["dw"] for r in got), dw, atol=GRAD_TOL)


def test_stage_range():
    """Each stage's blocks, and JAX's error when the stages do not divide
    the layers."""
    from chronoedit_tpu_torch.parallel.pipeline_parallel import stage_range

    def mesh(pipe, index):
        return mesh_t.Mesh((pipe, 1, 1, 1, 1), index, torch.device("cpu"), {"pipe": "g"})

    assert stage_range(40, None) == range(40)
    assert [stage_range(40, mesh(4, s)) for s in range(4)] == [
        range(0, 10), range(10, 20), range(20, 30), range(30, 40)]
    with pytest.raises(ValueError, match="40 stacked layers not divisible by 3 pipeline"):
        stage_range(40, mesh(3, 0))


# ------------------------------------------------------------ the DiT

def jax_forward(params, cfg, inputs, **kw):
    return np.asarray(dit_j.dit_forward(params, cfg, *[jnp.asarray(a) for a in inputs], **kw))


def check_ranks(got, want, n_layers, pipe):
    """Every rank of each pipe line bitwise alike, holding its stage's
    blocks only, and within JAX's pipeline bound of ``want``."""
    per = n_layers // pipe
    for r in got:
        np.testing.assert_array_equal(r["out"], got[0]["out"])
        assert r["blocks"] == per and r["layers"][1] - r["layers"][0] == per
    assert sorted({r["layers"] for r in got}) == [(s * per, (s + 1) * per) for s in range(pipe)]
    np.testing.assert_allclose(got[0]["out"], want, rtol=DIT_TOL, atol=DIT_TOL)


@pytest.mark.parametrize("pipe,layer_mask", [(2, False), (4, False), (2, True)])
def test_dit_pipeline_parallel_matches_jax(two_ranks, four_ranks, params, pipe, layer_mask):
    """The tiny DiT (batch 4: 2 / 4 microbatches) over pipe = 2 and 4 (4
    layers at 4), with and without the skip-layer mask (block 1 skipped, on
    stage 1), each rank holding its stage's blocks, against JAX's
    single-device forward; no ring or Ulysses call, no warning."""
    n = 4 if pipe == 4 else 2
    got = (two_ranks if pipe == 2 else four_ranks)["dit_mask" if layer_mask else "dit"]
    kw = {"layer_mask": jnp.asarray(MASK)} if layer_mask else {}
    check_ranks(got, jax_forward(params[n], tiny(dit_j, n), dit_inputs(tiny(dit_j, n)), **kw),
                n, pipe)
    for r in got:
        assert r["calls"] == {"ring": 0, "ulysses": 0} and not r["warnings"]


def test_quantized_stages(two_ranks, params):
    """``quantize_dit`` on each stage-local DiT (w8a8) quantizes its stage's
    blocks: the pipe forward against the single-process port's forward on
    the whole model quantized alike, within JAX's pipeline bound (the
    quantization is per weight column and per token row, so each stage's
    blocks and rows are the whole model's)."""
    from chronoedit_tpu_torch.models.from_jax import load_dit
    from chronoedit_tpu_torch.ops.quant import quantize_dit

    model = quantize_dit(load_dit(dit_t.DiT(tiny(dit_t)), params[2]), mode="int8")
    with torch.inference_mode():
        want = dit_t.dit_forward(model, *map(torch.from_numpy, dit_inputs(tiny(dit_j))))
    check_ranks(two_ranks["dit_int8"], want.numpy(), 2, 2)


@pytest.mark.parametrize("mode,b,t", PIPE_CP_CASES)
def test_dit_pipe_context_composed_matches_jax(four_ranks, params, mode, b, t):
    """pipe 2 x context 2 over 4 ranks: the tokens split over each stage's
    context group inside the stages (ring or Ulysses in every block), the
    head's output gathered; against JAX's single-device forward."""
    got = four_ranks[mode]
    check_ranks(got, jax_forward(params[2], tiny(dit_j), dit_inputs(tiny(dit_j), b=b, t=t)),
                2, 2)
    used = "ulysses" if mode == "auto" else mode  # 2 heads over 2
    microbatches = min(b, 2)
    for r in got:  # a stage's one block, once per microbatch
        assert r["calls"][used] == microbatches and sum(r["calls"].values()) == microbatches
        assert not r["warnings"]


def test_dit_pipe_data_and_unsplit_context(four_ranks, params):
    """pipe 2 x data 2 over 4 ranks: each data line takes 2 of the batch of
    4 (2 microbatches of 1), the head's output gathered over data; and pipe
    2 x context 2 on tokens that do not split (3 frames of 4 tokens over
    2), which run unsharded inside the stages with JAX's warning. Both
    against JAX's single-device forward."""
    cfg = tiny(dit_j)
    check_ranks(four_ranks["data"], jax_forward(params[2], cfg, dit_inputs(cfg)), 2, 2)
    got = four_ranks["unsplit"]
    check_ranks(got, jax_forward(params[2], cfg, dit_inputs(cfg, b=1, t=3)), 2, 2)
    for r in got:
        assert r["calls"] == {"ring": 0, "ulysses": 0}
        assert any("replicates the 'context' axis" in m for m in r["warnings"])


def test_cache_blocks_under_pipe_raises(params):
    """The block cache under a pipe axis raises ValueError, JAX's message,
    before any collective; so does a stage-local model without its mesh."""
    model = dit_t.DiT(tiny(dit_t))
    args = [torch.from_numpy(a) for a in dit_inputs(tiny(dit_j), b=1)]
    mesh = mesh_t.Mesh((2, 1, 1, 1, 1), 0, torch.device("cpu"), {"pipe": None})
    with pytest.raises(ValueError) as port:
        dit_t.dit_forward(model, *args, cache_blocks=(0, 1), mesh=mesh)
    with pytest.raises(ValueError) as ref:
        dit_j.dit_forward(params[2], tiny(dit_j), *map(jnp.asarray, dit_inputs(tiny(dit_j), b=1)),
                          cache_blocks=(0, 1), mesh=make_mesh_j(MeshConfigJ(data=4, pipe=2)))
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="stage-local"):
        dit_t.dit_forward(model.keep_layers(range(1, 2)), *args)


def test_mesh_layout_with_pipe_matches_jax(four_ranks):
    """In a world of 4, meshes of pipe 2 x context 2 and pipe 2 x data 2:
    every rank's coordinates are those of the JAX device at the same place
    of JAX's 4-device mesh, and each of its groups holds the ranks of its
    JAX mesh line; ``fsdp`` / ``tensor`` still raise (``test_torch_parallel``)."""
    for i, config in enumerate(LAYOUTS):
        mesh = make_mesh_j(MeshConfigJ(**config), devices=jax.devices()[:4])
        ids = np.vectorize(lambda d: d.id)(mesh.devices)
        for rank, layouts in enumerate(four_ranks["layouts"]):
            layout = layouts[i]
            where = np.argwhere(ids == rank)[0].tolist()
            assert layout["coords"] == dict(zip(mesh.axis_names, where))
            for axis, size in mesh.shape.items():
                if size > 1:
                    row = list(where)
                    row[mesh.axis_names.index(axis)] = slice(None)
                    assert layout["groups"][axis] == ids[tuple(row)].tolist()
            assert set(layout["groups"]) == {a for a, n in mesh.shape.items() if n > 1}


# ------------------------------------------------------------ loading and the pipeline

def test_stage_local_loader(two_ranks, checkpoint):
    """``load_pipeline`` under pipe 2 from a tiny checkpoint directory with a
    diffusers LoRA (scale 0.8; one target in block 1 only): each rank's DiT
    holds only its stage's block, bitwise the single-process load's (the
    LoRA merged into it); the bytes it read from the DiT shards are the
    non-block tensors' and its block's, from the files' headers, and from
    the LoRA file its block's. The loaded pipeline's 2-step edit on every
    rank bitwise the single process's."""
    ckpt, lora = checkpoint
    got = two_ranks["loader"]
    whole = load_pipeline_t(tiny_t(), ckpt, loras=[(lora, 0.8)], device=torch.device("cpu"))
    want = dict(whole.dit.named_parameters())
    shards = [str(p) for p in sorted(Path(ckpt, "transformer").glob("*.safetensors"))]

    def nbytes(files, keep):
        return sum(files.nbytes(k) for k in files
                   if keep(w_t.block_index(k.removeprefix("transformer."))))

    with w_t.load_safetensors(shards) as sd, w_t.load_safetensors(lora) as lsd:
        for stage, r in enumerate(got):
            assert r["layers"] == (stage, stage + 1) and r["blocks"] == 1
            names = [n for n in want if not n.startswith("blocks.")
                     or n.startswith(f"blocks.{stage}.")]
            assert len(r["params"]) == len(names)
            for name, value in r["params"].items():
                ref = name.replace("blocks.0.", f"blocks.{stage}.", 1)
                np.testing.assert_array_equal(value, want[ref].detach().numpy(), err_msg=name)
            assert r["bytes"]["dit"] == nbytes(sd, lambda i: i in (None, stage))
            assert r["bytes"]["loras"] == nbytes(lsd, lambda i: i == stage) > 0
    video = whole(**{k: torch.from_numpy(v) for k, v in W.loader_edit_inputs(tiny_t()).items()},
                  num_steps=2)
    for r in got:
        np.testing.assert_array_equal(r["video"], video.numpy())


def test_pipeline_under_pipe_matches_jax(two_ranks, trees):
    """The edit with batched CFG (guidance 5, a negative prompt: B = 2, so
    2 microbatches and a bubble of 1 in 3 ticks) under pipe 2, every rank's
    clip against JAX's single-device pipeline."""
    got = two_ranks["pipeline"]
    inputs = edit_inputs(tiny_j(), 17)
    want = np.asarray(PipeJ(tiny_j(), *trees)(
        **{n: jnp.asarray(a) for n, a in inputs.items()}, **EDIT_CALL))
    assert got[0]["out"].shape == want.shape
    np.testing.assert_array_equal(got[1]["out"], got[0]["out"])
    assert psnr(got[0]["out"], want) >= MIN_PSNR_DB


def test_run_inference_pipe_under_torchrun(tmp_path):
    """``run_inference --mesh pipe=2 --smoke --device cpu`` under
    ``torch.distributed.run --nproc-per-node 2``: each rank keeps its
    stage's block of the seeded tiny model, and rank 0 writes the edit,
    bitwise the single process's PNG."""
    from PIL import Image

    args = ["-m", "chronoedit_tpu_torch.scripts.run_inference", "--smoke", "--device", "cpu"]
    runs = {"single": [sys.executable, *args],
            "mesh": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc-per-node", "2", *args, "--mesh", "pipe=2"]}
    for name, cmd in runs.items():
        proc = subprocess.run([*cmd, "--output", str(tmp_path / f"{name}.png")], cwd=REPO,
                              capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "mesh {'pipe': 2" in proc.stdout
    single = np.asarray(Image.open(tmp_path / "single.png"))
    assert single.std() > 0
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "mesh.png")), single)
