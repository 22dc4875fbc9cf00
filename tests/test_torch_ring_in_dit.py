"""Context parallelism inside the DiT and the pipeline, against JAX.

The port's side runs in worlds of 2 and 4 gloo processes on the CPU
(``test_torch_cp_workers.py`` through ``parallel.launch.run_world``; each
world ends within its own timeout); JAX's runs in this process, single
device and under its own mesh on the 8 virtual CPU devices, as its
``tests/test_ring_in_dit.py`` runs it. The same numpy weights go to both
(``models/from_jax.py``); fp32.

Bounds: the DiT within 1e-4 of outputs scaled to O(1) (the single-process
port-against-JAX bound of ``test_torch_dit.py``; JAX holds its own mesh
forward to 2e-4 of its single-device one); the pipeline at 60 dB PSNR over
the [-1, 1] range (``test_torch_pipeline.py``'s bar); where the port runs
unsharded under a mesh, or a CLI's PNG, bitwise.
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
from chronoedit_tpu.pipeline.edit_pipeline import ChronoEditPipeline as PipeJ
from chronoedit_tpu_torch.configs import chronoedit_tiny as tiny_t
from chronoedit_tpu_torch.models import dit as dit_t
from chronoedit_tpu_torch.models.from_jax import load_dit
from chronoedit_tpu_torch.parallel.launch import run_world
from test_torch_dit import _kernel_shaped, randomize
from test_torch_pipeline import psnr
import test_torch_cp_workers as W

torch.set_num_threads(2)

DIT_REL = 1e-4
MIN_PSNR_DB = 60.0
TIMEOUT = 120.0
REPO = Path(__file__).resolve().parents[1]


def world(tmp_path, fn, n, *args):
    return run_world(fn, n, args, timeout=TIMEOUT, tmp_dir=str(tmp_path))


def four_heads(mod):
    """The tiny DiT with 4 heads of 12, so that Ulysses splits them over 2
    and 4 ranks."""
    cfg = (tiny_j if mod is dit_j else tiny_t)().dit
    return dataclasses.replace(cfg, num_heads=4)


@pytest.fixture(scope="module")
def params():
    return randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), four_heads(dit_j)), 3)


def dit_inputs(cfg, b=2, t=2, h=4, w=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cfg.in_channels, t, h, w)).astype(np.float32)
    ts = rng.uniform(0, 1000, (b,)).astype(np.float32)
    text = rng.standard_normal((b, 7, cfg.text_dim)).astype(np.float32)
    img = rng.standard_normal((b, cfg.image_tokens, cfg.image_dim)).astype(np.float32)
    return x, ts, text, img


def jax_forward(params, cfg, inputs, mesh=None, **kw):
    args = [jnp.asarray(a) for a in inputs]
    if mesh is None:
        return np.asarray(dit_j.dit_forward(params, cfg, *args, **kw))
    with mesh:
        fwd = jax.jit(lambda p, *a: dit_j.dit_forward(p, cfg, *a, mesh=mesh, **kw))
        return np.asarray(fwd(params, *args))


def close(got, want, rel=DIT_REL):
    np.testing.assert_allclose(got, want, atol=rel * max(1.0, float(np.abs(want).max())))


# (mode, context size, latent frames): 8 tokens of 4 a frame split into one
# frame per rank at 2, half a frame at 4; 4 frames at 4, one frame each
CP_CASES = [("ring", 2, 2), ("ulysses", 2, 2), ("ring", 4, 2), ("ulysses", 4, 2),
            ("auto", 4, 4)]


@pytest.mark.parametrize("mode,cp,t", CP_CASES)
def test_cp_modes_match_jax(tmp_path, params, mode, cp, t):
    """Ring and Ulysses in the DiT: every rank's whole velocity against
    JAX's single-device forward and JAX's forward under its own mesh
    (data x context over its 8 devices) in the same mode; all ranks
    bitwise alike."""
    inputs = dit_inputs(four_heads(dit_j), t=t)
    cfg_j = dataclasses.replace(four_heads(dit_j), context_parallel=mode)
    cfg_t = dataclasses.replace(four_heads(dit_t), context_parallel=mode)
    got, calls = zip(*world(tmp_path, W.dit_forward, cp, cfg_t, params, inputs, cp))
    ref = jax_forward(params, four_heads(dit_j), inputs)
    want = jax_forward(params, cfg_j, inputs, make_mesh_j(MeshConfigJ(data=8 // cp, context=cp)))
    close(want, ref, 2e-4)
    used = "ulysses" if mode == "auto" else mode  # 4 heads divide 2 and 4
    for out, n in zip(got, calls):
        np.testing.assert_array_equal(out, got[0])
        assert n[used] == cfg_t.num_layers and sum(n.values()) == cfg_t.num_layers
    close(got[0], ref)
    close(got[0], want)


def test_cp_flash_ring_at_head_dim_128(tmp_path):
    """The kernels' head dim (2 heads of 128): the DiT's ring takes the flash
    hops (the twins of K1/K5 on the CPU), over 2 ranks, against JAX's
    single-device forward."""
    cfg_j = dataclasses.replace(_kernel_shaped(dit_j), context_parallel="ring")
    cfg_t = dataclasses.replace(_kernel_shaped(dit_t), context_parallel="ring")
    p = randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg_j), 4)
    inputs = dit_inputs(cfg_j, b=1, h=4, w=6)
    out, calls = world(tmp_path, W.dit_forward, 2, cfg_t, p, inputs, 2)[1]
    assert calls["ring"] == cfg_t.num_layers
    close(out, jax_forward(p, _kernel_shaped(dit_j), inputs))


@pytest.mark.parametrize("t,h,w", [(3, 2, 2), (3, 4, 4)])
def test_cp_falls_back_when_tokens_do_not_split(tmp_path, params, t, h, w):
    """3 tokens over 2 ranks (the sequence does not divide), and 12 tokens
    of 4 a frame (6 a rank: neither whole frames nor part of one): the
    forward runs unsharded on every rank, bitwise the port's own forward
    without a mesh, and against JAX."""
    cfg_t = dataclasses.replace(four_heads(dit_t), context_parallel="ring")
    inputs = dit_inputs(four_heads(dit_j), b=1, t=t, h=h, w=w)
    got = world(tmp_path, W.dit_forward, 2, cfg_t, params, inputs, 2)
    with torch.inference_mode():
        alone = dit_t.dit_forward(load_dit(dit_t.DiT(cfg_t), params),
                                  *map(torch.from_numpy, inputs)).numpy()
    for out, calls in got:
        assert calls == {"ring": 0, "ulysses": 0}
        np.testing.assert_array_equal(out, alone)
    close(alone, jax_forward(params, four_heads(dit_j), inputs))


def test_cp_data_and_context(tmp_path, params):
    """A mesh of data 2 x context 2 over 4 ranks: each data line runs the
    same forward over its own context group."""
    inputs = dit_inputs(four_heads(dit_j))
    got, calls = zip(*world(tmp_path, W.dit_forward, 4, four_heads(dit_t), params, inputs, 2, 2))
    ref = jax_forward(params, four_heads(dit_j), inputs)
    for out, n in zip(got, calls):
        assert n["ulysses"] == 2
        np.testing.assert_array_equal(out, got[0])
    close(got[0], ref)


def test_cp_block_cache_and_skip_layers(tmp_path, params):
    """Under context parallelism the block cache is each rank's block of
    the token delta: a refresh step and a reuse step against JAX's cached
    forward (its cache fed back), and a skip-layer mask against JAX's."""
    inputs = dit_inputs(four_heads(dit_j))
    blocks, mask = (1, 2), np.array([1.0, 0.0], np.float32)
    got = world(tmp_path, W.dit_cached, 2, four_heads(dit_t), params, inputs, 2, blocks, mask)
    cfg = four_heads(dit_j)
    fresh, cache = dit_j.dit_forward(params, cfg, *map(jnp.asarray, inputs), cache_blocks=blocks)
    reused, _ = dit_j.dit_forward(params, cfg, *map(jnp.asarray, inputs), cache_blocks=blocks,
                                  cache=cache, cache_refresh=False)
    masked = jax_forward(params, cfg, inputs, layer_mask=jnp.asarray(mask))
    for rank in got:
        assert rank["cache_shape"] == (2, 4, cfg.dim)  # 8 tokens over 2 ranks
        close(rank["fresh"], np.asarray(fresh))
        close(rank["reused"], np.asarray(reused))
        close(rank["masked"], masked)


def test_context_split_rules():
    """"auto" takes Ulysses when the heads divide the context size, else the
    ring; "none" and a context axis of 1 run whole; another mode raises."""
    from chronoedit_tpu_torch.parallel.mesh import Mesh

    def mesh(cp, index=0):
        return Mesh((1, 1, 1, 1, cp), index, torch.device("cpu"), {"context": "g"})

    cfg = dit_t.DiTConfig()  # 40 heads
    assert dit_t.context_split(cfg, mesh(4), 7200, 3600).mode == "ulysses"
    assert dit_t.context_split(cfg, mesh(3), 10800, 3600).mode == "ring"
    split = dit_t.context_split(cfg, mesh(4, 3), 28800, 3600)
    assert (split.group, split.index, split.size) == ("g", 3, 4)
    assert dit_t.context_split(cfg, mesh(1), 7200, 3600) is None
    assert dit_t.context_split(cfg, None, 7200, 3600) is None
    none = dataclasses.replace(cfg, context_parallel="none")
    assert dit_t.context_split(none, mesh(4), 7200, 3600) is None
    with pytest.raises(ValueError, match="context_parallel"):
        dit_t.context_split(dataclasses.replace(cfg, context_parallel="gspmd"), mesh(2),
                            7200, 3600)


# ------------------------------------------------------------ the pipeline

@pytest.fixture(scope="module")
def pipe_weights():
    from chronoedit_tpu.models import vae as vae_jm

    cfg = tiny_j()
    dit_p = randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg.dit), 8)
    vae_p = randomize(lambda: vae_jm.init_vae_params(jax.random.PRNGKey(1), cfg.vae), 9,
                      fan_in=lambda s: int(np.prod(s[:-1])))
    return dit_p, vae_p


def pipe_inputs(frames, h=16, w=16, seed=17):
    cfg = tiny_j()
    rng = np.random.default_rng(seed)
    d, sf = cfg.dit, cfg.vae.spatial_factor
    tl = cfg.vae.latent_frames(frames)
    f32 = np.float32
    return dict(image=rng.uniform(-1, 1, (1, 3, h, w)).astype(f32),
                prompt_emb=rng.standard_normal((1, 6, d.text_dim)).astype(f32),
                image_emb=rng.standard_normal((1, d.image_tokens, d.image_dim)).astype(f32),
                latents=rng.standard_normal((1, cfg.vae.z_dim, tl, h // sf, w // sf)).astype(f32))


@pytest.mark.parametrize("cp,frames,k", [(2, 3, 0), (4, 15, 2)])
def test_pipeline_under_context_parallelism_matches_jax(tmp_path, pipe_weights, cp, frames, k):
    """The edit (3 frames: 2 latent frames of 64 tokens, one a rank at
    context 2, through Ulysses) and a reasoning edit with the drop (15
    frames: 8 latent frames, two a rank at context 4 through the ring, the
    tiny model's 2 heads not dividing 4; after k = 2 steps 2 frames, half a
    frame a rank), every rank's clip against JAX's pipeline under its own
    mesh of the same context size."""
    dit_p, vae_p = pipe_weights
    inputs = pipe_inputs(frames)
    call = dict(num_frames=frames, enable_temporal_reasoning=k > 0,
                num_temporal_reasoning_steps=k)
    got, calls = zip(*world(tmp_path, W.pipeline, cp, tiny_t(), dit_p, vae_p, inputs, call, cp))
    mesh = make_mesh_j(MeshConfigJ(data=8 // cp, context=cp))
    pipe = PipeJ(tiny_j(), dit_p, vae_p, mesh=mesh)
    with mesh:
        want = np.asarray(pipe(**{n: jnp.asarray(a) for n, a in inputs.items()}, **call))
    assert got[0].shape == want.shape
    # every step's forward (2 blocks) went through Ulysses at 2, the ring at 4
    steps = tiny_t().num_steps * tiny_t().dit.num_layers
    for out, n in zip(got, calls):
        assert n == ({"ring": 0, "ulysses": steps} if cp == 2 else {"ring": steps, "ulysses": 0})
        np.testing.assert_array_equal(out, got[0])
    assert psnr(got[0], want) >= MIN_PSNR_DB


def test_run_inference_mesh_under_torchrun(tmp_path):
    """``run_inference --mesh context=2`` under ``torch.distributed.run
    --nproc-per-node 2`` on the CPU, from a tiny checkpoint directory, in
    reasoning mode with the drop (29 frames: 15 latent frames run whole,
    their tokens not splitting over 2 ranks; then 2 frames, one a rank):
    rank 0 writes the edit, bitwise the single process's PNG."""
    from PIL import Image

    from test_torch_weights import write_checkpoint

    cfg = tiny_j()
    dit_p = randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg.dit), 31)
    vae_p = randomize(lambda: vae_j.init_vae_params(jax.random.PRNGKey(1), cfg.vae), 32,
                      fan_in=lambda s: int(np.prod(s[:-1])))
    write_checkpoint(tmp_path / "ck", dit_p, vae_p)
    rng = np.random.default_rng(5)
    Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(tmp_path / "in.png")
    args = ["-m", "chronoedit_tpu_torch.scripts.run_inference", "--experiment", "tiny",
            "--checkpoint-dir", str(tmp_path / "ck"), "--input", str(tmp_path / "in.png"),
            "--height", "16", "--width", "16", "--device", "cpu",
            "--enable-temporal-reasoning", "--num-temporal-reasoning-steps", "2"]
    runs = {"single": [sys.executable, *args],
            "mesh": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc-per-node", "2", *args, "--mesh", "context=2"]}
    for name, cmd in runs.items():
        proc = subprocess.run([*cmd, "--output", str(tmp_path / f"{name}.png")], cwd=REPO,
                              capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    single = np.asarray(Image.open(tmp_path / "single.png"))
    assert single.std() > 0
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "mesh.png")), single)
