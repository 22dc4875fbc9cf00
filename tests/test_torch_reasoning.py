"""Temporal-reasoning mode, image -> pixels, against the JAX pipeline.

The tiny preset with 9 pixel frames (5 latent frames: the tiny VAE's
temporal factor is 2), the same weights through ``models/from_jax.py``,
the same image, embeddings and initial latents, fp32 on both sides. Both
submodes: k = 2 < num_steps drops to [first, last] after two steps (a
3-frame clip), k >= num_steps keeps the whole trajectory (9 frames). With
``vae_spatial_tiles`` = 2 the streaming encode and decode run W-tiled.
The bar is the edit test's: PSNR over the [-1, 1] range of at least 60 dB.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.configs import chronoedit_14b as c14_j
from chronoedit_tpu.configs import chronoedit_tiny as tiny_j
from chronoedit_tpu.models import dit as dit_j
from chronoedit_tpu.models import vae as vae_j
from chronoedit_tpu.pipeline.edit_pipeline import ChronoEditPipeline as PipeJ
from chronoedit_tpu_torch.configs import chronoedit_14b as c14_t
from chronoedit_tpu_torch.configs import chronoedit_tiny as tiny_t
from chronoedit_tpu_torch.models import dit as dit_t
from chronoedit_tpu_torch.models import vae as vae_t
from chronoedit_tpu_torch.models.from_jax import load_dit, load_vae
from chronoedit_tpu_torch.pipeline.edit_pipeline import ChronoEditPipeline as PipeT
from test_torch_dit import randomize
from test_torch_pipeline import psnr

torch.set_num_threads(2)
# fp32 comparisons: TF32 off in matmuls and cuDNN convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MIN_PSNR_DB = 60.0
H = W = 16
FRAMES = 9


@pytest.fixture(scope="module")
def weights():
    cfg = tiny_j()
    dit_p = randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg.dit), 8)
    vae_p = randomize(lambda: vae_j.init_vae_params(jax.random.PRNGKey(1), cfg.vae), 9,
                      fan_in=lambda s: int(np.prod(s[:-1])))
    return dit_p, vae_p


def _pipelines(weights, tiles):
    dit_p, vae_p = weights
    cfg_j = dataclasses.replace(tiny_j(), vae_spatial_tiles=tiles)
    cfg_t = dataclasses.replace(tiny_t(), vae_spatial_tiles=tiles)
    return (PipeJ(cfg_j, dit_p, vae_p),
            PipeT(cfg_t, load_dit(dit_t.DiT(cfg_t.dit), dit_p),
                  load_vae(vae_t.VAE(cfg_t.vae), vae_p)))


def _inputs(cfg):
    rng = np.random.default_rng(17)
    d = cfg.dit
    tl = cfg.vae.latent_frames(FRAMES)
    sf = cfg.vae.spatial_factor
    f32 = np.float32
    return dict(
        image=rng.uniform(-1, 1, (1, 3, H, W)).astype(f32),
        prompt_emb=rng.standard_normal((1, 6, d.text_dim)).astype(f32),
        neg_prompt_emb=rng.standard_normal((1, 6, d.text_dim)).astype(f32),
        image_emb=rng.standard_normal((1, d.image_tokens, d.image_dim)).astype(f32),
        latents=rng.standard_normal((1, cfg.vae.z_dim, tl, H // sf, W // sf)).astype(f32),
    )


# (reasoning steps k, vae_spatial_tiles, guidance); the preset runs 4 steps
CASES = [(2, None, 2.0), (4, None, 1.0), (2, 2, 1.0), (99, 2, 2.0)]


@pytest.mark.parametrize("k,tiles,guidance", CASES)
def test_reasoning_matches_jax(weights, k, tiles, guidance):
    pipe_j, pipe_t = _pipelines(weights, tiles)
    inp = _inputs(pipe_t.config)
    kw = dict(num_frames=FRAMES, enable_temporal_reasoning=True,
              num_temporal_reasoning_steps=k, guidance_scale=guidance)
    want = np.asarray(pipe_j(**{n: jnp.asarray(v) for n, v in inp.items()}, **kw))
    targs = {n: torch.from_numpy(v) for n, v in inp.items()}
    got = pipe_t(**targs, **kw).numpy()
    frames = 3 if k < pipe_t.config.num_steps else FRAMES
    assert got.shape == want.shape == (1, 3, frames, H, W)
    assert np.isfinite(got).all() and float(np.abs(want).max()) > 0
    assert psnr(got, want) >= MIN_PSNR_DB
    np.testing.assert_array_equal(pipe_t.edit_image(**targs, **kw).numpy(), got[:, :, -1])


def test_drop_keeps_first_and_last_latent_frames(weights):
    """``output_type="latent"`` after the drop is the 2-frame solver state."""
    _, pipe_t = _pipelines(weights, None)
    inp = {n: torch.from_numpy(v) for n, v in _inputs(pipe_t.config).items()}
    lat = pipe_t(**inp, num_frames=FRAMES, enable_temporal_reasoning=True,
                 num_temporal_reasoning_steps=2, output_type="latent")
    assert lat.dtype == torch.float32
    assert tuple(lat.shape) == (1, 4, 2, H // 2, W // 2)


@pytest.mark.parametrize("preset", ["tiny", "14b"])
def test_resolve_num_frames_matches_jax(preset):
    """29 frames by default in reasoning mode, the edit default otherwise,
    rounded down to temporal_factor*k + 1, as in JAX."""
    cfg_j, cfg_t = (tiny_j(), tiny_t()) if preset == "tiny" else (c14_j(), c14_t())
    for n in (None, 9, 12, 29, 30):
        for reasoning in (False, True):
            assert (cfg_t.resolve_num_frames(n, reasoning)
                    == cfg_j.resolve_num_frames(n, reasoning))
    assert cfg_t.resolve_num_frames(None, True) == 29
