"""The whole edit slice, image -> pixels, against the JAX pipeline.

The tiny preset, the same weights (numpy noise in the JAX tree's shapes,
loaded through ``models/from_jax.py``), the same image, embeddings and
initial ``latents``, fp32 on both sides. The bar is PSNR over the [-1, 1]
pixel range (peak-to-peak 2): at least 60 dB, far above the 35 dB fidelity
bar; fp32 op-order differences through 4 solver steps leave ~1e-6 errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.configs import chronoedit_tiny as tiny_j
from chronoedit_tpu.models import dit as dit_j
from chronoedit_tpu.models import vae as vae_j
from chronoedit_tpu.pipeline.edit_pipeline import ChronoEditPipeline as PipeJ
from chronoedit_tpu_torch.configs import chronoedit_tiny as tiny_t
from chronoedit_tpu_torch.models import dit as dit_t
from chronoedit_tpu_torch.models import vae as vae_t
from chronoedit_tpu_torch.models.from_jax import load_dit, load_vae
from chronoedit_tpu_torch.pipeline.edit_pipeline import ChronoEditPipeline as PipeT
from test_torch_dit import randomize

torch.set_num_threads(2)
# fp32 comparisons: TF32 off in matmuls and cuDNN convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MIN_PSNR_DB = 60.0
H = W = 16


def psnr(got: np.ndarray, want: np.ndarray) -> float:
    mse = float(np.mean((got.astype(np.float64) - want) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(2.0 ** 2 / mse)


@pytest.fixture(scope="module")
def pipelines():
    cfg_j, cfg_t = tiny_j(), tiny_t()
    dit_p = randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg_j.dit), 5)
    vae_p = randomize(lambda: vae_j.init_vae_params(jax.random.PRNGKey(1), cfg_j.vae), 6,
                      fan_in=lambda s: int(np.prod(s[:-1])))
    pipe_j = PipeJ(cfg_j, dit_p, vae_p)
    pipe_t = PipeT(cfg_t, load_dit(dit_t.DiT(cfg_t.dit), dit_p),
                   load_vae(vae_t.VAE(cfg_t.vae), vae_p))
    return pipe_j, pipe_t


def _inputs(cfg):
    rng = np.random.default_rng(7)
    d = cfg.dit
    tl = cfg.vae.latent_frames(cfg.num_frames)
    sf = cfg.vae.spatial_factor
    f32 = np.float32
    return dict(
        image=rng.uniform(-1, 1, (1, 3, H, W)).astype(f32),
        prompt_emb=rng.standard_normal((1, 6, d.text_dim)).astype(f32),
        neg_prompt_emb=rng.standard_normal((1, 6, d.text_dim)).astype(f32),
        image_emb=rng.standard_normal((1, d.image_tokens, d.image_dim)).astype(f32),
        latents=rng.standard_normal((1, cfg.vae.z_dim, tl, H // sf, W // sf)).astype(f32),
    )


@pytest.mark.parametrize("guidance", [2.0, 1.0])
def test_pipeline_matches_jax(pipelines, guidance):
    """guidance 2.0 runs cond and uncond batched in one forward; 1.0 is the
    distilled path's single forward. Video and ``edit_image`` both hold."""
    pipe_j, pipe_t = pipelines
    inp = _inputs(pipe_t.config)
    kw = dict(guidance_scale=guidance)
    want = np.asarray(pipe_j(**{k: jnp.asarray(v) for k, v in inp.items()}, **kw))
    want_frame = np.asarray(pipe_j.edit_image(
        **{k: jnp.asarray(v) for k, v in inp.items()}, **kw))
    targs = {k: torch.from_numpy(v) for k, v in inp.items()}
    got = pipe_t(**targs, **kw).numpy()
    got_frame = pipe_t.edit_image(**targs, **kw).numpy()

    assert got.shape == want.shape == (1, 3, pipe_t.config.num_frames, H, W)
    assert got_frame.shape == want_frame.shape == (1, 3, H, W)
    assert np.isfinite(got).all() and float(np.abs(want).max()) > 0
    assert psnr(got, want) >= MIN_PSNR_DB
    assert psnr(got_frame, want_frame) >= MIN_PSNR_DB
    np.testing.assert_array_equal(got_frame, got[:, :, -1])


def test_latent_output_and_generator_noise(pipelines):
    """``output_type="latent"`` returns the fp32 solver state; without
    ``latents`` the noise comes from the generator, so one seed gives one
    result."""
    _, pipe_t = pipelines
    inp = {k: torch.from_numpy(v) for k, v in _inputs(pipe_t.config).items()}
    lat_given = inp.pop("latents")
    a = pipe_t(**inp, generator=torch.Generator().manual_seed(3), output_type="latent")
    b = pipe_t(**inp, generator=torch.Generator().manual_seed(3), output_type="latent")
    assert a.dtype == torch.float32 and a.shape == lat_given.shape
    torch.testing.assert_close(a, b, rtol=0, atol=0)
