"""The port's ``vae_encode`` / ``vae_decode`` against the JAX VAE.

Same weights (JAX init, randomised with numpy so that no zero-initialised
projection hides an error, loaded through ``models/from_jax.py``) and the
same 5-frame 32x32 clip, fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.configs import chronoedit_tiny as tiny_j
from chronoedit_tpu.models import vae as vae_j
from chronoedit_tpu_torch.configs import chronoedit_tiny as tiny_t
from chronoedit_tpu_torch.models import vae as vae_t
from chronoedit_tpu_torch.models.from_jax import load_vae
from test_torch_dit import randomize

torch.set_num_threads(2)
# fp32 comparisons: TF32 off in matmuls and cuDNN convolutions
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

# 8x spatial and 4x temporal compression with 16 latent channels, so the
# latent mean/std path runs (it applies only when z_dim == 16)
_WIDE = dict(dim=8, z_dim=16, dim_mult=(1, 2, 4, 4), num_res_blocks=1,
             temporal_downsample=(False, True, True))

CONFIGS = {
    "tiny": (lambda: tiny_j().vae, lambda: tiny_t().vae),
    "wan_layout": (lambda: vae_j.VAEConfig(**_WIDE), lambda: vae_t.VAEConfig(**_WIDE)),
}


def _conv_fan_in(shape):
    return int(np.prod(shape[:-1]))  # (kt, kh, kw, cin, cout)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def vae_pair(request):
    cfg_j, cfg_t = (f() for f in CONFIGS[request.param])
    params = randomize(lambda: vae_j.init_vae_params(jax.random.PRNGKey(0), cfg_j), 4,
                       fan_in=_conv_fan_in)
    return cfg_j, params, load_vae(vae_t.VAE(cfg_t), params)


def _clip(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (1, 3, 5, 32, 32)).astype(np.float32)


def test_vae_encode_matches_jax(vae_pair):
    """fp32 convs summed in another order: 1e-4 of the output's scale."""
    cfg_j, params, vae = vae_pair
    x = _clip(0)
    want = np.asarray(vae_j.vae_encode(params, cfg_j, jnp.asarray(x)))
    with torch.inference_mode():
        got = vae_t.vae_encode(vae, torch.from_numpy(x)).numpy()
    tl = cfg_j.latent_frames(5)
    sf = cfg_j.spatial_factor
    assert got.shape == want.shape == (1, cfg_j.z_dim, tl, 32 // sf, 32 // sf)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=1e-4 * scale)


def test_vae_decode_matches_jax(vae_pair):
    """The decoder (temporal Rep-masked upsample, nearest spatial upsample)
    on the same latents: 1e-4 of the output's scale."""
    cfg_j, params, vae = vae_pair
    sf = cfg_j.spatial_factor
    rng = np.random.default_rng(1)
    z = rng.standard_normal((1, cfg_j.z_dim, 2, 32 // sf, 32 // sf)).astype(np.float32)
    want = np.asarray(vae_j.vae_decode(params, cfg_j, jnp.asarray(z)))
    with torch.inference_mode():
        got = vae_t.vae_decode(vae, torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (1, 3, cfg_j.pixel_frames(2), 32, 32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=1e-4 * scale)
