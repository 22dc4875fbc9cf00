"""The port's streaming and W-tiled VAE paths against its own full-sequence
path and against the JAX VAE with the same ``streaming``/``spatial_tiles``.

Same weights (JAX init, randomised with numpy, loaded through
``models/from_jax.py``), inputs from a numpy seed, fp32. Two geometries:
the tiny preset (2x spatial, 2x temporal) and the Wan layout at a narrow
width (8x spatial, 4x temporal: two stacked temporal downsamples, z 16 so
that the latent statistics apply).

Bounds: streaming and tiling compute the same sums as the full-sequence
pass (a zero cache is the causal pad; the halo covers the receptive
field), so the port against itself is held at 2e-5 of the output's scale,
as the JAX package holds its own paths (``tests/test_vae.py``); the port
against JAX at 1e-4 of scale, as the full-sequence comparison in
``tests/test_torch_vae.py``.
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
from test_torch_dit import randomize, warm_cpu_math

torch.set_num_threads(2)
# fp32 comparisons: TF32 off in matmuls and cuDNN convolutions
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

_WAN = dict(dim=4, z_dim=16, dim_mult=(1, 1, 2, 2), num_res_blocks=1,
            temporal_downsample=(False, True, True))

CONFIGS = {
    "tiny": (lambda: tiny_j().vae, lambda: tiny_t().vae),
    "wan_layout": (lambda: vae_j.VAEConfig(**_WAN), lambda: vae_t.VAEConfig(**_WAN)),
}

SELF_TOL = 2e-5
JAX_TOL = 1e-4


@pytest.fixture(scope="module")
def vaes():
    warm_cpu_math()
    out = {}
    for name, (cfg_jf, cfg_tf) in CONFIGS.items():
        cfg_j, cfg_t = cfg_jf(), cfg_tf()
        params = randomize(lambda: vae_j.init_vae_params(jax.random.PRNGKey(0), cfg_j), 11,
                           fan_in=lambda s: int(np.prod(s[:-1])))
        out[name] = (cfg_j, params, load_vae(vae_t.VAE(cfg_t), params))
    return out


def _check(got, full, want):
    assert got.shape == full.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, full, atol=SELF_TOL * scale, rtol=0)
    np.testing.assert_allclose(got, want, atol=JAX_TOL * scale, rtol=0)


# (config, T, H, W, streaming, spatial_tiles); None is the auto rule
ENCODE_CASES = [
    ("tiny", 7, 16, 16, True, 1),
    ("tiny", 9, 16, 16, True, 1),
    ("tiny", 9, 16, 16, None, None),  # auto: streams past 5 frames
    ("tiny", 9, 16, 64, True, 2),
    ("tiny", 5, 16, 64, True, 4),
    ("tiny", 5, 16, 64, False, 2),
    ("tiny", 3, 16, 64, False, 4),
    ("wan_layout", 13, 16, 16, True, 1),
    ("wan_layout", 9, 16, 256, True, 4),
    ("wan_layout", 5, 16, 256, False, 4),
]


@pytest.mark.parametrize("name,t,h,w,streaming,tiles", ENCODE_CASES)
def test_encode_paths_match_full_and_jax(vaes, name, t, h, w, streaming, tiles):
    cfg_j, params, vae = vaes[name]
    x = np.random.default_rng(t * 1000 + w).uniform(-1, 1, (1, 3, t, h, w)).astype(np.float32)
    kw = dict(streaming=streaming, spatial_tiles=tiles)
    want = np.asarray(vae_j.vae_encode(params, cfg_j, jnp.asarray(x), **kw))
    with torch.inference_mode():
        got = vae_t.vae_encode(vae, torch.from_numpy(x), **kw).numpy()
        full = vae_t.vae_encode(vae, torch.from_numpy(x), streaming=False,
                                spatial_tiles=1).numpy()
    sf = cfg_j.spatial_factor
    assert got.shape == (1, cfg_j.z_dim, cfg_j.latent_frames(t), h // sf, w // sf)
    _check(got, full, want)


# (config, Tl, latent H, latent W, streaming, spatial_tiles)
DECODE_CASES = [
    ("tiny", 5, 4, 4, True, 1),
    ("tiny", 5, 4, 4, None, None),  # auto: streams past 2 latent frames
    ("tiny", 2, 4, 4, True, 1),
    ("tiny", 5, 8, 32, True, 2),
    ("tiny", 4, 8, 32, True, 4),
    ("tiny", 2, 8, 32, False, 2),
    ("tiny", 3, 8, 32, False, 4),
    ("wan_layout", 4, 2, 4, True, 1),
    ("wan_layout", 4, 2, 32, True, 4),
    ("wan_layout", 2, 2, 32, False, 4),
]


@pytest.mark.parametrize("name,tl,h,w,streaming,tiles", DECODE_CASES)
def test_decode_paths_match_full_and_jax(vaes, name, tl, h, w, streaming, tiles):
    cfg_j, params, vae = vaes[name]
    z = np.random.default_rng(tl * 1000 + w).standard_normal(
        (1, cfg_j.z_dim, tl, h, w)).astype(np.float32)
    kw = dict(streaming=streaming, spatial_tiles=tiles)
    want = np.asarray(vae_j.vae_decode(params, cfg_j, jnp.asarray(z), **kw))
    with torch.inference_mode():
        got = vae_t.vae_decode(vae, torch.from_numpy(z), **kw).numpy()
        full = vae_t.vae_decode(vae, torch.from_numpy(z), streaming=False,
                                spatial_tiles=1).numpy()
    sf = cfg_j.spatial_factor
    assert got.shape == (1, 3, cfg_j.pixel_frames(tl), h * sf, w * sf)
    _check(got, full, want)


@pytest.mark.parametrize("what,streaming", [("encode", False), ("encode", True),
                                            ("decode", False), ("decode", True)])
def test_only_chunks_before_the_last_copy_a_cache(vaes, monkeypatch, what, streaming):
    """The full-sequence pass is one chunk and copies no cached frames; a
    streamed pass over 5 chunks (9 pixel or 5 latent frames) copies them
    after each of the first 4, the same number after each."""
    keeps = []
    tail = vae_t._tail

    def spy(x, start, keep):
        keeps.append(keep)
        return tail(x, start, keep)

    monkeypatch.setattr(vae_t, "_tail", spy)
    _, _, vae = vaes["tiny"]
    with torch.inference_mode():
        if what == "encode":
            vae_t.vae_encode(vae, torch.zeros(1, 3, 9, 16, 16), streaming=streaming)
        else:
            vae_t.vae_decode(vae, torch.zeros(1, 4, 5, 4, 4), streaming=streaming)
    last = keeps.count(False)
    assert last > 0
    assert keeps.count(True) == (4 * last if streaming else 0)


@pytest.mark.parametrize("geometry", ["tiny", "wan_layout", "14b"])
def test_halos_match_jax(geometry):
    """The tile halos are the JAX package's; at the 14B geometry 80 input
    px (encoder) and 14 latent px (decoder)."""
    if geometry == "14b":
        cfg_j, cfg_t = vae_j.VAEConfig(), vae_t.VAEConfig()
        assert (vae_t._encoder_halo(cfg_t), vae_t._decoder_halo(cfg_t)) == (80, 14)
    else:
        cfg_j, cfg_t = (f() for f in CONFIGS[geometry])
    assert vae_t._encoder_halo(cfg_t) == vae_j._encoder_halo(cfg_j)
    assert vae_t._decoder_halo(cfg_t) == vae_j._decoder_halo(cfg_j)
    assert vae_t._encoder_halo(cfg_t) % cfg_t.spatial_factor == 0
    for w, tiles, halo in ((1280, 4, 80), (160, 4, 14), (64, 4, 10)):
        assert vae_t._tile_plan(w, tiles, halo) == vae_j._tile_plan(w, tiles, halo)


@pytest.mark.parametrize("what", ["encode", "decode"])
def test_indivisible_width_is_rejected(vaes, what):
    """A W that the tiles do not divide raises rather than mis-tiling."""
    _, _, vae = vaes["tiny"]
    with pytest.raises(ValueError), torch.inference_mode():
        if what == "encode":
            vae_t.vae_encode(vae, torch.zeros(1, 3, 9, 16, 60), streaming=True,
                             spatial_tiles=4)
        else:
            vae_t.vae_decode(vae, torch.zeros(1, 4, 5, 8, 30), streaming=True,
                             spatial_tiles=4)
