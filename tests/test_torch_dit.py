"""The port's ``dit_forward`` against the JAX DiT on the same weights.

Weights are initialised by JAX, randomised with numpy (the JAX init zeroes
the output head, which would hide every error), converted to numpy and
loaded through ``models/from_jax.py``. Two latent frames exercise the
temporal-skip RoPE. fp32 throughout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.configs import chronoedit_tiny as tiny_j
from chronoedit_tpu.core.rope import Rope3DSpec as RopeJ
from chronoedit_tpu.models import dit as dit_j
from chronoedit_tpu_torch.configs import chronoedit_tiny as tiny_t
from chronoedit_tpu_torch.core.rope import Rope3DSpec as RopeT
from chronoedit_tpu_torch.models import dit as dit_t
from chronoedit_tpu_torch.models.from_jax import load_dit

torch.set_num_threads(2)
# fp32 comparisons: TF32 off in matmuls and cuDNN convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def randomize(init_fn, seed, fan_in=lambda shape: shape[-2]):
    """A parameter tree shaped like ``init_fn()``'s (traced abstractly, so
    nothing is compiled) filled with seeded numpy noise: kernels
    ~N(0, 1/fan_in), norm scales 1 + 0.1 N, everything else 0.1 N. The JAX
    init zeroes output projections, which would hide errors. Returns numpy
    arrays, ready for ``from_jax`` and for the JAX side."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return (rng.standard_normal(a.shape) / np.sqrt(fan_in(a.shape))).astype(np.float32)
        if ("scale" in name and "table" not in name) or "gamma" in name:
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init_fn))


def warm_cpu_math():
    """A workaround for a cause that was not found. Under the whole suite
    (pytest-xdist, several files to a worker process), the flash twin's
    first comparison with JAX in ``test_torch_ops.py`` sometimes erred by
    2e-5 (logsumexp up to 4e-5) where it errs by 7e-7 when the file runs
    alone, with or without this call: not a reordered sum, which would stay
    near 1e-6. One throwaway attention-twin call before the comparisons
    made it go away in 28 runs of 28. Files with bounds near 1e-5 make that
    call first."""
    from chronoedit_tpu_torch.ops.flash_attention import flash_attention_plain

    x = torch.randn(1, 64, 2, 128, generator=torch.Generator().manual_seed(0))
    flash_attention_plain(x, x, x, 0.1)


def _kernel_shaped(mod):
    """2 heads x 128, 2 layers, ffn 512, text 64, image 32 — the kernels'
    head dim at a CPU-sized width."""
    kw = dict(num_heads=2, head_dim=128, in_channels=36, out_channels=16,
              text_dim=64, freq_dim=256, ffn_dim=512, num_layers=2, image_dim=32,
              image_tokens=9, temporal_skip=True, dtype=None, param_dtype=None)
    if mod is dit_j:
        kw.update(rope=RopeJ(head_dim=128), dtype=jnp.float32, param_dtype=jnp.float32)
    else:
        kw.update(rope=RopeT(head_dim=128), dtype=torch.float32,
                  param_dtype=torch.float32)
    return mod.DiTConfig(**kw)


CONFIGS = {
    "tiny": (lambda: tiny_j().dit, lambda: tiny_t().dit, (4, 4)),
    "kernel_shaped": (lambda: _kernel_shaped(dit_j), lambda: _kernel_shaped(dit_t),
                      (4, 6)),
}


@pytest.mark.parametrize("name,masked", [("tiny", False), ("tiny", True),
                                         ("kernel_shaped", False)])
def test_dit_forward_matches_jax(name, masked):
    """Same fp32 math with per-op rounding differences only: max-abs error
    within 1e-4 of outputs scaled to O(1)."""
    cfg_jf, cfg_tf, (h, w) = CONFIGS[name]
    cfg_j, cfg_t = cfg_jf(), cfg_tf()
    params = randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg_j), 1)
    model = load_dit(dit_t.DiT(cfg_t), params)

    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, cfg_j.in_channels, 2, h, w)).astype(np.float32)
    ts = np.array([[999.0, 937.0]], np.float32)  # per latent frame
    text = rng.standard_normal((1, 7, cfg_j.text_dim)).astype(np.float32)
    img = rng.standard_normal((1, cfg_j.image_tokens, cfg_j.image_dim)).astype(np.float32)
    mask = np.array([1.0, 0.0], np.float32) if masked else None

    want = dit_j.dit_forward(params, cfg_j, jnp.asarray(x), jnp.asarray(ts),
                             jnp.asarray(text), jnp.asarray(img),
                             layer_mask=None if mask is None else jnp.asarray(mask))
    with torch.inference_mode():
        got = dit_t.dit_forward(model, torch.from_numpy(x), torch.from_numpy(ts),
                                torch.from_numpy(text), torch.from_numpy(img),
                                layer_mask=mask)
    want = np.asarray(want)
    assert got.shape == want.shape == (1, cfg_j.out_channels, 2, h, w)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * scale)


def test_scalar_timestep_broadcasts_per_frame():
    """A (B,) timestep equals the same value given per latent frame."""
    cfg = tiny_t().dit
    model = dit_t.init_dit_params(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.head.proj.weight.normal_(generator=torch.Generator().manual_seed(1))
    x = torch.randn(1, cfg.in_channels, 2, 4, 4)
    text = torch.randn(1, 3, cfg.text_dim)
    a = dit_t.dit_forward(model, x, torch.tensor([500.0]), text)
    b = dit_t.dit_forward(model, x, torch.tensor([[500.0, 500.0]]), text)
    assert float(a.abs().max()) > 0
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_random_init_is_seeded_and_in_param_dtype():
    """init draws from the generator directly in param_dtype: same seed,
    same weights; the output projection starts at zero."""
    cfg = dataclasses.replace(tiny_t().dit, param_dtype=torch.bfloat16)
    a = dit_t.init_dit_params(cfg, torch.Generator().manual_seed(3))
    b = dit_t.init_dit_params(cfg, torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert pa.dtype == torch.bfloat16, name
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    assert float(a.head.proj.weight.abs().max()) == 0.0
    assert len(a.blocks) == cfg.num_layers
