"""The kernel wrappers' plain twins (K1-K5) against the JAX package, on CPU.

On CPU the JAX fused norms run their jnp formulation (the Pallas path is
gated to TPU) and JAX flash attention runs the Pallas kernel itself in
interpret mode. Inputs are numpy, fixed seeds, fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.ops import flash_attention as fa_j
from chronoedit_tpu.ops import fused_norms as fn_j
from chronoedit_tpu_torch.kernels import build
from chronoedit_tpu_torch.ops import flash_attention as fa_t
from chronoedit_tpu_torch.ops import fused_norms as fn_t
from chronoedit_tpu_torch.ops import layers as L
from chronoedit_tpu_torch.ops.attention import dot_product_attention
from test_torch_dit import warm_cpu_math

torch.set_num_threads(2)
# fp32 comparisons: TF32 off in matmuls and cuDNN convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, T, HW, D = 2, 2, 12, 256


@pytest.fixture(scope="module", autouse=True)
def _warm():
    warm_cpu_math()


def _rng(seed):
    return np.random.default_rng(seed)


def _stream(rng, shape=(B, T * HW, D)):
    # an offset mean so the LayerNorm centring matters
    return (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)


def test_ln_modulate_matches_jax():
    """fp32 LayerNorm + modulate, same formula; sum order differs only:
    1e-5 on O(1) outputs."""
    rng = _rng(0)
    x = _stream(rng)
    scale = (0.1 * rng.standard_normal((B, T, D))).astype(np.float32)
    shift = (0.1 * rng.standard_normal((B, T, D))).astype(np.float32)
    want = fn_j.layer_norm_modulate(jnp.asarray(x), jnp.asarray(scale),
                                    jnp.asarray(shift), HW, 1e-6)
    got = fn_t.layer_norm_modulate(torch.from_numpy(x), torch.from_numpy(scale),
                                   torch.from_numpy(shift), HW, 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_gated_residual_matches_jax():
    """Elementwise fp32 x + delta*gate: 1e-6 on O(1) outputs."""
    rng = _rng(1)
    x, delta = _stream(rng), _stream(rng)
    gate = rng.standard_normal((B, T, D)).astype(np.float32)
    want = fn_j.gated_residual(jnp.asarray(x), jnp.asarray(delta),
                               jnp.asarray(gate), HW)
    got = fn_t.gated_residual(torch.from_numpy(x), torch.from_numpy(delta),
                              torch.from_numpy(gate), HW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_rms_norm_matches_jax():
    """fp32 statistics, then the weight: 1e-5 on O(1) outputs."""
    rng = _rng(2)
    x = _stream(rng)
    w = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    want = fn_j.rms_norm_fused({"scale": jnp.asarray(w)}, jnp.asarray(x), 1e-6)
    p = L.RMSNorm(D)
    with torch.no_grad():
        p.scale.copy_(torch.from_numpy(w))
    got = fn_t.rms_norm_fused(p, torch.from_numpy(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("skv", [200, 77])
def test_flash_attention_matches_pallas_interpret(skv):
    """The K1 twin against the JAX Pallas flash kernel run in interpret
    mode, output and LSE. Both are fp32 softmax attention; the kernel's
    online softmax sums in another order: 2e-5 on O(1) values."""
    rng = _rng(3)
    q = rng.standard_normal((1, 200, 2, 128)).astype(np.float32)
    k = rng.standard_normal((1, skv, 2, 128)).astype(np.float32)
    v = rng.standard_normal((1, skv, 2, 128)).astype(np.float32)
    scale = 128 ** -0.5
    out_j, lse_j = fa_j.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    out_t, lse_t = fa_t.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale)
    assert tuple(lse_t.shape) == (1, 200, 2)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=2e-5)

    got = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(out_j), atol=2e-5)
    want = fa_j.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    np.testing.assert_allclose(fa_t.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale).numpy(),
        np.asarray(want), atol=2e-5)


def test_streamed_flash_matches_pallas_streamed_kernel(monkeypatch):
    """K5: the twin against the JAX streamed Pallas kernel in interpret
    mode. JAX streams KV only past 6 MiB of K and V (2*Skv*D*itemsize), so
    fp32 KV of 6,500 rows with 1 head does; 130 q rows leave a ragged q
    tail, and 6,500 a ragged KV tail in JAX's 1,536-row KV groups. A spy
    shows that the streamed kernel, not the resident one, ran. Output and
    LSE within 2e-5, as for K1; the q-chunked twin (ragged last chunk)
    equals the unchunked one within 1e-6 (GEMMs of another height may
    block their sums differently)."""
    ran = []
    streamed = fa_j._fwd_kernel_streamed

    def spy(*args, **kw):
        ran.append(kw["group"])
        return streamed(*args, **kw)

    monkeypatch.setattr(fa_j, "_fwd_kernel_streamed", spy)
    rng = _rng(5)
    q = rng.standard_normal((1, 130, 1, 128)).astype(np.float32)
    k = rng.standard_normal((1, 6500, 1, 128)).astype(np.float32)
    v = rng.standard_normal((1, 6500, 1, 128)).astype(np.float32)
    scale = 128 ** -0.5
    out_j, lse_j = fa_j.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    assert ran, "JAX did not take the streamed kernel"
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    out_t, lse_t = fa_t.flash_attention_with_lse(qt, kt, vt, scale)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=2e-5)

    out_c, lse_c = fa_t.flash_attention_plain(qt, kt, vt, scale, q_chunk=48)
    assert out_c.shape == out_t.shape and lse_c.shape == lse_t.shape == (1, 130, 1)
    torch.testing.assert_close(out_c, out_t, atol=1e-6, rtol=0)
    torch.testing.assert_close(lse_c, lse_t, atol=1e-6, rtol=0)


def test_cpu_tensors_never_touch_the_kernel_loader(monkeypatch):
    """A wrapper given CPU tensors runs its plain twin: the library is
    neither built nor loaded, and no launch is counted."""
    def refuse(*a, **k):
        raise AssertionError("kernel loader touched for a CPU tensor")

    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "lib", refuse)
    before = dict(build.LAUNCHES), {k: dict(v) for k, v in build.SHAPE_LAUNCHES.items()}
    x = torch.randn(1, 8, 128)
    mod = torch.randn(1, 2, 128)
    fn_t.layer_norm_modulate(x, mod, mod, 4)
    fn_t.gated_residual(x, x, mod, 4)
    fn_t.rms_norm_fused(L.RMSNorm(128), x)
    q = torch.randn(1, 8, 2, 128)
    fa_t.flash_attention_with_lse(q, q, q, 0.1)
    dot_product_attention(q, q, q)
    assert (build.LAUNCHES, build.SHAPE_LAUNCHES) == before


def test_launch_counts_by_name_and_kv_length(monkeypatch):
    """``check`` counts a successful launch under its name and, for flash
    attention, under its KV length; ``reset_launches`` zeroes both."""
    monkeypatch.setattr(build, "LAUNCHES", dict.fromkeys(build.LAUNCHES, 0))
    monkeypatch.setattr(build, "SHAPE_LAUNCHES", {k: {} for k in build.SHAPE_LAUNCHES})
    for kv in (28800, 28800, 512):
        build.check(0, "flash_fwd", kv)
    build.check(0, "rms_norm")
    assert build.LAUNCHES["flash_fwd"] == 3 and build.LAUNCHES["rms_norm"] == 1
    assert build.SHAPE_LAUNCHES["flash_fwd"] == {28800: 2, 512: 1}
    build.reset_launches()
    assert not any(build.LAUNCHES.values()) and not any(build.SHAPE_LAUNCHES.values())


@pytest.mark.parametrize("case", ["fp32", "head_dim", "kv_mismatch", "strided"])
def test_flash_checks_reject_what_the_kernel_does_not_take(case):
    """The K1 argument checks (run before any launch on a card)."""
    q = torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16)
    k = v = q
    if case == "fp32":
        q = q.float()
    elif case == "head_dim":
        q = k = v = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    elif case == "kv_mismatch":
        v = torch.zeros(1, 9, 2, 128, dtype=torch.bfloat16)
    else:
        q = torch.zeros(1, 2, 8, 128, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError):
        fa_t._check(q, k, v)


@pytest.mark.parametrize("case", ["fp32", "width", "frames", "mod_shape"])
def test_norm_checks_reject_what_the_kernels_do_not_take(case):
    """The K2-K4 argument checks (run before any launch on a card)."""
    x = torch.zeros(1, 8, 128, dtype=torch.bfloat16)
    mod = torch.zeros(1, 2, 128)
    if case == "fp32":
        with pytest.raises(ValueError):
            fn_t._check_stream("k", x.float())
    elif case == "width":
        with pytest.raises(ValueError):
            fn_t._check_stream("k", torch.zeros(1, 8, 100, dtype=torch.bfloat16))
    elif case == "frames":
        with pytest.raises(ValueError):
            fn_t._frames("k", x, 3)
    else:
        with pytest.raises(ValueError):
            fn_t._check_like("k", x, mod[:, :1], (1, 2, 128), torch.float32)
