"""Attention's backward (the K6/K7 twin and the autograd Function) and the
K2-K4 autograd Functions against the JAX package, on CPU.

JAX's flash backward runs its Pallas kernels (``_dq_kernel``,
``_dkv_kernel``) in interpret mode; the JAX fused norms run their jnp
formulation, differentiated by ``jax.grad``. Inputs are numpy, fixed seeds,
fp32.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.ops import flash_attention as fa_j
from chronoedit_tpu.ops import fused_norms as fn_j
from chronoedit_tpu_torch.kernels import build
from chronoedit_tpu_torch.ops import flash_attention as fa_t
from chronoedit_tpu_torch.ops import fused_norms as fn_t
from chronoedit_tpu_torch.ops.attention import dot_product_attention
from test_torch_dit import warm_cpu_math

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SCALE = 128 ** -0.5


@pytest.fixture(scope="module", autouse=True)
def _warm():
    warm_cpu_math()


def _qkv(skv, seed=0, sq=200, heads=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, sq, heads, 128)).astype(np.float32)
    k = rng.standard_normal((1, skv, heads, 128)).astype(np.float32)
    v = rng.standard_normal((1, skv, heads, 128)).astype(np.float32)
    dout = rng.standard_normal((1, sq, heads, 128)).astype(np.float32)
    return q, k, v, dout


def _t(*arrays, grad=False):
    return [torch.from_numpy(np.array(a)).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("skv", [200, 77])
def test_bwd_twin_matches_pallas_bwd(skv):
    """The K6+K7 twin against JAX ``flash_attention_bwd`` (its Pallas dQ and
    dKV kernels in interpret mode) on the same O and LSE: the same fp32
    math in another summation order, 2e-4 on O(1) gradients (the bound of
    ``tests/test_parallel.py``'s flash backward check). KV 77 is ragged
    against every tile; q 200 against JAX's q blocks."""
    q, k, v, dout = _qkv(skv)
    out, lse = fa_j.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), SCALE)
    want = fa_j.flash_attention_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out,
                                    jnp.asarray(dout), lse, SCALE)
    got = fa_t.flash_attention_bwd(*_t(q, k, v, np.asarray(out), dout, np.asarray(lse)),
                                   SCALE)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4)


@pytest.mark.parametrize("skv", [200, 77])
def test_attention_function_grads_match_jax_grad(skv):
    """Gradients through ``dot_product_attention`` (the autograd Function:
    the twin forward, then the twin backward from the saved LSE) against
    ``jax.grad`` of JAX ``flash_attention`` (Pallas forward and backward in
    interpret mode), for a loss <out, dO>: 2e-4, as above."""
    q, k, v, dout = _qkv(skv, seed=1)

    def loss_j(q_, k_, v_):
        return jnp.sum(fa_j.flash_attention(q_, k_, v_, SCALE) * jnp.asarray(dout))

    want = jax.grad(loss_j, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v))
    qt, kt, vt = _t(q, k, v, grad=True)
    (dot_product_attention(qt, kt, vt) * torch.from_numpy(dout)).sum().backward()
    for g, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4)


@pytest.mark.parametrize("grad_q,grad_kv", [(True, False), (False, True), (True, True)])
def test_function_asks_only_for_the_gradients_needed(monkeypatch, grad_q, grad_kv):
    """The Function's backward passes ``needs_input_grad`` on: no dK/dV
    (no K7 on a card) when neither k nor v needs a gradient, no dQ (no K6)
    when q does not; the gradients it does return equal the full ones."""
    calls = []
    real = fa_t.flash_attention_bwd

    def spy(*args):
        calls.append(args[-2:])
        return real(*args)

    monkeypatch.setattr(fa_t, "flash_attention_bwd", spy)
    q, k, v, dout = _qkv(77, seed=2, sq=40)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(r)
                  for a, r in ((q, grad_q), (k, grad_kv), (v, grad_kv)))
    (fa_t.flash_attention(qt, kt, vt, SCALE) * torch.from_numpy(dout)).sum().backward()
    assert calls == [(grad_q, grad_kv)]

    full = [t.requires_grad_() for t in _t(q, k, v)]
    (fa_t.flash_attention(*full, SCALE) * torch.from_numpy(dout)).sum().backward()
    for t, f, wanted in ((qt, full[0], grad_q), (kt, full[1], grad_kv), (vt, full[2], grad_kv)):
        if wanted:
            torch.testing.assert_close(t.grad, f.grad, rtol=0, atol=0)
        else:
            assert t.grad is None


@pytest.mark.parametrize("need_dq,need_dkv", [(True, True), (True, False), (False, True)])
def test_q_chunked_bwd_twin_equals_unchunked(need_dq, need_dkv):
    """``q_chunk`` splits dQ rows and sums dK/dV over the chunks (a ragged
    last chunk here): the same sums, 1e-6 (fp32 accumulation across chunks
    in another order). Asked for K6's or K7's part alone, the twin returns
    that part, bitwise the full call's, and None for the other."""
    q, k, v, dout = _qkv(77, seed=3)
    qt, kt, vt, dt = _t(q, k, v, dout)
    out, lse = fa_t.flash_attention_with_lse(qt, kt, vt, SCALE)
    whole = fa_t.flash_attention_bwd_plain(qt, kt, vt, out, dt, lse, SCALE)
    wanted = (need_dq, need_dkv, need_dkv)
    for q_chunk in (None, 64):
        got = fa_t.flash_attention_bwd_plain(qt, kt, vt, out, dt, lse, SCALE, q_chunk=q_chunk,
                                             need_dq=need_dq, need_dkv=need_dkv)
        for a, b, w in zip(got, whole, wanted):
            if not w:
                assert a is None
            elif q_chunk is None:
                torch.testing.assert_close(a, b, atol=0, rtol=0)
            else:
                torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_bwd_launches_count_by_kernel_and_kv_length(monkeypatch):
    """``check`` counts K6/K7 launches under their names and their KV
    lengths, apart from the forward's; ``reset_launches`` zeroes them."""
    monkeypatch.setattr(build, "LAUNCHES", dict.fromkeys(build.LAUNCHES, 0))
    monkeypatch.setattr(build, "SHAPE_LAUNCHES", {k: {} for k in build.SHAPE_LAUNCHES})
    for kv in (7200, 512, 257):
        build.check(0, "flash_bwd_dq", kv)
    build.check(0, "flash_bwd_dkv", 512)
    assert build.LAUNCHES["flash_bwd_dq"] == 3 and build.LAUNCHES["flash_bwd_dkv"] == 1
    assert build.SHAPE_LAUNCHES["flash_bwd_dq"] == {7200: 1, 512: 1, 257: 1}
    assert build.SHAPE_LAUNCHES["flash_bwd_dkv"] == {512: 1}
    assert build.SHAPE_LAUNCHES["flash_fwd"] == {}
    build.reset_launches()
    assert not any(build.SHAPE_LAUNCHES.values())


# ----------------------------------------------------------- K2-K4 gradients

B, T, HW, D = 2, 2, 12, 256


def _stream(rng):
    return (rng.standard_normal((B, T * HW, D)) * 2.0 + 0.5).astype(np.float32)


def _norm_case(name, rng):
    """(JAX fn, port fn, numpy inputs) of one fused norm, all inputs
    differentiable."""
    x = _stream(rng)
    if name == "ln_modulate":
        scale, shift = (0.1 * rng.standard_normal((B, T, D)).astype(np.float32)
                        for _ in range(2))
        return (lambda x_, s_, b_: fn_j.layer_norm_modulate(x_, s_, b_, HW, 1e-6),
                lambda x_, s_, b_: fn_t.layer_norm_modulate(x_, s_, b_, HW, 1e-6),
                (x, scale, shift))
    if name == "gated_residual":
        gate = rng.standard_normal((B, T, D)).astype(np.float32)
        return (lambda x_, d_, g_: fn_j.gated_residual(x_, d_, g_, HW),
                lambda x_, d_, g_: fn_t.gated_residual(x_, d_, g_, HW),
                (x, _stream(rng), gate))
    w = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)

    return (lambda x_, w_: fn_j.rms_norm_fused({"scale": w_}, x_, 1e-6),
            lambda x_, w_: fn_t.rms_norm_fused(SimpleNamespace(scale=w_), x_, 1e-6), (x, w))


@pytest.mark.parametrize("name", ["ln_modulate", "gated_residual", "rms_norm"])
def test_fused_norm_grads_match_jax_grad(name):
    """K2-K4's Functions (backward: the twin's VJP from the saved inputs)
    against ``jax.grad`` of the JAX wrappers, every input, for a loss
    <out, cotangent>: the same fp32 math, 1e-4 on gradients that sum up to
    3,600 terms (LayerNorm's and RMSNorm's row reductions, the per-frame
    scale/shift/gate sums over 12 tokens x 2 batch rows)."""
    rng = np.random.default_rng(7)
    fj, ft, inputs = _norm_case(name, rng)
    cot = rng.standard_normal((B, T * HW, D)).astype(np.float32)
    argnums = tuple(range(len(inputs)))
    want = jax.grad(lambda *a: jnp.sum(fj(*a) * jnp.asarray(cot)), argnums=argnums)(
        *(jnp.asarray(a) for a in inputs))
    ts = _t(*inputs, grad=True)
    (ft(*ts) * torch.from_numpy(cot)).sum().backward()
    for t, w in zip(ts, want):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4 * scale)
