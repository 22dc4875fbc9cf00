"""QLoRA against the JAX package: LoRA adapters trained over a frozen
quantized base (``ops/quant.py``, ``models/lora.py``), on CPU, fp32.

- the straight-through int8 product (``_Int8DotSTE``) alone against JAX's
  ``_int8_dot_ste``: forward bitwise, backward within 1e-6 of scale;
- K8's autograd Function (the twin forward on the CPU) against
  ``jax.grad`` of JAX's int4 apply: 1e-6 of scale;
- side branches on a float base compute what the merge computes
  (``attach_lora`` against ``merge_lora``, JAX's gate);
- the adapters' gradients over int8, int4 (uniform and Lloyd) and int4_a8
  bases against ``jax.grad`` through ``attach_lora``, each bar set between
  two readings (the port in the same mode against JAX, and the float-base
  port against the same JAX gradient, which must fail it);
- the QLoRA step trains and leaves the base's bits alone, and its
  gradient stays aligned with the float-base step's (JAX's gate, cosine >
  0.9).

The kernel-shaped 2-block DiT (2 heads x 128, ffn 512): every projection's
in-dim is at least 128, so the Lloyd codebook is one computation per
process on each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.core import rectified_flow as rf_j
from chronoedit_tpu.models import dit as dit_j
from chronoedit_tpu.models import lora as lora_j
from chronoedit_tpu.ops import layers as layers_j
from chronoedit_tpu.ops import quant as quant_j
from chronoedit_tpu.train import train_step as ts_j
from chronoedit_tpu_torch.core import rectified_flow as rf_t
from chronoedit_tpu_torch.models import dit as dit_t
from chronoedit_tpu_torch.models import lora as lora_t
from chronoedit_tpu_torch.models.from_jax import load_dit, load_lora
from chronoedit_tpu_torch.ops import int4_matmul as i4_t
from chronoedit_tpu_torch.ops import layers as L
from chronoedit_tpu_torch.ops import quant as quant_t
from chronoedit_tpu_torch.train import lora_train as lt_t
from chronoedit_tpu_torch.train import train_step as ts_t
from test_torch_dit import _kernel_shaped, randomize
from test_torch_quant import _pair, _quantize_pair

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


# ----------------------------------------------------------- the products

def test_int8_ste_forward_and_backward_match_jax():
    """Forward: JAX's exact int32 product as fp32, bitwise (the rounding is
    half to even on both sides). Backward: ``g @ w8`` (the rounding taken as
    the identity) against ``jax.vjp``, 1e-6 of the gradient's scale; the
    int8 weight gets no gradient."""
    rng = np.random.default_rng(0)
    xq_f = (rng.standard_normal((3, 7, 96)) * 60).astype(np.float32)
    xq_f[0, 0, :4] = [0.5, 1.5, -2.5, 200.0]  # ties to even, and the clip
    w8 = rng.integers(-127, 128, (96, 40), dtype=np.int8)  # JAX's (in, out)
    g = rng.standard_normal((3, 7, 40)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: quant_j._int8_dot_ste(x, jnp.asarray(w8)), jnp.asarray(xq_f))
    (want_dx,) = vjp(jnp.asarray(g))
    x_t = torch.from_numpy(xq_f).requires_grad_(True)
    w_t = torch.from_numpy(np.ascontiguousarray(w8.T))  # the port's (out, in)
    got = quant_t._Int8DotSTE.apply(x_t, w_t)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (dx,) = torch.autograd.grad(got, [x_t], torch.from_numpy(g))
    scale = float(np.abs(want_dx).max())
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=1e-6 * scale, rtol=0)


@pytest.mark.parametrize("kind", ["int8", "uniform", "lloyd", "lloyd_a8"])
def test_quantized_linear_grad_matches_jax(kind):
    """d(sum(y * g))/dx through each quantized apply (w8a8 and w4a8: the
    straight-through product plus the per-token scale's own path through
    ``amax``; w4a16: K8's Function, ``dy @ dequant(W)``) against
    ``jax.grad`` of JAX's apply: 1e-5 of the gradient's scale (fp32, other
    summation orders; the int8 modes' forward roundings agree here)."""
    rng = np.random.default_rng(3)
    pj, lt = _pair(rng, 200, 48)  # 200 pads to 256 rows in int4
    a, b = _quantize_pair(kind, pj, lt)
    x = rng.standard_normal((2, 5, 200)).astype(np.float32)
    g = rng.standard_normal((2, 5, 48)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(layers_j.linear(a, v) * g))(jnp.asarray(x))
    x_t = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad((L.linear(b, x_t) * torch.from_numpy(g)).sum(), [x_t])
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5 * scale, rtol=0)
    assert all(not t.requires_grad for t in b.buffers() if t is not None)


def test_int4_matmul_function_backward_is_dy_dequant():
    """K8's Function on the CPU: the forward is the twin's bits, the
    backward ``dy @ dequant(W)`` in x's dtype, exactly the twin's own
    autograd gradient; the packed weight, scales and table get none."""
    rng = np.random.default_rng(4)
    _, lt = _pair(rng, 256, 24)
    leaf = quant_t.quantize_linear_params_int4(lt, grid="uniform")
    x = torch.from_numpy(rng.standard_normal((3, 256)).astype(np.float32)).requires_grad_(True)
    y = i4_t.int4_matmul(x, leaf.packed, leaf.scales, leaf.table)
    twin = i4_t.int4_matmul_plain(x, leaf.packed, leaf.scales, leaf.table)
    torch.testing.assert_close(y, twin, rtol=0, atol=0)
    dy = torch.from_numpy(rng.standard_normal((3, 24)).astype(np.float32))
    (dx,) = torch.autograd.grad(y, [x], dy)
    (want,) = torch.autograd.grad(twin, [x], dy)
    torch.testing.assert_close(dx, want, rtol=1e-6, atol=1e-6)
    w = i4_t.dequantize(leaf.packed, leaf.scales, leaf.table)
    torch.testing.assert_close(dx, dy @ w, rtol=0, atol=0)


# ----------------------------------------------------------- the model

@pytest.fixture(scope="module")
def qlora_setup():
    """The kernel-shaped DiT's weights, rank-4 adapters with b drawn non-zero
    (b = 0 would zero every a's gradient), one batch, one JAX key and its
    draws."""
    cfg_j = _kernel_shaped(dit_j)
    params = randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg_j), 31)
    lcfg = lora_j.LoRAConfig(rank=4)
    lora_np = randomize(lambda: lora_j.init_lora_params(
        jax.random.PRNGKey(3), jax.eval_shape(lambda: jax.tree.map(jnp.asarray, params)),
        lcfg), 32, fan_in=lambda s: 4.0 * s[-2])
    rng = np.random.default_rng(33)
    batch = {"latents": rng.standard_normal((1, 16, 2, 4, 4)).astype(np.float32),
             "condition": rng.standard_normal((1, 20, 2, 4, 4)).astype(np.float32),
             "text_emb": rng.standard_normal((1, 6, cfg_j.text_dim)).astype(np.float32),
             "image_emb": rng.standard_normal((1, cfg_j.image_tokens, cfg_j.image_dim)
                                              ).astype(np.float32)}
    key = jax.random.PRNGKey(42)
    k_t, k_eps = jax.random.split(key)
    rf = rf_j.RectifiedFlowConfig()
    u = np.array(rf_j.sample_train_time(k_t, 1, rf))
    noise = np.array(jax.random.normal(k_eps, batch["latents"].shape, jnp.float32))
    return cfg_j, params, lcfg, lora_np, batch, key, u, noise


# mode -> (JAX mode, grid)
QMODES = {"int8": ("int8", "lloyd"), "int4_uniform": ("int4", "uniform"),
          "int4_lloyd": ("int4", "lloyd"), "int4_a8": ("int4_a8", "lloyd")}


def _jax_grads(setup, mode=None):
    """JAX's adapter gradient (flat fp64) over the float base (``mode``
    None: merge) or the base quantized in ``mode`` (attach)."""
    cfg_j, params, lcfg, lora_np, batch, key, _, _ = setup
    tree = jax.tree.map(jnp.asarray, params)
    if mode is not None:
        tree = quant_j.quantize_dit_params(tree, mode=mode)
    attach = lora_j.base_is_quantized(tree, lcfg)
    assert attach == (mode is not None)

    def loss(lp):
        m = (lora_j.attach_lora if attach else lora_j.merge_lora)(tree, lp, 1.0, lcfg)
        return ts_j.velocity_loss(m, cfg_j, rf_j.RectifiedFlowConfig(),
                                  *(jnp.asarray(batch[k]) for k in (
                                      "latents", "condition", "text_emb", "image_emb")),
                                  key)[0]

    return jax.grad(loss)(jax.tree.map(jnp.asarray, lora_np))


def _port(setup, mode=None):
    """(base, adapters) of the port: the float base, or quantized in
    ``mode``."""
    cfg_j, params, lcfg, lora_np, *_ = setup
    base = load_dit(dit_t.DiT(_kernel_shaped(dit_t)), params)
    if mode is not None:
        quant_t.quantize_dit(base, mode=mode)
    lora = load_lora(lora_t.LoRA(base, lora_t.LoRAConfig(rank=lcfg.rank)), lora_np)
    return base, lora


def _port_grads(setup, base, lora):
    *_, batch, _, u, noise = setup
    loss = ts_t.velocity_loss(base, base.cfg, rf_t.RectifiedFlowConfig(),
                              *(torch.from_numpy(batch[k]) for k in (
                                  "latents", "condition", "text_emb", "image_emb")),
                              torch.from_numpy(u), torch.from_numpy(noise), lora=lora,
                              lora_attach=lora_t.base_is_quantized(base, lora.cfg))
    return torch.cat([g.flatten().double()
                      for g in torch.autograd.grad(loss, list(lora.parameters()))])


def _flat(base, grads_j, rank: int):
    """JAX's gradient tree flattened in the port's adapter order."""
    ref = load_lora(lora_t.LoRA(base, lora_t.LoRAConfig(rank=rank)),
                    jax.tree.map(np.asarray, grads_j))
    return torch.cat([p.detach().flatten().double() for p in ref.parameters()])


def test_attach_equals_merge_on_a_float_base(qlora_setup):
    """Side branches on a float base compute the merged model's function
    (JAX's gate: 2e-4; here 1e-5 of the output's scale, fp32 association
    only), and match JAX's ``attach_lora`` forward within the DiT's 1e-4
    bound; ``base_is_quantized`` is False for it."""
    cfg_j, params, lcfg, lora_np, batch, *_ = qlora_setup
    base, lora = _port(qlora_setup)
    assert not lora_t.base_is_quantized(base, lora.cfg)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, cfg_j.in_channels, 2, 4, 4)).astype(np.float32)
    ts = np.array([500.0], np.float32)
    args = (x, ts, batch["text_emb"], batch["image_emb"])
    want = np.asarray(dit_j.dit_forward(
        lora_j.attach_lora(jax.tree.map(jnp.asarray, params),
                           jax.tree.map(jnp.asarray, lora_np), 1.0, lcfg),
        cfg_j, *map(jnp.asarray, args)))
    with torch.no_grad():
        merged = dit_t.dit_forward(base, *map(torch.from_numpy, args), lora=lora)
        attached = dit_t.dit_forward(base, *map(torch.from_numpy, args), lora=lora,
                                     lora_attach=True)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(attached.numpy(), merged.numpy(), atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(attached.numpy(), want, atol=1e-4 * scale, rtol=0)


# The adapters' gradient, relative error |g_port - g_jax| / |g_jax| over
# every adapter entry, read on this file's inputs (one CPU, deterministic):
# the port in the same mode against JAX, and the port's float base (merge)
# against the same JAX gradient:
#   int8          1.24e-3 against 1.38e-2
#   int4 uniform  4.71e-6 against 0.210
#   int4 Lloyd    4.33e-6 against 0.139
#   int4_a8       7.39e-4 against 0.135
# w4a16 runs no activation rounding: fp32 summation order only. The int8
# modes round activations, and an x / xs within fp32 rounding of a .5 goes
# the other way in one framework (see ``tests/test_torch_quant.py``); w8a8
# is so faithful that its float base lies only 11x further. Each bar sits
# between its two readings, near their geometric mean.
QLORA_GRAD_REL = {"int8": 4e-3, "int4_uniform": 1e-4, "int4_lloyd": 1e-4, "int4_a8": 1e-2}


@pytest.mark.parametrize("name", list(QMODES))
def test_qlora_adapter_grads_match_jax(qlora_setup, name, monkeypatch):
    """The adapters' gradient over a base quantized in each mode (side
    branches, the straight-through int8 product, K8's Function) against
    ``jax.grad`` through JAX's ``attach_lora``, same weights and draws: the
    relative error under the mode's bar, which the float-base port fails."""
    mode, grid = QMODES[name]
    monkeypatch.setattr(quant_j, "INT4_GRID", grid)
    monkeypatch.setattr(quant_t, "INT4_GRID", grid)
    base, lora = _port(qlora_setup, mode)
    assert lora_t.base_is_quantized(base, lora.cfg)
    want = _flat(base, _jax_grads(qlora_setup, mode), lora.cfg.rank)
    got = _port_grads(qlora_setup, base, lora)
    fbase, flora = _port(qlora_setup)
    float_rel = float((_port_grads(qlora_setup, fbase, flora) - want).norm() / want.norm())
    rel = float((got - want).norm() / want.norm())
    print(f"{name}: relative error {rel:.2e}, float base {float_rel:.2e}")
    assert rel < QLORA_GRAD_REL[name] < float_rel
    assert all(p.grad is None for p in base.parameters())


def test_qlora_step_trains_and_tracks_the_float_step(qlora_setup):
    """JAX's QLoRA gate on the port: over a w4a8 base, the adapters'
    gradient has cosine > 0.9 with the float-base step's, six steps lower
    the loss, and the base's buffers and parameters keep their bits."""
    base, lora = _port(qlora_setup, "int4_a8")
    fbase, flora = _port(qlora_setup)
    g_q, g_f = _port_grads(qlora_setup, base, lora), _port_grads(qlora_setup, fbase, flora)
    cos = float(g_q @ g_f / (g_q.norm() * g_f.norm()))
    assert cos > 0.9, cos
    before = {k: v.clone() for k, v in base.state_dict().items()}
    *_, batch, _, u, noise = qlora_setup
    tcfg = ts_t.TrainConfig(lr=5e-3, warmup_steps=1)
    state = lt_t.make_lora_train_state(lora, tcfg)
    step = lt_t.make_lora_train_step(base.cfg, tcfg)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = [float(step(state, base, b, u=torch.from_numpy(u),
                         noise=torch.from_numpy(noise))["loss"]) for _ in range(6)]
    assert losses[-1] < losses[0], losses
    for k, v in base.state_dict().items():
        assert torch.equal(v, before[k]), k
