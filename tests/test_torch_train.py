"""The port's training path against the JAX package, on CPU, fp32: the
rectified-flow math, the velocity loss and its gradient through the whole
DiT (both remat modes), the optimizer chain against optax, whole train
steps (full-parameter and LoRA) over 3 steps with JAX's random draws, EMA,
the LoRA adapters and the edit training batch.

Weights are drawn by numpy (``randomize``) and loaded on both sides;
JAX's random draws (train time u and noise) are replayed into the port,
whose ``torch.Generator`` would draw other numbers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chronoedit_tpu.configs import chronoedit_tiny as tiny_j
from chronoedit_tpu.core import rectified_flow as rf_j
from chronoedit_tpu.models import dit as dit_j
from chronoedit_tpu.models import lora as lora_j
from chronoedit_tpu.models import vae as vae_j
from chronoedit_tpu.train import ema as ema_j
from chronoedit_tpu.train import lora_train as lt_j
from chronoedit_tpu.train import train_step as ts_j
from chronoedit_tpu_torch.configs import chronoedit_tiny as tiny_t
from chronoedit_tpu_torch.core import rectified_flow as rf_t
from chronoedit_tpu_torch.data import mock as mock_t
from chronoedit_tpu_torch.models import dit as dit_t
from chronoedit_tpu_torch.models import lora as lora_t
from chronoedit_tpu_torch.models import vae as vae_t
from chronoedit_tpu_torch.models.from_jax import load_dit, load_lora, load_vae
from chronoedit_tpu_torch.train import ema as ema_t
from chronoedit_tpu_torch.train import lora_train as lt_t
from chronoedit_tpu_torch.train import train_step as ts_t
from test_torch_dit import randomize, warm_cpu_math

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RF_CASES = [rf_j.RectifiedFlowConfig(),
            rf_j.RectifiedFlowConfig(shift=3.0, train_time_distribution="uniform",
                                     min_timestep_boundary=0.2, train_time_weight="reweighting")]


def _rf_t(cfg_j):
    return rf_t.RectifiedFlowConfig(**dataclasses.asdict(cfg_j))


@pytest.fixture(scope="module", autouse=True)
def _warm():
    warm_cpu_math()


# ----------------------------------------------------------- rectified flow

@pytest.mark.parametrize("case", range(len(RF_CASES)))
def test_rectified_flow_tables_and_lookups_match_jax(case):
    """The host tables are the same float64 numpy code: bitwise. The
    lookups (floor(u*N), fp32 gathers) are bitwise too; interpolation,
    weights and x0 are fp32 elementwise: 1e-6."""
    cfg_j = RF_CASES[case]
    cfg_t = _rf_t(cfg_j)
    for a, b in zip(cfg_t.train_grid(), cfg_j.train_grid()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(cfg_t.reweighting_table(), cfg_j.reweighting_table())

    rng = np.random.default_rng(case)
    u = np.concatenate([rng.uniform(0, 1, 6), [0.0, 0.9999999, 1.0]]).astype(np.float32)
    t_j, s_j = rf_j.discretize_time(jnp.asarray(u), cfg_j)
    t_t, s_t = rf_t.discretize_time(torch.from_numpy(u), cfg_t)
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_allclose(rf_t.train_time_weight(t_t, cfg_t).numpy(),
                               np.asarray(rf_j.train_time_weight(t_j, cfg_j)), atol=1e-6)

    noise, data = (rng.standard_normal((9, 4, 3, 2, 2)).astype(np.float32) for _ in range(2))
    per_frame = rng.uniform(0, 1, (9, 3)).astype(np.float32)
    for sig in (np.array(s_j), per_frame):
        want = rf_j.get_interpolation(jnp.asarray(noise), jnp.asarray(data), jnp.asarray(sig))
        got = rf_t.get_interpolation(torch.from_numpy(noise), torch.from_numpy(data),
                                     torch.from_numpy(sig))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    x0_j = rf_j.x0_from_velocity(jnp.asarray(noise), jnp.asarray(data), s_j)
    x0_t = rf_t.x0_from_velocity(torch.from_numpy(noise), torch.from_numpy(data), s_t)
    np.testing.assert_allclose(x0_t.numpy(), np.asarray(x0_j), atol=1e-6)


@pytest.mark.parametrize("case", range(len(RF_CASES)))
def test_train_time_draws_are_seeded_and_in_range(case):
    """``sample_train_time`` draws from the generator it is given (same
    seed, same u) within the configured support."""
    cfg = _rf_t(RF_CASES[case])
    a, b = (rf_t.sample_train_time(torch.Generator().manual_seed(3), 4096, cfg)
            for _ in range(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (4096,) and a.dtype == torch.float32
    assert float(a.min()) >= cfg.min_timestep_boundary
    assert float(a.max()) <= cfg.max_timestep_boundary


# ----------------------------------------------------------- shared set-up

def _batch(cfg_j, seed=5, b=1):
    rng = np.random.default_rng(seed)
    return {
        "latents": rng.standard_normal((b, cfg_j.out_channels, 2, 4, 4)).astype(np.float32),
        "condition": rng.standard_normal(
            (b, cfg_j.in_channels - cfg_j.out_channels, 2, 4, 4)).astype(np.float32),
        "text_emb": rng.standard_normal((b, 6, cfg_j.text_dim)).astype(np.float32),
        "image_emb": rng.standard_normal((b, cfg_j.image_tokens, cfg_j.image_dim)
                                         ).astype(np.float32),
    }


def _jax_draws(key, latents, rf_cfg):
    """The u and noise JAX's ``velocity_loss`` draws from ``key``."""
    k_t, k_eps = jax.random.split(key)
    u = rf_j.sample_train_time(k_t, latents.shape[0], rf_cfg)
    noise = jax.random.normal(k_eps, latents.shape, jnp.float32)
    return torch.from_numpy(np.array(u)), torch.from_numpy(np.array(noise))


def _tiny_pair(remat="none"):
    cfg_j, cfg_t = tiny_j().dit, dataclasses.replace(tiny_t().dit, remat=remat)
    params = randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg_j), 1)
    return cfg_j, cfg_t, params


def _tree_t(tree):
    return jax.tree.map(jnp.asarray, tree)


def _flat_by_name(model, grads_j):
    """JAX gradient leaves keyed like the port's named parameters (the
    port's weight is the transpose of JAX's kernel; blocks unstack)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
            return
        a = np.asarray(node)
        name = ".".join("weight" if p == "kernel" else p for p in path)
        if path[0] == "blocks":
            for i in range(a.shape[0]):
                leaf = a[i].T if path[-1] == "kernel" else a[i]
                out[name.replace("blocks.", f"blocks.{i}.", 1)] = leaf
        else:
            out[name] = a.T if path[-1] == "kernel" else a

    walk(grads_j, [])
    assert sorted(out) == sorted(n for n, _ in model.named_parameters())
    return out


# ----------------------------------------------------------- loss and gradient

@pytest.fixture(scope="module")
def loss_and_grads_j():
    cfg_j, _, params = _tiny_pair()
    batch = _batch(cfg_j)
    rf_cfg = rf_j.RectifiedFlowConfig()
    key = jax.random.PRNGKey(11)

    def loss_fn(p):
        return ts_j.velocity_loss(p, cfg_j, rf_cfg, *(jnp.asarray(batch[k]) for k in (
            "latents", "condition", "text_emb", "image_emb")), key)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(_tree_t(params))
    u, noise = _jax_draws(key, batch["latents"], rf_cfg)
    return float(loss), grads, batch, u, noise


@pytest.mark.parametrize("remat", ["none", "full"])
def test_velocity_loss_and_grads_match_jax(loss_and_grads_j, remat):
    """``velocity_loss`` and its gradient over every DiT parameter against
    ``jax.value_and_grad`` with JAX's draws, at the tiny preset: within
    1e-4 of each gradient's scale (fp32, per-op rounding only). Remat
    recomputes blocks and must not change a number: full equals none
    exactly."""
    loss_j, grads_j, batch, u, noise = loss_and_grads_j
    cfg_j, cfg_t, params = _tiny_pair(remat)
    model = load_dit(dit_t.DiT(cfg_t), params)
    for p in model.parameters():
        p.requires_grad_(True)
    loss = ts_t.velocity_loss(model, cfg_t, rf_t.RectifiedFlowConfig(),
                              *(torch.from_numpy(batch[k]) for k in (
                                  "latents", "condition", "text_emb", "image_emb")),
                              u, noise)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), loss_j, rtol=1e-5)
    want = _flat_by_name(model, grads_j)
    for name, p in model.named_parameters():
        w = want[name]
        scale = max(1e-3, float(np.abs(w).max()))
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-4 * scale, err_msg=name)
    if remat != "none":
        ref = load_dit(dit_t.DiT(_tiny_pair()[1]), params)
        for p in ref.parameters():
            p.requires_grad_(True)
        ts_t.velocity_loss(ref, ref.cfg, rf_t.RectifiedFlowConfig(),
                           *(torch.from_numpy(batch[k]) for k in (
                               "latents", "condition", "text_emb", "image_emb")),
                           u, noise).backward()
        for (name, p), q in zip(model.named_parameters(), ref.parameters()):
            torch.testing.assert_close(p.grad, q.grad, rtol=0, atol=0, msg=name)


def test_lora_grads_under_remat_full_equal_none():
    """With LoRA, each block merges its adapters inside its checkpoint, so
    remat "full" recomputes the merge in the backward: the adapters'
    gradients equal those without remat exactly, and the frozen base gets
    none."""
    cfg_j, cfg_t, params, lcfg_j, lora_np, base, lora = _lora_pair()
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg_j, seed=8).items()}
    u, noise = torch.tensor([0.4]), torch.from_numpy(
        np.random.default_rng(9).standard_normal(batch["latents"].shape).astype(np.float32))
    grads = []
    for cfg in (cfg_t, dataclasses.replace(cfg_t, remat="full")):
        loss = ts_t.velocity_loss(base, cfg, rf_t.RectifiedFlowConfig(),
                                  *(batch[k] for k in ("latents", "condition", "text_emb",
                                                       "image_emb")), u, noise, lora=lora)
        grads.append(torch.autograd.grad(loss, list(lora.parameters())))
    assert all(bool(a.any()) for a in grads[0])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert all(p.grad is None and not p.requires_grad for p in base.parameters())


def test_unknown_remat_mode_raises():
    """Only "none" and "full" are ported; any other mode (JAX's
    "matmul_only" among them) is refused, not silently run without remat."""
    _, cfg_t, params = _tiny_pair("matmul_only")
    model = load_dit(dit_t.DiT(cfg_t), params)
    for p in model.parameters():
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tiny_j().dit).items()}
    with pytest.raises(ValueError, match="unknown remat mode"):
        ts_t.velocity_loss(model, cfg_t, rf_t.RectifiedFlowConfig(),
                           *(batch[k] for k in ("latents", "condition", "text_emb",
                                                "image_emb")),
                           torch.tensor([0.5]), torch.zeros_like(batch["latents"]))


# ----------------------------------------------------------- optimizer

@pytest.mark.parametrize("warmup,clip", [(3, 1.0), (3, 100.0), (1, 0.3)])
def test_optimizer_matches_optax_on_identical_grads(warmup, clip):
    """Clip (active at 1.0 and 0.3, idle at 100), warm-up (lr 0 on the
    first update) and AdamW against the JAX package's
    ``make_optimizer`` fed the same gradients, 5 steps: parameters within
    1e-6 (fp32 rounding of the same formulas)."""
    cfg = dict(lr=1e-2, weight_decay=0.1, warmup_steps=warmup, grad_clip=clip)
    opt_j = ts_j.make_optimizer(ts_j.TrainConfig(**cfg))
    rng = np.random.default_rng(4)
    shapes = [(4, 3), (7,), (2, 2, 5)]
    params_np = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    params_j = [jnp.asarray(p) for p in params_np]
    state_j = opt_j.init(params_j)
    params_t = [torch.from_numpy(p.copy()) for p in params_np]
    opt_t = ts_t.Optimizer(params_t, ts_t.TrainConfig(**cfg))
    for step in range(5):
        grads = [rng.standard_normal(s).astype(np.float32) * 0.5 for s in shapes]
        upd, state_j = opt_j.update([jnp.asarray(g) for g in grads], state_j, params_j)
        params_j = optax.apply_updates(params_j, upd)
        before = [p.clone() for p in params_t]
        opt_t.update([torch.from_numpy(g) for g in grads])
        for a, b in zip(params_t, params_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
        moved = any(bool((a != b).any()) for a, b in zip(params_t, before))
        assert moved == (step > 0)
    assert opt_t.gradient_step == 5


def test_warmup_schedule_matches_optax():
    sched = optax.warmup_constant_schedule(0.0, 3e-4, 4)
    cfg = ts_t.TrainConfig(lr=3e-4, warmup_steps=4)
    for count in range(7):
        np.testing.assert_allclose(ts_t.warmup_lr(cfg, count), float(sched(count)),
                                   rtol=1e-6, atol=0)
    assert ts_t.warmup_lr(cfg, 0) == 0.0


# ----------------------------------------------------------- EMA

@pytest.mark.parametrize("mode,step", [("power", 0), ("power", 7), ("classic", 3)])
def test_ema_update_matches_jax(mode, step):
    """fp32 lerp with the same beta: 1e-7; the power EMA copies the params
    at step 0. The port updates in place."""
    cfg_j = ema_j.EMAConfig(mode=mode, decay=0.9)
    cfg_t = ema_t.EMAConfig(mode=mode, decay=0.9)
    rng = np.random.default_rng(step)
    ema, params = (rng.standard_normal((3, 5)).astype(np.float32) for _ in range(2))
    want = ema_j.ema_update({"w": jnp.asarray(ema)}, {"w": jnp.asarray(params)},
                            jnp.asarray(step), cfg_j)["w"]
    e = torch.from_numpy(ema.copy())
    ema_t.ema_update([e], [torch.from_numpy(params)], step, cfg_t)
    np.testing.assert_allclose(e.numpy(), np.asarray(want), atol=1e-7, rtol=0)
    np.testing.assert_allclose(float(ema_t.power_ema_beta(step, 6.94)),
                               float(ema_j.power_ema_beta(jnp.asarray(step), 6.94)), rtol=1e-6)


# ----------------------------------------------------------- whole steps

# Adam's first updates are about lr * sign(g): a parameter whose gradient
# is near 0 (|g| ~ eps) can take either sign on the two sides, so one entry
# may differ by up to 2 lr per applied update with a non-zero learning
# rate. Steps: lr 0 (warm-up), then lr, lr. Everything else agrees to
# fp32 rounding, which the second bound holds for all but a sliver.
LR = 1e-3
STEP_ATOL = 2 * LR * 2
CLOSE_ATOL = 1e-6


def _assert_params_close(got, want, what):
    diff = np.abs(got - want)
    assert diff.max() <= STEP_ATOL, (what, diff.max())
    assert np.mean(diff > CLOSE_ATOL) <= 1e-3, (what, np.mean(diff > CLOSE_ATOL))


def test_train_step_matches_jax_over_three_steps():
    """``make_train_step`` (full-parameter, EMA on) against JAX's jitted
    step, 3 steps with JAX's draws (keys 0, 1, 2): loss and grad_norm per
    step within 1e-4 relative, every parameter and its EMA within the
    bounds above."""
    cfg_j, cfg_t, params = _tiny_pair()
    batch = _batch(cfg_j, seed=6)
    tcfg = dict(lr=LR, warmup_steps=1, grad_clip=1.0)
    state_j = ts_j.make_train_state(_tree_t(params), ts_j.TrainConfig(**tcfg))
    step_j = ts_j.make_train_step(cfg_j, ts_j.TrainConfig(**tcfg), donate=False)
    model = load_dit(dit_t.DiT(cfg_t), params)
    state_t = ts_t.make_train_state(model, ts_t.TrainConfig(**tcfg))
    step_t = ts_t.make_train_step(cfg_t, ts_t.TrainConfig(**tcfg))
    batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(3):
        key = jax.random.PRNGKey(i)
        state_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        u, noise = _jax_draws(key, batch["latents"], rf_j.RectifiedFlowConfig())
        m_t = step_t(state_t, batch_t, u=u, noise=noise)
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m_t[name]), float(m_j[name]), rtol=1e-4)
    assert state_t.step == 3
    want = _flat_by_name(model, state_j.params)
    want_ema = _flat_by_name(model, state_j.ema_params)
    for (name, p), e in zip(model.named_parameters(), state_t.ema_params):
        _assert_params_close(p.detach().numpy(), want[name], name)
        _assert_params_close(e.numpy(), want_ema[name], "ema " + name)


def _lora_pair(rank=2):
    cfg_j, cfg_t, params = _tiny_pair()
    lcfg_j = lora_j.LoRAConfig(rank=rank)
    lora_np = randomize(lambda: lora_j.init_lora_params(
        jax.random.PRNGKey(3), jax.eval_shape(lambda: _tree_t(params)), lcfg_j), 8,
        fan_in=lambda s: 4.0 * s[-2])
    base = load_dit(dit_t.DiT(cfg_t), params)
    lora = load_lora(lora_t.LoRA(base, lora_t.LoRAConfig(rank=rank)), lora_np)
    return cfg_j, cfg_t, params, lcfg_j, lora_np, base, lora


def test_lora_train_step_matches_jax_over_three_steps():
    """``make_lora_train_step`` over a frozen base against JAX's, 3 steps
    with JAX's draws: losses, grad norms, adapters and their EMA within the
    bounds of the full step; the base is never written and keeps
    requires_grad False."""
    cfg_j, cfg_t, params, lcfg_j, lora_np, base, lora = _lora_pair()
    before = {n: p.detach().clone() for n, p in base.named_parameters()}
    batch = _batch(cfg_j, seed=7)
    tcfg = dict(lr=LR, warmup_steps=1, grad_clip=1.0)
    state_j = lt_j.make_lora_train_state(_tree_t(lora_np), ts_j.TrainConfig(**tcfg))
    step_j = lt_j.make_lora_train_step(cfg_j, ts_j.TrainConfig(**tcfg), lcfg_j, donate=False)
    state_t = lt_t.make_lora_train_state(lora, ts_t.TrainConfig(**tcfg))
    step_t = lt_t.make_lora_train_step(cfg_t, ts_t.TrainConfig(**tcfg))
    batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        state_j, m_j = step_j(state_j, _tree_t(params),
                              {k: jnp.asarray(v) for k, v in batch.items()}, key)
        u, noise = _jax_draws(key, batch["latents"], rf_j.RectifiedFlowConfig())
        m_t = step_t(state_t, base, batch_t, u=u, noise=noise)
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m_t[name]), float(m_j[name]), rtol=1e-4)
    want = load_lora(lora_t.LoRA(base, lora_t.LoRAConfig(rank=2)),
                     jax.tree.map(np.asarray, state_j.lora_params))
    want_ema = load_lora(lora_t.LoRA(base, lora_t.LoRAConfig(rank=2)),
                         jax.tree.map(np.asarray, state_j.ema_params))
    for (name, p), e, w, we in zip(lora.named_parameters(), state_t.ema_params,
                                   want.parameters(), want_ema.parameters()):
        _assert_params_close(p.detach().numpy(), w.detach().numpy(), name)
        _assert_params_close(e.numpy(), we.detach().numpy(), "ema " + name)
    for n, p in base.named_parameters():
        assert not p.requires_grad
        torch.testing.assert_close(p, before[n], rtol=0, atol=0)


# ----------------------------------------------------------- LoRA adapters

def test_lora_init_merge_and_load_match_jax():
    """``init_lora_params``: a ~ N(0, 0.02) in fp32, b = 0, every default
    target of every block. ``load_lora`` carries JAX's stacked adapters
    across; ``merge_lora`` then equals JAX's ``merge_lora`` weight for
    weight (1e-6: one fp32 product of rank 2), and a LoRA forward (merged
    block by block) equals the merged model's forward exactly."""
    cfg_j, cfg_t, params, lcfg_j, lora_np, base, lora = _lora_pair()
    fresh = lora_t.init_lora_params(torch.Generator().manual_seed(0), base,
                                    lora_t.LoRAConfig())
    targets = [t for blk in fresh.blocks for t, _ in lora_t.iter_adapters(blk)]
    assert len(targets) == cfg_t.num_layers * len(lora_t.DEFAULT_TARGETS)
    for _, ad in lora_t.iter_adapters(fresh.blocks[0]):
        assert ad.a.dtype == torch.float32 and ad.a.requires_grad
        assert not ad.b.detach().any() and ad.b.shape[0] == 32
    a_all = torch.cat([ad.a.flatten() for blk in fresh.blocks
                       for _, ad in lora_t.iter_adapters(blk)])
    assert abs(float(a_all.detach().std()) - 0.02) < 0.001

    want = _flat_by_name(base, jax.tree.map(np.asarray, lora_j.merge_lora(
        _tree_t(params), _tree_t(lora_np), 0.7, lcfg_j)))
    merged = lora_t.merge_lora(base, lora, 0.7)
    for name, p in merged.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-6, err_msg=name)

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, cfg_t.in_channels, 2, 4, 4)).astype(np.float32))
    text = torch.from_numpy(rng.standard_normal((1, 6, cfg_t.text_dim)).astype(np.float32))
    img = torch.from_numpy(rng.standard_normal((1, cfg_t.image_tokens, cfg_t.image_dim)
                                               ).astype(np.float32))
    ts = torch.tensor([700.0])
    with torch.no_grad():
        a = dit_t.dit_forward(base, x, ts, text, img, lora=lora)
        b = dit_t.dit_forward(lora_t.merge_lora(base, lora), x, ts, text, img)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_load_lora_raises_on_a_missing_leaf():
    cfg_j, cfg_t, params, lcfg_j, lora_np, base, lora = _lora_pair()
    del lora_np["blocks"]["ffn"]["fc2"]
    with pytest.raises(ValueError, match="not set"):
        load_lora(lora_t.LoRA(base, lora_t.LoRAConfig(rank=2)), lora_np)


# ----------------------------------------------------------- edit training batch

def test_edit_training_batch_and_mock_iterator_match_jax():
    """``edit_training_batch`` through the port's VAE against JAX's on the
    same weights and clip (tiny VAE, temporal factor 2: [f0, f4 x 2] -> 2
    latent frames): shapes equal, values within 1e-4 of scale (the VAE
    comparison's bound in ``test_torch_vae.py``). ``mock_batch_iterator``
    yields the same clips JAX's does, as ready batches."""
    pipe_j, pipe_t = tiny_j(), tiny_t()
    vparams = randomize(lambda: vae_j.init_vae_params(jax.random.PRNGKey(0), pipe_j.vae), 4,
                        fan_in=lambda s: int(np.prod(s[:-1])))
    vae = load_vae(vae_t.VAE(pipe_t.vae), vparams)
    video = np.random.default_rng(2).uniform(-1, 1, (1, 3, 5, 8, 8)).astype(np.float32)
    want = ts_j.edit_training_batch(_tree_t(vparams), pipe_j, jnp.asarray(video))
    with torch.no_grad():
        got = ts_t.edit_training_batch(vae, pipe_t, torch.from_numpy(video))
    assert tuple(got[0].shape) == (1, 4, 2, 4, 4) and tuple(got[1].shape) == (1, 6, 2, 4, 4)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 or g is got[1]
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4 * scale)

    it = mock_t.mock_batch_iterator(vae, pipe_t, height=8, width=8)
    batch = next(it)
    assert tuple(batch["latents"].shape) == (1, 4, 2, 4, 4)
    assert tuple(batch["condition"].shape) == (1, 6, 2, 4, 4)
    assert tuple(batch["text_emb"].shape) == (1, 8, pipe_t.dit.text_dim)
    assert tuple(batch["image_emb"].shape) == (1, pipe_t.dit.image_tokens, pipe_t.dit.image_dim)
    raw = next(iter(mock_t.MockEditDataset(height=8, width=8, text_tokens=8,
                                           text_dim=pipe_t.dit.text_dim,
                                           image_tokens=pipe_t.dit.image_tokens,
                                           image_dim=pipe_t.dit.image_dim)))
    with torch.no_grad():
        lat, _ = ts_t.edit_training_batch(vae, pipe_t, torch.from_numpy(raw["video"]))
    torch.testing.assert_close(batch["latents"], lat, rtol=0, atol=0)
