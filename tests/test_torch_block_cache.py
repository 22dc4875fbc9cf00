"""The Δ-DiT block cache (``dit_forward(cache_blocks=...)`` and the
pipeline's ``cache_period`` / ``cache_thresh``) against the JAX package,
mirroring ``tests/test_block_cache.py``.

The tiny preset at 4 blocks, fp32 on both sides, the same weights through
``models/from_jax.py``. Bounds, each with its reason:
- a forward that refreshes is the uncached forward: 1e-6 (the same blocks
  in the same order; only the delta's sum is extra);
- port against JAX, forwards: 1e-5 of the output's largest magnitude
  (``test_torch_dit.py``'s bound: fp32 op order);
- pipelines: the edit test's PSNR bar, 60 dB over the [-1, 1] range.

The adaptive refresh compares an fp32 accumulator with the threshold on
each side. The tests record each step's latents and refresh flag on both
sides (``jax.debug.callback`` inside JAX's scan), recompute each side's
accumulator from its own latents, and compare the schedules; a step whose
margin to the threshold is within fp32 rounding is named in the output
and ends the comparison there (the two may then rightly decide apart).
"""

import dataclasses

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
from chronoedit_tpu_torch.ops import quant as quant_t
from chronoedit_tpu_torch.pipeline.edit_pipeline import ChronoEditPipeline as PipeT
from test_torch_dit import randomize
from test_torch_pipeline import psnr

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EXACT_TOL = 1e-6
DIT_REL = 1e-5
MIN_PSNR_DB = 60.0
LAYERS = 4
BLOCKS = (1, 3)
STEPS = 8
# mixed between refresh and reuse on these inputs (the edit: T F F F T F T
# F; reasoning: T F F T F T F T; least margin 0.028); chosen from the grid
# 0.02 / 0.05 / 0.1 / 0.2 / 0.3 / 0.5 / 1.0 as the first value that mixes
THRESH = 0.3
# a margin to the threshold below this (relative) is within fp32 rounding
# of two differently ordered means over the latents
FP32_MARGIN = 1e-5
H = W = 16


def _cfg(mod):
    cfg = (tiny_j if mod == "j" else tiny_t)()
    return dataclasses.replace(cfg, num_steps=STEPS,
                               dit=dataclasses.replace(cfg.dit, num_layers=LAYERS))


@pytest.fixture(scope="module")
def weights():
    cfg = _cfg("j")
    dit_p = randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg.dit), 41)
    vae_p = randomize(lambda: vae_j.init_vae_params(jax.random.PRNGKey(1), cfg.vae), 42,
                      fan_in=lambda s: int(np.prod(s[:-1])))
    return dit_p, vae_p


def _pipes(weights, **kw):
    dit_p, vae_p = weights
    cfg_j, cfg_t = (dataclasses.replace(_cfg(m), **kw) for m in "jt")
    return (PipeJ(cfg_j, dit_p, vae_p),
            PipeT(cfg_t, load_dit(dit_t.DiT(cfg_t.dit), dit_p),
                  load_vae(vae_t.VAE(cfg_t.vae), vae_p)))


def _dit_inputs(cfg, seed=3, b=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cfg.in_channels, 2, 4, 6)).astype(np.float32)
    ts = np.array([[999.0, 937.0]] * b, np.float32)
    text = rng.standard_normal((b, 7, cfg.text_dim)).astype(np.float32)
    img = rng.standard_normal((b, cfg.image_tokens, cfg.image_dim)).astype(np.float32)
    return x, ts, text, img


def _edit_inputs(cfg, frames=None, neg=True):
    rng = np.random.default_rng(7)
    d, sf = cfg.dit, cfg.vae.spatial_factor
    tl = cfg.vae.latent_frames(frames or cfg.num_frames)
    inp = dict(image=rng.uniform(-1, 1, (1, 3, H, W)),
               prompt_emb=rng.standard_normal((1, 6, d.text_dim)),
               neg_prompt_emb=rng.standard_normal((1, 6, d.text_dim)),
               image_emb=rng.standard_normal((1, d.image_tokens, d.image_dim)),
               latents=rng.standard_normal((1, cfg.vae.z_dim, tl, H // sf, W // sf)))
    if not neg:
        del inp["neg_prompt_emb"]
    return {k: v.astype(np.float32) for k, v in inp.items()}


def _close(got, want, rel=DIT_REL):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


# ------------------------------------------------------------------ the DiT

def test_refresh_every_step_is_exact(weights):
    """A refresh runs every block: the uncached output; its cache is JAX's."""
    dit_p, _ = weights
    cfg_j, cfg_t = _cfg("j").dit, _cfg("t").dit
    args = _dit_inputs(cfg_t)
    model = load_dit(dit_t.DiT(cfg_t), dit_p)
    with torch.inference_mode():
        targs = [torch.from_numpy(a) for a in args]
        ref = dit_t.dit_forward(model, *targs)
        out, cache = dit_t.dit_forward(model, *targs, cache_blocks=BLOCKS, cache_refresh=True)
    torch.testing.assert_close(out, ref, rtol=EXACT_TOL, atol=EXACT_TOL)
    out_j, cache_j = dit_j.dit_forward(dit_p, cfg_j, *map(jnp.asarray, args),
                                       cache_blocks=BLOCKS, cache_refresh=True)
    assert cache.shape == cache_j.shape and cache.shape[-1] == cfg_t.dim
    _close(out.numpy(), np.asarray(out_j))
    _close(cache.numpy(), np.asarray(cache_j))


def test_reuse_step_matches_jax_and_composition(weights):
    """Given JAX's cache from a refresh on other inputs, a reuse step is
    JAX's reuse step, returns the cache unchanged, and equals the front
    block, the delta, then the back block (a 2-block model of blocks 0 and
    3 with the delta added before its block 1, JAX's manual composition)."""
    dit_p, _ = weights
    cfg_j, cfg_t = _cfg("j").dit, _cfg("t").dit
    xa, ts, text, img = _dit_inputs(cfg_t)
    xb = xa + 0.05 * np.random.default_rng(7).standard_normal(xa.shape).astype(np.float32)
    rest_j = tuple(map(jnp.asarray, (ts, text, img)))
    _, cache_j = dit_j.dit_forward(dit_p, cfg_j, jnp.asarray(xa), *rest_j,
                                   cache_blocks=BLOCKS, cache_refresh=True)
    want, _ = dit_j.dit_forward(dit_p, cfg_j, jnp.asarray(xb), *rest_j, cache_blocks=BLOCKS,
                                cache=cache_j, cache_refresh=False)

    model = load_dit(dit_t.DiT(cfg_t), dit_p)
    sliced = jax.tree_util.tree_map(lambda p: np.concatenate([p[0:1], p[3:4]]),
                                    dit_p["blocks"])
    cfg2 = dataclasses.replace(cfg_t, num_layers=2)
    model2 = load_dit(dit_t.DiT(cfg2), dict(dit_p, blocks=sliced))
    cache = torch.from_numpy(np.array(cache_j))
    rest = [torch.from_numpy(a) for a in (ts, text, img)]
    with torch.inference_mode():
        got, cache2 = dit_t.dit_forward(model, torch.from_numpy(xb), *rest,
                                        cache_blocks=BLOCKS, cache=cache, cache_refresh=False)
        manual, _ = dit_t.dit_forward(model2, torch.from_numpy(xb), *rest,
                                      cache_blocks=(1, 1), cache=cache, cache_refresh=False)
    assert cache2 is cache
    _close(got.numpy(), np.asarray(want))
    torch.testing.assert_close(got, manual, rtol=EXACT_TOL, atol=EXACT_TOL)


def test_cache_accumulates_in_the_stream_dtype(weights):
    """In bf16 the cache is the block-by-block sum of the deltas in bf16, not
    the difference of the stream across the range (other bits)."""
    dit_p, _ = weights
    cfg = dataclasses.replace(_cfg("t").dit, dtype=torch.bfloat16)
    model = load_dit(dit_t.DiT(cfg), dit_p)
    args = [torch.from_numpy(a) for a in _dit_inputs(cfg)]
    seen = []
    blocks = dit_t._run_block

    def recording(*a):
        out = blocks(*a)
        seen.append((a[4], out))  # the block's input tokens and its output
        return out

    dit_t._run_block = recording
    try:
        with torch.inference_mode():
            _, cache = dit_t.dit_forward(model, *args, cache_blocks=BLOCKS, cache_refresh=True)
    finally:
        dit_t._run_block = blocks
    deltas = [out - x for x, out in seen[BLOCKS[0]:BLOCKS[1]]]
    assert cache.dtype == torch.bfloat16
    torch.testing.assert_close(cache, deltas[0] + deltas[1], rtol=0, atol=0)
    across = seen[BLOCKS[1] - 1][1] - seen[BLOCKS[0]][0]
    assert not torch.equal(cache, across)


def test_value_errors(weights):
    dit_p, vae_p = weights
    cfg = _cfg("t").dit
    model = load_dit(dit_t.DiT(cfg), dit_p)
    args = [torch.from_numpy(a) for a in _dit_inputs(cfg)]
    with torch.inference_mode():
        with pytest.raises(ValueError, match="incompatible"):
            dit_t.dit_forward(model, *args, layer_mask=[1.0] * LAYERS, cache_blocks=BLOCKS)
        for bad in ((2, 1), (-1, 2), (0, LAYERS + 1)):
            with pytest.raises(ValueError, match="out of range"):
                dit_t.dit_forward(model, *args, cache_blocks=bad)
    inp = {k: torch.from_numpy(v) for k, v in _edit_inputs(_cfg("t")).items()}
    for kw, call in ((dict(cfg_batched=False), {}), ({}, dict(slg_layers=(1,)))):
        _, pipe_t = _pipes(weights, cache_blocks=BLOCKS, cache_period=2, **kw)
        with pytest.raises(ValueError, match="cfg_batched"):
            pipe_t(**inp, guidance_scale=2.0, **call)


# ------------------------------------------------------------------ pipelines

def _record_port(monkeypatch, log):
    forward = dit_t.dit_forward

    def recording(model, x, *a, cache_refresh=True, **kw):
        log.append((x.detach().float().numpy().copy(), bool(cache_refresh)))
        return forward(model, x, *a, cache_refresh=cache_refresh, **kw)

    monkeypatch.setattr(dit_t, "dit_forward", recording)


def _record_jax(monkeypatch, log):
    forward = dit_j.dit_forward

    def recording(params, cfg, x, *a, cache_refresh=True, **kw):
        jax.debug.callback(lambda xx, r: log.append((np.asarray(xx), bool(r))), x,
                           jnp.asarray(cache_refresh), ordered=True)
        return forward(params, cfg, x, *a, cache_refresh=cache_refresh, **kw)

    monkeypatch.setattr(dit_j, "dit_forward", recording)


def _accumulators(log, b, channels, step0s):
    """Each step's fp32 accumulator before its decision (JAX's formula),
    recomputed from the recorded DiT inputs: the latents are the first
    ``channels`` channels of the first ``b`` rows."""
    accs, acc, prev = [], 0.0, None
    for i, (xin, refresh) in enumerate(log):
        x = xin[:b, :channels].astype(np.float32)
        if i in step0s:
            acc, prev = np.float32(0.0), x
        rel = np.float32(np.mean(np.abs(x - prev)) / (np.mean(np.abs(prev)) + 1e-6))
        acc = np.float32(acc + rel)
        accs.append(float(acc))
        if refresh:
            acc, prev = np.float32(0.0), x
    return accs


def _compare_schedules(log_t, log_j, accs_t, accs_j, thresh):
    """The port's refresh schedule is JAX's up to the first step whose margin
    to ``thresh`` is within fp32 rounding on either side (named if any)."""
    sched_t = [r for _, r in log_t]
    sched_j = [r for _, r in log_j]
    near = [i for i, (a, b) in enumerate(zip(accs_t, accs_j))
            if min(abs(a - thresh), abs(b - thresh)) < FP32_MARGIN * max(thresh, 1e-30)]
    upto = near[0] + 1 if near else len(sched_j)
    if near:
        print(f"steps {near}: accumulator within fp32 rounding of {thresh}; schedules "
              f"compared through step {near[0]} only")
    margins = [abs(a - thresh) for a in accs_j]
    print(f"schedule {sched_j}; accumulators port {accs_t}, JAX {accs_j}; "
          f"least margin {min(margins):.3e}")
    assert sched_t[:upto] == sched_j[:upto]
    return not near


@pytest.mark.parametrize("mode", ["period2", "adaptive"])
def test_cached_pipeline_matches_jax(weights, monkeypatch, mode):
    """The cached edit (batched CFG, guidance 2) against JAX, with the refresh
    schedules compared: period 2 refreshes on even steps; the adaptive
    threshold refreshes on some steps and not on others."""
    kw = (dict(cache_period=2) if mode == "period2" else dict(cache_thresh=THRESH))
    pipe_j, pipe_t = _pipes(weights, cache_blocks=BLOCKS, **kw)
    inp = _edit_inputs(pipe_t.config)
    log_t, log_j = [], []
    _record_port(monkeypatch, log_t)
    _record_jax(monkeypatch, log_j)
    want = np.asarray(pipe_j(**{k: jnp.asarray(v) for k, v in inp.items()}, guidance_scale=2.0))
    jax.effects_barrier()
    got = pipe_t(**{k: torch.from_numpy(v) for k, v in inp.items()}, guidance_scale=2.0).numpy()
    assert len(log_t) == len(log_j) == STEPS
    sched = [r for _, r in log_j]
    if mode == "period2":
        assert [r for _, r in log_t] == sched == [i % 2 == 0 for i in range(STEPS)]
        same = True
    else:
        c = pipe_t.config.latent_channels
        same = _compare_schedules(log_t, log_j, _accumulators(log_t, 1, c, {0}),
                                  _accumulators(log_j, 1, c, {0}), THRESH)
        assert sched[0] and any(sched) and not all(sched)
    if same:
        assert psnr(got, want) >= MIN_PSNR_DB


def test_adaptive_extremes_and_period_one(weights):
    """Threshold 0 refreshes every step (the uncached edit, within fp32
    rounding of the delta's sum); a huge one refreshes only on the first
    step (period >= steps); period 1 runs the uncached path bitwise."""
    inp = {k: torch.from_numpy(v) for k, v in _edit_inputs(_cfg("t")).items()}

    def run(**kw):
        return _pipes(weights, **kw)[1](**inp, guidance_scale=2.0).numpy()

    ref = run()
    np.testing.assert_allclose(run(cache_blocks=BLOCKS, cache_thresh=0.0), ref, atol=EXACT_TOL)
    np.testing.assert_allclose(run(cache_blocks=BLOCKS, cache_thresh=1e9),
                               run(cache_blocks=BLOCKS, cache_period=STEPS), atol=EXACT_TOL)
    np.testing.assert_array_equal(run(cache_blocks=BLOCKS, cache_period=1), ref)


def test_reasoning_cache_restarts_per_phase(weights, monkeypatch):
    """Reasoning with the drop after 3 of 8 steps and period 2: each phase
    refreshes on its first step (0 and 3), so steps 0, 2, 3, 5, 7 refresh;
    the tokens shrink at the drop; against JAX's reasoning pipeline."""
    frames = 9
    pipe_j, pipe_t = _pipes(weights, cache_blocks=BLOCKS, cache_period=2)
    inp = _edit_inputs(pipe_t.config, frames)
    kw = dict(enable_temporal_reasoning=True, num_temporal_reasoning_steps=3,
              num_frames=frames, guidance_scale=2.0)
    log_t, log_j = [], []
    _record_port(monkeypatch, log_t)
    _record_jax(monkeypatch, log_j)
    want = np.asarray(pipe_j(**{k: jnp.asarray(v) for k, v in inp.items()}, **kw))
    jax.effects_barrier()
    got = pipe_t(**{k: torch.from_numpy(v) for k, v in inp.items()}, **kw).numpy()
    expect = [True, False, True, True, False, True, False, True]
    assert [r for _, r in log_t] == [r for _, r in log_j] == expect
    assert [x.shape[2] for x, _ in log_t] == [5] * 3 + [2] * 5
    assert got.shape == want.shape == (1, 3, 3, H, W)
    assert psnr(got, want) >= MIN_PSNR_DB

    # the adaptive form restarts too: its accumulator is reset at the drop
    log_t.clear()
    log_j.clear()
    pipe_j, pipe_t = _pipes(weights, cache_blocks=BLOCKS, cache_thresh=THRESH)
    want = np.asarray(pipe_j(**{k: jnp.asarray(v) for k, v in inp.items()}, **kw))
    jax.effects_barrier()
    got = pipe_t(**{k: torch.from_numpy(v) for k, v in inp.items()}, **kw).numpy()
    c = pipe_t.config.latent_channels
    same = _compare_schedules(log_t, log_j, _accumulators(log_t, 1, c, {0, 3}),
                              _accumulators(log_j, 1, c, {0, 3}), THRESH)
    assert log_t[0][1] and log_t[3][1]
    if same:
        assert psnr(got, want) >= MIN_PSNR_DB


# ------------------------------------------------------------------ gates

def _gate_run(quantize=None, upgrade=(), cache=False):
    """``tests/test_quant.py``'s ``_tiny_pipe_run`` on the port: the tiny
    preset (2 blocks), the middle-blocks cache at period 2, randomized DiT
    weights, a 32x64 image; fp32 on the CPU."""
    cfg = tiny_t()
    if cache:
        n = cfg.dit.num_layers
        a = max(1, n // 5)
        cfg = dataclasses.replace(cfg, cache_blocks=(a, max(a + 1, n - a)), cache_period=2)
    cfg_j = tiny_j()
    dit_p = randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg_j.dit), 7)
    vae_p = randomize(lambda: vae_j.init_vae_params(jax.random.PRNGKey(1), cfg_j.vae), 8,
                      fan_in=lambda s: int(np.prod(s[:-1])))
    pipe = PipeT(cfg, load_dit(dit_t.DiT(cfg.dit), dit_p), load_vae(vae_t.VAE(cfg.vae), vae_p))
    if quantize:
        pipe.quantize(mode=quantize, upgrade=upgrade)
    rng = np.random.default_rng(2)
    d = cfg.dit
    return pipe(torch.from_numpy(rng.uniform(-1, 1, (1, 3, 32, 64)).astype(np.float32)),
                torch.from_numpy(rng.standard_normal((1, 6, d.text_dim)).astype(np.float32)),
                image_emb=torch.from_numpy(rng.standard_normal(
                    (1, d.image_tokens, d.image_dim)).astype(np.float32)),
                generator=torch.Generator().manual_seed(5)).numpy()


def test_cache_psnr_gates():
    """JAX's tiny-geometry gates on the port: the cached pipeline within
    30 dB of the exact one (``test_cache_pipeline_psnr_gate``), and the
    cached mixed2 pipeline, which JAX never gated, within mixed2's own bar
    of 34 dB (``test_int4_a8_mixed2_pipeline_psnr_gate``). Read here:
    cached 35.07 dB, mixed2 39.06 dB, mixed2 + cache 34.46 dB."""
    ref = _gate_run()
    db = psnr(_gate_run(cache=True), ref)
    mixed2 = psnr(_gate_run("int4_a8", quant_t.INT4_MIXED2_UPGRADE), ref)
    both = psnr(_gate_run("int4_a8", quant_t.INT4_MIXED2_UPGRADE, cache=True), ref)
    print(f"cached {db:.2f} dB, mixed2 {mixed2:.2f} dB, mixed2 + cache {both:.2f} dB")
    assert db >= 30.0
    assert both >= 34.0
