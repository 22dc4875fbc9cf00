"""Int8-score attention (``flash_attention_qk_int8``, K9's twin) and the
quantized pipelines' fidelity gate, against the JAX package on the CPU.

JAX runs its int8-score Pallas kernel in interpret mode with
``_RESIDENT_KV_BYTES`` patched to 1 (its own tests' device,
``tests/test_quant.py:663-668``), so that short CPU shapes take the
streamed int8 path; the port's ``QK8_RESIDENT_KV_BYTES`` is lowered to
match. fp32, inputs from numpy seeds.
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
from chronoedit_tpu.models import vae as vae_j
from chronoedit_tpu.ops import attention as attn_j
from chronoedit_tpu.ops import flash_attention as fa_j
from chronoedit_tpu.pipeline.edit_pipeline import ChronoEditPipeline as PipeJ
from chronoedit_tpu.utils import platform as platform_j
from chronoedit_tpu_torch.configs import chronoedit_tiny as tiny_t
from chronoedit_tpu_torch.core.rope import Rope3DSpec as RopeT
from chronoedit_tpu_torch.kernels import build
from chronoedit_tpu_torch.models import dit as dit_t
from chronoedit_tpu_torch.models import vae as vae_t
from chronoedit_tpu_torch.models.from_jax import load_dit, load_vae
from chronoedit_tpu_torch.ops import flash_attention as fa_t
from chronoedit_tpu_torch.ops import layers as L
from chronoedit_tpu_torch.ops import quant as quant_t
from chronoedit_tpu_torch.pipeline.edit_pipeline import ChronoEditPipeline as PipeT
from test_dit import _randomize
from test_torch_dit import randomize, warm_cpu_math
from test_torch_pipeline import psnr

torch.set_num_threads(2)
# fp32 comparisons: TF32 off in matmuls and cuDNN convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SCALE = 128 ** -0.5


@pytest.fixture(scope="module", autouse=True)
def _warm():
    warm_cpu_math()


def _qkv(seed, sq, skv, h=2):
    rng = np.random.default_rng(seed)
    # k with an offset mean, so that centring it matters
    return (rng.standard_normal((1, sq, h, 128)).astype(np.float32),
            (rng.standard_normal((1, skv, h, 128)) + 0.7).astype(np.float32),
            rng.standard_normal((1, skv, h, 128)).astype(np.float32))


def _jax_prologue(q, k):
    """JAX's inline prologue (``flash_attention_qk_int8`` :838-846)."""
    kf = k.astype(jnp.float32)
    kc = kf - jnp.mean(kf, axis=1, keepdims=True)
    ks = jnp.maximum(jnp.max(jnp.abs(kc), axis=-1, keepdims=True), 1e-20) / 127.0
    k8 = jnp.round(kc / ks).astype(jnp.int8)
    qf = q.astype(jnp.float32)
    qs = jnp.maximum(jnp.max(jnp.abs(qf), axis=-1, keepdims=True), 1e-20) / 127.0
    q8 = jnp.round(qf / qs).astype(jnp.int8)
    return q8, qs[..., 0], k8, ks[..., 0]


def test_prologue_matches_jax():
    """q8 and the scales equal JAX's bit for bit; k8 may differ where the
    centred k / ks lies within fp32 rounding of a .5 (torch sums the mean
    in another order): at most 2 of its elements, each by one step, and
    ks equals JAX's (the absmax of the centred row rounds the same)."""
    q, k, _ = _qkv(0, 300, 300)
    got = fa_t.quantize_qk(torch.from_numpy(q), torch.from_numpy(k))
    want = [np.asarray(a) for a in _jax_prologue(jnp.asarray(q), jnp.asarray(k))]
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_allclose(got[3].numpy(), want[3], rtol=1e-6, atol=0)
    diff = got[2].numpy().astype(np.int32) - want[2]
    assert np.abs(diff).max() <= 1 and np.count_nonzero(diff) <= 2


@pytest.mark.parametrize("skv", [200, 77])  # ragged KV tails in JAX's 256-row blocks
def test_qk8_twin_matches_pallas_interpret(monkeypatch, skv):
    """K9's twin on JAX's own int8 inputs against JAX's int8-score Pallas
    kernel (interpret mode): the integer scores are exact on both sides,
    so only the softmax's summation order differs: 2e-5 on O(1) outputs.
    Then the whole ``flash_attention_qk_int8``, prologue included, within
    1e-4 (a k8 rounding flip, see above, moves one score by ks * |q8|)."""
    monkeypatch.setattr(fa_j, "_RESIDENT_KV_BYTES", 1)
    monkeypatch.setattr(fa_t, "QK8_RESIDENT_KV_BYTES", 0)
    q, k, v = _qkv(1, 130, skv)
    want = np.asarray(fa_j.flash_attention_qk_int8(*map(jnp.asarray, (q, k, v)), SCALE))
    q8, qs, k8, ks = (torch.from_numpy(np.array(a))
                      for a in _jax_prologue(jnp.asarray(q), jnp.asarray(k)))
    twin = fa_t.flash_attention_qk_int8_plain(q8, k8, torch.from_numpy(v), qs, ks, SCALE)
    np.testing.assert_allclose(twin.numpy(), want, atol=2e-5, rtol=0)
    chunked = fa_t.flash_attention_qk_int8_plain(q8, k8, torch.from_numpy(v), qs, ks, SCALE,
                                                 q_chunk=48)
    torch.testing.assert_close(chunked, twin, atol=1e-6, rtol=0)
    got = fa_t.flash_attention_qk_int8(*map(torch.from_numpy, (q, k, v)), SCALE)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    # the int8 scores are not the float ones: a non-vacuous comparison
    exact = fa_t.flash_attention(*map(torch.from_numpy, (q, k, v)), SCALE)
    assert float((exact - got).abs().max()) > 1e-3


@pytest.mark.parametrize("kv_len,itemsize,int8", [
    (12288, 2, False), (12289, 2, True), (28800, 2, True), (7200, 2, False),
    (6144, 4, False), (6145, 4, True)])
def test_int8_score_threshold_is_jax_rule(kv_len, itemsize, int8):
    """The port's rule against JAX's, by arithmetic (no tensors): JAX plans
    its blocks for the KV length and element size, rounds the KV up to its
    resident block and compares 2 * Skv_res * D * itemsize with 6 MiB
    (:830-835); at D = 128 in bf16 that is KV > 12,288 tokens."""
    assert fa_t.uses_int8_scores(kv_len, 128, itemsize) is int8
    _, block_kv, _ = fa_j._plan_blocks(1024, kv_len, 128, itemsize, fa_j._BLOCK_Q,
                                       fa_j._BLOCK_KV, None)
    bkv = min(block_kv, 256)
    resident = 2 * (-(-kv_len // bkv) * bkv) * 128 * itemsize <= fa_j._RESIDENT_KV_BYTES
    assert int8 is not resident


def test_short_kv_runs_bf16_attention_and_grads_are_refused(monkeypatch):
    """Under the resident rule the call is the plain flash attention, bit
    for bit, and stays differentiable; the int8 path is forward only."""
    q, k, v = map(torch.from_numpy, _qkv(2, 64, 64))
    torch.testing.assert_close(fa_t.flash_attention_qk_int8(q, k, v, SCALE),
                               fa_t.flash_attention(q, k, v, SCALE), atol=0, rtol=0)
    qg = q.clone().requires_grad_()
    fa_t.flash_attention_qk_int8(qg, k, v, SCALE).sum().backward()
    assert qg.grad is not None
    monkeypatch.setattr(fa_t, "QK8_RESIDENT_KV_BYTES", 0)
    with pytest.raises(RuntimeError, match="forward only"):
        fa_t.flash_attention_qk_int8(qg, k, v, SCALE)
    with torch.no_grad():
        assert fa_t.flash_attention_qk_int8(qg, k, v, SCALE).shape == q.shape


def test_cpu_tensors_never_touch_the_kernel_loader(monkeypatch):
    """Quantized leaves and the int8-score path on CPU tensors run their
    twins: the library is neither built nor loaded, no launch counted."""
    def refuse(*a, **k):
        raise AssertionError("kernel loader touched for a CPU tensor")

    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "lib", refuse)
    monkeypatch.setattr(fa_t, "QK8_RESIDENT_KV_BYTES", 0)
    before = dict(build.LAUNCHES)
    lin = L.Linear(256, 64, generator=torch.Generator().manual_seed(0))
    x = torch.randn(3, 256)
    for leaf in (quant_t.quantize_linear_params(lin),
                 quant_t.quantize_linear_params_int4(lin, grid="uniform"),
                 quant_t.quantize_linear_params_int4(lin, grid="uniform", act8=True)):
        assert L.linear(leaf, x).shape == (3, 64)
    q = torch.randn(1, 8, 2, 128)
    fa_t.flash_attention_qk_int8(q, q, q, SCALE)
    assert build.LAUNCHES == before and not build.SHAPE_LAUNCHES["flash_fwd_qk8"]


@pytest.mark.parametrize("case", ["ok", "q8_dtype", "v_fp32", "scale_shape", "head_dim"])
def test_k9_checks_reject_what_the_kernel_does_not_take(case):
    """K9's argument checks (run before any launch on a card)."""
    q8 = torch.zeros(1, 8, 2, 128, dtype=torch.int8)
    k8 = torch.zeros(1, 5, 2, 128, dtype=torch.int8)
    v = torch.zeros(1, 5, 2, 128, dtype=torch.bfloat16)
    qs, ks = torch.zeros(1, 8, 2), torch.zeros(1, 5, 2)
    if case == "ok":
        fa_t._check_qk8(q8, k8, v, qs, ks)
        return
    if case == "q8_dtype":
        q8 = q8.float()
    elif case == "v_fp32":
        v = v.float()
    elif case == "scale_shape":
        ks = torch.zeros(1, 2, 5)
    else:
        q8, k8, v = q8[..., :64], k8[..., :64], v[..., :64]
    with pytest.raises(ValueError):
        fa_t._check_qk8(q8, k8, v, qs, ks)


# ------------------------------------------------------------ pipelines

def _tiny_1x128(cfg, rope, qk_int8):
    """The tiny preset with one 128-wide head, as JAX's qk8 gate pins it."""
    return dataclasses.replace(cfg, dit=dataclasses.replace(
        cfg.dit, num_heads=1, head_dim=128, rope=rope(head_dim=128, temporal_skip_len=8),
        attn_qk_int8=qk_int8))


# The int8-score pipeline against JAX's, PSNR over the [-1, 1] range. On
# the test's inputs the port's int8-score pipeline reads 108.9 dB (no k8
# rounding flips; fp32 summation order only) and its float-score pipeline,
# the wrong arithmetic, 77.9 dB against the same JAX output. The bar sits
# between them, about 15 dB from each: a k8 flip (see the prologue test)
# that the steps carry on may cost some of the first margin, and a port
# that ignored ``attn_qk_int8`` must fail it.
QK8_PIPE_DB = 93.0


def test_qk8_pipeline_matches_jax(monkeypatch):
    """The tiny edit pipeline with ``attn_qk_int8`` (4 steps, guidance 2
    batched, 32 self-attention tokens), port against JAX under its gate's
    three patches, the port's rule lowered to match, fp32: at least
    QK8_PIPE_DB, and the port's float-score pipeline below it."""
    cfg_j, cfg_t = _tiny_1x128(tiny_j(), RopeJ, True), _tiny_1x128(tiny_t(), RopeT, True)
    dit_p = randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg_j.dit), 31)
    vae_p = randomize(lambda: vae_j.init_vae_params(jax.random.PRNGKey(1), cfg_j.vae), 32,
                      fan_in=lambda s: int(np.prod(s[:-1])))
    rng = np.random.default_rng(33)
    d, sf = cfg_t.dit, cfg_t.vae.spatial_factor
    tl = cfg_t.vae.latent_frames(cfg_t.num_frames)
    inp = dict(image=rng.uniform(-1, 1, (1, 3, 16, 16)),
               prompt_emb=rng.standard_normal((1, 6, d.text_dim)),
               neg_prompt_emb=rng.standard_normal((1, 6, d.text_dim)),
               image_emb=rng.standard_normal((1, d.image_tokens, d.image_dim)),
               latents=rng.standard_normal((1, cfg_t.vae.z_dim, tl, 16 // sf, 16 // sf)))
    inp = {k: v.astype(np.float32) for k, v in inp.items()}
    monkeypatch.setattr(attn_j, "_on_tpu", lambda: True)
    monkeypatch.setattr(fa_j, "_RESIDENT_KV_BYTES", 1)
    monkeypatch.setattr(platform_j, "multi_device_world", lambda: False)
    monkeypatch.setattr(fa_t, "QK8_RESIDENT_KV_BYTES", 0)
    want = np.asarray(PipeJ(cfg_j, dit_p, vae_p)(**{k: jnp.asarray(v) for k, v in inp.items()}))
    model, vae = load_dit(dit_t.DiT(cfg_t.dit), dit_p), load_vae(vae_t.VAE(cfg_t.vae), vae_p)
    pipe = PipeT(cfg_t, model, vae)
    got = pipe(**{k: torch.from_numpy(v) for k, v in inp.items()})
    model.cfg = dataclasses.replace(model.cfg, attn_qk_int8=False)
    float_scores = pipe(**{k: torch.from_numpy(v) for k, v in inp.items()})
    assert got.shape == want.shape and np.isfinite(got.numpy()).all()
    assert psnr(got.numpy(), want) >= QK8_PIPE_DB
    assert psnr(float_scores.numpy(), want) < QK8_PIPE_DB


def test_mixed2_pipeline_gate_as_jax():
    """The port's mirror of JAX's one tier-1 quantization gate
    (``tests/test_quant.py:628-642``): the tiny pipeline (32x64 image,
    4 steps, guidance 2) in mixed2 (w4a8 with ``INT4_MIXED2_UPGRADE``)
    against the same pipeline unquantized, both the port's, on JAX's gate
    weights and draws: at least 34 dB over the reference's peak (JAX
    measures 35.7 dB there)."""
    cfg_j = tiny_j()
    dit_p = jax.tree.map(np.asarray, _randomize(
        dit_j.init_dit_params(jax.random.PRNGKey(0), cfg_j.dit), jax.random.PRNGKey(7)))
    vae_p = jax.tree.map(np.asarray, vae_j.init_vae_params(jax.random.PRNGKey(1), cfg_j.vae))
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(2), 3)
    tl, sf = cfg_j.vae.latent_frames(cfg_j.num_frames), cfg_j.vae.spatial_factor
    inp = dict(image=jax.random.uniform(k1, (1, 3, 32, 64), jnp.float32, -1, 1),
               prompt_emb=jax.random.normal(k2, (1, 6, cfg_j.dit.text_dim)),
               image_emb=jax.random.normal(k3, (1, cfg_j.dit.image_tokens,
                                                cfg_j.dit.image_dim)),
               latents=jax.random.normal(jax.random.PRNGKey(5),
                                         (1, cfg_j.latent_channels, tl, 32 // sf, 64 // sf),
                                         jnp.float32))
    inp = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    cfg_t = tiny_t()

    def run(quantize):
        pipe = PipeT(cfg_t, load_dit(dit_t.DiT(cfg_t.dit), dit_p),
                     load_vae(vae_t.VAE(cfg_t.vae), vae_p))
        if quantize:
            pipe.quantize(mode="int4_a8", upgrade=quant_t.INT4_MIXED2_UPGRADE)
        return pipe(**inp).numpy().astype(np.float64)

    ref, got = run(False), run(True)
    db = 10 * np.log10(np.abs(ref).max() ** 2 / np.mean((got - ref) ** 2))
    assert db >= 34.0, db
