"""Quantized serving (``ops/quant.py``, K8's twin) against the JAX package.

fp32 on the CPU, inputs made with numpy from fixed seeds. JAX's int4 apply
runs its XLA path (the Pallas kernel is gated to one TPU); K8's twin is
held against the Pallas kernel itself in interpret mode, on uniform-grid
weights, as ``tests/test_quant.py`` runs it.

Every in-dim here is at least 128, so the Lloyd codebook has one
effective group (128) and is computed once per process on each side
(about 13 s each).

Bounds, each with its reason:
- the quantizers: bitwise (the same fp32 operations in the same order);
- w8a8 and w4a8 applies: bitwise here too (exact int32 sums, the same
  fp32 scaling);
- w4a16: 1e-6 of the output's largest magnitude, fp32 summation order
  (JAX sums two half products, the twin one product);
- the DiT and the pipeline: see ``INT8_ACT_DIT_DB`` and the tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.configs import chronoedit_14b as c14_j
from chronoedit_tpu.configs import chronoedit_tiny as tiny_j
from chronoedit_tpu.core.rope import Rope3DSpec as RopeJ
from chronoedit_tpu.models import dit as dit_j
from chronoedit_tpu.models import vae as vae_j
from chronoedit_tpu.ops import layers as layers_j
from chronoedit_tpu.ops import quant as quant_j
from chronoedit_tpu.ops.int4_matmul import int4_matmul as int4_matmul_j
from chronoedit_tpu.pipeline.edit_pipeline import ChronoEditPipeline as PipeJ
from chronoedit_tpu_torch.configs import chronoedit_14b as c14_t
from chronoedit_tpu_torch.configs import chronoedit_tiny as tiny_t
from chronoedit_tpu_torch.core.rope import Rope3DSpec as RopeT
from chronoedit_tpu_torch.kernels import build
from chronoedit_tpu_torch.models import dit as dit_t
from chronoedit_tpu_torch.models import lora as lora_t
from chronoedit_tpu_torch.models import vae as vae_t
from chronoedit_tpu_torch.models.from_jax import load_dit, load_vae
from chronoedit_tpu_torch.ops import int4_matmul as i4_t
from chronoedit_tpu_torch.ops import layers as L
from chronoedit_tpu_torch.ops import quant as quant_t
from chronoedit_tpu_torch.pipeline.edit_pipeline import ChronoEditPipeline as PipeT
from test_torch_dit import _kernel_shaped, randomize
from test_torch_pipeline import psnr

torch.set_num_threads(2)
# fp32 comparisons: TF32 off in matmuls and cuDNN convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

W4A16_REL = 1e-6
MIN_PSNR_DB = 60.0
# mode -> (JAX/port mode, upgrade list)
MODES = {"int8": ("int8", ()), "int4": ("int4", ()),
         "mixed2": ("int4_a8", quant_t.INT4_MIXED2_UPGRADE)}


def _pair(rng, din, dout):
    """The same random (in, out) kernel and bias as a JAX leaf and a port
    Linear."""
    k = rng.standard_normal((din, dout)).astype(np.float32)
    b = rng.standard_normal((dout,)).astype(np.float32)
    lin = L.Linear(din, dout)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(k.T))
        lin.bias.copy_(torch.from_numpy(b))
    return {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}, lin


def _quantize_pair(kind, pj, lt):
    """(JAX leaf, port leaf) quantized the same way."""
    if kind == "int8":
        return quant_j.quantize_linear_params(pj), quant_t.quantize_linear_params(lt)
    grid, act8 = kind.split("_")[0], kind.endswith("_a8")
    return (quant_j.quantize_linear_params_int4(pj, act8=act8, grid=grid),
            quant_t.quantize_linear_params_int4(lt, act8=act8, grid=grid))


def test_lloyd_levels_match_jax():
    """The port's numpy copy of the codebook gives JAX's levels bit for
    bit; odd-symmetric with an exact 0 and pinned +-1."""
    got, want = quant_t._lloyd_levels(128), quant_j._lloyd_levels(128)
    assert got == want
    lut = quant_t.int4_levels("lloyd", 128)
    assert lut.dtype == torch.float32 and lut[7] == 0 and lut[0] == -1 and lut[14] == 1
    assert torch.equal(quant_t.int4_levels("uniform", 128), torch.arange(-7., 8.))


@pytest.mark.parametrize("din", [256, 200])  # 200 pads to 256 rows (2 groups)
@pytest.mark.parametrize("kind", ["int8", "uniform", "lloyd", "lloyd_a8"])
def test_quantizer_bits_match_jax(kind, din):
    """The port's int8 weights, packed int4 bytes, scales, tables and
    scale8 equal JAX's after the transpose, bit for bit."""
    pj, lt = _pair(np.random.default_rng(din), din, 48)
    a, b = _quantize_pair(kind, pj, lt)
    if kind == "int8":
        np.testing.assert_array_equal(b.weight_q.numpy(), np.asarray(a["kernel_q"]).T)
        np.testing.assert_array_equal(b.weight_scale.numpy(), np.asarray(a["kernel_scale"]))
        return
    assert b.packed.dtype == torch.int8 and tuple(b.packed.shape) == (48, 128)
    np.testing.assert_array_equal(b.packed.numpy(), np.asarray(a["kernel_q4"]).T)
    np.testing.assert_array_equal(b.scales.numpy(), np.asarray(a["kernel_scale4"]))
    want_lut = a.get("kernel_lut4", np.arange(-7, 8, dtype=np.float32))
    np.testing.assert_array_equal(b.table.numpy(), np.asarray(want_lut))
    if kind.endswith("_a8"):
        np.testing.assert_array_equal(b.scale8.numpy(), np.asarray(a["kernel_scale8"]))
    else:
        assert b.scale8 is None


@pytest.mark.parametrize("kind", ["int8", "uniform", "lloyd", "uniform_a8", "lloyd_a8"])
def test_applies_match_jax(kind):
    """``quantized_linear``, ``quantized_linear_int4`` and the w4a8 apply,
    with a bias and a ragged (3, 5) leading shape, and ``L.linear``'s
    dispatch to them. w8a8/w4a8: bitwise; w4a16: within W4A16_REL of
    max|y|."""
    rng = np.random.default_rng(1)
    pj, lt = _pair(rng, 200, 48)
    a, b = _quantize_pair(kind, pj, lt)
    x = rng.standard_normal((3, 5, 200)).astype(np.float32)
    want = np.asarray(layers_j.linear(a, jnp.asarray(x)))
    got = L.linear(b, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 5, 48)
    if kind in ("uniform", "lloyd"):
        np.testing.assert_allclose(got, want, atol=W4A16_REL * np.abs(want).max(), rtol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["one_k_tile", "k_tiles", "ragged_m", "lloyd_xla"])
def test_int4_matmul_twin_matches_jax(case):
    """K8's twin against JAX's Pallas kernel in interpret mode (uniform
    grid): one k tile (K/2 = 128), four k tiles (bk = 128) and a ragged M
    of 130 rows with a (2, 65) leading shape; and against JAX's XLA path on
    Lloyd weights. fp32 sums in another order: 2e-5 of max|y|."""
    din, dout, m, bk = {"one_k_tile": (256, 128, 64, None), "k_tiles": (1024, 256, 64, 128),
                        "ragged_m": (256, 128, 130, None),
                        "lloyd_xla": (1024, 256, 96, None)}[case]
    rng = np.random.default_rng(11)
    pj, lt = _pair(rng, din, dout)
    grid = "lloyd" if case == "lloyd_xla" else "uniform"
    pj = {"kernel": pj["kernel"]}  # no bias: the matmul alone
    a = quant_j.quantize_linear_params_int4(pj, grid=grid)
    b = quant_t.quantize_linear_params_int4(lt, grid=grid)
    x = rng.standard_normal((m, din)).astype(np.float32)
    if case == "lloyd_xla":
        want = np.asarray(quant_j.quantized_linear_int4(a, jnp.asarray(x)))
    else:
        xj = jnp.asarray(x).reshape(2, m // 2, din) if case == "ragged_m" else jnp.asarray(x)
        want = np.asarray(int4_matmul_j(xj, a["kernel_q4"], a["kernel_scale4"], bk=bk,
                                        interpret=True)).reshape(m, dout)
    xt = torch.from_numpy(x)
    if case == "ragged_m":
        xt = xt.reshape(2, m // 2, din)
    got = i4_t.int4_matmul(xt, b.packed, b.scales, b.table).reshape(m, dout).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=0)
    # the twin's weight is the dequantized leaf, cast to x's dtype
    w = quant_t.dequantize_linear_params(b, in_dim=din).weight
    np.testing.assert_allclose(got, x @ w.numpy().T, atol=2e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("case", ["bf16_x", "fp32_x", "odd_groups", "n_not_8", "scales"])
def test_int4_matmul_checks_reject_what_k8_does_not_take(case):
    """K8's argument checks (run before any launch on a card)."""
    x = torch.zeros(4, 256, dtype=torch.bfloat16)
    packed = torch.zeros(16, 128, dtype=torch.int8)
    scales = torch.zeros(2, 16)
    table = torch.zeros(15)
    if case == "bf16_x":  # the shapes K8 takes pass
        i4_t._check(x, packed, scales, table)
        return
    if case == "fp32_x":
        x = x.float()
    elif case == "odd_groups":
        x, packed, scales = (torch.zeros(4, 128, dtype=torch.bfloat16),
                             torch.zeros(16, 64, dtype=torch.int8), torch.zeros(1, 16))
    elif case == "n_not_8":
        packed, scales = torch.zeros(12, 128, dtype=torch.int8), torch.zeros(2, 12)
    else:
        scales = torch.zeros(16, 2)
    with pytest.raises(ValueError):
        i4_t._check(x, packed, scales, table)


def _kernel_dit(mod):
    """The kernel-shaped 2-block DiT (2 heads x 128, ffn 512): every
    projection's in-dim is 256 or 512."""
    return _kernel_shaped(mod)


def test_quantize_dit_targets_skip_upgrade_and_validation():
    """Per mode, the targets become leaves and the edges stay float;
    ``skip`` keeps a projection float, ``upgrade`` makes it w8a8 inside an
    int4 model; unknown modes and non-target upgrades raise."""
    cfg = _kernel_dit(dit_t)
    g = torch.Generator().manual_seed(0)
    m8 = quant_t.quantize_dit(dit_t.init_dit_params(cfg, g), mode="int8")
    blk = m8.blocks[1]
    assert isinstance(blk.self_attn.q, quant_t.QuantLinear8)
    assert isinstance(blk.ffn.fc2, quant_t.QuantLinear8)
    assert isinstance(blk.cross_attn.k, L.Linear)  # context kv stays float under int8
    assert isinstance(m8.patch_embed, L.Linear) and isinstance(m8.head.proj, L.Linear)

    m4 = quant_t.quantize_dit(dit_t.init_dit_params(cfg, g), mode="int4_a8",
                              skip=(("self_attn", "k"),),
                              upgrade=quant_t.INT4_MIXED2_UPGRADE)
    blk = m4.blocks[0]
    assert isinstance(blk.self_attn.k, L.Linear)
    assert isinstance(blk.cross_attn.k_img, quant_t.QuantLinear4)
    assert blk.cross_attn.k_img.scale8 is not None
    for mod, name in quant_t.INT4_MIXED2_UPGRADE:
        assert isinstance(getattr(getattr(blk, mod), name), quant_t.QuantLinear8)
    assert isinstance(m4.time_proj, L.Linear) and isinstance(m4.img_embed.fc1, L.Linear)

    with pytest.raises(ValueError):
        quant_t.quantize_dit(m4, mode="int2")
    with pytest.raises(ValueError):  # cross k is no int8 target
        quant_t.quantize_dit(m4, mode="int8", upgrade=(("cross_attn", "k"),))


def test_quantize_dit_idempotent_and_int8_then_int4():
    """A second call leaves every leaf as it was; int8 then int4 keeps the
    int8 leaves and quantizes only what int8 skipped (JAX's
    ``tests/test_quant.py:234-257``)."""
    cfg = _kernel_dit(dit_t)
    model = quant_t.quantize_dit(dit_t.init_dit_params(cfg, torch.Generator().manual_seed(1)),
                                 mode="int4")
    fc2 = model.blocks[0].ffn.fc2
    assert quant_t.quantize_dit(model, mode="int4").blocks[0].ffn.fc2 is fc2
    mixed = quant_t.quantize_dit(dit_t.init_dit_params(cfg, torch.Generator().manual_seed(1)))
    quant_t.quantize_dit(mixed, mode="int4")
    assert isinstance(mixed.blocks[0].ffn.fc2, quant_t.QuantLinear8)
    assert isinstance(mixed.blocks[0].cross_attn.k, quant_t.QuantLinear4)


@pytest.mark.parametrize("mode,upgrade,limit_gb", [
    ("int4", (), 10.0), ("int4_a8", quant_t.INT4_MIXED2_UPGRADE, 13.0)])
def test_full_width_weight_bytes(mode, upgrade, limit_gb):
    """The 40-block 14B DiT's bytes from shapes alone (the model on the
    meta device): w4a16 under 10 GB, as JAX asserts for its tree
    (``tests/test_quant.py:260-277``); mixed2 under 13 GB (by arithmetic
    3.29 GB of int8 over w4a8's storage, about 12.4 GB in all)."""
    cfg = dataclasses.replace(c14_t().dit, param_dtype=torch.bfloat16)
    model = quant_t.quantize_dit(dit_t.DiT(cfg, device="meta"), mode=mode, upgrade=upgrade)
    total = sum(t.numel() * t.element_size()
                for t in (*model.parameters(), *model.buffers()))
    assert total < limit_gb * 1e9, total
    if mode == "int4":  # JAX's tree has the same bytes
        cj = dataclasses.replace(c14_j().dit, param_dtype=jnp.bfloat16)
        shapes = jax.eval_shape(lambda k: quant_j.quantize_dit_params(
            dit_j.init_dit_params(k, cj), mode="int4"), jax.random.PRNGKey(0))
        assert total == sum(x.size * x.dtype.itemsize for x in jax.tree_util.tree_leaves(shapes))


def test_diagnostics_match_jax():
    """``quantization_error`` equals JAX's; ``dequantize_linear_params``
    needs the in-dim for an int4 leaf; ``rank_projection_sensitivity``
    ranks every float target, worst first."""
    pj, lt = _pair(np.random.default_rng(4), 200, 32)
    assert quant_t.quantization_error(lt) == pytest.approx(quant_j.quantization_error(pj),
                                                           rel=1e-6)
    leaf = quant_t.quantize_linear_params_int4(lt)
    with pytest.raises(ValueError):
        quant_t.dequantize_linear_params(leaf)
    deq = quant_t.dequantize_linear_params(leaf, in_dim=200)
    want = quant_j.dequantize_linear_params(quant_j.quantize_linear_params_int4(pj), in_dim=200)
    np.testing.assert_array_equal(deq.weight.detach().numpy(), np.asarray(want["kernel"]).T)
    model = dit_t.init_dit_params(_kernel_dit(dit_t), torch.Generator().manual_seed(2))
    ranked = quant_t.rank_projection_sensitivity(model)
    assert sorted(t for t, _ in ranked) == sorted(quant_t._BLOCK_LINEARS)
    assert all(a[1] >= b[1] > 0 for a, b in zip(ranked, ranked[1:]))


def test_lora_refuses_quantized_targets():
    """No float weight to merge into: building adapters over a quantized
    projection raises."""
    model = quant_t.quantize_dit(
        dit_t.init_dit_params(_kernel_dit(dit_t), torch.Generator().manual_seed(3)))
    with pytest.raises(ValueError, match="quantized"):
        lora_t.LoRA(model, lora_t.LoRAConfig(rank=2))


def test_launch_counts_by_rows_and_kv_length(monkeypatch):
    """``check`` counts an int4 matmul launch under its row count and an
    int8-score launch under its KV length; ``reset_launches`` zeroes them."""
    monkeypatch.setattr(build, "LAUNCHES", dict.fromkeys(build.LAUNCHES, 0))
    monkeypatch.setattr(build, "SHAPE_LAUNCHES", {k: {} for k in build.SHAPE_LAUNCHES})
    for rows in (7200, 7200, 257):
        build.check(0, "int4_matmul", rows)
    build.check(0, "flash_fwd_qk8", 28800)
    assert build.LAUNCHES["int4_matmul"] == 3 and build.LAUNCHES["flash_fwd_qk8"] == 1
    assert build.SHAPE_LAUNCHES["int4_matmul"] == {7200: 2, 257: 1}
    assert build.SHAPE_LAUNCHES["flash_fwd_qk8"] == {28800: 1}
    build.reset_launches()
    assert not any(build.LAUNCHES.values()) and not any(build.SHAPE_LAUNCHES.values())


# ------------------------------------------------------------ the model

@pytest.fixture(scope="module")
def kernel_dit_weights():
    cfg = _kernel_dit(dit_j)
    return randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg), 21)


@pytest.mark.parametrize("name", ["int8", "int4", "int4_uniform", "mixed2"])
def test_bridge_carries_quantized_jax_trees(kernel_dit_weights, name, monkeypatch):
    """A quantized JAX tree loads into a port model quantized in the same
    mode from other weights: every buffer is written (``load_dit`` checks)
    and the result equals the port's own quantization of the JAX model's
    float weights, bit for bit (a uniform-grid tree gets the -7..7 table)."""
    if name == "int4_uniform":
        monkeypatch.setattr(quant_j, "INT4_GRID", "uniform")
        monkeypatch.setattr(quant_t, "INT4_GRID", "uniform")
    mode, upgrade = MODES.get(name, ("int4", ()))
    tree = jax.tree.map(np.asarray, quant_j.quantize_dit_params(
        kernel_dit_weights, mode=mode, upgrade=upgrade))
    cfg = _kernel_dit(dit_t)
    other = quant_t.quantize_dit(dit_t.init_dit_params(cfg, torch.Generator().manual_seed(5)),
                                 mode=mode, upgrade=upgrade)
    got = load_dit(other, tree).state_dict()
    want = quant_t.quantize_dit(load_dit(dit_t.DiT(cfg), kernel_dit_weights),
                                mode=mode, upgrade=upgrade).state_dict()
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key
    with pytest.raises(ValueError, match="quantize the port model"):
        load_dit(dit_t.DiT(cfg), tree)


def peak_db(got: np.ndarray, want: np.ndarray) -> float:
    """PSNR against the reference's own peak: 20 log10(max|want| / rms err)."""
    err = float(np.sqrt(np.mean((got.astype(np.float64) - want) ** 2)))
    return float("inf") if err == 0 else 20.0 * np.log10(float(np.abs(want).max()) / err)


# With int8 activations (w8a8, and w4a8 in mixed2) the two frameworks'
# fp32 op orders (~1e-7 relative) can put x / xs on either side of a .5 and
# round one activation the other way. Counted on the DiT test's inputs in
# int8 mode (JAX run eagerly under ``jax.disable_jit`` so that its roundings
# could be read, call by call): no flip in block 0's first six projections,
# then 1 of 3,072 in its fc1 input; that token's later roundings follow (24
# in fc2, then 3 to 561 per projection in block 1), and the output moves by
# 1e-2 at a peak of 4.3 (64.8 dB). JAX's own jitted forward differs from
# its call by 3.7e-3 (79.3 dB) for the same reason. So the int8-activation
# modes get PSNR bars, each set between two readings on the tests' inputs:
# the port in the same mode against JAX, and the port's unquantized model
# (the wrong arithmetic) against the same JAX output, which must fall below.
#   DiT:      int8 64.8 against 52.7 dB, mixed2 126.8 against 37.2 dB
#   pipeline: int8 54.9 against 50.6 dB, mixed2 54.2 against 36.9 dB
# w4a16 runs no activation rounding and keeps the float bars (its DiT
# within 1e-4 of max|out|, its pipeline 133.9 dB against a 60 dB bar; the
# unquantized port reads 29.9 and 26.4 dB). The int8 pipeline's readings lie
# 4.3 dB apart (the flips cost almost as much as the quantization itself at
# 4 steps), so its bar has about 2 dB on each side; all runs are
# deterministic on one CPU.
INT8_ACT_DIT_DB = 58.5
PIPE_DB = {"int8": 52.5, "int4": MIN_PSNR_DB, "mixed2": 45.0}


@pytest.mark.parametrize("name", list(MODES))
def test_dit_forward_quantized_matches_jax(kernel_dit_weights, name):
    """The 2-block DiT quantized in each mode from the same float weights,
    port against JAX, fp32. The quantized weights are the same bits. w4a16:
    within 1e-4 of max|out| (the float DiT's bound); with int8 activations
    at least INT8_ACT_DIT_DB over JAX's peak (rounding flips, see above).
    The port's unquantized DiT fails the same check."""
    mode, upgrade = MODES[name]
    cfg_j, cfg_t = _kernel_dit(dit_j), _kernel_dit(dit_t)
    params = quant_j.quantize_dit_params(kernel_dit_weights, mode=mode, upgrade=upgrade)
    model = quant_t.quantize_dit(load_dit(dit_t.DiT(cfg_t), kernel_dit_weights),
                                 mode=mode, upgrade=upgrade)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, cfg_j.in_channels, 2, 4, 6)).astype(np.float32)
    ts = np.array([[999.0, 937.0]], np.float32)
    text = rng.standard_normal((1, 7, cfg_j.text_dim)).astype(np.float32)
    img = rng.standard_normal((1, cfg_j.image_tokens, cfg_j.image_dim)).astype(np.float32)
    want = np.asarray(dit_j.dit_forward(params, cfg_j, *map(jnp.asarray, (x, ts, text, img))))
    unquantized = load_dit(dit_t.DiT(cfg_t), kernel_dit_weights)
    with torch.inference_mode():
        got, float_out = (dit_t.dit_forward(m, *map(torch.from_numpy, (x, ts, text, img))).numpy()
                          for m in (model, unquantized))
    assert got.shape == want.shape

    def passes(out):
        if mode == "int4":
            return np.allclose(out, want, rtol=1e-7,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))
        return peak_db(out, want) >= INT8_ACT_DIT_DB

    assert passes(got) and not passes(float_out)


def _tiny128(mod, rope):
    """The tiny preset with one 128-wide head and ffn 128: every
    projection's in-dim is 128 (one Lloyd group)."""
    cfg = (tiny_j if mod == "j" else tiny_t)()
    return dataclasses.replace(cfg, dit=dataclasses.replace(
        cfg.dit, num_heads=1, head_dim=128, ffn_dim=128,
        rope=rope(head_dim=128, temporal_skip_len=8)))


@pytest.fixture(scope="module")
def tiny128_weights():
    cfg = _tiny128("j", RopeJ)
    dit_p = randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg.dit), 25)
    vae_p = randomize(lambda: vae_j.init_vae_params(jax.random.PRNGKey(1), cfg.vae), 26,
                      fan_in=lambda s: int(np.prod(s[:-1])))
    return dit_p, vae_p


@pytest.mark.parametrize("name", list(MODES))
def test_pipeline_quantized_matches_jax(tiny128_weights, name):
    """The tiny edit pipeline (4 steps, guidance 2 batched) quantized in
    each mode through ``quantize``, port against JAX on the same float
    weights and inputs, fp32, PSNR over the [-1, 1] range: at least the
    mode's PIPE_DB (see above), and the port's unquantized pipeline below
    it."""
    mode, upgrade = MODES[name]
    dit_p, vae_p = tiny128_weights
    cfg_j, cfg_t = _tiny128("j", RopeJ), _tiny128("t", RopeT)
    pipe_j = PipeJ(cfg_j, dit_p, vae_p).quantize(mode=mode, upgrade=upgrade)
    pipe_t = PipeT(cfg_t, load_dit(dit_t.DiT(cfg_t.dit), dit_p),
                   load_vae(vae_t.VAE(cfg_t.vae), vae_p))
    rng = np.random.default_rng(27)
    d, sf = cfg_t.dit, cfg_t.vae.spatial_factor
    tl = cfg_t.vae.latent_frames(cfg_t.num_frames)
    inp = dict(image=rng.uniform(-1, 1, (1, 3, 16, 16)),
               prompt_emb=rng.standard_normal((1, 6, d.text_dim)),
               neg_prompt_emb=rng.standard_normal((1, 6, d.text_dim)),
               image_emb=rng.standard_normal((1, d.image_tokens, d.image_dim)),
               latents=rng.standard_normal((1, cfg_t.vae.z_dim, tl, 16 // sf, 16 // sf)))
    inp = {k: v.astype(np.float32) for k, v in inp.items()}
    want = np.asarray(pipe_j(**{k: jnp.asarray(v) for k, v in inp.items()}))
    float_out = pipe_t(**{k: torch.from_numpy(v) for k, v in inp.items()}).numpy()
    got = pipe_t.quantize(mode=mode, upgrade=upgrade)(
        **{k: torch.from_numpy(v) for k, v in inp.items()}).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert psnr(got, want) >= PIPE_DB[name] > psnr(float_out, want)
