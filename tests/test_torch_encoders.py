"""The port's text and image encoders, XLM-R and the conditioner against the
JAX package's, on the same weights and inputs, fp32 on the CPU.

Weights are numpy noise in the JAX trees' shapes (``randomize``), loaded
into the port through ``models/from_jax.py``. Bars: features at least
60 dB over the reference's peak (fp32 op-order differences leave ~1e-6
errors at peaks of about 3, over 120 dB; a missing bias, a wrong norm
order or a scaled logit costs tens of dB); ``preprocess`` within 1e-6
(max abs) on the production 720x1280 -> 224 resize, 1e-5 on other shapes
(fp32 rounding of the resize weights, times 1/std < 4; bicubic without
antialiasing misses by 1.5 at 720p and 0.2 when it upsamples); converters
bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.configs import chronoedit_tiny as tiny_j
from chronoedit_tpu.models import clip as clip_j
from chronoedit_tpu.models import conditioner as cond_j
from chronoedit_tpu.models import umt5 as umt5_j
from chronoedit_tpu.models import xlm_roberta as xlmr_j
from chronoedit_tpu.pipeline.edit_pipeline import ChronoEditPipeline as PipeJ
from chronoedit_tpu_torch.configs import chronoedit_tiny as tiny_t
from chronoedit_tpu_torch.models import clip as clip_t
from chronoedit_tpu_torch.models import conditioner as cond_t
from chronoedit_tpu_torch.models import dit as dit_t
from chronoedit_tpu_torch.models import umt5 as umt5_t
from chronoedit_tpu_torch.models import vae as vae_t
from chronoedit_tpu_torch.models import xlm_roberta as xlmr_t
from chronoedit_tpu_torch.models.from_jax import (load_clip, load_dit, load_umt5, load_vae,
                                                  load_xlm_roberta)
from chronoedit_tpu_torch.pipeline.edit_pipeline import ChronoEditPipeline as PipeT
from test_torch_dit import randomize

torch.set_num_threads(2)

MIN_DB = 60.0
F32 = dict(dtype=torch.float32, param_dtype=torch.float32)
# the tiny encoders of tests/test_text_image_encoders.py
T5_KW = dict(vocab_size=100, dim=16, dim_attn=16, dim_ffn=32, num_heads=2, num_layers=2,
             num_buckets=8, text_len=12)
CLIP_KW = dict(image_size=28, patch_size=14, dim=16, mlp_ratio=2, num_heads=2, num_layers=3)


def peak_db(got, want) -> float:
    """PSNR over the reference's peak magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mse = float(np.mean((got - want) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(float(np.abs(want).max()) ** 2 / mse)


def state_equal(a: torch.nn.Module, b: torch.nn.Module) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype, k
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0, msg=k)


def umt5_pair(seed=1, **kw):
    cfg_j = umt5_j.UMT5Config(**T5_KW, dtype=jnp.float32, **kw)
    params = randomize(lambda: umt5_j.init_umt5_params(jax.random.PRNGKey(0), cfg_j), seed)
    model = load_umt5(umt5_t.UMT5(umt5_t.UMT5Config(**T5_KW, **F32, **kw)), params)
    return cfg_j, params, model


def clip_pair(seed=2, **kw):
    kw = {**CLIP_KW, **kw}
    cfg_j = clip_j.CLIPVisionConfig(**kw, dtype=jnp.float32)
    params = randomize(lambda: clip_j.init_clip_vision_params(jax.random.PRNGKey(0), cfg_j),
                       seed)
    model = load_clip(clip_t.CLIPVision(clip_t.CLIPVisionConfig(**kw, **F32)), params)
    return cfg_j, params, model


@pytest.mark.parametrize("length,buckets,max_dist", [(6, 8, 16), (512, 32, 128), (77, 32, 20)])
def test_relative_position_buckets_equal_jax(length, buckets, max_dist):
    want = umt5_j.relative_position_buckets(length, buckets, max_dist)
    got = umt5_t.relative_position_buckets(length, buckets, max_dist)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ragged", [True, False])
def test_umt5_matches_jax(ragged):
    """``encode_ids`` with a ragged mask (keys past each length masked,
    outputs there zeroed) and without padding."""
    cfg_j, params, model = umt5_pair()
    rng = np.random.default_rng(3)
    ids = rng.integers(0, cfg_j.vocab_size, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    if ragged:
        mask[0, 5:] = 0
        mask[1, 11:] = 0
    want = np.asarray(umt5_j.UMT5TextEncoder(params, cfg_j).encode_ids(jnp.asarray(ids),
                                                                      jnp.asarray(mask)))
    got = umt5_t.UMT5TextEncoder(model).encode_ids(torch.from_numpy(ids),
                                                   torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (2, 12, cfg_j.dim)
    assert peak_db(got, want) >= MIN_DB
    np.testing.assert_array_equal(got[mask == 0], 0.0)
    # padded keys do not reach the valid outputs
    ids2 = ids.copy()
    ids2[0, 5:] = (ids2[0, 5:] + 1) % cfg_j.vocab_size
    again = umt5_t.umt5_encode(model, torch.from_numpy(ids2), torch.from_numpy(mask)).numpy()
    if ragged:
        np.testing.assert_allclose(again[0, :5], got[0, :5], atol=1e-5)


@pytest.mark.parametrize("penultimate", [True, False])
def test_clip_forward_matches_jax(penultimate):
    cfg_j, params, model = clip_pair()
    rng = np.random.default_rng(4)
    pixels = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)
    want = np.asarray(clip_j.clip_vision_forward(params, cfg_j, jnp.asarray(pixels),
                                                 penultimate=penultimate))
    got = clip_t.clip_vision_forward(model, torch.from_numpy(pixels), penultimate).detach()
    assert got.shape == want.shape == (2, cfg_j.num_tokens, cfg_j.dim)
    assert peak_db(got.numpy(), want) >= MIN_DB


@pytest.mark.parametrize("shape,size,tol", [((1, 3, 720, 1280), 224, 1e-6),
                                            ((1, 3, 100, 100), 224, 1e-5),
                                            ((2, 3, 37, 53), 28, 1e-5)])
def test_clip_preprocess_matches_jax(shape, size, tol):
    """The antialiased bicubic of ``jax.image.resize``: the 720p frame the
    edit feeds CLIP, an upsample and an odd downsample."""
    x = np.random.default_rng(5).uniform(-1, 1, shape).astype(np.float32)
    want = np.asarray(clip_j.preprocess(jnp.asarray(x), size))
    got = clip_t.preprocess(torch.from_numpy(x), size).numpy()
    assert got.shape == want.shape == shape[:2] + (size, size)
    assert float(np.abs(got - want).max()) <= tol


def test_clip_image_encoder_matches_jax():
    """[-1, 1] images through ``preprocess`` and the penultimate tower."""
    cfg_j, params, model = clip_pair()
    img = np.random.default_rng(6).uniform(-1, 1, (1, 3, 45, 80)).astype(np.float32)
    want = np.asarray(clip_j.CLIPImageEncoder(params, cfg_j)(jnp.asarray(img)))
    got = clip_t.CLIPImageEncoder(model)(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape
    assert peak_db(got, want) >= MIN_DB


def umt5_reference_sd(params, cfg) -> dict:
    """The reference file's names from a JAX tree (numpy)."""
    sd = {"token_embedding.weight": params["token_embedding"],
          "norm.weight": params["norm"]["scale"], "unused.weight": np.zeros(3, np.float32)}
    for i in range(cfg.num_layers):
        blk = jax.tree_util.tree_map(lambda a: np.asarray(a)[i], params["blocks"])
        sd[f"blocks.{i}.norm1.weight"] = blk["norm1"]["scale"]
        sd[f"blocks.{i}.norm2.weight"] = blk["norm2"]["scale"]
        for k in "qkvo":
            sd[f"blocks.{i}.attn.{k}.weight"] = blk["attn"][k]["kernel"].T
        sd[f"blocks.{i}.ffn.gate.0.weight"] = blk["ffn"]["gate"]["kernel"].T
        sd[f"blocks.{i}.ffn.fc1.weight"] = blk["ffn"]["fc1"]["kernel"].T
        sd[f"blocks.{i}.ffn.fc2.weight"] = blk["ffn"]["fc2"]["kernel"].T
        sd[f"blocks.{i}.pos_embedding.embedding.weight"] = blk["rel_emb"]
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def clip_reference_sd(params, cfg) -> dict:
    """The open-clip file's names (visual tower, a text-tower key, the
    visual head) from a JAX tree (numpy); the patch embedding as Conv2d."""
    p = cfg.patch_size
    kern = np.asarray(params["patch_embed"]["kernel"])
    sd = {"visual.patch_embedding.weight": kern.T.reshape(cfg.dim, 3, p, p),
          "visual.cls_embedding": params["cls_embedding"],
          "visual.pos_embedding": params["pos_embedding"],
          "visual.head": np.zeros((cfg.dim, 4), np.float32),
          "textual.token_embedding.weight": np.zeros((5, 4), np.float32)}
    for n in ("pre_norm", "post_norm"):
        sd[f"visual.{n}.weight"] = params[n]["scale"]
        sd[f"visual.{n}.bias"] = params[n]["bias"]
    for i in range(cfg.num_layers):
        blk = jax.tree_util.tree_map(lambda a: np.asarray(a)[i], params["blocks"])
        b = f"visual.transformer.{i}"
        for ref, node in (("norm1", blk["norm1"]), ("norm2", blk["norm2"])):
            sd[f"{b}.{ref}.weight"], sd[f"{b}.{ref}.bias"] = node["scale"], node["bias"]
        for ref, node in (("attn.to_qkv", blk["attn"]["qkv"]), ("attn.proj", blk["attn"]["proj"]),
                          ("mlp.0", blk["mlp"]["fc1"]), ("mlp.2", blk["mlp"]["fc2"])):
            sd[f"{b}.{ref}.weight"], sd[f"{b}.{ref}.bias"] = node["kernel"].T, node["bias"]
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


@pytest.mark.parametrize("which", ["umt5", "clip"])
def test_encoder_converters_equal_jax_bitwise(which):
    """The reference files' state dicts through JAX's converter and
    ``from_jax``, and through the port's converter: the same bits."""
    if which == "umt5":
        cfg_j, params, _ = umt5_pair()
        sd = umt5_reference_sd(params, cfg_j)
        want = load_umt5(umt5_t.UMT5(umt5_t.UMT5Config(**T5_KW, **F32)),
                         umt5_j.convert_umt5_checkpoint(sd, num_layers=cfg_j.num_layers))
        got = umt5_t.convert_umt5_checkpoint({k: torch.from_numpy(v) for k, v in sd.items()},
                                             umt5_t.UMT5Config(**T5_KW, **F32))
    else:
        cfg_j, params, _ = clip_pair()
        sd = clip_reference_sd(params, cfg_j)
        want = load_clip(clip_t.CLIPVision(clip_t.CLIPVisionConfig(**CLIP_KW, **F32)),
                         clip_j.convert_clip_vision_checkpoint(sd, num_layers=cfg_j.num_layers))
        got = clip_t.convert_clip_vision_checkpoint(
            {k: torch.from_numpy(v) for k, v in sd.items()},
            clip_t.CLIPVisionConfig(**CLIP_KW, **F32))
    state_equal(got, want)


def test_encoders_store_jax_precisions():
    """At the default (bf16) configs, the UMT5 parameters and CLIP's linears
    and embeddings are bf16, CLIP's LayerNorms fp32 (JAX keeps those at
    full precision and casts the rest at use); an fp16 CLIP file's LayerNorm
    values survive exactly."""
    t5 = umt5_t.UMT5(umt5_t.UMT5Config(**T5_KW), device="meta")
    assert {p.dtype for p in t5.parameters()} == {torch.bfloat16}
    cfg = clip_t.CLIPVisionConfig(**CLIP_KW)
    _, params, _ = clip_pair()
    sd = {k: torch.from_numpy(v).half() for k, v in clip_reference_sd(params, cfg).items()}
    model = clip_t.convert_clip_vision_checkpoint(sd, cfg)
    for name, p in model.named_parameters():
        assert p.dtype == (torch.float32 if "norm" in name else torch.bfloat16), name
    torch.testing.assert_close(model.pre_norm.scale, sd["visual.pre_norm.weight"].float(),
                               rtol=0, atol=0)
    torch.testing.assert_close(model.blocks[0].attn.qkv.weight,
                               sd["visual.transformer.0.attn.to_qkv.weight"].bfloat16(),
                               rtol=0, atol=0)


def xlmr_reference_sd(cfg, rng) -> dict:
    """A reference XLM-R state dict of random values."""
    d = cfg.dim
    sd = {"token_embedding.weight": rng.standard_normal((cfg.vocab_size, d)),
          "type_embedding.weight": rng.standard_normal((cfg.type_size, d)),
          "pos_embedding.weight": rng.standard_normal((cfg.max_seq_len, d)),
          "norm.weight": 1 + 0.1 * rng.standard_normal(d),
          "norm.bias": 0.1 * rng.standard_normal(d)}
    for i in range(cfg.num_layers):
        b = f"blocks.{i}"
        for n in "qkvo":
            sd[f"{b}.attn.{n}.weight"] = rng.standard_normal((d, d)) / np.sqrt(d)
            sd[f"{b}.attn.{n}.bias"] = 0.1 * rng.standard_normal(d)
        for n in ("norm1", "norm2"):
            sd[f"{b}.{n}.weight"] = 1 + 0.1 * rng.standard_normal(d)
            sd[f"{b}.{n}.bias"] = 0.1 * rng.standard_normal(d)
        sd[f"{b}.ffn.0.weight"] = rng.standard_normal((4 * d, d)) / np.sqrt(d)
        sd[f"{b}.ffn.0.bias"] = 0.1 * rng.standard_normal(4 * d)
        sd[f"{b}.ffn.2.weight"] = rng.standard_normal((d, 4 * d)) / np.sqrt(4 * d)
        sd[f"{b}.ffn.2.bias"] = 0.1 * rng.standard_normal(d)
    if cfg.out_dim is not None:
        mid = (d + cfg.out_dim) // 2
        sd["head.0.weight"] = rng.standard_normal((mid, d)) / np.sqrt(d)
        sd["head.2.weight"] = rng.standard_normal((cfg.out_dim, mid)) / np.sqrt(mid)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("post_norm,out_dim", [(True, None), (False, None), (True, 6),
                                               (False, 6)])
def test_xlm_roberta_matches_jax(post_norm, out_dim):
    """Both norm orders, with and without the pooled head, on random weights
    (tests/test_xlm_roberta.py needs the reference tree, which is absent);
    the port converts the same state dict itself and through ``from_jax``,
    to the same bits."""
    kw = dict(vocab_size=50, max_seq_len=20, dim=16, num_heads=2, num_layers=2,
              post_norm=post_norm, out_dim=out_dim)
    cfg_j, cfg_t = xlmr_j.XLMRobertaConfig(**kw), xlmr_t.XLMRobertaConfig(**kw)
    rng = np.random.default_rng(7)
    sd = xlmr_reference_sd(cfg_t, rng)
    params = xlmr_j.convert_xlm_roberta(sd, cfg_j.num_layers)
    ids = rng.integers(2, cfg_j.vocab_size, (2, 9)).astype(np.int32)
    ids[0, 6:] = cfg_j.pad_id  # ragged: the second sequence is full
    want = np.asarray(xlmr_j.xlm_roberta_encode(
        jax.tree_util.tree_map(jnp.asarray, params), cfg_j, jnp.asarray(ids)))
    model = xlmr_t.convert_xlm_roberta({k: torch.from_numpy(v) for k, v in sd.items()}, cfg_t)
    state_equal(model, load_xlm_roberta(xlmr_t.XLMRoberta(cfg_t), params))
    with torch.no_grad():
        got = xlmr_t.xlm_roberta_encode(model, torch.from_numpy(ids).long()).numpy()
    assert got.shape == want.shape == ((2, 9, 16) if out_dim is None else (2, out_dim))
    assert peak_db(got, want) >= MIN_DB


@pytest.mark.parametrize("case", ["zeros", "empty_emb", "negative"])
def test_conditioner_pairs_match_jax(case):
    """``condition_uncondition``: zero nulls, the empty-prompt embedding,
    and a negative prompt that overrides the null."""
    rng = np.random.default_rng(8)

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    text, img = randn(2, 4, 6), randn(2, 3, 5)
    empty = randn(1, 4, 6) if case == "empty_emb" else None
    neg = {"text_emb": randn(2, 4, 6)} if case == "negative" else None
    batch = {"text_emb": text, "image_emb": img}

    def as_(conv, tree):
        return None if tree is None else {k: conv(v) for k, v in tree.items()}

    cj = cond_j.edit_conditioner(None if empty is None else jnp.asarray(empty))
    ct = cond_t.edit_conditioner(None if empty is None else torch.from_numpy(empty))
    want = cj.condition_uncondition(as_(jnp.asarray, batch), negative=as_(jnp.asarray, neg))
    got = ct.condition_uncondition(as_(torch.from_numpy, batch),
                                   negative=as_(torch.from_numpy, neg))
    for w_, g_ in zip(want, got):
        assert w_.keys() == g_.keys()
        for k in w_:
            np.testing.assert_array_equal(g_[k].numpy(), np.asarray(w_[k]))


@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_conditioner_dropout_matches_jax_where_draws_cannot_matter(rate):
    """Rates 0 and 1 give the same batch whatever the draws; the image key
    (rate 0 in the recipe) is never touched."""
    rng = np.random.default_rng(9)
    empty = rng.standard_normal((1, 4, 6)).astype(np.float32)
    batch = {"text_emb": rng.standard_normal((3, 4, 6)).astype(np.float32),
             "image_emb": rng.standard_normal((3, 2)).astype(np.float32)}
    want = cond_j.edit_conditioner(jnp.asarray(empty), text_dropout=rate)(
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    got = cond_t.edit_conditioner(torch.from_numpy(empty), text_dropout=rate)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator().manual_seed(0))
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    if rate == 1.0:
        np.testing.assert_array_equal(got["text_emb"].numpy(),
                                      np.broadcast_to(empty, batch["text_emb"].shape))


@pytest.fixture(scope="module")
def encoder_pipelines():
    """The tiny edit pipeline with a UMT5 of the DiT's text width and a CLIP
    tower whose 5 tokens x 10 channels are the DiT's image input."""
    from chronoedit_tpu.models import dit as dit_j
    from chronoedit_tpu.models import vae as vae_j

    cfg_j, cfg_t = tiny_j(), tiny_t()
    dit_p = randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg_j.dit), 5)
    vae_p = randomize(lambda: vae_j.init_vae_params(jax.random.PRNGKey(1), cfg_j.vae), 6,
                      fan_in=lambda s: int(np.prod(s[:-1])))
    t5_cfg_j, t5_p, t5 = umt5_pair(seed=11)
    clip_cfg_j, clip_p, clip = clip_pair(seed=12, dim=cfg_t.dit.image_dim, num_heads=2,
                                         num_layers=2)
    pipe_j = PipeJ(cfg_j, dit_p, vae_p, text_encoder=umt5_j.UMT5TextEncoder(t5_p, t5_cfg_j),
                   image_encoder=clip_j.CLIPImageEncoder(clip_p, clip_cfg_j))
    pipe_t = PipeT(cfg_t, load_dit(dit_t.DiT(cfg_t.dit), dit_p),
                   load_vae(vae_t.VAE(cfg_t.vae), vae_p),
                   text_encoder=umt5_t.UMT5TextEncoder(t5),
                   image_encoder=clip_t.CLIPImageEncoder(clip))
    return pipe_j, pipe_t


def test_pipeline_encodes_then_edits_like_jax(encoder_pipelines):
    """Token ids and an image through the attached encoders, then the 4-step
    edit from those embeddings: each stage against JAX's (JAX's
    ``encode_prompt`` takes a string, whose tokenizer is a download, so its
    side calls ``encode_ids``)."""
    pipe_j, pipe_t = encoder_pipelines
    rng = np.random.default_rng(13)
    ids = rng.integers(0, T5_KW["vocab_size"], (1, 6)).astype(np.int32)
    mask = np.array([[1, 1, 1, 1, 0, 0]], np.int32)
    image = rng.uniform(-1, 1, (1, 3, 16, 16)).astype(np.float32)
    latents = rng.standard_normal((1, 4, 3, 8, 8)).astype(np.float32)

    prompt_j = pipe_j.text_encoder.encode_ids(jnp.asarray(ids), jnp.asarray(mask))
    image_j = pipe_j.encode_image(jnp.asarray(image))
    prompt_t = pipe_t.encode_prompt(torch.from_numpy(ids), torch.from_numpy(mask))
    image_t = pipe_t.encode_image(torch.from_numpy(image))
    assert peak_db(prompt_t.numpy(), prompt_j) >= MIN_DB
    assert peak_db(image_t.numpy(), image_j) >= MIN_DB

    want = np.asarray(pipe_j.edit_image(jnp.asarray(image), prompt_j, image_emb=image_j,
                                        latents=jnp.asarray(latents)))
    got = pipe_t.edit_image(torch.from_numpy(image), prompt_t, image_emb=image_t,
                            latents=torch.from_numpy(latents)).numpy()
    assert got.shape == want.shape == (1, 3, 16, 16)
    mse = float(np.mean((got.astype(np.float64) - want) ** 2))
    assert 10.0 * np.log10(2.0 ** 2 / mse) >= MIN_DB  # PSNR over the [-1, 1] range


def test_encode_without_encoders_raises():
    cfg = tiny_t()
    pipe = PipeT(cfg, dit_t.DiT(cfg.dit, device="meta"), vae_t.VAE(cfg.vae, device="meta"))
    with pytest.raises(ValueError, match="text_encoder"):
        pipe.encode_prompt(torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(ValueError, match="image_encoder"):
        pipe.encode_image(torch.zeros((1, 3, 8, 8)))
