"""Checkpoint import, LoRA files and loading against the JAX package, fp32
on the CPU at the tiny presets (the port's counterpart of
tests/test_lora_weights.py).

The same fake reference state dicts (fp32, which JAX's
``safetensors.numpy`` can read) go through JAX's converters and
``models/from_jax.py``, and through the port's converters: the module
weights must be bitwise equal. The loaded tiny pipeline's edit must match
JAX's ``load_pipeline`` on the same files at 60 dB over the [-1, 1] range
(the repo's fp32 bar).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.configs import chronoedit_tiny as tiny_j
from chronoedit_tpu.models import dit as dit_j
from chronoedit_tpu.models import lora as lora_j
from chronoedit_tpu.models import vae as vae_j
from chronoedit_tpu.models import weights as weights_j
from chronoedit_tpu.pipeline.loader import load_pipeline as load_pipeline_j
from chronoedit_tpu_torch.configs import chronoedit_tiny as tiny_t
from chronoedit_tpu_torch.models import clip as clip_t
from chronoedit_tpu_torch.models import dit as dit_t
from chronoedit_tpu_torch.models import lora as lora_t
from chronoedit_tpu_torch.models import umt5 as umt5_t
from chronoedit_tpu_torch.models import vae as vae_t
from chronoedit_tpu_torch.models import weights as weights_t
from chronoedit_tpu_torch.models.from_jax import load_dit, load_lora, load_vae
from chronoedit_tpu_torch.pipeline.loader import load_pipeline as load_pipeline_t
from test_loader_e2e import _write_vae_pth
from test_torch_dit import randomize
from test_torch_encoders import (CLIP_KW, T5_KW, clip_pair, clip_reference_sd,
                                 state_equal, umt5_pair, umt5_reference_sd)

torch.set_num_threads(2)

CPU = torch.device("cpu")
MIN_PSNR_DB = 60.0
CFG_J, CFG_T = tiny_j(), tiny_t()


def psnr(got, want) -> float:
    mse = float(np.mean((np.asarray(got, np.float64) - np.asarray(want, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(2.0 ** 2 / mse)


def as_torch(sd: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def trees():
    """Numpy DiT and VAE trees in the JAX layout, and the port modules
    holding the same values."""
    dit_p = randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), CFG_J.dit), 21)
    vae_p = randomize(lambda: vae_j.init_vae_params(jax.random.PRNGKey(1), CFG_J.vae), 22,
                      fan_in=lambda s: int(np.prod(s[:-1])))
    return (dit_p, vae_p, load_dit(dit_t.DiT(CFG_T.dit), dit_p),
            load_vae(vae_t.VAE(CFG_T.vae), vae_p))


def diffusers_sd(dit_p) -> dict:
    """JAX's diffusers export with the patch embedding as the reference's
    Conv3d (out, in, kt, kh, kw)."""
    sd = weights_j.export_diffusers_dit(dit_p)
    pe = sd["patch_embedding.weight"]
    sd["patch_embedding.weight"] = pe.reshape(pe.shape[0], CFG_J.dit.in_channels,
                                              *CFG_J.dit.patch_size)
    return sd


def invert(names: dict, model: torch.nn.Module, shapes=None) -> dict:
    """A reference state dict (numpy) from a port module by a name table;
    ``shapes(ref, value)`` gives the reference's shape of each value."""
    params = dict(model.named_parameters())
    out = {}
    for ref, name in names.items():
        v = params[name].detach().numpy()
        out[ref] = v.reshape(shapes(ref, v)) if shapes else v
    return out


def native_shape(ref, v):
    return (1,) + v.shape if ref.endswith("modulation") else v.shape


@pytest.mark.parametrize("dialect,prefix", [("diffusers", ""), ("diffusers", "transformer."),
                                            ("diffusers", "model.diffusion_model."),
                                            ("native", "net.")])
def test_dit_converters_equal_jax_bitwise(trees, dialect, prefix):
    dit_p, _, dit, _ = trees
    if dialect == "diffusers":
        sd = {**diffusers_sd(dit_p),
              "blocks.0.attn2.norm_added_q.weight": np.ones(CFG_J.dit.dim, np.float32)}
        convert_j, convert_t = weights_j.convert_diffusers_dit, weights_t.convert_diffusers_dit
    else:
        sd = {**invert(weights_t.native_dit_names(CFG_T.dit), dit, native_shape),
              "accum_steps": np.zeros(1, np.float32),
              "blocks.0.self_attn._extra_state": np.zeros(2, np.float32)}
        convert_j, convert_t = weights_j.convert_native_dit, weights_t.convert_native_dit
    sd = {prefix + k: v for k, v in sd.items()}
    want = load_dit(dit_t.DiT(CFG_T.dit), convert_j(sd, num_layers=CFG_J.dit.num_layers))
    got = convert_t(as_torch(sd), CFG_T.dit, CPU)
    state_equal(got, want)
    state_equal(got, dit)


def vae_shape(ref, v):
    """The reference's shapes: RMS gains (C, 1, 1, 1), the spatial resample
    a Conv2d."""
    if ref.endswith(".gamma"):
        return (v.shape[0], 1, 1, 1)
    if ".resample." in ref and ref.endswith(".weight"):
        return v.shape[:2] + v.shape[3:]
    return v.shape


def test_vae_converter_equals_jax_bitwise(trees):
    _, _, _, vae = trees
    sd = invert(weights_t.wan_vae_names(CFG_T.vae), vae, vae_shape)
    v = CFG_J.vae
    want = load_vae(vae_t.VAE(CFG_T.vae), weights_j.convert_wan_vae(
        sd, dim_mult=v.dim_mult, num_res_blocks=v.num_res_blocks,
        temporal_downsample=v.temporal_downsample))
    got = weights_t.convert_wan_vae(as_torch(sd), CFG_T.vae, CPU)
    state_equal(got, want)
    state_equal(got, vae)


RANK = 3


def lora_file(dialect: str) -> dict:
    """A LoRA state dict (numpy) in ``dialect`` over two targets, one of
    them in layer 1 only, with alpha 6 (scaling 2)."""
    rng = np.random.default_rng(31)
    d, f = CFG_J.dit.dim, CFG_J.dit.ffn_dim
    entries = [("attn1.to_q", "self_attn_q", 0, d, d), ("attn1.to_q", "self_attn_q", 1, d, d),
               ("ffn.net.0.proj", "ffn_0", 1, d, f)]
    sd = {}
    for mod, musubi, i, din, dout in entries:
        a = rng.standard_normal((RANK, din)).astype(np.float32)
        b = rng.standard_normal((dout, RANK)).astype(np.float32)
        if dialect == "diffusers":
            base = f"transformer.blocks.{i}.{mod}"
            sd[f"{base}.lora_A.weight"], sd[f"{base}.lora_B.weight"] = a, b
            sd[f"{base}.alpha"] = np.float32(2 * RANK)
        else:
            base = f"lora_unet_blocks_{i}_{musubi}"
            sd[f"{base}.lora_down.weight"], sd[f"{base}.lora_up.weight"] = a, b
            sd[f"{base}.alpha"] = np.float32(2 * RANK)
    return sd


def port_lora(tree: dict, targets: tuple) -> lora_t.LoRA:
    lora = lora_t.LoRA(dit_t.DiT(CFG_T.dit), lora_t.LoRAConfig(rank=RANK, alpha=RANK,
                                                                 targets=targets))
    return load_lora(lora, tree)


@pytest.mark.parametrize("dialect", ["diffusers", "musubi"])
def test_lora_converters_equal_jax_bitwise(dialect):
    sd = lora_file(dialect)
    convert_j = (weights_j.convert_diffusers_lora if dialect == "diffusers"
                 else weights_j.convert_musubi_lora)
    convert_t = (weights_t.convert_diffusers_lora if dialect == "diffusers"
                 else weights_t.convert_musubi_lora)
    tree, scaling_j = convert_j(sd, num_layers=CFG_J.dit.num_layers)
    got, scaling_t = convert_t(as_torch(sd), CFG_T.dit, CPU)
    assert scaling_t == scaling_j == 2.0
    assert got.cfg.targets == ("self_attn/q", "ffn/fc1") and got.cfg.scaling == 1.0
    state_equal(got, port_lora(tree, got.cfg.targets))
    assert not got.blocks[0]["ffn"]["fc1"].a.any()  # layer 0 absent -> zeros


def test_diffusers_lora_converter_raises_on_other_dialects():
    """JAX's diffusers converter returns an empty adapter for a musubi file,
    so its loader's musubi fallback (on ValueError) never runs; the port's
    raises, so that its loader's does."""
    sd = lora_file("musubi")
    tree, _ = weights_j.convert_diffusers_lora(sd, num_layers=CFG_J.dit.num_layers)
    assert tree == {"blocks": {}}
    with pytest.raises(ValueError, match="no diffusers LoRA keys"):
        weights_t.convert_diffusers_lora(as_torch(sd), CFG_T.dit, CPU)


@pytest.mark.parametrize("what", ["dit", "lora"])
def test_exports_round_trip_bitwise(trees, what):
    """Export then convert gives the same bits, and the export equals JAX's
    export of the same tree (names, shapes and values)."""
    dit_p, _, dit, _ = trees
    if what == "dit":
        sd = weights_t.export_diffusers_dit(dit)
        want = weights_j.export_diffusers_dit(dit_p)
        state_equal(weights_t.convert_diffusers_dit(sd, CFG_T.dit, CPU), dit)
    else:
        lora_sd = lora_file("diffusers")
        tree, _ = weights_j.convert_diffusers_lora(lora_sd, num_layers=CFG_J.dit.num_layers)
        lora = port_lora(tree, ("self_attn/q", "ffn/fc1"))
        sd = weights_t.export_diffusers_lora(lora, alpha=6.0)
        want = weights_j.export_diffusers_lora(tree, alpha=6.0)
        back, scaling = weights_t.convert_diffusers_lora(sd, CFG_T.dit, CPU)
        assert scaling == 2.0
        state_equal(back, lora)
    assert sd.keys() == want.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_merge_multi_lora_rounds_each_adapter_like_jax(trees):
    """Two adapters merged into a bf16 DiT: JAX adds each in fp32 and rounds
    to bf16 before the next, and so must the port, to the bit. The
    adapters' values are multiples of 1/8 and 1/64, so a @ b is exact in
    fp32 whatever the summation order, and only the rounding order is under
    test; summing the deltas first gives other bits here."""
    dit_p, _, _, _ = trees
    rng = np.random.default_rng(41)
    n, d = CFG_J.dit.num_layers, CFG_J.dit.dim
    cfg = lora_t.LoRAConfig(rank=2, alpha=4.0, targets=("self_attn/q", "ffn/fc1"))
    cfg_j = lora_j.LoRAConfig(rank=2, alpha=4.0, targets=cfg.targets)

    def adapter():
        def ab(dout):
            return {"a": rng.integers(-4, 5, (n, d, 2)).astype(np.float32) / 8,
                    "b": rng.integers(-4, 5, (n, 2, dout)).astype(np.float32) / 64}
        return {"blocks": {"self_attn": {"q": ab(d)}, "ffn": {"fc1": ab(CFG_J.dit.ffn_dim)}}}

    l1, l2 = adapter(), adapter()
    bf16_j = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), dit_p)
    merged_j = lora_j.merge_multi_lora(bf16_j, {"one": (l1, 0.7), "two": (l2, 0.5)}, cfg_j)
    want = load_dit(dit_t.DiT(dataclasses.replace(CFG_T.dit, param_dtype=torch.bfloat16)),
                    jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                           merged_j))
    base = dit_t.DiT(dataclasses.replace(CFG_T.dit, param_dtype=torch.bfloat16))
    load_dit(base, dit_p)
    adapters = {"one": (load_lora(lora_t.LoRA(base, cfg), l1), 0.7),
                "two": (load_lora(lora_t.LoRA(base, cfg), l2), 0.5)}
    got = lora_t.merge_multi_lora(base, adapters)
    state_equal(got, want)
    # the input is untouched
    assert not torch.equal(got.blocks[0].self_attn.q.weight, base.blocks[0].self_attn.q.weight)
    # the other order of rounding: both deltas summed, rounded once
    w = dit_t.DiT(dataclasses.replace(CFG_T.dit, param_dtype=torch.bfloat16))
    load_dit(w, dit_p)
    lin = w.blocks[0].self_attn.q
    delta = sum(cfg.scaling * s * (ad.blocks[0]["self_attn"]["q"].a
                                   @ ad.blocks[0]["self_attn"]["q"].b)
                for ad, s in adapters.values())
    summed = (lin.weight.float() + delta.T).to(torch.bfloat16)
    assert not torch.equal(summed, got.blocks[0].self_attn.q.weight)


def test_bf16_files_load_bitwise(trees, tmp_path, monkeypatch):
    """bf16 safetensors shards and a bf16 torch file (which JAX's numpy
    reader cannot take) load into bf16 modules bit for bit; listing the
    shards and testing a key read no tensor, and the converter reads each
    tensor once, shard by shard in file order."""
    from safetensors.torch import save_file

    reads = []
    real_get = weights_t.SafetensorsFiles.__getitem__
    monkeypatch.setattr(weights_t.SafetensorsFiles, "__getitem__",
                        lambda self, key: reads.append(key) or real_get(self, key))

    _, _, dit, vae = trees
    dcfg = dataclasses.replace(CFG_T.dit, param_dtype=torch.bfloat16)
    src = dit_t.DiT(dcfg)
    src.load_state_dict(dit.state_dict())
    sd = weights_t.export_diffusers_dit(src)
    keys = sorted(sd)
    paths = [str(tmp_path / f"dit-{i}.safetensors") for i in range(2)]
    save_file({k: sd[k] for k in keys[::2]}, paths[0])
    save_file({k: sd[k] for k in keys[1::2]}, paths[1])
    files = weights_t.load_safetensors(paths)
    assert len(files) == len(sd) and keys[1] in files and "absent" not in files
    assert not reads
    state_equal(weights_t.convert_diffusers_dit(files, dcfg, CPU), src)
    assert reads == keys[::2] + keys[1::2] and files[keys[1]].dtype == torch.bfloat16

    vcfg = dataclasses.replace(CFG_T.vae, param_dtype=torch.bfloat16)
    vsrc = vae_t.VAE(vcfg)
    vsrc.load_state_dict(vae.state_dict())
    params = dict(vsrc.named_parameters())
    vsd = {ref: params[name].detach().reshape(vae_shape(ref, params[name]))
           for ref, name in weights_t.wan_vae_names(vcfg).items()}
    torch.save({"state_dict": vsd}, tmp_path / "vae.pth")
    files = weights_t.load_torch(str(tmp_path / "vae.pth"))
    assert files["conv1.weight"].dtype == torch.bfloat16
    state_equal(weights_t.convert_wan_vae(files, vcfg, CPU), vsrc)


def write_checkpoint(root, dit_p, vae_p) -> None:
    """The reference layout at the tiny preset: two fp32 DiT shards under
    transformer/ and Wan2.1_VAE.pth."""
    from safetensors.numpy import save_file

    (root / "transformer").mkdir(parents=True)
    sd = weights_j.export_diffusers_dit(dit_p)
    keys = sorted(sd)
    save_file({k: sd[k] for k in keys[: len(keys) // 2]},
              str(root / "transformer" / "model-00001.safetensors"))
    save_file({k: sd[k] for k in keys[len(keys) // 2:]},
              str(root / "transformer" / "model-00002.safetensors"))
    _write_vae_pth(str(root / "Wan2.1_VAE.pth"), vae_p)


def test_load_pipeline_matches_jax(trees, tmp_path):
    """A checkpoint directory with a diffusers LoRA at scale 0.8 through both
    loaders: the same weights to the bit, and the same 4-step edit."""
    from safetensors.numpy import save_file

    dit_p, vae_p, _, _ = trees
    write_checkpoint(tmp_path, dit_p, vae_p)
    lora_sd = lora_file("diffusers")
    lora_path = str(tmp_path / "edit_lora.safetensors")
    save_file({k: np.asarray(v) for k, v in lora_sd.items()}, lora_path)

    pipe_j = load_pipeline_j(CFG_J, str(tmp_path), loras=[(lora_path, 0.8)])
    pipe_t = load_pipeline_t(CFG_T, str(tmp_path), loras=[(lora_path, 0.8)], device=CPU)
    assert pipe_t.text_encoder is None and pipe_t.image_encoder is None
    assert set(pipe_t.load_seconds) == {"dit", "vae", "loras"}
    state_equal(pipe_t.dit, load_dit(dit_t.DiT(CFG_T.dit),
                                     jax.tree_util.tree_map(np.asarray, pipe_j.dit_params)))
    state_equal(pipe_t.vae, load_vae(vae_t.VAE(CFG_T.vae),
                                     jax.tree_util.tree_map(np.asarray, pipe_j.vae_params)))

    rng = np.random.default_rng(51)
    d = CFG_T.dit
    inp = dict(image=rng.uniform(-1, 1, (1, 3, 16, 16)),
               prompt_emb=rng.standard_normal((1, 6, d.text_dim)),
               image_emb=rng.standard_normal((1, d.image_tokens, d.image_dim)),
               latents=rng.standard_normal((1, 4, 3, 8, 8)))
    inp = {k: v.astype(np.float32) for k, v in inp.items()}
    want = np.asarray(pipe_j.edit_image(**{k: jnp.asarray(v) for k, v in inp.items()}))
    got = pipe_t.edit_image(**{k: torch.from_numpy(v) for k, v in inp.items()}).numpy()
    assert got.shape == want.shape == (1, 3, 16, 16)
    assert psnr(got, want) >= MIN_PSNR_DB


def test_load_pipeline_encoders_and_musubi_lora(trees, tmp_path, monkeypatch):
    """The UMT5 and CLIP files (bf16 and fp16, as the reference ships them)
    load after their casts (the encoders' default configs made tiny here);
    a musubi LoRA in a torch file goes through the diffusers-then-musubi
    choice and merges like the converted adapter."""
    dit_p, vae_p, dit, _ = trees
    write_checkpoint(tmp_path, dit_p, vae_p)
    t5_cfg_j, t5_p, _ = umt5_pair()
    clip_cfg_j, clip_p, _ = clip_pair()
    t5_sd = {k: torch.from_numpy(v).bfloat16()
             for k, v in umt5_reference_sd(t5_p, t5_cfg_j).items()}
    clip_sd = {k: torch.from_numpy(v).half()
               for k, v in clip_reference_sd(clip_p, clip_cfg_j).items()}
    torch.save(t5_sd, tmp_path / "models_t5_umt5-xxl-enc-bf16.pth")
    torch.save(clip_sd, tmp_path / "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth")
    lora_sd = lora_file("musubi")
    torch.save(as_torch(lora_sd), tmp_path / "musubi_lora.pt")

    t5_cfg, clip_cfg = umt5_t.UMT5Config(**T5_KW), clip_t.CLIPVisionConfig(**CLIP_KW)
    monkeypatch.setattr(umt5_t, "UMT5Config", lambda: t5_cfg)
    monkeypatch.setattr(clip_t, "CLIPVisionConfig", lambda: clip_cfg)
    pipe = load_pipeline_t(CFG_T, str(tmp_path), loras=[(str(tmp_path / "musubi_lora.pt"), 0.5)],
                           device=CPU)
    assert set(pipe.load_seconds) == {"dit", "vae", "loras", "text_encoder", "image_encoder"}
    state_equal(pipe.text_encoder.model, umt5_t.convert_umt5_checkpoint(t5_sd, t5_cfg))
    t5 = pipe.text_encoder.model
    torch.testing.assert_close(t5.blocks[1].rel_emb,
                               t5_sd["blocks.1.pos_embedding.embedding.weight"], rtol=0, atol=0)
    clip = pipe.image_encoder.model
    state_equal(clip, clip_t.convert_clip_vision_checkpoint(clip_sd, clip_cfg))
    assert clip.blocks[0].norm1.scale.dtype == torch.float32
    torch.testing.assert_close(clip.blocks[0].norm1.scale,
                               clip_sd["visual.transformer.0.norm1.weight"].float(), rtol=0, atol=0)

    adapter, scaling = weights_t.convert_musubi_lora(as_torch(lora_sd), CFG_T.dit, CPU)
    state_equal(pipe.dit, lora_t.merge_lora(dit, adapter, 0.5 * scaling))
    assert not torch.equal(pipe.dit.blocks[1].ffn.fc1.weight, dit.blocks[1].ffn.fc1.weight)
    # without the encoders asked for, none is built
    bare = load_pipeline_t(CFG_T, str(tmp_path), device=CPU, with_text_encoder=False,
                           with_image_encoder=False)
    assert bare.text_encoder is None and bare.image_encoder is None
    state_equal(bare.dit, dit)


def test_load_pipeline_runs_on_the_card_unless_given_the_cpu(tmp_path, monkeypatch):
    """No device means the CUDA card: without one it raises, never falls back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "transformer").mkdir()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_pipeline_t(CFG_T, str(tmp_path))
