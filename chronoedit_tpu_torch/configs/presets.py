"""Model presets, the same as ``chronoedit_tpu/configs/presets.py`` with
torch dtypes."""

from __future__ import annotations

import dataclasses

import torch

from chronoedit_tpu_torch.core.rope import Rope3DSpec
from chronoedit_tpu_torch.models.dit import DiTConfig
from chronoedit_tpu_torch.models.vae import VAEConfig
from chronoedit_tpu_torch.pipeline.edit_pipeline import PipelineConfig


def chronoedit_14b(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                   remat: str = "none") -> PipelineConfig:
    """The full ChronoEdit-14B edit model."""
    return PipelineConfig(
        dit=DiTConfig(
            patch_size=(1, 2, 2),
            num_heads=40,
            head_dim=128,
            in_channels=36,
            out_channels=16,
            text_dim=4096,
            freq_dim=256,
            ffn_dim=13824,
            num_layers=40,
            image_dim=1280,
            image_tokens=257,
            temporal_skip=True,
            rope=Rope3DSpec(head_dim=128, temporal_skip_len=8),
            dtype=dtype,
            param_dtype=param_dtype,
            remat=remat,
        ),
        vae=VAEConfig(dtype=dtype, param_dtype=param_dtype),
        num_steps=50,
        guidance_scale=5.0,
        flow_shift=5.0,
    )


def chronoedit_14b_distilled(**kw) -> PipelineConfig:
    """8-step distilled sampling defaults: guidance 1.0, flow shift 2.0."""
    return dataclasses.replace(chronoedit_14b(**kw), num_steps=8,
                               guidance_scale=1.0, flow_shift=2.0)


def chronoedit_tiny(dtype=torch.float32) -> PipelineConfig:
    """Tiny architecture-faithful config for tests and smoke runs."""
    return PipelineConfig(
        dit=DiTConfig(
            patch_size=(1, 2, 2),
            num_heads=2,
            head_dim=12,
            in_channels=10,  # 4 latent + (2 mask + 4 cond latent) channels
            out_channels=4,
            text_dim=16,
            freq_dim=8,
            ffn_dim=32,
            num_layers=2,
            image_dim=10,
            image_tokens=5,
            temporal_skip=True,
            rope=Rope3DSpec(head_dim=12, temporal_skip_len=8),
            dtype=dtype,
            param_dtype=torch.float32,
        ),
        vae=VAEConfig(dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
                      temporal_downsample=(True,), dtype=dtype),
        num_steps=4,
        guidance_scale=2.0,
        flow_shift=2.0,
    )


EXPERIMENTS = {
    "chronoedit_14b": chronoedit_14b,
    "chronoedit_14b_distilled": chronoedit_14b_distilled,
    "tiny": chronoedit_tiny,
}


def get_experiment(name: str, **kw) -> PipelineConfig:
    """The preset registered under ``name``, built with ``kw``."""
    if name not in EXPERIMENTS:
        raise KeyError(f"unknown experiment {name!r}; have {sorted(EXPERIMENTS)}")
    return EXPERIMENTS[name](**kw)
