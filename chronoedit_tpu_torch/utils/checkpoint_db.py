"""Checkpoint registry: names -> artifact paths/URIs with local caching.

Equivalent of the reference's pydantic checkpoint DB
(``utils/checkpoint_db.py:31-120``): a declarative registry describing the
ChronoEdit model-zoo artifacts, resolvable against a local checkpoint root
(network fetch is environment-provided; zero-egress setups pre-stage files).

A verbatim copy of ``chronoedit_tpu/utils/checkpoint_db.py`` (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class CheckpointEntry:
    name: str
    relpath: str  # path under the checkpoint root
    kind: str  # "dit" | "vae" | "umt5" | "clip" | "lora"
    uri: str = ""  # canonical upstream source (informational)


REGISTRY: dict[str, CheckpointEntry] = {
    e.name: e
    for e in [
        CheckpointEntry(
            "chronoedit_14b_dit", "ChronoEdit-14B/transformer", "dit",
            "hf://nvidia/ChronoEdit-14B-Diffusers"),
        CheckpointEntry(
            "wan2.1_vae", "ChronoEdit-14B/Wan2.1_VAE.pth", "vae",
            "hf://nvidia/ChronoEdit-14B-Diffusers"),
        CheckpointEntry(
            "umt5_xxl_enc", "ChronoEdit-14B/models_t5_umt5-xxl-enc-bf16.pth",
            "umt5", "hf://nvidia/ChronoEdit-14B-Diffusers"),
        CheckpointEntry(
            "clip_vit_h",
            "ChronoEdit-14B/models_clip_open-clip-xlm-roberta-large-vit-huge-14_fp16.pth",
            "clip", "hf://nvidia/ChronoEdit-14B-Diffusers"),
        CheckpointEntry(
            "distill_lora", "ChronoEdit-14B/lora/chronoedit_distill_lora.safetensors",
            "lora", "hf://nvidia/ChronoEdit-14B-Diffusers"),
        CheckpointEntry(
            "paintbrush_lora", "ChronoEdit-14B/lora/paintbrush_lora.safetensors",
            "lora", "hf://nvidia/ChronoEdit-14B-Diffusers"),
        CheckpointEntry(
            "upscaler_lora", "ChronoEdit-14B/lora/upscale_lora.safetensors",
            "lora", "hf://nvidia/ChronoEdit-14B-Diffusers"),
    ]
}


def resolve(name: str, root: str = "./checkpoints") -> str:
    """Registry name -> local path; raises with provenance info if absent."""
    if name not in REGISTRY:
        raise KeyError(f"unknown checkpoint {name!r}; have {sorted(REGISTRY)}")
    entry = REGISTRY[name]
    path = os.path.join(root, entry.relpath)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint {name!r} not staged at {path} (source: {entry.uri})")
    return path
