"""Pipeline loading from a checkpoint directory (the ``from_pretrained``
experience), PyTorch.

The port of ``chronoedit_tpu/pipeline/loader.py``. The directory holds the
reference's files: diffusers DiT shards (``transformer/*.safetensors``, or
``*.safetensors`` at the top), ``Wan2.1_VAE.pth``, and optionally
``models_t5_umt5-xxl-enc-bf16.pth`` (UMT5-XXL), ``models_clip_*.pth``
(open-clip ViT-H; its visual tower) and LoRA files. Every tensor is read
from its file and copied into its parameter on the target device
(``models/weights.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import os
import time

import torch

from chronoedit_tpu_torch.models import lora as lora_lib
from chronoedit_tpu_torch.models import weights as w
from chronoedit_tpu_torch.pipeline.edit_pipeline import ChronoEditPipeline, PipelineConfig
from chronoedit_tpu_torch.utils.platform import cuda_device

T5_FILE = "models_t5_umt5-xxl-enc-bf16.pth"
VAE_FILE = "Wan2.1_VAE.pth"
CLIP_GLOB = "models_clip_*.pth"


def _seconds(device: torch.device, t0: float) -> float:
    """Host seconds since ``t0``, after the device's queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def load_pipeline(
    config: PipelineConfig,
    checkpoint_dir: str,
    loras: list[tuple[str, float]] | None = None,
    with_text_encoder: bool = True,
    with_image_encoder: bool = True,
    device: torch.device | None = None,
    guardrails=None,
) -> ChronoEditPipeline:
    """Load every staged component and fuse any LoRAs, on ``device``
    (default :func:`~utils.platform.cuda_device`: the CPU only when asked
    for).

    The DiT and the VAE are built in ``config.dit.param_dtype`` (JAX's cast
    of both, before any LoRA). ``loras`` are ``[(path, scale), ...]``
    (``.safetensors`` or a torch file), each read as the diffusers dialect,
    or as musubi's when that raises ValueError, and fused in order with
    ``scale`` times the file's alpha / rank, each rounded to the DiT's
    dtype before the next (``models/lora.merge_multi_lora``'s order). The
    encoders, UMT5-XXL and CLIP ViT-H/14 at their default configs as in
    JAX, load when their files are there and ``with_*`` asks for them.
    With several ``models_clip_*.pth``, the first in sorted order is taken.

    Seconds per component (``dit``, ``vae``, ``loras``, ``text_encoder``,
    ``image_encoder``) are kept in the pipeline's ``load_seconds``.
    ``guardrails`` (``aux/guardrails.Guardrails``) are attached to the
    pipeline. Not here (JAX has it): ``mesh`` (multi-device sharding).
    """
    from chronoedit_tpu_torch.models.clip import CLIPImageEncoder, convert_clip_vision_checkpoint
    from chronoedit_tpu_torch.models.umt5 import UMT5TextEncoder, convert_umt5_checkpoint

    device = cuda_device() if device is None else torch.device(device)
    seconds = {}
    shards = (sorted(glob.glob(os.path.join(checkpoint_dir, "transformer", "*.safetensors")))
              or sorted(glob.glob(os.path.join(checkpoint_dir, "*.safetensors"))))
    if not shards:
        raise FileNotFoundError(f"no DiT safetensors under {checkpoint_dir}")
    t0 = time.perf_counter()
    with w.load_safetensors(shards) as sd:
        dit = w.convert_diffusers_dit(sd, config.dit, device)
    seconds["dit"] = _seconds(device, t0)

    t0 = time.perf_counter()
    vae_cfg = dataclasses.replace(config.vae, param_dtype=config.dit.param_dtype)
    vae = w.convert_wan_vae(w.load_torch(os.path.join(checkpoint_dir, VAE_FILE)), vae_cfg,
                            device)
    seconds["vae"] = _seconds(device, t0)

    t0 = time.perf_counter()
    for path, scale in loras or []:
        with (w.load_safetensors(path) if path.endswith(".safetensors")
              else contextlib.nullcontext(w.load_torch(path))) as sd:
            try:
                adapter, scaling = w.convert_diffusers_lora(sd, config.dit, device)
            except ValueError:
                adapter, scaling = w.convert_musubi_lora(sd, config.dit, device)
        lora_lib.merge_lora(dit, adapter, scale * scaling, in_place=True)
        del adapter
    seconds["loras"] = _seconds(device, t0)

    text_encoder = image_encoder = None
    t5_path = os.path.join(checkpoint_dir, T5_FILE)
    if with_text_encoder and os.path.exists(t5_path):
        t0 = time.perf_counter()
        text_encoder = UMT5TextEncoder(
            convert_umt5_checkpoint(w.load_torch(t5_path), device=device))
        seconds["text_encoder"] = _seconds(device, t0)
    clip_paths = sorted(glob.glob(os.path.join(checkpoint_dir, CLIP_GLOB)))
    if with_image_encoder and clip_paths:
        t0 = time.perf_counter()
        image_encoder = CLIPImageEncoder(
            convert_clip_vision_checkpoint(w.load_torch(clip_paths[0]), device=device))
        seconds["image_encoder"] = _seconds(device, t0)

    pipe = ChronoEditPipeline(dataclasses.replace(config, vae=vae_cfg), dit, vae,
                              text_encoder=text_encoder, image_encoder=image_encoder,
                              guardrails=guardrails)
    pipe.load_seconds.update(seconds)
    return pipe
