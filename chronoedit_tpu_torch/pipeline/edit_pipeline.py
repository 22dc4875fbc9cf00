"""ChronoEdit edit pipeline: image + prompt embeddings -> edited frame / clip.

The edit path of ``chronoedit_tpu/pipeline/edit_pipeline.py``:

1. ``prepare_condition``: VAE-encode [image, zeros x (T-1)] and prepend the
   4-channel first-frame mask;
2. UniPC flow-match denoise (a Python loop), with classifier-free guidance
   batched into one forward when guidance > 1;
3. VAE decode.

Temporal-reasoning mode (``enable_temporal_reasoning``) starts from a
29-frame volume (8 latent frames, streamed through the VAE). With
0 < k < num_steps reasoning steps it runs steps [0, k) on all latent frames,
then keeps [first, last] of the solver state and the condition and runs
the rest on those two; with k >= num_steps the whole trajectory survives.
Either way it decodes twice: the reasoning video and the 2-frame edit.

``quantize`` switches the DiT to int8 / int4 projections in place
(``ops/quant.py``). Prompt and CLIP image embeddings are passed in, or
made by the attached encoders: ``encode_prompt`` (UMT5, from a prompt or
from token ids) and ``encode_image`` (CLIP ViT-H); ``pipeline/loader.py``
builds the whole pipeline from a checkpoint directory. Not here yet:
guardrails, skip-layer guidance over two forwards, the block cache and
multi-device meshes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from chronoedit_tpu_torch.core.schedule import make_flow_schedule
from chronoedit_tpu_torch.core.unipc import UniPCState, make_unipc_coeffs, run_unipc
from chronoedit_tpu_torch.models import dit as dit_lib
from chronoedit_tpu_torch.models import vae as vae_lib


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    dit: dit_lib.DiTConfig = dit_lib.DiTConfig()
    vae: vae_lib.VAEConfig = vae_lib.VAEConfig()
    num_steps: int = 50
    guidance_scale: float = 5.0
    flow_shift: float = 5.0
    num_frames: int = 5  # pixel frames in edit mode (29 in reasoning mode)
    # VAE W-tiles; None is the VAE's own rule (tile only streaming paths)
    vae_spatial_tiles: int | None = None

    @property
    def latent_channels(self) -> int:
        return self.vae.z_dim

    def resolve_num_frames(self, num_frames: int | None = None,
                           enable_temporal_reasoning: bool = False) -> int:
        """The pixel frame count a run uses: the 29-frame reasoning default
        or the edit default, rounded down to a VAE-compatible
        ``temporal_factor*k + 1``."""
        num_frames = num_frames or (29 if enable_temporal_reasoning else self.num_frames)
        tfac = self.vae.temporal_factor
        if num_frames % tfac != 1:
            num_frames = max(num_frames // tfac * tfac + 1, 1)
        return num_frames


def prepare_condition(vae: vae_lib.VAE, cfg: PipelineConfig, image: torch.Tensor,
                      num_frames: int, spatial_tiles: int | None = None) -> torch.Tensor:
    """(B, 3, H, W) image in [-1, 1] -> (B, tfac + z_dim, Tl, H/8, W/8): the
    first-frame mask channels, then the VAE latents of [image, zeros]."""
    b, c, h, w = image.shape
    tfac = cfg.vae.temporal_factor
    tl = cfg.vae.latent_frames(num_frames)
    video = torch.cat(
        [image[:, :, None],
         torch.zeros((b, c, num_frames - 1, h, w), dtype=image.dtype,
                     device=image.device)], dim=2)
    cond_latents = vae_lib.vae_encode(vae, video, spatial_tiles=spatial_tiles)

    hl, wl = h // cfg.vae.spatial_factor, w // cfg.vae.spatial_factor
    # mask over pixel frames (frame 0 -> 1), the first frame repeated tfac
    # times, folded to (tfac, Tl)
    mask = np.zeros((tfac + num_frames - 1,), np.float32)
    mask[:tfac] = 1.0
    mask = mask.reshape(tl, tfac).T
    mask = torch.as_tensor(mask, device=image.device).to(cond_latents.dtype)
    mask = mask[None, :, :, None, None].expand(b, tfac, tl, hl, wl)
    return torch.cat([mask, cond_latents], dim=1)


class ChronoEditPipeline:
    """Holds the DiT and VAE modules, and optionally the text and image
    encoders (``models/umt5.UMT5TextEncoder``, ``models/clip.
    CLIPImageEncoder``), and exposes the edit API."""

    def __init__(self, config: PipelineConfig, dit: dit_lib.DiT, vae: vae_lib.VAE,
                 text_encoder=None, image_encoder=None):
        self.config = config
        self.dit = dit
        self.vae = vae
        self.text_encoder = text_encoder
        self.image_encoder = image_encoder
        # seconds per component when ``pipeline/loader.py`` built it
        self.load_seconds: dict[str, float] = {}

    def quantize(self, skip: tuple = (), mode: str = "int8",
                 upgrade: tuple = ()) -> "ChronoEditPipeline":
        """Switch the DiT to quantized serving in place (``ops/quant.py``
        ``quantize_dit``): ``mode`` "int8" (w8a8), "int4" (w4a16, K8 on the
        card) or "int4_a8" (w4a8); ``skip`` keeps (module, name)
        projections in float, ``upgrade`` makes them w8a8 inside an int4
        model (``INT4_MIXED2_UPGRADE`` is the recipe over the 35 dB bar).
        Attention, the embedders, the head and the VAE keep their dtype.
        Returns self."""
        from chronoedit_tpu_torch.ops.quant import quantize_dit

        quantize_dit(self.dit, skip=skip, mode=mode, upgrade=upgrade)
        return self

    def encode_prompt(self, prompt: str | torch.Tensor,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
        """UMT5 embeddings (1 or B, text_len, dim), zero past each prompt's
        length: of a prompt (through the tokenizer, whose vocabulary is a
        download) or of token ids (B, S) with their 0/1 ``mask`` (all ones
        by default)."""
        if self.text_encoder is None:
            raise ValueError("no text_encoder attached; pass prompt_emb instead")
        if isinstance(prompt, str):
            return self.text_encoder([prompt])
        return self.text_encoder.encode_ids(prompt, torch.ones_like(prompt) if mask is None
                                            else mask)

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        """CLIP penultimate features (B, 257, 1280) of [-1, 1] images."""
        if self.image_encoder is None:
            raise ValueError("no image_encoder attached; pass image_emb instead")
        return self.image_encoder(image)

    def _model_fn(self, condition, text_emb, neg_text_emb, image_emb, guidance):
        """Velocity closure ``fn(x, t)`` for the solver; with guidance > 1,
        classifier-free guidance runs cond and uncond batched in one
        forward (the only CFG form ported)."""
        cfg = self.config
        dtype = cfg.dit.dtype
        condition = condition.to(dtype)
        if not (guidance > 1.0 and neg_text_emb is not None):
            def fn(x, t):
                xin = torch.cat([x.to(dtype), condition], dim=1)
                ts = torch.full((x.shape[0],), t, dtype=torch.float32, device=x.device)
                return dit_lib.dit_forward(self.dit, xin, ts, text_emb, image_emb)
            return fn

        text2 = torch.cat([text_emb, neg_text_emb], dim=0)
        img2 = None if image_emb is None else torch.cat([image_emb] * 2, dim=0)
        cond2 = torch.cat([condition] * 2, dim=0)

        def fn(x, t):
            x2 = torch.cat([x, x], dim=0).to(dtype)
            xin = torch.cat([x2, cond2], dim=1)
            ts = torch.full((x2.shape[0],), t, dtype=torch.float32, device=x.device)
            v = dit_lib.dit_forward(self.dit, xin, ts, text2, img2)
            v_cond, v_uncond = v.chunk(2, dim=0)
            return v_uncond + guidance * (v_cond - v_uncond)
        return fn

    @torch.inference_mode()
    def __call__(self, image: torch.Tensor, prompt_emb: torch.Tensor,
                 neg_prompt_emb: torch.Tensor | None = None,
                 image_emb: torch.Tensor | None = None,
                 num_frames: int | None = None, num_steps: int | None = None,
                 guidance_scale: float | None = None, flow_shift: float | None = None,
                 enable_temporal_reasoning: bool = False,
                 num_temporal_reasoning_steps: int = 0,
                 generator: torch.Generator | None = None,
                 latents: torch.Tensor | None = None,
                 output_type: str = "video") -> torch.Tensor:
        """Run the edit. Returns pixels (B, 3, T, H, W) in [-1, 1] (the last
        frame is the edit), or the fp32 latents with ``output_type="latent"``.
        Initial noise is ``latents`` if given, else drawn from ``generator``.
        In reasoning mode with k > 0 reasoning steps the clip is the
        reasoning video, then the edit clip after its first frame; at the
        29-frame default that is 29 frames for k >= num_steps, 5 after the
        drop."""
        cfg = self.config
        reasoning, k = enable_temporal_reasoning, num_temporal_reasoning_steps
        num_frames = cfg.resolve_num_frames(num_frames, reasoning)
        num_steps = num_steps or cfg.num_steps
        guidance = cfg.guidance_scale if guidance_scale is None else guidance_scale
        shift = flow_shift or cfg.flow_shift

        b, _, h, w = image.shape
        tl = cfg.vae.latent_frames(num_frames)
        hl, wl = h // cfg.vae.spatial_factor, w // cfg.vae.spatial_factor
        if latents is None:
            latents = torch.randn((b, cfg.latent_channels, tl, hl, wl),
                                  generator=generator, dtype=torch.float32,
                                  device=image.device)

        coeffs = make_unipc_coeffs(make_flow_schedule(num_steps, shift=shift))
        condition = prepare_condition(self.vae, cfg, image, num_frames,
                                      cfg.vae_spatial_tiles)

        def phase(state, cond, start, end):
            fn = self._model_fn(cond, prompt_emb, neg_prompt_emb, image_emb, guidance)
            return run_unipc(fn, coeffs, state, start, end)

        state = UniPCState.init(latents)
        if reasoning and 0 < k < num_steps:
            # the mid-loop drop: latents, solver history and condition keep
            # [first, last] after k steps
            state = phase(state, condition, 0, k)
            keep = [0, tl - 1]
            state = state.truncate(lambda t: t[:, :, keep])
            state = phase(state, condition[:, :, keep], k, num_steps)
        else:
            state = phase(state, condition, 0, num_steps)
        if output_type == "latent":
            return state.x
        return self.decode(state.x, dual=reasoning and k > 0)

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor, dual: bool = False) -> torch.Tensor:
        """Final latents -> pixels. ``dual`` (reasoning mode with k > 0
        reasoning steps) decodes the reasoning video from all but the last
        latent frame, then the [first, last] edit clip, and appends the
        edit clip without its first frame."""
        cfg = self.config

        def decode(z):
            return vae_lib.vae_decode(self.vae, z, spatial_tiles=cfg.vae_spatial_tiles)

        if not dual:
            return decode(latents)
        video_reason = decode(latents[:, :, :-1])
        video_edit = decode(latents[:, :, [0, latents.shape[2] - 1]])
        return torch.cat([video_reason, video_edit[:, :, 1:]], dim=2)

    def edit_image(self, image: torch.Tensor, prompt_emb: torch.Tensor,
                   **kw) -> torch.Tensor:
        """Just the edited frame (B, 3, H, W): the clip's last frame."""
        return self(image, prompt_emb, **kw)[:, :, -1]
