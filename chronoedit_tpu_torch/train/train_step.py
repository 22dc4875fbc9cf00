"""The training step: rectified-flow velocity loss, AdamW with clipping and
warm-up, EMA.

The port of ``chronoedit_tpu/train/train_step.py``. JAX's step is one
jitted pure function over an optax chain; here the step runs eagerly and
updates the parameters, the optimizer's moments and the EMA in place.
:class:`Optimizer` reproduces the optax chain the JAX package builds:

- ``clip_by_global_norm``: scale by ``max / |g|`` only when ``|g| >= max``
  (``torch.nn.utils.clip_grad_norm_`` would add 1e-6 to the norm);
- ``adamw`` over ``warmup_constant_schedule(0, lr, warmup_steps)``: the
  first update has learning rate 0. ``torch.optim.AdamW`` computes the same
  update (decoupled decay scaled by lr, eps outside the square root).

Every step applies one update: JAX's ``grad_accum`` (``optax.MultiSteps``)
is not ported, as no path of the port accumulates yet. The EMA moves after
each update at the update count, as in JAX. ``grad_norm`` is the norm of
the raw gradient, before clipping. The random draws (train time u and the noise) are arguments of
:func:`velocity_loss`, so a caller can feed the same draws to JAX and here;
:func:`draw_train_noise` makes them from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from chronoedit_tpu_torch.core import rectified_flow as rf
from chronoedit_tpu_torch.models import dit as dit_lib
from chronoedit_tpu_torch.models import vae as vae_lib
from chronoedit_tpu_torch.pipeline.edit_pipeline import PipelineConfig, prepare_condition
from chronoedit_tpu_torch.train.ema import EMAConfig, ema_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-5
    weight_decay: float = 0.01
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 1000
    rectified_flow: rf.RectifiedFlowConfig = rf.RectifiedFlowConfig()
    ema: EMAConfig = EMAConfig()


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, fp32 (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def warmup_lr(cfg: TrainConfig, count: int) -> float:
    """optax ``warmup_constant_schedule(0, lr, warmup_steps)`` at ``count``
    applied updates."""
    if cfg.warmup_steps <= 0:
        return cfg.lr
    frac = 1.0 - min(max(count / cfg.warmup_steps, 0.0), 1.0)
    return (0.0 - cfg.lr) * frac + cfg.lr


class Optimizer:
    """The port of JAX's ``make_optimizer`` (``grad_accum = 1``): optax
    ``chain(clip_by_global_norm, adamw)`` over a list of parameters,
    updating them in place."""

    def __init__(self, params: list[torch.Tensor], cfg: TrainConfig):
        self.params, self.cfg = params, cfg
        self.adamw = torch.optim.AdamW(params, lr=0.0, betas=cfg.betas, eps=cfg.eps,
                                       weight_decay=cfg.weight_decay)
        self.gradient_step = 0  # updates so far

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor]) -> None:
        """One clip + AdamW update of the parameters with ``grads``."""
        cfg = self.cfg
        g_norm = global_norm(grads)
        clip = None if bool(g_norm < cfg.grad_clip) else g_norm
        for p, g in zip(self.params, grads):
            p.grad = g if clip is None else (g / clip) * cfg.grad_clip
        for group in self.adamw.param_groups:
            group["lr"] = warmup_lr(cfg, self.gradient_step)
        self.adamw.step()
        for p in self.params:
            p.grad = None
        self.gradient_step += 1


@dataclasses.dataclass
class TrainState:
    """Full-parameter training state: the model (its parameters are the
    trained ones), the optimizer, the EMA copies (None when disabled) and
    the step count."""

    model: dit_lib.DiT
    optimizer: Optimizer
    ema_params: list[torch.Tensor] | None
    step: int = 0

    @property
    def params(self) -> list[torch.Tensor]:
        return self.optimizer.params


def make_train_state(model: dit_lib.DiT, cfg: TrainConfig) -> TrainState:
    """Every parameter of ``model`` becomes trainable; the EMA starts as a
    copy of them."""
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    ema = [p.detach().clone() for p in params] if cfg.ema.enabled else None
    return TrainState(model, Optimizer(params, cfg), ema)


def edit_training_batch(vae: vae_lib.VAE, pipe_cfg: PipelineConfig, video: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(clean latents fp32 (B, z, 2, h, w), condition (B, tfac + z, 2, h,
    w)) from a raw edit-pair clip (B, 3, T, H, W) in [-1, 1]: the first
    frame is the source, the last the edit target, repeated tfac times so
    the clip encodes to 2 latent frames. (JAX's ``is_video_prior`` option,
    which keeps the whole trajectory, has no caller in the port yet.)"""
    vcfg = pipe_cfg.vae
    tfac = vcfg.temporal_factor
    first, last = video[:, :, :1], video[:, :, -1:]
    edit_clip = torch.cat([first] + [last] * tfac, dim=2)
    latents = vae_lib.vae_encode(vae, edit_clip).float()
    num_frames = vcfg.pixel_frames(latents.shape[2])
    condition = prepare_condition(vae, pipe_cfg, first[:, :, 0], num_frames)
    return latents, condition


def draw_train_noise(generator: torch.Generator, latents: torch.Tensor,
                     rf_cfg: rf.RectifiedFlowConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(u (B,), noise like latents, fp32) from ``generator``."""
    u = rf.sample_train_time(generator, latents.shape[0], rf_cfg)
    noise = torch.randn(latents.shape, generator=generator, device=generator.device)
    return u, noise


def velocity_loss(model: dit_lib.DiT, dit_cfg: dit_lib.DiTConfig,
                  rf_cfg: rf.RectifiedFlowConfig, latents: torch.Tensor,
                  condition: torch.Tensor, text_emb: torch.Tensor,
                  image_emb: torch.Tensor | None, u: torch.Tensor, noise: torch.Tensor,
                  lora=None) -> torch.Tensor:
    """Time-weighted velocity MSE for given draws u (B,) and noise."""
    b = latents.shape[0]
    timesteps, sigmas = rf.discretize_time(u, rf_cfg)
    x_t, v_target = rf.get_interpolation(noise.float(), latents.float(), sigmas)
    xin = torch.cat([x_t.to(dit_cfg.dtype), condition.to(dit_cfg.dtype)], dim=1)
    v_pred = dit_lib.dit_forward(model, xin, timesteps, text_emb, image_emb, lora=lora)
    per_sample = (v_pred.float() - v_target).square().reshape(b, -1).mean(dim=1)
    return (rf.train_time_weight(timesteps, rf_cfg) * per_sample).mean()


def apply_step(loss: torch.Tensor, params: list[torch.Tensor], optimizer: Optimizer,
               ema_params: list[torch.Tensor] | None, cfg: TrainConfig) -> dict:
    """Backward through ``loss`` to ``params``, one optimizer update and one
    EMA step at the update count."""
    grads = torch.autograd.grad(loss, params)
    g_norm = global_norm(grads)
    optimizer.update(list(grads))
    if ema_params is not None:
        ema_update(ema_params, params, optimizer.gradient_step - 1, cfg.ema)
    return {"loss": loss.detach(), "grad_norm": g_norm}


def make_train_step(dit_cfg: dit_lib.DiTConfig, cfg: TrainConfig
                    ) -> Callable[..., dict]:
    """``step(state, batch, generator=None, *, u=None, noise=None)`` runs
    one step in place and returns {"loss", "grad_norm"}; batch =
    {"latents", "condition", "text_emb", "image_emb" (optional)}. The draws
    come from ``generator`` unless u and noise are given."""

    def step(state: TrainState, batch: dict, generator: torch.Generator | None = None,
             *, u: torch.Tensor | None = None, noise: torch.Tensor | None = None) -> dict:
        if u is None or noise is None:
            u, noise = draw_train_noise(generator, batch["latents"], cfg.rectified_flow)
        loss = velocity_loss(state.model, dit_cfg, cfg.rectified_flow,
                             batch["latents"], batch["condition"], batch["text_emb"],
                             batch.get("image_emb"), u, noise)
        metrics = apply_step(loss, state.params, state.optimizer, state.ema_params, cfg)
        state.step += 1
        return metrics

    return step
