"""LoRA fine-tuning: train only the adapters over a frozen base DiT.

The port of ``chronoedit_tpu/train/lora_train.py`` (bf16 base; the QLoRA
branch over a quantized base waits for the quantization slice). The base's
parameters keep ``requires_grad=False`` and are never written; gradients
reach the adapters through the merge each block makes of its targets
(``models/lora.py``). With ``DiTConfig.remat = "full"`` only the blocks'
inputs stay alive between the forward and the backward, which is what lets
the 14B model train at 720p on one 80 GB card. As in the full-parameter
step, every step applies one update (JAX's ``grad_accum`` is not ported).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from chronoedit_tpu_torch.models import dit as dit_lib
from chronoedit_tpu_torch.models import lora as lora_lib
from chronoedit_tpu_torch.train.train_step import (
    Optimizer, TrainConfig, apply_step, draw_train_noise, velocity_loss)


@dataclasses.dataclass
class LoRATrainState:
    lora: lora_lib.LoRA
    optimizer: Optimizer
    ema_params: list[torch.Tensor] | None
    step: int = 0

    @property
    def params(self) -> list[torch.Tensor]:
        return self.optimizer.params


def make_lora_train_state(lora: lora_lib.LoRA, cfg: TrainConfig) -> LoRATrainState:
    params = list(lora.parameters())
    ema = [p.detach().clone() for p in params] if cfg.ema.enabled else None
    return LoRATrainState(lora, Optimizer(params, cfg), ema)


def make_lora_train_step(dit_cfg: dit_lib.DiTConfig, cfg: TrainConfig
                         ) -> Callable[..., dict]:
    """``step(state, base, batch, generator=None, *, u=None, noise=None)``:
    one step of the adapters over the frozen ``base`` DiT, in
    place; returns {"loss", "grad_norm"}."""

    def step(state: LoRATrainState, base: dit_lib.DiT, batch: dict,
             generator: torch.Generator | None = None, *,
             u: torch.Tensor | None = None, noise: torch.Tensor | None = None) -> dict:
        if u is None or noise is None:
            u, noise = draw_train_noise(generator, batch["latents"], cfg.rectified_flow)
        loss = velocity_loss(base, dit_cfg, cfg.rectified_flow, batch["latents"],
                             batch["condition"], batch["text_emb"],
                             batch.get("image_emb"), u, noise, lora=state.lora)
        metrics = apply_step(loss, state.params, state.optimizer, state.ema_params, cfg)
        state.step += 1
        return metrics

    return step
