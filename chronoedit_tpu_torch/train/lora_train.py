"""LoRA fine-tuning: train only the adapters over a frozen base DiT.

The port of ``chronoedit_tpu/train/lora_train.py``. The base's parameters
keep ``requires_grad=False`` and are never written; gradients reach the
adapters through the merge each block makes of its targets
(``models/lora.py``), or, over a quantized base (QLoRA: w8a8, w4a16 or
w4a8 leaves with no float weight to merge into), through the side branches
``(x @ a) @ (scaling * b)`` after each quantized product, whose backward is
the straight-through int8 product or ``dy @ dequant(W)`` (``ops/quant.py``,
``ops/int4_matmul.py``). With ``DiTConfig.remat = "full"`` only the blocks'
inputs stay alive between the forward and the backward, which is what lets
the 14B model train at 720p on one 80 GB card.

``TrainConfig.grad_accum`` accumulates as the full-parameter step does
(``train/train_step.py``). The EMA moves after each applied update at the
applied count: JAX's LoRA step moves it on every micro-step at the
micro-step count, the same rule when ``grad_accum = 1``; under
accumulation the port follows JAX's full-parameter rule (``ROADMAP.md``
queue 3).

Under a mesh (``mesh=``: data, fsdp and tensor) the adapters stay whole on
every rank over the base sharded by ``parallel/sharding.shard_params``;
their gradients are summed where ranks used parts of them (tensor slices,
fsdp rows: ``models/lora.py``) and averaged over ``data``, as the
full-parameter step's (``train/train_step.py``). A context or pipe axis
above 1 raises ``ValueError`` (JAX's LoRA step takes no mesh;
``ROADMAP.md`` queue 1, item 3.3), as does a quantized base (QLoRA) under
a mesh: the row layers' int8 token scale is all-reduced without a
gradient (item 3.3 too).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from chronoedit_tpu_torch.models import dit as dit_lib
from chronoedit_tpu_torch.models import lora as lora_lib
from chronoedit_tpu_torch.train.train_step import (
    Optimizer, TrainConfig, apply_step, check_lora_mesh, draw_train_noise, leaf_splits,
    velocity_loss)


@dataclasses.dataclass
class LoRATrainState:
    lora: lora_lib.LoRA
    optimizer: Optimizer
    ema_params: list[torch.Tensor] | None
    step: int = 0

    @property
    def params(self) -> list[torch.Tensor]:
        return self.optimizer.params


def make_lora_train_state(lora: lora_lib.LoRA, cfg: TrainConfig, mesh=None) -> LoRATrainState:
    """The adapters' train state; under ``mesh`` they are whole on every
    rank."""
    check_lora_mesh(mesh)
    params = list(lora.parameters())
    ema = [p.detach().clone() for p in params] if cfg.ema.enabled else None
    return LoRATrainState(lora, Optimizer(params, cfg, leaf_splits(lora, mesh)), ema)


def make_lora_train_step(dit_cfg: dit_lib.DiTConfig, cfg: TrainConfig, mesh=None
                         ) -> Callable[..., dict]:
    """``step(state, base, batch, generator=None, *, u=None, noise=None)``:
    one micro-step of the adapters over the frozen ``base`` DiT (merged
    into a float base, attached to a quantized one), in place; returns
    {"loss", "grad_norm"}. Under ``mesh`` the base holds this rank's
    shards and the batch is this data line's rows."""
    check_lora_mesh(mesh)

    def step(state: LoRATrainState, base: dit_lib.DiT, batch: dict,
             generator: torch.Generator | None = None, *,
             u: torch.Tensor | None = None, noise: torch.Tensor | None = None) -> dict:
        attach = lora_lib.base_is_quantized(base, state.lora.cfg)
        if attach and mesh is not None and mesh.size > 1:
            raise ValueError("QLoRA under a mesh is not ported yet: the row layers' int8 token "
                             "scale carries no gradient (ROADMAP.md queue 1, item 3.3)")
        if u is None or noise is None:
            u, noise = draw_train_noise(generator, batch["latents"], cfg.rectified_flow, mesh)
        loss = velocity_loss(base, dit_cfg, cfg.rectified_flow, batch["latents"],
                             batch["condition"], batch["text_emb"],
                             batch.get("image_emb"), u, noise, lora=state.lora,
                             lora_attach=attach, mesh=mesh)
        metrics = apply_step(loss, state.params, state.optimizer, state.ema_params, cfg, mesh)
        state.step += 1
        return metrics

    return step
