"""Declarative conditioning with CFG dropout, PyTorch.

The port of ``chronoedit_tpu/models/conditioner.py``. A
:class:`Conditioner` holds one :class:`CondSpec` per input key (a dropout
rate and what the null value is); called in training it replaces each
sample's value by its null with that probability, and
``condition_uncondition`` builds the (condition, uncondition) pair of
classifier-free guidance. The reference's empty-string drop
(``TextAttrEmptyStringDrop``) is ``null_mode="empty_emb"`` with the UMT5
embedding of "".

Dropout draws from an explicit ``torch.Generator`` (uniform < rate per
sample), where JAX draws ``jax.random.bernoulli`` from a key: the two agree
wherever the draw cannot matter (rates 0 and 1), not draw by draw.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CondSpec:
    """One conditioning input.

    dropout_rate: probability (per sample) of replacing the value with its
      null in training.
    null_mode: "zeros" | "empty_emb": what the unconditional value is;
      "empty_emb" needs ``null_value`` (e.g. the UMT5 embedding of "").
    """

    dropout_rate: float = 0.0
    null_mode: str = "zeros"
    null_value: torch.Tensor | None = None

    def null_for(self, value: torch.Tensor) -> torch.Tensor:
        if self.null_mode == "zeros":
            return torch.zeros_like(value)
        if self.null_mode == "empty_emb":
            if self.null_value is None:
                raise ValueError("null_mode='empty_emb' needs null_value")
            null = self.null_value.to(device=value.device, dtype=value.dtype)
            return null.expand(value.shape)
        raise ValueError(self.null_mode)


class Conditioner:
    """Per-key conditioning dropout and CFG pair construction."""

    def __init__(self, specs: dict[str, CondSpec]):
        self.specs = specs

    def __call__(self, batch: dict[str, torch.Tensor],
                 generator: torch.Generator | None = None,
                 train: bool = True) -> dict[str, torch.Tensor]:
        """Per-sample dropout of each configured key (training); the batch
        as it is without ``generator`` or with ``train=False``."""
        out = dict(batch)
        if not train or generator is None:
            return out
        for name, spec in self.specs.items():
            if name not in out or spec.dropout_rate <= 0.0:
                continue
            value = out[name]
            b = value.shape[0]
            drop = torch.rand((b,), generator=generator,
                              device=generator.device) < spec.dropout_rate
            mask = drop.to(value.device).reshape((b,) + (1,) * (value.ndim - 1))
            out[name] = torch.where(mask, spec.null_for(value), value)
        return out

    def condition_uncondition(
        self, batch: dict[str, torch.Tensor],
        uncond_keys: tuple[str, ...] = ("text_emb",),
        negative: dict[str, torch.Tensor] | None = None,
    ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        """(condition, uncondition) for CFG; ``negative`` values override the
        null (the reference's negative prompt)."""
        cond, uncond = dict(batch), dict(batch)
        for name in uncond_keys:
            if name not in batch:
                continue
            if negative and name in negative:
                uncond[name] = negative[name]
            else:
                uncond[name] = self.specs.get(name, CondSpec()).null_for(batch[name])
        return cond, uncond


def edit_conditioner(empty_text_emb: torch.Tensor | None = None,
                     text_dropout: float = 0.1,
                     image_dropout: float = 0.0) -> Conditioner:
    """The ChronoEdit edit model's recipe: text CFG dropout with the
    empty-prompt embedding as null (zeros without one); the CLIP image
    tokens kept (the reference's uncondition uses the same image
    embedding)."""
    text_spec = CondSpec(
        dropout_rate=text_dropout,
        null_mode="empty_emb" if empty_text_emb is not None else "zeros",
        null_value=empty_text_emb,
    )
    return Conditioner({
        "text_emb": text_spec,
        "image_emb": CondSpec(dropout_rate=image_dropout, null_mode="zeros"),
    })
