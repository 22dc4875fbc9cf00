"""Synthetic edit data: what ``scripts/train.py --data mock`` trains on.

The port of ``chronoedit_tpu/data/mock.py`` (its own copy: the port
imports nothing of the JAX package). Clips and embedding stand-ins are
drawn with numpy from a seed, so the JAX package and the port see the same
data; the batches go through the port's ``edit_training_batch``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MockEditDataset:
    """Deterministic random edit pairs: a clip whose first frame is the
    input and last frame the edit result, plus text/image embedding
    stand-ins."""

    batch_size: int = 1
    num_frames: int = 5
    height: int = 32
    width: int = 32
    text_tokens: int = 512
    text_dim: int = 4096
    image_tokens: int = 257
    image_dim: int = 1280
    seed: int = 0

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        while True:
            yield {
                "video": rng.uniform(
                    -1, 1, (self.batch_size, 3, self.num_frames,
                            self.height, self.width)).astype(np.float32),
                "text_emb": rng.standard_normal(
                    (self.batch_size, self.text_tokens, self.text_dim)
                ).astype(np.float32),
                "image_emb": rng.standard_normal(
                    (self.batch_size, self.image_tokens, self.image_dim)
                ).astype(np.float32),
                "prompt": ["mock edit instruction"] * self.batch_size,
            }


def mock_batch_iterator(vae, pipe_cfg, dataset: MockEditDataset | None = None,
                        **kw) -> Iterator[dict]:
    """Mock raw clips -> train-step batches (latents, condition and the
    embeddings) on the VAE's device."""
    from chronoedit_tpu_torch.train.train_step import edit_training_batch

    device = next(vae.parameters()).device
    dataset = dataset or MockEditDataset(
        text_dim=pipe_cfg.dit.text_dim, text_tokens=8,
        image_tokens=pipe_cfg.dit.image_tokens,
        image_dim=pipe_cfg.dit.image_dim or 8, **kw)
    for raw in dataset:
        with torch.no_grad():
            latents, condition = edit_training_batch(
                vae, pipe_cfg, torch.from_numpy(raw["video"]).to(device))
        yield {
            "latents": latents,
            "condition": condition,
            "text_emb": torch.from_numpy(raw["text_emb"]).to(device),
            "image_emb": torch.from_numpy(raw["image_emb"]).to(device),
        }
