"""Indexed pickle "item" datasets for in-training validation visualization.

Equivalent of the reference's item_dataset.py
(``chronoedit/_src/datasets/item_dataset.py:35-305``): a directory of
``{index:06d}.pkl`` items plus a ``meta_info.json`` length record, each item
carrying a prompt, its precomputed UMT5 embedding (padded to a fixed length
with an attention mask), and optionally a conditioning image. Paths go
through easy_io, so ``s3://`` URIs work like the reference's S3 items.

Used by :class:`~chronoedit_tpu_torch.train.callbacks.EveryNDrawSample`
through :func:`make_sample_fn`: a fixed, curated set of prompts/images
rendered every N steps under the EMA weights gives comparable validation
grids across a run.

The port of ``chronoedit_tpu/data/item_dataset.py``: ``write_item_dataset``
and ``PromptItemDataset`` are copies; ``make_sample_fn`` swaps the given
parameters into the pipeline's DiT module for one render. JAX draws the
render's noise from ``PRNGKey(item["__idx__"])``; the port draws it from a
``torch.Generator`` on the pipeline's device seeded with ``__idx__``, so the
two agree only when the noise is given (``latents=``).
"""

from __future__ import annotations

import os
import contextlib
from typing import Any, Callable

import numpy as np
import torch

from chronoedit_tpu_torch.utils import easy_io


def write_item_dataset(path: str, items: list[dict[str, Any]]) -> None:
    """Create an item dataset: ``{i:06d}.pkl`` files + meta_info.json.

    Each item dict may carry: "prompt" (str), "t5_text_embeddings"
    ((L, D) float array, unpadded), "image" ((3, H, W) float array in
    [-1, 1], optional), and any extra keys (stored verbatim).
    """
    for i, item in enumerate(items):
        easy_io.dump(item, os.path.join(path, f"{i:06d}.pkl"))
    easy_io.dump({"length": len(items)}, os.path.join(path, "meta_info.json"))


class PromptItemDataset:
    """Prompt/embedding items for validation viz (PromptOnlyItemDataset).

    Items are loaded lazily per index; T5 embeddings are zero-padded to
    ``max_t5_length`` with a matching 0/1 mask (item_dataset.py:108-118).
    """

    def __init__(self, path: str, start_index: int = 0,
                 end_index: int | None = None, max_t5_length: int = 512):
        self.path = path
        meta = easy_io.load(os.path.join(path, "meta_info.json"))
        length = int(meta["length"])
        if end_index is None:
            end_index = length
        if length < end_index:
            raise ValueError(
                f"dataset {path} has {length} items, end_index {end_index}")
        self.start_index = start_index
        self.end_index = end_index
        self.max_t5_length = max_t5_length

    def __len__(self) -> int:
        return self.end_index - self.start_index

    def __getitem__(self, idx: int) -> dict[str, Any]:
        item = dict(easy_io.load(
            os.path.join(self.path, f"{self.start_index + idx:06d}.pkl")))
        emb = np.asarray(item.get("t5_text_embeddings"), np.float32)
        if emb.ndim != 2:
            raise ValueError(f"item {idx}: t5_text_embeddings must be (L, D)")
        L = min(emb.shape[0], self.max_t5_length)
        mask = np.zeros((self.max_t5_length,), np.int32)
        mask[:L] = 1
        padded = np.zeros((self.max_t5_length, emb.shape[1]), np.float32)
        padded[:L] = emb[:L]
        item["t5_text_embeddings"] = padded
        item["t5_text_mask"] = mask
        item["__idx__"] = self.start_index + idx
        return item


@contextlib.contextmanager
def swapped_params(model: torch.nn.Module, params: list[torch.Tensor] | None):
    """Run the block with ``params`` (tensors in ``model.parameters()``
    order, each of its parameter's shape, dtype and device: a ``TrainState``'s
    ``params`` or ``ema_params``) as the model's parameters, then put the
    model's own tensors back, whether or not the block raised. Nothing is
    copied: each parameter's ``.data`` points at the given tensor for the
    block and at its own storage after, so the restore is bitwise. ``None``
    runs the block on the model's own parameters."""
    if params is None:
        yield
        return
    own = list(model.parameters())
    if len(params) != len(own):
        raise ValueError(f"{len(params)} tensors for {len(own)} parameters")
    for i, (p, q) in enumerate(zip(own, params)):
        if (p.shape, p.dtype, p.device) != (q.shape, q.dtype, q.device):
            raise ValueError(f"parameter {i}: {tuple(q.shape)} {q.dtype} on {q.device} for "
                             f"{tuple(p.shape)} {p.dtype} on {p.device}")
    saved = [p.data for p in own]
    try:
        for p, q in zip(own, params):
            p.data = q.detach()
        yield
    finally:
        for p, data in zip(own, saved):
            p.data = data


def make_sample_fn(pipeline, dataset: PromptItemDataset,
                   item_index: int = 0, **pipe_kwargs) -> Callable:
    """Build an ``EveryNDrawSample`` sample_fn from one curated item.

    Returns ``fn(params, guidance) -> (C, T, H, W)`` (fp32 numpy) that runs
    the edit pipeline on the item's image + prompt embedding on the
    pipeline's device under the given (usually EMA) DiT parameters
    (every_n_draw_sample.py:65-130 semantics). ``params`` are tensors in
    ``pipeline.dit.parameters()`` order (a ``TrainState``'s ``params`` or
    ``ema_params``), or None for the DiT's own. The noise is drawn from a
    generator on the pipeline's device seeded with the item's ``__idx__``
    unless ``pipe_kwargs`` give ``latents``.
    """
    item = dataset[item_index]
    if "image" not in item:
        raise ValueError("item has no 'image'; edit-mode viz needs one")
    device = pipeline.device
    image = torch.as_tensor(np.asarray(item["image"]))[None].to(device)
    prompt_emb = torch.as_tensor(item["t5_text_embeddings"])[None].to(device)
    seed = int(item["__idx__"])

    def sample_fn(params, guidance):
        # swap in the (usually EMA) params only for this render — leaking
        # them into the shared pipeline would silently serve EMA weights to
        # every later caller (the reference scopes this with ema_scope,
        # wan_t2v_model.py:1076-1096)
        with swapped_params(pipeline.dit, params):
            out = pipeline(image, prompt_emb, guidance_scale=guidance,
                           generator=torch.Generator(device=device).manual_seed(seed),
                           **pipe_kwargs)
        return out[0].float().cpu().numpy()

    return sample_fn
