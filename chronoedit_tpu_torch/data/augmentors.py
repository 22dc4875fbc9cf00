"""Composable sample augmentors (host-side numpy).

Equivalent of the reference's webdataset augmentor suite
(``_ext/imaginaire/datasets/webdataset/augmentors/image/``: resize.py,
cropping.py, flip.py, padding.py, normalize.py) re-expressed as plain
callables over sample dicts. All image ops accept (3, H, W) or video
(3, T, H, W) float arrays; every op is deterministic given the sample's
``__key__`` (per-sample seeding) so multi-process loaders stay reproducible
without shared RNG state.

A copy of ``chronoedit_tpu/data/augmentors.py`` with its import pointed at
the port's ``res_buckets``: the same ``__key__`` gives the same bits.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from chronoedit_tpu_torch.data.res_buckets import VIDEO_RES_SIZE_INFO, nearest_bucket

Sample = dict


def _sample_rng(sample: Sample, salt: int = 0) -> np.random.Generator:
    key = str(sample.get("__key__", "")).encode()
    return np.random.default_rng(zlib.crc32(key) + salt)


def _spatial(img: np.ndarray) -> tuple[int, int]:
    return img.shape[-2], img.shape[-1]


def _resize_hw(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize on the trailing (H, W) axes (PIL per frame — matches
    the reference's PIL-based resize augmentor)."""
    from PIL import Image

    src_h, src_w = _spatial(img)
    if (src_h, src_w) == (h, w):
        return img
    flat = img.reshape(-1, src_h, src_w)
    out = np.empty((flat.shape[0], h, w), img.dtype)
    # channels resized independently: PIL mode F handles float planes
    for i, plane in enumerate(flat):
        out[i] = np.asarray(
            Image.fromarray(plane.astype(np.float32), mode="F").resize(
                (w, h), Image.BILINEAR))
    return out.reshape(*img.shape[:-2], h, w)


@dataclass
class Compose:
    ops: Sequence[Callable[[Sample], Sample]]

    def __call__(self, sample: Sample) -> Sample:
        for op in self.ops:
            sample = op(sample)
        return sample


@dataclass
class ResizeSmallestSide:
    """Scale so min(H, W) == size (resize.py ResizeSmallestSideAspectPreserving)."""

    size: int
    keys: Sequence[str] = ("jpg",)

    def __call__(self, sample: Sample) -> Sample:
        for k in self.keys:
            if k not in sample:
                continue
            h, w = _spatial(sample[k])
            scale = self.size / min(h, w)
            sample[k] = _resize_hw(sample[k], round(h * scale), round(w * scale))
        return sample


@dataclass
class ResizeToBucket:
    """Resize to the nearest aspect bucket of a resolution class
    (VIDEO_RES_SIZE_INFO hookup; distributor keeps per-rank aspect uniform)."""

    resolution: str = "720p"
    keys: Sequence[str] = ("jpg",)

    def __call__(self, sample: Sample) -> Sample:
        for k in self.keys:
            if k not in sample:
                continue
            h, w = _spatial(sample[k])
            bh, bw = nearest_bucket(h, w, self.resolution)
            sample[k] = _resize_hw(sample[k], bh, bw)
        return sample


@dataclass
class CenterCrop:
    height: int
    width: int
    keys: Sequence[str] = ("jpg",)

    def __call__(self, sample: Sample) -> Sample:
        for k in self.keys:
            if k not in sample:
                continue
            img = sample[k]
            h, w = _spatial(img)
            top = max((h - self.height) // 2, 0)
            left = max((w - self.width) // 2, 0)
            sample[k] = img[..., top:top + self.height, left:left + self.width]
        return sample


@dataclass
class RandomCrop:
    height: int
    width: int
    keys: Sequence[str] = ("jpg",)

    def __call__(self, sample: Sample) -> Sample:
        rng = _sample_rng(sample, salt=1)
        for k in self.keys:
            if k not in sample:
                continue
            img = sample[k]
            h, w = _spatial(img)
            top = int(rng.integers(0, max(h - self.height, 0) + 1))
            left = int(rng.integers(0, max(w - self.width, 0) + 1))
            sample[k] = img[..., top:top + self.height, left:left + self.width]
        return sample


@dataclass
class HorizontalFlip:
    """Random h-flip applied consistently to every listed key (flip.py)."""

    p: float = 0.5
    keys: Sequence[str] = ("jpg",)

    def __call__(self, sample: Sample) -> Sample:
        if float(_sample_rng(sample, salt=2).random()) < self.p:
            for k in self.keys:
                if k in sample:
                    sample[k] = np.ascontiguousarray(sample[k][..., ::-1])
        return sample


@dataclass
class PadToMultiple:
    """Zero-pad trailing dims to a multiple (padding.py; mod-16 latents)."""

    multiple: int = 16
    keys: Sequence[str] = ("jpg",)

    def __call__(self, sample: Sample) -> Sample:
        for k in self.keys:
            if k not in sample:
                continue
            img = sample[k]
            h, w = _spatial(img)
            ph, pw = (-h) % self.multiple, (-w) % self.multiple
            if ph or pw:
                widths = [(0, 0)] * (img.ndim - 2) + [(0, ph), (0, pw)]
                sample[k] = np.pad(img, widths)
        return sample


@dataclass
class Normalize:
    """Channel-wise (x - mean) / std (normalize.py)."""

    mean: Sequence[float] = (0.0, 0.0, 0.0)
    std: Sequence[float] = (1.0, 1.0, 1.0)
    keys: Sequence[str] = ("jpg",)

    def __call__(self, sample: Sample) -> Sample:
        mean = np.asarray(self.mean, np.float32)
        std = np.asarray(self.std, np.float32)
        for k in self.keys:
            if k not in sample:
                continue
            img = sample[k]
            shape = (3,) + (1,) * (img.ndim - 3) + (1, 1)
            sample[k] = (img - mean.reshape(shape)) / std.reshape(shape)
        return sample
