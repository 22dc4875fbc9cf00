"""Edit dataset: composable processing pipeline + metadata-driven dataset.

Host-side (numpy/PIL) port of the reference data layer
(``chronoedit/_src/datasets/chronoedit_dataset/unified_dataset.py``):

- ``DataOp`` pipelines composable with ``>>``;
- ``LoadImage`` / ``ImageCropAndResize`` (aspect-preserving resize +
  center-crop, dims rounded to division factors, area capped at max_pixels);
- ``LoadVideo`` with frame-count rounding to ``4k+1`` (time_division_factor
  4, remainder 1);
- ``UnifiedDataset`` over metadata.csv/.json/.jsonl with per-key operators;
- ``EditDataset`` yielding edit pairs ([input image, edit target] videos)
  plus prompts or precomputed UMT5 embedding pickles
  (chronoedit_dataloader.py:42-160).

Everything yields numpy; device transfer happens in the training loop.

A copy of ``chronoedit_tpu/data/edit_dataset.py`` (the port imports
nothing of the JAX package): the inference CLI's preprocessing
(``ImageCropAndResize``, ``ToArray``) and the training CLI's dataset.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Callable

import numpy as np


class DataOp:
    """Composable processing step: ``(LoadImage() >> CropResize(...))(x)``."""

    def __call__(self, x):
        raise NotImplementedError

    def __rshift__(self, other: "DataOp") -> "DataOp":
        return _Chain(self, other)


class _Chain(DataOp):
    def __init__(self, first, second):
        self.first, self.second = first, second

    def __call__(self, x):
        return self.second(self.first(x))


class ToAbsolutePath(DataOp):
    def __init__(self, base_path: str = ""):
        self.base_path = base_path

    def __call__(self, path: str) -> str:
        return path if os.path.isabs(path) else os.path.join(self.base_path, path)


class LoadImage(DataOp):
    def __call__(self, path_or_file):
        from PIL import Image

        img = Image.open(path_or_file)
        return img.convert("RGB")


class ImageCropAndResize(DataOp):
    """Aspect-preserving resize then center-crop to (height, width); if
    height/width are None they derive from the source, capped at
    ``max_pixels`` and rounded down to the division factors
    (unified_dataset.py:95-121)."""

    def __init__(self, height: int | None = None, width: int | None = None,
                 max_pixels: int = 1920 * 1080,
                 height_division_factor: int = 16,
                 width_division_factor: int = 16):
        self.height, self.width = height, width
        self.max_pixels = max_pixels
        self.hf, self.wf = height_division_factor, width_division_factor

    def target_size(self, w: int, h: int) -> tuple[int, int]:
        th, tw = self.height, self.width
        if th is None or tw is None:
            th, tw = h, w
            if th * tw > self.max_pixels:
                scale = (self.max_pixels / (th * tw)) ** 0.5
                th, tw = int(th * scale), int(tw * scale)
        th = max(self.hf, th // self.hf * self.hf)
        tw = max(self.wf, tw // self.wf * self.wf)
        return th, tw

    def __call__(self, img):
        from PIL import Image

        w, h = img.size
        th, tw = self.target_size(w, h)
        scale = max(tw / w, th / h)
        img = img.resize((round(w * scale), round(h * scale)), Image.BICUBIC)
        # center crop
        w2, h2 = img.size
        left, top = (w2 - tw) // 2, (h2 - th) // 2
        return img.crop((left, top, left + tw, top + th))


class ToArray(DataOp):
    """PIL -> (3, H, W) float32 in [-1, 1]."""

    def __call__(self, img) -> np.ndarray:
        arr = np.asarray(img, np.float32) / 127.5 - 1.0
        return arr.transpose(2, 0, 1)


class LoadVideo(DataOp):
    """Video file -> list of PIL frames, count rounded down to
    ``time_division_factor * k + remainder`` (4k+1 for the Wan VAE)."""

    def __init__(self, num_frames: int = 81, time_division_factor: int = 4,
                 time_division_remainder: int = 1,
                 frame_processor: DataOp | None = None):
        self.num_frames = num_frames
        self.tf = time_division_factor
        self.tr = time_division_remainder
        self.frame_processor = frame_processor

    def round_frames(self, n: int) -> int:
        n = min(n, self.num_frames)
        while n > 1 and n % self.tf != self.tr:
            n -= 1
        return n

    def __call__(self, path: str):
        import imageio.v3 as iio
        from PIL import Image

        frames = iio.imread(path)
        n = self.round_frames(len(frames))
        out = []
        for f in frames[:n]:
            img = Image.fromarray(f).convert("RGB")
            if self.frame_processor is not None:
                img = self.frame_processor(img)
            out.append(img)
        return out


class LoadPickle(DataOp):
    def __call__(self, path: str):
        with open(path, "rb") as f:
            return pickle.load(f)


class UnifiedDataset:
    """Metadata-driven map-style dataset (unified_dataset.py:255-370)."""

    def __init__(self, base_path: str = "", metadata_path: str | None = None,
                 repeat: int = 1, data_file_keys: tuple[str, ...] = (),
                 main_data_operator: Callable | None = None,
                 special_operator_map: dict[str, Callable] | None = None):
        self.base_path = base_path
        self.repeat = repeat
        self.data_file_keys = data_file_keys
        self.main_data_operator = main_data_operator or (lambda x: x)
        self.special_operator_map = special_operator_map or {}
        self.data = self._load_metadata(metadata_path)

    def _load_metadata(self, path: str | None) -> list[dict[str, Any]]:
        if path is None:
            raise ValueError("metadata_path is required")
        if path.endswith(".json"):
            with open(path) as f:
                return json.load(f)
        if path.endswith(".jsonl"):
            with open(path) as f:
                return [json.loads(line) for line in f if line.strip()]
        # csv (header row; no pandas dependency needed)
        import csv

        with open(path, newline="") as f:
            return list(csv.DictReader(f))

    def __len__(self) -> int:
        return len(self.data) * self.repeat

    def __getitem__(self, idx: int) -> dict[str, Any]:
        item = dict(self.data[idx % len(self.data)])
        for key in self.data_file_keys:
            if key in item:
                op = self.special_operator_map.get(key, self.main_data_operator)
                item[key] = op(item[key])
        return item


class EditDataset:
    """metadata.csv rows -> edit-pair training samples.

    Expected columns (chronoedit_dataloader.py): ``video`` (or
    ``image``+``edit_image``), ``prompt``, optional ``umt5_emb`` (pickle of
    precomputed text embeddings from scripts/extract_umt5.py).
    """

    def __init__(self, base_path: str, metadata_path: str,
                 height: int | None = None, width: int | None = None,
                 max_pixels: int = 1280 * 720, num_frames: int = 5):
        crop = ImageCropAndResize(height, width, max_pixels)
        self.image_op = ToAbsolutePath(base_path) >> LoadImage() >> crop >> ToArray()
        self.video_op = ToAbsolutePath(base_path) >> LoadVideo(
            num_frames, frame_processor=crop)
        self.pkl_op = ToAbsolutePath(base_path) >> LoadPickle()
        self.dataset = UnifiedDataset(
            base_path=base_path, metadata_path=metadata_path)

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        item = self.dataset[idx]
        out: dict[str, Any] = {"prompt": item.get("prompt", "")}
        if "video" in item and item["video"]:
            frames = self.video_op(item["video"])
            video = np.stack([np.asarray(ToArray()(f)) for f in frames], axis=1)
        else:
            first = self.image_op(item["image"])
            last = self.image_op(item["edit_image"])
            video = np.stack([first, last], axis=1)  # (3, 2, H, W)
        out["video"] = video
        if item.get("umt5_emb"):
            out["text_emb"] = np.asarray(self.pkl_op(item["umt5_emb"]), np.float32)
        return out
