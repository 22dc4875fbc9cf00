"""The inference CLI's image preprocessing: ``ImageCropAndResize``
(aspect-preserving resize + center-crop, dims rounded to division factors,
area capped at max_pixels) and ``ToArray`` (PIL -> (3, H, W) float32 in
[-1, 1]). Host-side numpy/PIL copies of the JAX package's
``data/edit_dataset.py`` classes (reference:
``chronoedit/_src/datasets/chronoedit_dataset/unified_dataset.py``).
"""

from __future__ import annotations

import numpy as np


class ImageCropAndResize:
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


class ToArray:
    """PIL -> (3, H, W) float32 in [-1, 1]."""

    def __call__(self, img) -> np.ndarray:
        arr = np.asarray(img, np.float32) / 127.5 - 1.0
        return arr.transpose(2, 0, 1)
