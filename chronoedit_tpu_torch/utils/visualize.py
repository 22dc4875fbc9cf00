"""Image/video writers (reference: imaginaire ``visualize/video.py``
``save_img_or_video`` used by run_inference)."""

from __future__ import annotations

import os

import numpy as np


def to_uint8(frames: np.ndarray) -> np.ndarray:
    """[-1, 1] float (C, T, H, W) or (C, H, W) -> uint8 HWC frames."""
    arr = np.asarray(frames, np.float32)
    arr = np.clip((arr + 1.0) * 127.5, 0, 255).astype(np.uint8)
    if arr.ndim == 3:  # C H W
        return arr.transpose(1, 2, 0)
    return arr.transpose(1, 2, 3, 0)  # T H W C


def save_image(path: str, image: np.ndarray):
    """image: (C, H, W) in [-1, 1]."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(to_uint8(image)).save(path)


def save_video(path: str, video: np.ndarray, fps: int = 16) -> str:
    """video: (C, T, H, W) in [-1, 1] -> mp4/gif by extension. Falls back to
    GIF when no mp4 backend (ffmpeg/pyav) is installed. Returns the path
    actually written."""
    import imageio

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames = list(to_uint8(video))
    try:
        imageio.mimsave(path, frames, fps=fps)
        return path
    except (ValueError, ImportError, IndexError):
        alt = os.path.splitext(path)[0] + ".gif"
        imageio.mimsave(alt, frames, duration=1000.0 / fps, loop=0)
        return alt


def save_img_or_video(path: str, data: np.ndarray, fps: int = 16):
    """Single-frame videos save as images; otherwise as video
    (visualize/video.py semantics)."""
    if data.ndim == 3 or data.shape[1] == 1:
        img = data if data.ndim == 3 else data[:, 0]
        save_image(path if path.endswith((".png", ".jpg")) else path + ".png", img)
    else:
        save_video(path if path.endswith((".mp4", ".gif")) else path + ".mp4",
                   data, fps)
