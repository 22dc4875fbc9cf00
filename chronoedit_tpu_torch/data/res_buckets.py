"""Resolution / aspect-ratio buckets.

Equivalent of the reference's ``VIDEO_RES_SIZE_INFO`` table
(``chronoedit/_src/datasets/utils.py:45-68``) and the area-matched mod-16
sizing of the inference script (``run_inference_diffusers.py:260-280``):
given a source aspect ratio, pick the (height, width) whose area matches the
resolution class with both dims divisible by 16.

A verbatim copy of ``chronoedit_tpu/data/res_buckets.py`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

# resolution class -> aspect-label -> (height, width), all mod-16
VIDEO_RES_SIZE_INFO: dict[str, dict[str, tuple[int, int]]] = {
    "480p": {
        "16:9": (480, 832), "9:16": (832, 480),
        "4:3": (512, 672), "3:4": (672, 512), "1:1": (576, 576),
    },
    "720p": {
        "16:9": (720, 1280), "9:16": (1280, 720),
        "4:3": (768, 1024), "3:4": (1024, 768), "1:1": (880, 880),
    },
    "1080p": {
        "16:9": (1088, 1920), "9:16": (1920, 1088),
        "4:3": (1152, 1536), "3:4": (1536, 1152), "1:1": (1328, 1328),
    },
}


def nearest_bucket(height: int, width: int, resolution: str = "720p") -> tuple[int, int]:
    """Pick the bucket in ``resolution`` with the closest aspect ratio."""
    aspect = width / height
    table = VIDEO_RES_SIZE_INFO[resolution]
    best = min(table.values(), key=lambda hw: abs(hw[1] / hw[0] - aspect))
    return best


def area_matched_size(height: int, width: int, target_area: int = 720 * 1280,
                      mod: int = 16) -> tuple[int, int]:
    """Scale (h, w) to ~target_area preserving aspect, both dims mod-N
    (run_inference_diffusers.py:260-280 sizing)."""
    scale = (target_area / (height * width)) ** 0.5
    h = max(mod, round(height * scale / mod) * mod)
    w = max(mod, round(width * scale / mod) * mod)
    return h, w
