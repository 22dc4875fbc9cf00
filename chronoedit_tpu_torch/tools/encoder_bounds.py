"""Experiment: what ``chip_smoke.py``'s encoder bound (``ENCODER_MIN_DB``)
reads for sound encoders and for planted faults.

UMT5 (full width, two blocks, 512 token ids with a 300-id mask) and CLIP
ViT-H (full width, the two blocks of a three-block tower's penultimate
path, a 720x1280 frame through ``preprocess``) are built from the same
seed and in the same order as ``chip_smoke.py``'s phase 5, in fp32 on the
CPU as the reference and in bf16 on ``--device``. Each bf16 encoder runs
sound and then with one fault planted at a time (by patching the module,
never its source), and the line prints its dB over the reference's peak,
the measure phase 5 bounds:

- UMT5: the pad keys let into the attention (the mask dropped, the
  outputs past the prompt still zeroed); the logits scaled by
  head_dim**-0.5 as other attentions are;
- CLIP: the LayerNorms' scale not loaded (left at ones); the tanh GELU in
  place of the exact one; ``preprocess`` without antialiasing.

Run: ``python -m chronoedit_tpu_torch.tools.encoder_bounds [--device cpu]``
(the card by default; the CPU takes seconds).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
from unittest import mock

import torch
import torch.nn.functional as F

from chronoedit_tpu_torch.models import clip, umt5
from chronoedit_tpu_torch.ops import layers as L
from chronoedit_tpu_torch.utils.platform import cuda_device

# phase 5's sizes: a small vocabulary (the lookup's table size does not
# change the arithmetic), 512 ids of which 300 are the prompt, a 720p frame
SMALL_VOCAB = 4096
TEXT_TOKENS, PROMPT_LEN = 512, 300
EDIT_H, EDIT_W = 720, 1280
F32 = dict(dtype=torch.float32, param_dtype=torch.float32)


def peak_db(got: torch.Tensor, want: torch.Tensor) -> float:
    """PSNR over the reference's peak magnitude (features, not pixels)."""
    mse = float((got.double() - want.double()).square().mean())
    peak = float(want.double().abs().max())
    return math.inf if mse == 0 else 10.0 * math.log10(peak ** 2 / mse)


def redraw_layer_norms(model, g: torch.Generator) -> None:
    """CLIP's LayerNorms redrawn as in phase 5 (scale 1 + 0.1 N, bias 0.1 N)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, L.LayerNorm):
                m.scale.normal_(1.0, 0.1, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)


def _scaled_logits(p, x, bias, cfg):
    """UMT5's attention with the logits scaled by head_dim**-0.5 (a fault)."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v = (L.linear(p[n], x).reshape(b, s, h, hd).transpose(1, 2) for n in "qkv")
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5 + bias
    weights = torch.softmax(logits, dim=-1).to(x.dtype)
    return L.linear(p["o"], torch.matmul(weights, v).transpose(1, 2).reshape(b, s, h * hd))


def _unit_norms(model):
    """A copy of ``model`` whose LayerNorm scales were never loaded."""
    faulty = type(model)(model.cfg, device=model.pre_norm.scale.device)
    faulty.load_state_dict(model.state_dict())
    with torch.no_grad():
        for m in faulty.modules():
            if isinstance(m, L.LayerNorm):
                m.scale.fill_(1.0)
    return faulty


def main(device: torch.device) -> dict:
    g = torch.Generator().manual_seed(4)  # phase 5's seed and draw order
    t5_cfg = umt5.UMT5Config(vocab_size=SMALL_VOCAB, num_layers=2)
    t5_ref = umt5.init_umt5_params(dataclasses.replace(t5_cfg, **F32), g)
    t5 = umt5.UMT5(t5_cfg, device=device)
    t5.load_state_dict(t5_ref.state_dict())
    ids = torch.randint(0, SMALL_VOCAB, (1, TEXT_TOKENS), generator=g)
    mask = (torch.arange(TEXT_TOKENS) < PROMPT_LEN).long()[None]

    clip_cfg = clip.CLIPVisionConfig(num_layers=3)
    tower_ref = clip.init_clip_vision_params(dataclasses.replace(clip_cfg, **F32), g)
    redraw_layer_norms(tower_ref, g)
    tower = clip.CLIPVision(clip_cfg, device=device)
    tower.load_state_dict(tower_ref.state_dict())
    image = torch.rand((1, 3, EDIT_H, EDIT_W), generator=g) * 2.0 - 1.0

    def text(model, dev):
        out = umt5.UMT5TextEncoder(model).encode_ids(ids.to(dev), mask.to(dev))
        return out[:, :PROMPT_LEN].float().cpu()

    def vision(model, dev):
        return clip.CLIPImageEncoder(model)(image.to(dev)).float().cpu()

    encode = umt5.umt5_encode
    interpolate, gelu = F.interpolate, F.gelu
    cases = {
        "UMT5": (text, t5_ref, t5, {
            "sound": contextlib.nullcontext,
            "pad keys let in": lambda: mock.patch.object(
                umt5, "umt5_encode", lambda model, i, m=None: encode(model, i, None)),
            "logits scaled by head_dim**-0.5": lambda: mock.patch.object(
                umt5, "_t5_attention", _scaled_logits),
        }),
        "CLIP": (vision, tower_ref, tower, {
            "sound": contextlib.nullcontext,
            "LayerNorm scales not loaded": None,
            "tanh GELU": lambda: mock.patch.object(
                clip.F, "gelu", lambda x: gelu(x, approximate="tanh")),
            "preprocess without antialiasing": lambda: mock.patch.object(
                clip.F, "interpolate", lambda *a, **k: interpolate(*a, **{**k,
                                                                          "antialias": False})),
        }),
    }
    results = {}
    with torch.no_grad():
        for name, (run, ref, model, faults) in cases.items():
            want = run(ref, torch.device("cpu"))
            for fault, patch in faults.items():
                t0 = time.perf_counter()
                if patch is None:
                    got = run(_unit_norms(model), device)
                else:
                    with patch():
                        got = run(model, device)
                db = peak_db(got, want)
                results[f"{name}: {fault}"] = db
                print(f"{name} bf16 on {device.type}, {fault}: {db:.2f} dB over the fp32 peak "
                      f"{float(want.abs().max()):.4f} ({time.perf_counter() - t0:.1f} s)",
                      flush=True)
    print(json.dumps({"device": str(device), "db": results}))
    return results


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="where the bf16 side runs (default: the card)")
    args = parser.parse_args()
    main(torch.device(args.device) if args.device else cuda_device())
