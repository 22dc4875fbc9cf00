"""RetinaFace face detector for the face-blur guardrail, PyTorch.

The port of ``chronoedit_tpu/aux/face_detector.py``. The reference's face
blur uses the external Pytorch_Retinaface package's ResNet-50 RetinaFace
(`face_blur_filter/face_blur_filter.py:52-211`, `retinaface_utils.py:24-73`):
detect faces per frame, decode anchor boxes, NMS, then pixelate each region.

- NCHW convolutions (PyTorch's layout; cuDNN on the card).
- BatchNorm folded into the conv weights at conversion, as JAX does: the
  detector only runs in eval mode, so each conv + BN pair is one biased
  conv. The converter reads the public ``Resnet50_Final.pth`` naming.
- Anchors ("priors"), box decode and NMS run on the host in numpy (copies
  of JAX's), as the reference does.
- The FPN's nearest upsampling samples at half-pixel centres
  (``nearest-exact``), as ``jax.image.resize`` does: at 720p the C5 -> C4
  and C4 -> C3 sizes (23 -> 45, 45 -> 90) are not exact multiples, where
  the reference's ``F.interpolate(mode="nearest")`` would pick other rows.

Architecture (Pytorch_Retinaface ``cfg_re50``): ResNet-50 v1.5 body
returning C3/C4/C5 (strides 8/16/32), a 3-level FPN at 256 channels, one
SSH context module per level, and per-level class/bbox heads with 2 anchors
per cell (``min_sizes`` [[16,32],[64,128],[256,512]], steps [8,16,32],
variance [0.1,0.2]). Parameters are fp32, named as in the JAX tree.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from chronoedit_tpu_torch.ops.layers import empty_param

# detection post-processing constants (face_blur_filter.py:47-49)
TOP_K = 5_000
KEEP_TOP_K = 750
NMS_THRESHOLD = 0.4
CONFIDENCE_THRESHOLD = 0.7

# RetinaFace input preprocessing: BGR mean subtraction
# (face_blur_filter.py:101-106)
_BGR_MEANS = np.array([104.0, 117.0, 123.0], np.float32)


@dataclasses.dataclass(frozen=True)
class RetinaFaceConfig:
    """``cfg_re50`` geometry by default; shrinkable for tests."""

    width: int = 64                                # ResNet stem width
    blocks: tuple[int, ...] = (3, 4, 6, 3)         # ResNet-50
    out_channel: int = 256                         # FPN/SSH channels
    min_sizes: tuple[tuple[int, ...], ...] = ((16, 32), (64, 128), (256, 512))
    steps: tuple[int, ...] = (8, 16, 32)
    variance: tuple[float, float] = (0.1, 0.2)

    @property
    def fpn_in_channels(self) -> tuple[int, int, int]:
        # C3/C4/C5 of a bottleneck ResNet: width * (8, 16, 32)
        return self.width * 8, self.width * 16, self.width * 32

    @property
    def num_anchors(self) -> int:
        return len(self.min_sizes[0])


# ---------------------------------------------------------------- modules

class Conv(nn.Module):
    """A biased conv (BatchNorm folded in): ``weight`` (cout, cin, k, k)."""

    def __init__(self, cin: int, cout: int, k: int, device=None):
        super().__init__()
        self.weight = empty_param((cout, cin, k, k), device, torch.float32)
        self.bias = empty_param((cout,), device, torch.float32)


def _conv_dict(specs: dict, device) -> nn.ModuleDict:
    return nn.ModuleDict({name: Conv(*spec, device=device) for name, spec in specs.items()})


class RetinaFace(nn.Module):
    """The detector's parameters, named as in the JAX tree: ``stem``,
    ``layers`` (stages of bottlenecks with ``conv1-3`` and ``down``),
    ``fpn``, ``ssh`` and ``heads`` (``cls``, ``box``)."""

    def __init__(self, cfg: RetinaFaceConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.stem = Conv(3, w, 7, device)
        stages, cin = [], w
        for li, n_blocks in enumerate(cfg.blocks):
            mid = w * 2 ** li
            blocks = []
            for bi in range(n_blocks):
                spec = {"conv1": (cin, mid, 1), "conv2": (mid, mid, 3),
                        "conv3": (mid, mid * 4, 1)}
                if bi == 0:
                    spec["down"] = (cin, mid * 4, 1)
                blocks.append(_conv_dict(spec, device))
                cin = mid * 4
            stages.append(nn.ModuleList(blocks))
        self.layers = nn.ModuleList(stages)
        oc = cfg.out_channel
        c3c, c4c, c5c = cfg.fpn_in_channels
        self.fpn = _conv_dict({"output1": (c3c, oc, 1), "output2": (c4c, oc, 1),
                               "output3": (c5c, oc, 1), "merge1": (oc, oc, 3),
                               "merge2": (oc, oc, 3)}, device)
        self.ssh = nn.ModuleList(_conv_dict(
            {"c3": (oc, oc // 2, 3), "c5_1": (oc, oc // 4, 3), "c5_2": (oc // 4, oc // 4, 3),
             "c7_2": (oc // 4, oc // 4, 3), "c7_3": (oc // 4, oc // 4, 3)}, device)
            for _ in range(3))
        na = cfg.num_anchors
        self.heads = nn.ModuleDict({
            "cls": nn.ModuleList(Conv(oc, na * 2, 1, device) for _ in range(3)),
            "box": nn.ModuleList(Conv(oc, na * 4, 1, device) for _ in range(3))})


def init_retinaface_params(generator: torch.Generator, cfg: RetinaFaceConfig,
                           device=None) -> RetinaFace:
    """Random weights in the converted layout with JAX's distributions
    (kernels 0.1 N(0, 1), zero biases), for tests and shape checks."""
    model = RetinaFace(cfg, device=device)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv):
                m.weight.normal_(0.0, 0.1, generator=generator)
                m.bias.zero_()
    return model


# ---------------------------------------------------------------- forward

def _conv(p: Conv, x: torch.Tensor, stride: int = 1, pad: int = 0,
          relu: bool = False) -> torch.Tensor:
    y = F.conv2d(x, p.weight, p.bias, stride=stride, padding=pad)
    return F.relu(y) if relu else y


def _bottleneck(p: nn.ModuleDict, x: torch.Tensor, stride: int) -> torch.Tensor:
    """torchvision ResNet v1.5 bottleneck (stride on the 3x3 conv)."""
    out = _conv(p["conv1"], x, relu=True)
    out = _conv(p["conv2"], out, stride=stride, pad=1, relu=True)
    out = _conv(p["conv3"], out)
    shortcut = _conv(p["down"], x, stride=stride) if "down" in p else x
    return F.relu(out + shortcut)


def _ssh(p: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    """SSH context module: 3x3 (+) 5x5 (two 3x3s) (+) 7x7 (three 3x3s)."""
    c3 = _conv(p["c3"], x, pad=1)
    c5_1 = _conv(p["c5_1"], x, pad=1, relu=True)
    c5 = _conv(p["c5_2"], c5_1, pad=1)
    c7_2 = _conv(p["c7_2"], c5_1, pad=1, relu=True)
    c7 = _conv(p["c7_3"], c7_2, pad=1)
    return F.relu(torch.cat([c3, c5, c7], dim=1))


def _upsample_to(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, size=like.shape[2:], mode="nearest-exact")


def retinaface_forward(model: RetinaFace, images: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Images (B, 3, H, W) BGR mean-subtracted fp32 -> (loc (B, N, 4),
    conf (B, N, 2) softmaxed) over all N anchors, in the reference's anchor
    order (level, cell row-major, anchor)."""
    x = _conv(model.stem, images, stride=2, pad=3, relu=True)
    x = F.max_pool2d(x, 3, 2, 1)

    feats = []
    for li, stage in enumerate(model.layers):
        for bi, blk in enumerate(stage):
            x = _bottleneck(blk, x, stride=2 if (li > 0 and bi == 0) else 1)
        if li >= 1:  # C3, C4, C5
            feats.append(x)
    c3, c4, c5 = feats

    fpn = model.fpn
    p5 = _conv(fpn["output3"], c5, relu=True)
    p4 = _conv(fpn["output2"], c4, relu=True)
    p4 = _conv(fpn["merge2"], p4 + _upsample_to(p5, p4), pad=1, relu=True)
    p3 = _conv(fpn["output1"], c3, relu=True)
    p3 = _conv(fpn["merge1"], p3 + _upsample_to(p4, p3), pad=1, relu=True)

    locs, confs = [], []
    for level, feat in enumerate((p3, p4, p5)):
        feat = _ssh(model.ssh[level], feat)
        b = feat.shape[0]
        # 1x1 heads; NHWC order flattens to (B, cells * anchors, c)
        loc = _conv(model.heads["box"][level], feat).permute(0, 2, 3, 1)
        conf = _conv(model.heads["cls"][level], feat).permute(0, 2, 3, 1)
        locs.append(loc.reshape(b, -1, 4))
        confs.append(conf.reshape(b, -1, 2))
    return torch.cat(locs, dim=1), torch.softmax(torch.cat(confs, dim=1), dim=-1)


# ------------------------------------------------------- priors/decode/nms

def prior_boxes(cfg: RetinaFaceConfig, height: int, width: int) -> np.ndarray:
    """Anchor centers+sizes in [0,1] cxcywh, matching PriorBox
    (prior_box.py): per level, per cell (row-major), per min_size."""
    anchors = []
    for step, sizes in zip(cfg.steps, cfg.min_sizes):
        fh = -(-height // step)  # ceil
        fw = -(-width // step)
        for i in range(fh):
            for j in range(fw):
                for m in sizes:
                    anchors.append([(j + 0.5) * step / width,
                                    (i + 0.5) * step / height,
                                    m / width, m / height])
    return np.asarray(anchors, np.float32)


def decode_boxes(loc: np.ndarray, priors: np.ndarray,
                 variance: tuple[float, float]) -> np.ndarray:
    """Anchor-relative loc predictions -> xyxy boxes in [0,1]
    (retinaface_utils.py:46-73, batched)."""
    centers = priors[..., :2] + loc[..., :2] * variance[0] * priors[..., 2:]
    sizes = priors[..., 2:] * np.exp(loc[..., 2:] * variance[1])
    return np.concatenate([centers - sizes / 2, centers + sizes / 2], -1)


def nms(boxes: np.ndarray, scores: np.ndarray, thresh: float) -> list[int]:
    """Greedy IoU NMS (py_cpu_nms semantics: +1 box areas)."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        iou = w * h / (areas[i] + areas[order[1:]] - w * h)
        order = order[1:][iou <= thresh]
    return keep


def filter_boxes(boxes: np.ndarray, scores: np.ndarray,
                 confidence_threshold: float = CONFIDENCE_THRESHOLD,
                 nms_threshold: float = NMS_THRESHOLD,
                 top_k: int = TOP_K, keep_top_k: int = KEEP_TOP_K) -> np.ndarray:
    """Threshold -> sort/top-k -> NMS -> keep-top-k
    (retinaface_utils.py:24-42)."""
    inds = np.where(scores > confidence_threshold)[0]
    boxes, scores = boxes[inds], scores[inds]
    order = scores.argsort()[::-1][:top_k]
    boxes, scores = boxes[order], scores[order]
    if len(boxes) == 0:
        return boxes.reshape(0, 4)
    keep = nms(boxes.astype(np.float32), scores, nms_threshold)
    return boxes[keep][:keep_top_k]


# ---------------------------------------------------------------- converter

def _fold_conv_bn(sd: dict, conv_key: str, bn_key: str | None,
                  eps: float = 1e-5) -> tuple[np.ndarray, np.ndarray]:
    """Fold eval-mode BatchNorm into the preceding conv: (weight OIHW, bias),
    in fp32 numpy (JAX's arithmetic)."""
    w = np.asarray(sd[f"{conv_key}.weight"], np.float32)
    b = (np.asarray(sd[f"{conv_key}.bias"], np.float32)
         if f"{conv_key}.bias" in sd else np.zeros(w.shape[0], np.float32))
    if bn_key is not None:
        gamma = np.asarray(sd[f"{bn_key}.weight"], np.float32)
        beta = np.asarray(sd[f"{bn_key}.bias"], np.float32)
        mean = np.asarray(sd[f"{bn_key}.running_mean"], np.float32)
        var = np.asarray(sd[f"{bn_key}.running_var"], np.float32)
        scale = gamma / np.sqrt(var + eps)
        w = w * scale[:, None, None, None]
        b = beta + (b - mean) * scale
    return w, b


def convert_retinaface(sd: dict, cfg: RetinaFaceConfig | None = None,
                       device=None) -> RetinaFace:
    """Pytorch_Retinaface ``Resnet50_Final.pth`` state dict -> the detector
    on ``device``, BatchNorm folded.

    Accepts the ``module.``-stripped naming the reference loader produces
    (retinaface_utils.py:102-117): ``body.*`` (torchvision ResNet),
    ``fpn.*``, ``ssh1/2/3.*``, ``ClassHead/BboxHead/LandmarkHead.*``. The
    landmark head is not read: the blur path never uses landmarks
    (face_blur_filter.py:198 discards them).
    """
    cfg = cfg or RetinaFaceConfig()
    sd = {k.split("module.", 1)[-1]: (v.numpy() if isinstance(v, torch.Tensor) else v)
          for k, v in sd.items()}
    model = RetinaFace(cfg, device=device)
    folds = {"stem": ("body.conv1", "body.bn1")}
    for li, n_blocks in enumerate(cfg.blocks):
        for bi in range(n_blocks):
            pre = f"body.layer{li + 1}.{bi}"
            for c in (1, 2, 3):
                folds[f"layers.{li}.{bi}.conv{c}"] = (f"{pre}.conv{c}", f"{pre}.bn{c}")
            if bi == 0:
                folds[f"layers.{li}.{bi}.down"] = (f"{pre}.downsample.0", f"{pre}.downsample.1")
    for name in ("output1", "output2", "output3", "merge1", "merge2"):
        folds[f"fpn.{name}"] = (f"fpn.{name}.0", f"fpn.{name}.1")
    for i in range(3):
        # Pytorch_Retinaface really does name the last one with a lowercase x
        for port, ref in (("c3", "conv3X3"), ("c5_1", "conv5X5_1"), ("c5_2", "conv5X5_2"),
                          ("c7_2", "conv7X7_2"), ("c7_3", "conv7x7_3")):
            folds[f"ssh.{i}.{port}"] = (f"ssh{i + 1}.{ref}.0", f"ssh{i + 1}.{ref}.1")
        folds[f"heads.cls.{i}"] = (f"ClassHead.{i}.conv1x1", None)
        folds[f"heads.box.{i}"] = (f"BboxHead.{i}.conv1x1", None)
    convs = dict(model.named_modules())
    with torch.no_grad():
        for name, (conv_key, bn_key) in folds.items():
            weight, bias = _fold_conv_bn(sd, conv_key, bn_key)
            convs[name].weight.copy_(torch.from_numpy(weight))
            convs[name].bias.copy_(torch.from_numpy(bias))
    if len(folds) != sum(isinstance(m, Conv) for m in convs.values()):
        raise ValueError("the checkpoint's convolutions do not cover the detector")
    return model


# ---------------------------------------------------------------- slot glue

def make_face_detect_fn(model: RetinaFace,
                        confidence_threshold: float = CONFIDENCE_THRESHOLD,
                        min_size: tuple[int, int] = (20, 20)):
    """The ``FaceBlur`` slot callable: ``detect(frame_rgb_uint8) -> [(x0,
    y0, x1, y1), ...]`` pixel boxes (face_blur_filter.py:108-160); the
    forward runs on the detector's device."""
    cfg = model.cfg
    device = model.stem.weight.device

    @functools.lru_cache(maxsize=8)
    def _priors(h, w):
        return prior_boxes(cfg, h, w)

    @torch.inference_mode()
    def detect(frame: np.ndarray) -> list[tuple[int, int, int, int]]:
        h, w = frame.shape[:2]
        bgr = frame[..., ::-1].astype(np.float32) - _BGR_MEANS
        x = torch.from_numpy(np.ascontiguousarray(bgr.transpose(2, 0, 1)))[None]
        loc, conf = retinaface_forward(model, x.to(device))
        boxes = decode_boxes(loc[0].cpu().numpy(), _priors(h, w), cfg.variance)
        boxes = boxes * np.array([w, h, w, h], np.float32)
        kept = filter_boxes(boxes, conf[0, :, 1].cpu().numpy(), confidence_threshold)
        out = []
        for x0, y0, x1, y1 in kept.astype(int):
            if x1 - x0 < min_size[0] or y1 - y0 < min_size[1]:
                continue
            x0, y0 = max(x0, 0), max(y0, 0)
            x1, y1 = min(x1, w), min(y1, h)
            if x1 > x0 and y1 > y0:  # drop boxes fully outside the frame
                out.append((x0, y0, x1, y1))
        return out

    return detect
