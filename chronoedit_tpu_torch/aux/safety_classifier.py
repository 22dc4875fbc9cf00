"""SigLIP vision encoder + MLP video-content safety classifier, PyTorch.

The port of ``chronoedit_tpu/aux/safety_classifier.py``: the reference's
video guardrail is a SigLIP so400m-patch14-384 image encoder feeding a
3-layer MLP multi-class safety head
(video_content_safety_filter/vision_encoder.py + model.py; runner logic
video_content_safety_filter.py:50-130).

- :func:`siglip_encode`: SigLIP ViT (patchify as reshape + linear, learned
  position embeddings, pre-LN blocks with tanh-GELU MLPs, post-LN, a
  multihead attention-pooling head with a learned probe), as HF
  ``SiglipVisionModel.pooler_output``; L2-normalized like
  ``SiglipModel.get_image_features``. Attention goes through
  ``ops.attention``: head dim 72 takes PyTorch's SDPA on the card (no
  Pallas kernel lives here), the plain twin on the CPU.
- :func:`classifier_logits`: Linear(->512)/BN/ReLU, Linear(->256)/BN/ReLU,
  Linear(->num_classes), BatchNorm in eval mode (model.py SafetyClassifier).
- converters from the HF SigLIP state dict and the reference's
  ``safety_filter.pt`` checkpoint.
- :func:`preprocess`: resize on the host with ``F.interpolate`` on a uint8
  CPU tensor (bicubic, antialiased), which stands in for PIL's bicubic
  resize (JAX's path; PIL is not a dependency of the port).
- :func:`make_classify_fn`: the ``FrameSafetyClassifier`` slot callable.

Parameters are fp32, named as in the JAX tree (``models/from_jax.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from chronoedit_tpu_torch.models import weights as w
from chronoedit_tpu_torch.ops import layers as L
from chronoedit_tpu_torch.ops.attention import dot_product_attention

CLASS_IDX_TO_NAME = {
    0: "Safe", 1: "Sexual_Content", 3: "Drugs", 4: "Child_Abuse",
    5: "Hate_and_Harassment", 6: "Self-Harm",
}
UNSAFE_FRAMES_PCT = 10.0
BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class SigLIPVisionConfig:
    """google/siglip-so400m-patch14-384 geometry by default."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    image_size: int = 384
    patch_size: int = 14
    eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class _Block(nn.Module):
    def __init__(self, d: int, hidden: int, device):
        super().__init__()
        self.ln1, self.ln2 = (L.LayerNorm(d, device=device) for _ in range(2))
        self.q, self.k, self.v, self.o = (L.Linear(d, d, device=device) for _ in range(4))
        self.fc1 = L.Linear(d, hidden, device=device)
        self.fc2 = L.Linear(hidden, d, device=device)


class _Head(nn.Module):
    """The attention-pooling head: a learned probe attends over the tokens."""

    def __init__(self, d: int, hidden: int, device):
        super().__init__()
        self.probe = L.empty_param((1, 1, d), device, torch.float32)
        self.q, self.k, self.v, self.o = (L.Linear(d, d, device=device) for _ in range(4))
        self.ln = L.LayerNorm(d, device=device)
        self.fc1 = L.Linear(d, hidden, device=device)
        self.fc2 = L.Linear(hidden, d, device=device)


class SigLIPVision(nn.Module):
    """The tower's fp32 parameters (uninitialised until converted or
    loaded)."""

    def __init__(self, cfg: SigLIPVisionConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        d, hidden = cfg.hidden_size, cfg.intermediate_size
        self.patch_embed = L.Linear(3 * cfg.patch_size ** 2, d, device=device)
        self.pos_embed = L.empty_param((1, cfg.num_patches, d), device, torch.float32)
        self.blocks = nn.ModuleList(_Block(d, hidden, device) for _ in range(cfg.num_layers))
        self.post_ln = L.LayerNorm(d, device=device)
        self.head = _Head(d, hidden, device)


class _ClassifierLayer(nn.Module):
    """A linear layer, followed (``bn``) by eval-mode BatchNorm and ReLU."""

    def __init__(self, d_in: int, d_out: int, bn: bool, device):
        super().__init__()
        self.weight = L.empty_param((d_out, d_in), device, torch.float32)
        self.bias = L.empty_param((d_out,), device, torch.float32)
        if bn:
            for name in ("bn_scale", "bn_bias", "bn_mean", "bn_var"):
                setattr(self, name, L.empty_param((d_out,), device, torch.float32))


class SafetyClassifier(nn.Module):
    """The MLP head over the SigLIP embedding."""

    def __init__(self, d_in: int, num_classes: int = 7, device=None):
        super().__init__()
        self.layers = nn.ModuleList([_ClassifierLayer(d_in, 512, True, device),
                                     _ClassifierLayer(512, 256, True, device),
                                     _ClassifierLayer(256, num_classes, False, device)])


def _ln(p: L.LayerNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    return L.layer_norm(p, x, eps)


def _mha(q, k, v, num_heads: int) -> torch.Tensor:
    b, sq, d = q.shape
    hd = d // num_heads

    def split(t):
        return t.reshape(b, -1, num_heads, hd).contiguous()

    return dot_product_attention(split(q), split(k), split(v)).reshape(b, sq, d)


def siglip_encode(model: SigLIPVision, pixels: torch.Tensor,
                  normalize: bool = True) -> torch.Tensor:
    """Pixels (B, 3, S, S), SigLIP-preprocessed (see :func:`preprocess`) ->
    pooled (B, hidden) fp32 features; L2-normalized when ``normalize``."""
    cfg = model.cfg
    p, n = cfg.patch_size, cfg.image_size // cfg.patch_size
    b = pixels.shape[0]
    # the patchify conv (stride = kernel, no padding) as reshape + matmul,
    # feature order (c, ph, pw); like the conv it drops the rows and columns
    # past the last whole patch (384 = 27 x 14 + 6 at so400m's geometry)
    x = pixels.to(model.pos_embed.device, torch.float32)[:, :, :n * p, :n * p]
    x = x.reshape(b, 3, n, p, n, p).permute(0, 2, 4, 1, 3, 5).reshape(b, cfg.num_patches, -1)
    x = L.linear(model.patch_embed, x) + model.pos_embed
    for blk in model.blocks:
        h = _ln(blk.ln1, x, cfg.eps)
        attn = _mha(L.linear(blk.q, h), L.linear(blk.k, h), L.linear(blk.v, h), cfg.num_heads)
        x = x + L.linear(blk.o, attn)
        h = _ln(blk.ln2, x, cfg.eps)
        x = x + L.linear(blk.fc2, L.gelu_tanh(L.linear(blk.fc1, h)))
    x = _ln(model.post_ln, x, cfg.eps)

    head = model.head
    probe = head.probe.expand(b, 1, cfg.hidden_size)
    pooled = L.linear(head.o, _mha(L.linear(head.q, probe), L.linear(head.k, x),
                                   L.linear(head.v, x), cfg.num_heads))
    h = _ln(head.ln, pooled, cfg.eps)
    pooled = pooled + L.linear(head.fc2, L.gelu_tanh(L.linear(head.fc1, h)))
    out = pooled[:, 0]
    if normalize:
        out = out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    return out


def preprocess(frames, cfg: SigLIPVisionConfig) -> torch.Tensor:
    """(T, H, W, 3) uint8 or [-1, 1] float frames -> the SigLIP pixel batch
    (T, 3, S, S) fp32 on the CPU: a bicubic antialiased resize of the uint8
    frames to the square input, rounded back to uint8 as an image resize
    does, then (x / 255 - 0.5) / 0.5."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = ((np.clip(frames, -1, 1) + 1) * 127.5).astype(np.uint8)
    s = cfg.image_size
    x = torch.from_numpy(np.ascontiguousarray(frames)).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(s, s), mode="bicubic", align_corners=False, antialias=True)
    return (x.float() / 255.0 - 0.5) / 0.5


def classifier_logits(model: SafetyClassifier, emb: torch.Tensor) -> torch.Tensor:
    """SafetyClassifier (model.py): Linear/BN/ReLU x2 + Linear, BN in eval
    mode (running statistics)."""
    x = emb
    for layer in model.layers:
        x = F.linear(x, layer.weight, layer.bias)
        if hasattr(layer, "bn_mean"):
            x = ((x - layer.bn_mean) * torch.rsqrt(layer.bn_var + BN_EPS)
                 * layer.bn_scale + layer.bn_bias)
            x = F.relu(x)
    return x


# ---------------------------------------------------------------- converters

def _lin(ref: str, port: str) -> dict[str, str]:
    return {f"{ref}.weight": f"{port}.weight", f"{ref}.bias": f"{port}.bias"}


def _norm(ref: str, port: str) -> dict[str, str]:
    return {f"{ref}.weight": f"{port}.scale", f"{ref}.bias": f"{port}.bias"}


def siglip_names(cfg: SigLIPVisionConfig) -> dict[str, str]:
    """{HF ``SiglipVisionModel`` name (no ``vision_model.`` prefix): the
    tower's parameter name}; the pooling head's packed ``in_proj`` appears
    split into ``head.attention.{q,k,v}_proj``."""
    names = {"embeddings.patch_embedding.weight": "patch_embed.weight",
             "embeddings.patch_embedding.bias": "patch_embed.bias",
             "embeddings.position_embedding.weight": "pos_embed",
             **_norm("post_layernorm", "post_ln"),
             "head.probe": "head.probe",
             **{k: v for ref, port in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                                       ("out_proj", "o"))
                for k, v in _lin(f"head.attention.{ref}", f"head.{port}").items()},
             **_norm("head.layernorm", "head.ln"),
             **_lin("head.mlp.fc1", "head.fc1"), **_lin("head.mlp.fc2", "head.fc2")}
    for i in range(cfg.num_layers):
        pre, port = f"encoder.layers.{i}", f"blocks.{i}"
        names.update({**_norm(f"{pre}.layer_norm1", f"{port}.ln1"),
                      **_norm(f"{pre}.layer_norm2", f"{port}.ln2"),
                      **_lin(f"{pre}.self_attn.q_proj", f"{port}.q"),
                      **_lin(f"{pre}.self_attn.k_proj", f"{port}.k"),
                      **_lin(f"{pre}.self_attn.v_proj", f"{port}.v"),
                      **_lin(f"{pre}.self_attn.out_proj", f"{port}.o"),
                      **_lin(f"{pre}.mlp.fc1", f"{port}.fc1"),
                      **_lin(f"{pre}.mlp.fc2", f"{port}.fc2")})
    return names


def convert_siglip_vision(sd: w.StateDict, cfg: SigLIPVisionConfig | None = None,
                          device=None) -> SigLIPVision:
    """HF ``SiglipVisionModel`` state dict (bare or ``vision_model.``-
    prefixed keys) -> the tower on ``device``, fp32."""
    cfg = cfg or SigLIPVisionConfig()
    sd = {k.removeprefix("vision_model."): torch.as_tensor(v) for k, v in sd.items()}
    d = cfg.hidden_size
    in_w, in_b = sd.pop("head.attention.in_proj_weight"), sd.pop("head.attention.in_proj_bias")
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        sd[f"head.attention.{name}.weight"] = in_w[i * d:(i + 1) * d]
        sd[f"head.attention.{name}.bias"] = in_b[i * d:(i + 1) * d]
    return w.fill_module(SigLIPVision(cfg, device=device),
                         {k: v.float() for k, v in sd.items()}, siglip_names(cfg))


def convert_safety_classifier(sd: w.StateDict, device=None) -> SafetyClassifier:
    """``safety_filter.pt``'s ``network.layers.*`` Sequential (Linear, BN,
    ReLU, Linear, BN, ReLU, Linear) -> the classifier on ``device``."""
    sd = {k.removeprefix("network."): torch.as_tensor(v).float() for k, v in sd.items()}
    names = {}
    for i, (lin, bn) in enumerate(((0, 1), (3, 4))):
        names.update({f"layers.{lin}.weight": f"layers.{i}.weight",
                      f"layers.{lin}.bias": f"layers.{i}.bias",
                      f"layers.{bn}.weight": f"layers.{i}.bn_scale",
                      f"layers.{bn}.bias": f"layers.{i}.bn_bias",
                      f"layers.{bn}.running_mean": f"layers.{i}.bn_mean",
                      f"layers.{bn}.running_var": f"layers.{i}.bn_var"})
    names.update({"layers.6.weight": "layers.2.weight", "layers.6.bias": "layers.2.bias"})
    d_in, classes = sd["layers.0.weight"].shape[1], sd["layers.6.weight"].shape[0]
    return w.fill_module(SafetyClassifier(d_in, classes, device), sd, names,
                         ignore=("num_batches_tracked",))


# ---------------------------------------------------------------- slot glue

def make_classify_fn(siglip: SigLIPVision, classifier: SafetyClassifier,
                     unsafe_frames_pct: float = UNSAFE_FRAMES_PCT, sample_every: int = 1,
                     chunk: int = 8):
    """The ``FrameSafetyClassifier`` slot callable: ``classify(frames) ->
    bool`` (True = SAFE, the slot's polarity: it blocks on False) over
    (T, H, W, 3) frames. Every ``sample_every``-th frame is encoded and
    classified on the tower's device, ``chunk`` frames at a time; the video
    is unsafe when more than ``unsafe_frames_pct`` percent of the sampled
    frames predict a non-Safe class (video_content_safety_filter.py:96-130).
    """
    cfg = siglip.cfg

    @torch.inference_mode()
    def classify(frames) -> bool:
        pixels = preprocess(np.asarray(frames)[::max(sample_every, 1)], cfg)
        classes = torch.cat([
            classifier_logits(classifier, siglip_encode(siglip, part)).argmax(dim=-1)
            for part in pixels.split(chunk)])
        unsafe = float((classes != 0).float().mean()) * 100.0
        return unsafe <= unsafe_frames_pct

    return classify
