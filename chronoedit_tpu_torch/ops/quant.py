"""Quantized serving for the DiT's block projections: w8a8, w4a16, w4a8.

The port of ``chronoedit_tpu/ops/quant.py``. A quantized projection is a
leaf module that replaces the block's :class:`~ops.layers.Linear` in place
(:func:`quantize_dit`); ``layers.linear`` dispatches on its type, as JAX
dispatches on the leaf's keys. Attention, the embedders, the head, the
norms and the modulation tables stay in the model's float dtype.

- **w8a8** (:class:`QuantLinear8`, mode ``"int8"``): symmetric int8
  weights with one scale per output channel; activations quantized per
  token on the fly (``max(amax, 1e-8) / 127``, round half to even, clip
  to +-127); int32 sums from ``torch._int_mm`` (cuBLASLt's int8 product
  on the card), dequantized as ``acc * xs * w_scale`` in fp32 with the
  bias added in fp32, then cast to x's dtype.
- **w4a16** (:class:`QuantLinear4`, mode ``"int4"``): split-half packed
  int4 nibbles with one fp32 scale per 128-row group and output channel.
  The weight is ``table[q + 7] * scale``: the uniform grid's table holds
  the integers -7..7 (scale = absmax / 7), the default Lloyd grid's 15
  MSE-optimal levels in [-1, 1] (scale = the group's absmax). The product
  is K8 (``ops/int4_matmul.py``) on the card, for both grids; JAX launches
  its Pallas kernel only for the uniform grid behind an environment
  switch and otherwise computes the same function in XLA.
- **w4a8** (mode ``"int4_a8"``): w4a16's storage plus a per-column int8
  scale ``scale8``; each call requantizes the weight to int8
  (``rint(table[q + 7] * scale / scale8)``, clipped to +-127) and runs the
  w8a8 product, two half products summed in fp32 as JAX does.

Layouts (the port's weights are (out, in), JAX's kernels (in, out)):
``weight_q`` (out, in) int8 is JAX's ``kernel_q`` transposed; ``packed``
(out, in_pad / 2) int8 is ``kernel_q4`` transposed, byte (n, j) holding
row j of the (in_pad, out) weight in its low nibble and row j + in_pad/2
in its high nibble; ``scales`` (g, out) fp32 is ``kernel_scale4`` as it
is, the first half's groups first. ``in_pad`` rounds the in-dim up to an
even number of 128-row groups.

The QLoRA branch (side adapters over a quantized base with the
straight-through int8 product) is not ported: the leaves serve forward
only, and ``models/lora.py`` refuses to merge into one.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from chronoedit_tpu_torch.ops import layers as L
from chronoedit_tpu_torch.ops.int4_matmul import GROUP as INT4_GROUP
from chronoedit_tpu_torch.ops.int4_matmul import dequantize, int4_matmul
from chronoedit_tpu_torch.ops.int4_matmul import unpack_int4 as _unpack_int4

_EPS = 1e-8
MODES = ("int8", "int4", "int4_a8")
INT4_GRID = "lloyd"  # the default int4 grid, as in JAX

# the per-token projections; the context k/v projections and the edges stay
# in float under int8
_BLOCK_LINEARS = (
    ("self_attn", "q"), ("self_attn", "k"), ("self_attn", "v"), ("self_attn", "o"),
    ("cross_attn", "q"), ("cross_attn", "o"),
    ("ffn", "fc1"), ("ffn", "fc2"),
)
# int4 is a capacity scheme: it also takes the context k/v projections
_BLOCK_LINEARS_INT4 = _BLOCK_LINEARS + (
    ("cross_attn", "k"), ("cross_attn", "v"),
    ("cross_attn", "k_img"), ("cross_attn", "v_img"),
)
# projections promoted to w8a8 inside an int4 model (JAX's measured
# sensitivity ladder): mixed, and mixed2, the recipe over the 35 dB bar
INT4_MIXED_UPGRADE = (
    ("cross_attn", "v_img"), ("cross_attn", "v"), ("self_attn", "o"),
)
INT4_MIXED2_UPGRADE = (
    ("cross_attn", "v_img"), ("cross_attn", "v"), ("cross_attn", "o"),
    ("self_attn", "o"), ("ffn", "fc2"),
)


# ------------------------------------------------------------------ leaves

class QuantLinear8(nn.Module):
    """w8a8 leaf: ``weight_q`` (out, in) int8, ``weight_scale`` (out,)
    fp32, ``bias`` (out,) in the float layer's dtype; all frozen buffers."""

    def __init__(self, weight_q: torch.Tensor, weight_scale: torch.Tensor,
                 bias: torch.Tensor):
        super().__init__()
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("weight_scale", weight_scale)
        self.register_buffer("bias", bias)


class QuantLinear4(nn.Module):
    """int4 leaf: ``packed`` (out, in_pad/2) int8 split-half nibbles,
    ``scales`` (g, out) fp32 (g = in_pad / 128, the first half's groups
    first), ``table`` (15,) fp32 (indexed by the nibble + 7), ``scale8``
    (out,) fp32 for w4a8 or None for w4a16, ``bias`` (out,) in the float
    layer's dtype; all frozen buffers."""

    def __init__(self, packed: torch.Tensor, scales: torch.Tensor, table: torch.Tensor,
                 bias: torch.Tensor, scale8: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("packed", packed)
        self.register_buffer("scales", scales)
        self.register_buffer("table", table)
        self.register_buffer("scale8", scale8)
        self.register_buffer("bias", bias)


def is_quantized(m: nn.Module) -> bool:
    return isinstance(m, (QuantLinear8, QuantLinear4))


# --------------------------------------------------------------- quantizers

def quantize_linear_params(lin: L.Linear) -> QuantLinear8:
    """Per-output-channel symmetric int8: ``scale = max(absmax, 1e-8) /
    127``, ``q = clip(round(w / scale), -127, 127)``."""
    w = lin.weight.detach().float()
    scale = w.abs().amax(dim=1).clamp_min(_EPS) / 127.0
    q = torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return QuantLinear8(q, scale, lin.bias.detach().clone())


@functools.lru_cache(maxsize=None)
def _lloyd_levels(eff_group: int) -> tuple[float, ...]:
    """15 symmetric levels in [-1, 1] minimizing MSE over absmax-normalized
    Gaussian groups of ``eff_group`` elements: the Lloyd-Max iteration of
    JAX's ``_lloyd_levels``, the same numpy arithmetic (so the same bits)
    from the same seed. Odd-symmetric with an exact 0 and pinned +-1
    endpoints. About 13 s of CPU per distinct ``eff_group`` and process."""
    rng = np.random.default_rng(12345)
    n = max(int(eff_group), 2)
    m = max(64, 2_000_000 // n)
    w = rng.standard_normal((m, n))
    x = (w / np.abs(w).max(axis=1, keepdims=True)).ravel()
    lv = np.linspace(-1.0, 1.0, 15)
    for _ in range(200):
        edges = (lv[1:] + lv[:-1]) / 2
        idx = np.digitize(x, edges)
        sums = np.bincount(idx, weights=x, minlength=15)
        cnts = np.bincount(idx, minlength=15)
        lv = np.where(cnts > 0, sums / np.maximum(cnts, 1), lv)
        lv = (lv - lv[::-1]) / 2.0  # odd symmetry; lv[7] == 0 exactly
        lv[0], lv[-1] = -1.0, 1.0
    return tuple(float(v) for v in lv)


def int4_levels(grid: str, eff_group: int, device=None) -> torch.Tensor:
    """The (15,) fp32 table of ``grid``: the integers -7..7 for "uniform",
    the Lloyd levels for "lloyd"."""
    if grid == "uniform":
        return torch.arange(-7, 8, dtype=torch.float32, device=device)
    if grid == "lloyd":
        return torch.tensor(_lloyd_levels(eff_group), dtype=torch.float32, device=device)
    raise ValueError(f"unknown int4 grid {grid!r}")


def quantize_linear_params_int4(lin: L.Linear, act8: bool = False,
                                grid: str | None = None) -> QuantLinear4:
    """Grouped int4 with per-(128-row group, output channel) scales, packed
    split half; zero-padded rows quantize to 0. ``act8`` adds ``scale8 =
    max_g(absmax) / 127`` (w4a8). Bit for bit JAX's
    ``quantize_linear_params_int4`` (at its default group) on the
    transposed weight."""
    grid = INT4_GRID if grid is None else grid
    group = INT4_GROUP
    w = lin.weight.detach().float()
    dout, din = w.shape
    g = -(-din // group)
    g += g % 2  # even group count: the half split lands on a group edge
    k = F.pad(w.T, (0, 0, 0, g * group - din))  # (in_pad, out), as JAX's kernel
    kg = k.reshape(g, group, dout)
    absmax = kg.abs().amax(dim=1).clamp_min(_EPS)  # (g, out)
    table = int4_levels(grid, min(group, din), device=w.device)
    if grid == "uniform":  # w ~ q * scale, q in [-7, 7]
        scale = absmax / 7.0
        q = torch.round(kg / scale[:, None, :]).clamp(-7, 7)
    else:  # codebook: w ~ table[q + 7] * scale, scale = group absmax
        scale = absmax
        edges = (table[1:] + table[:-1]) / 2.0
        q = torch.searchsorted(edges, (kg / scale[:, None, :]).contiguous()) - 7
    q = q.to(torch.int8).reshape(g * group, dout)
    half = g * group // 2
    # through uint8: a left shift of a negative int8 is not defined
    lo, hi = q[:half].view(torch.uint8), q[half:].view(torch.uint8)
    packed = ((lo & 0x0F) | (hi << 4)).view(torch.int8)
    scale8 = absmax.amax(dim=0) / 127.0 if act8 else None
    return QuantLinear4(packed.T.contiguous(), scale, table, lin.bias.detach().clone(),
                        scale8)


# ------------------------------------------------------------------ applies

def _int8_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ w.T``: a (..., K) int8, w (N, K) int8, through
    ``torch._int_mm``. Rows are padded with zeros to at least 17, which
    cuBLASLt's int8 product needs on the card."""
    lead, k = a.shape[:-1], a.shape[-1]
    a2 = a.reshape(-1, k).contiguous()
    m = a2.shape[0]
    if m <= 16:
        a2 = F.pad(a2, (0, 0, 0, 17 - m))
    return torch._int_mm(a2, w.T)[:m].reshape(*lead, w.shape[0])


def _quantize_tokens(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 of x: (xq int8, xs (..., 1) fp32)."""
    xf = x.float()
    xs = xf.abs().amax(dim=-1, keepdim=True).clamp_min(_EPS) / 127.0
    return torch.round(xf / xs).clamp(-127, 127).to(torch.int8), xs


def quantized_linear(p: QuantLinear8, x: torch.Tensor) -> torch.Tensor:
    """w8a8: per-token int8 activations, int32 sums, ``acc * xs * w_scale
    + bias`` in fp32; out in x's dtype."""
    xq, xs = _quantize_tokens(x)
    y = _int8_mm(xq, p.weight_q).float() * xs * p.weight_scale
    return (y + p.bias.float()).to(x.dtype)


def quantized_linear_int4(p: QuantLinear4, x: torch.Tensor) -> torch.Tensor:
    """int4 leaf: w4a8 when ``p.scale8`` is set, else w4a16 through K8
    (the bias added afterwards in x's dtype, as JAX does). x's last dim
    is zero-padded to in_pad."""
    pad = 2 * p.packed.shape[1] - x.shape[-1]
    if pad:
        x = F.pad(x, (0, pad))
    if p.scale8 is not None:
        return _int4_apply_a8(p, x)
    return int4_matmul(x, p.packed, p.scales, p.table) + p.bias.to(x.dtype)


def _int4_apply_a8(p: QuantLinear4, x: torch.Tensor) -> torch.Tensor:
    """w4a8: the int4 weight requantized per call to per-column int8
    (``rint(table[q + 7] * scale / scale8)``, clipped to +-127), per-token
    int8 activations, the two halves' int32 products converted to fp32
    and summed, then ``* xs * scale8 + bias`` in fp32."""
    dout, half = p.packed.shape
    g = p.scales.shape[0]
    f = (p.scales / p.scale8).T  # (out, g): <= 127 / 7 uniform, <= 127 codebook

    def rq(q_half, f_half):
        w = p.table[q_half.long() + 7].reshape(dout, g // 2, -1) * f_half[:, :, None]
        return torch.round(w).clamp(-127, 127).to(torch.int8).reshape(dout, half)

    lo, hi = _unpack_int4(p.packed)
    w8_lo, w8_hi = rq(lo, f[:, : g // 2]), rq(hi, f[:, g // 2:])
    xq, xs = _quantize_tokens(x)
    acc = (_int8_mm(xq[..., :half], w8_lo).float()
           + _int8_mm(xq[..., half:], w8_hi).float())
    y = acc * xs * p.scale8
    return (y + p.bias.float()).to(x.dtype)


# -------------------------------------------------------------------- model

def quantize_dit(model: nn.Module, skip: tuple = (), mode: str = "int8",
                 upgrade: tuple = ()) -> nn.Module:
    """Replace the block projections of ``model`` (a DiT) in place by
    quantized leaves and return it: w8a8 (``"int8"``) on
    ``_BLOCK_LINEARS``; w4a16 (``"int4"``) or w4a8 (``"int4_a8"``) on
    ``_BLOCK_LINEARS_INT4``. ``skip`` lists (module, name) projections to
    keep in float; ``upgrade`` those quantized w8a8 instead of the mode's
    int4 (each must be a target of the mode). An already-quantized leaf is
    left alone, so a second call changes nothing and int8-then-int4 keeps
    the int8 leaves. Each float layer is dropped as its leaf takes its
    place, so its weight is freed as the walk goes."""
    if mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r}")
    targets = _BLOCK_LINEARS if mode == "int8" else _BLOCK_LINEARS_INT4
    bad = [u for u in upgrade if u not in targets]
    if bad:
        raise ValueError(f"upgrade entries are not quantization targets for mode "
                         f"{mode!r}: {bad}")
    if mode == "int8":
        qfn = quantize_linear_params
    else:
        qfn = functools.partial(quantize_linear_params_int4, act8=mode == "int4_a8")
    with torch.no_grad():
        for blk in model.blocks:
            for mod, name in targets:
                parent = getattr(blk, mod, None)
                lin = getattr(parent, name, None) if parent is not None else None
                if lin is None or (mod, name) in skip or is_quantized(lin):
                    continue
                fn = quantize_linear_params if (mod, name) in upgrade else qfn
                setattr(parent, name, fn(lin))
    return model


def dequantize_linear_params(p: nn.Module, in_dim: int | None = None) -> L.Linear:
    """The fp32 float layer a leaf stands for (lossy inverse of the
    quantizers). ``in_dim`` trims the int4 group padding and is required
    for int4 leaves, whose packing does not record the in-dim."""
    if isinstance(p, QuantLinear4):
        if in_dim is None:
            raise ValueError("dequantize_linear_params: in_dim is required for int4 "
                             f"leaves (padded in-dim here: {2 * p.packed.shape[1]})")
        w = dequantize(p.packed, p.scales, p.table)[:, :in_dim]
    else:
        w = p.weight_q.float() * p.weight_scale[:, None]
    out = L.Linear(w.shape[1], w.shape[0], device=w.device)
    with torch.no_grad():
        out.weight.copy_(w)
        out.bias.copy_(p.bias)
    return out


def quantization_error(lin: L.Linear) -> float:
    """Max relative per-channel weight error of int8 quantization:
    ``max_out(max_in |deq - w| / max(max_in |w|, 1e-8))``."""
    w = lin.weight.detach().float()
    deq = dequantize_linear_params(quantize_linear_params(lin)).weight
    denom = w.abs().amax(dim=1).clamp_min(_EPS)
    return float(((deq - w).abs().amax(dim=1) / denom).max())


def rank_projection_sensitivity(model: nn.Module, mode: str = "int8"
                                ) -> list[tuple[tuple[str, str], float]]:
    """The float projections that ``mode`` would quantize, ranked worst
    first by the largest :func:`quantization_error` over the blocks: the
    candidates for ``quantize_dit(skip=...)``."""
    targets = _BLOCK_LINEARS if mode == "int8" else _BLOCK_LINEARS_INT4
    scores = []
    for mod, name in targets:
        errs = []
        for blk in model.blocks:
            parent = getattr(blk, mod, None)
            lin = getattr(parent, name, None) if parent is not None else None
            if lin is not None and not is_quantized(lin):
                errs.append(quantization_error(lin))
        if errs:
            scores.append(((mod, name), max(errs)))
    return sorted(scores, key=lambda kv: -kv[1])
