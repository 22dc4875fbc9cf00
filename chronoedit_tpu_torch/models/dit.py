"""Wan-style diffusion transformer (ChronoEdit-14B backbone), PyTorch.

The forward of ``chronoedit_tpu/models/dit.py``, on one device or over a
mesh (``dit_forward(..., mesh=)``): split over its context axis (each rank
its block of the tokens, ring or Ulysses self-attention,
``parallel/context.py``), over its tensor axis (Megatron's column / row
blocks: each rank its heads, its columns of q / k / v / fc1 and its rows
of o / fc2, the row products summed over the tensor group before their
bias), with its parameters sharded over its fsdp axis (each rank its slice
of every leaf, ``parallel/sharding.py``; a block's leaves gathered just
before the block, the embedders' and the head's where they are used), or
run as a pipeline over its pipe axis (each rank the blocks of its stage,
``parallel/pipeline_parallel.py``; a stage-local model holds only those,
``DiT(..., layers=)``), composed with the context axis inside the stages
and the data axis on the batch:

- patch embed as reshape + linear, feature order (c, kt, kh, kw);
- N blocks of AdaLN-zero 6-way modulation from a per-block
  ``scale_shift_table`` plus the shared time projection; self-attention
  with temporal-skip 3D RoPE and qk RMSNorm across heads; I2V
  cross-attention over the text tokens plus a CLIP image branch, summed;
  gelu-tanh FFN;
- fp32 norms, modulation and gated residuals on a bf16 stream.

The blocks are an ``nn.ModuleList`` walked by a Python loop. Timesteps are
per latent frame, (B, T). The main path's kernels: K2 (LayerNorm +
modulate), K3 (gated residual), K4 (RMSNorm, on every q and k including
the text and image keys) and K1 (attention), through the wrappers in
``ops/``; in training, K6/K7 (attention's backward) through the same
wrappers' autograd Functions. Quantized serving (``ops/quant.py``,
``ChronoEditPipeline.quantize``) swaps block projections for int8/int4
leaves that ``layers.linear`` dispatches on (K8 for w4a16), and
``attn_qk_int8`` sends long self-attention to the int8-score forward (K9);
cross-attention never takes it, as in JAX.

Training: gradients flow to every parameter that requires one (full
fine-tuning) and to LoRA adapters when ``dit_forward`` is given them (their
block's targets are merged inside the block, or attached as side branches
over a quantized base, see ``models/lora.py``). ``DiTConfig.remat``:
``"full"`` recomputes blocks in the backward, as JAX's ``jax.checkpoint``
does: only each block's inputs stay alive between the forward and the
backward. ``"matmul_only"`` is JAX's ``dots_with_no_batch_dims_saveable``
policy as a selective checkpoint: the outputs of the block's 2-D products
(``mm``, ``addmm``, ``_int_mm``: the projections, the LoRA side branches)
are kept and the rest is recomputed, the attention and norm kernels
included (a Pallas call is not a dot in JAX's policy). The per-block LoRA
merge's fp32 ``a @ b`` is a 2-D product too, but one JAX computes outside
its blocks: it is recomputed, never kept (at rank 32 it would hold about
1.4 GB a block).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from chronoedit_tpu_torch.core.rope import (
    Rope3DSpec, apply_rope, rope_3d_tables, temporal_skip_rope_tables)
from chronoedit_tpu_torch.models import lora as lora_lib
from chronoedit_tpu_torch.ops import layers as L
from chronoedit_tpu_torch.ops.attention import dot_product_attention
from chronoedit_tpu_torch.ops.fused_norms import (
    frames_map_locally, gated_residual, layer_norm_modulate, local_frame_slice, rms_norm_fused,
    rms_norm_tensor)
from chronoedit_tpu_torch.parallel import collectives as C
from chronoedit_tpu_torch.parallel import context
from chronoedit_tpu_torch.parallel import pipeline_parallel as pp
from chronoedit_tpu_torch.parallel import sharding
from chronoedit_tpu_torch.parallel.mesh import InnerAxes


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """Static DiT hyperparameters; defaults are the 14B model (patch (1,2,2),
    40 heads x 128, in 36 channels, out 16, text 4096, freq 256, ffn 13824,
    40 layers, image_dim 1280 with 257 CLIP tokens)."""

    patch_size: tuple[int, int, int] = (1, 2, 2)
    num_heads: int = 40
    head_dim: int = 128
    in_channels: int = 36
    out_channels: int = 16
    text_dim: int = 4096
    freq_dim: int = 256
    ffn_dim: int = 13824
    num_layers: int = 40
    image_dim: int | None = 1280  # None => t2v (no image cross-attn branch)
    image_tokens: int = 257
    eps: float = 1e-6
    cross_attn_norm: bool = True
    temporal_skip: bool = True
    rope: Rope3DSpec = Rope3DSpec()
    dtype: torch.dtype = torch.bfloat16  # compute / stream dtype
    param_dtype: torch.dtype = torch.float32
    remat: str = "none"  # "none" | "full" | "matmul_only", as the JAX DiT
    # int8 q.k scores in self-attention (serving only, forward only; applies
    # past JAX's resident KV length: ops/flash_attention.uses_int8_scores)
    attn_qk_int8: bool = False
    # context-parallel self-attention, used when dit_forward gets a mesh with
    # a context axis above 1 (parallel/context.py):
    # - "auto": Ulysses when the heads divide the context size, else the ring;
    # - "ring": K/V blocks around the ring, flash hops merged by LSE;
    # - "ulysses": all-to-all from a sequence split to a head split and back;
    # - "none": no context split; every rank runs the whole forward.
    context_parallel: str = "auto"

    @property
    def dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def patch_dim(self) -> int:
        return self.in_channels * math.prod(self.patch_size)


# ================================================================= modules

class SelfAttention(nn.Module):
    def __init__(self, cfg: DiTConfig, **kw):
        super().__init__()
        dim = cfg.dim
        self.q, self.k, self.v, self.o = (L.Linear(dim, dim, **kw) for _ in range(4))
        self.q_norm = L.RMSNorm(dim, **kw)
        self.k_norm = L.RMSNorm(dim, **kw)


class CrossAttention(nn.Module):
    def __init__(self, cfg: DiTConfig, **kw):
        super().__init__()
        dim = cfg.dim
        self.q, self.k, self.v, self.o = (L.Linear(dim, dim, **kw) for _ in range(4))
        self.q_norm = L.RMSNorm(dim, **kw)
        self.k_norm = L.RMSNorm(dim, **kw)
        if cfg.image_dim is not None:
            self.k_img = L.Linear(dim, dim, **kw)
            self.v_img = L.Linear(dim, dim, **kw)
            self.k_img_norm = L.RMSNorm(dim, **kw)


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig, *, device, dtype, generator):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.scale_shift_table = L.empty_param((6, cfg.dim), device, dtype)
        if generator is not None:
            with torch.no_grad():
                self.scale_shift_table.normal_(0.0, 1.0 / math.sqrt(cfg.dim),
                                               generator=generator)
        self.self_attn = SelfAttention(cfg, **kw)
        self.cross_attn = CrossAttention(cfg, **kw)
        self.ffn = nn.ModuleDict(dict(fc1=L.Linear(cfg.dim, cfg.ffn_dim, **kw),
                                      fc2=L.Linear(cfg.ffn_dim, cfg.dim, **kw)))
        if cfg.cross_attn_norm:
            self.norm2 = L.LayerNorm(cfg.dim, **kw)


class DiT(nn.Module):
    """Parameters of the DiT, named as in the JAX parameter tree.

    ``layers`` (default all ``cfg.num_layers``) are the global indices of
    the blocks the model holds, ``blocks[j]`` being block ``layers[j]``: a
    pipeline stage's model holds only its stage's (``parallel.
    pipeline_parallel.stage_range``) and runs only under its pipe mesh. A
    random init draws the blocks it holds in order, so a stage-local
    model's random blocks are not the whole model's: drop the others
    with :meth:`keep_layers` instead.

    ``tensor`` and ``fsdp`` are None for a whole model;
    ``parallel.sharding.shard_params`` (or a loader given a tensor or fsdp
    mesh) keeps this rank's slice of each leaf and records the plan of
    each axis there (a ``parallel.sharding.Shards``)."""

    def __init__(self, cfg: DiTConfig, *, device=None,
                 generator: torch.Generator | None = None, layers: range | None = None):
        super().__init__()
        self.cfg = cfg
        self.layers = range(cfg.num_layers) if layers is None else layers
        dim = cfg.dim
        kw = dict(device=device, dtype=cfg.param_dtype, generator=generator)
        self.patch_embed = L.Linear(cfg.patch_dim, dim, **kw)
        self.time_embed = nn.ModuleDict(dict(
            fc1=L.Linear(cfg.freq_dim, dim, std=0.02, **kw),
            fc2=L.Linear(dim, dim, std=0.02, **kw)))
        self.time_proj = L.Linear(dim, 6 * dim, **kw)
        self.text_embed = nn.ModuleDict(dict(
            fc1=L.Linear(cfg.text_dim, dim, std=0.02, **kw),
            fc2=L.Linear(dim, dim, std=0.02, **kw)))
        out_dim = cfg.out_channels * math.prod(cfg.patch_size)
        self.head = nn.ModuleDict(dict(proj=L.Linear(dim, out_dim, zero=True, **kw)))
        self.head.scale_shift_table = L.empty_param((2, dim), device, cfg.param_dtype)
        if generator is not None:
            with torch.no_grad():
                self.head.scale_shift_table.normal_(0.0, 1.0 / math.sqrt(dim),
                                                    generator=generator)
        if cfg.image_dim is not None:
            self.img_embed = nn.ModuleDict(dict(
                norm1=L.LayerNorm(cfg.image_dim, **kw),
                fc1=L.Linear(cfg.image_dim, cfg.image_dim, **kw),
                fc2=L.Linear(cfg.image_dim, dim, **kw),
                norm2=L.LayerNorm(dim, **kw)))
        self.blocks = nn.ModuleList(
            DiTBlock(cfg, device=device, dtype=cfg.param_dtype, generator=generator)
            for _ in self.layers)
        self.tensor = None
        self.fsdp = None

    def global_name(self, name: str) -> str:
        """The whole model's name of the parameter or buffer ``name``: a
        stage-local model's block ``j`` is block ``layers.start + j`` of
        the whole (checkpoints and references use these names)."""
        if not name.startswith("blocks.") or self.layers.start == 0:
            return name
        _, j, rest = name.split(".", 2)
        return f"blocks.{self.layers.start + int(j)}.{rest}"

    def keep_layers(self, layers: range) -> "DiT":
        """Keep only the blocks of ``layers`` (global indices among those the
        model holds) and drop the rest, freeing them: a whole model made a
        pipeline stage's. Returns self."""
        if not (self.layers.start <= layers.start and layers.stop <= self.layers.stop):
            raise ValueError(f"layers {layers} are not among the model's {self.layers}")
        if self.fsdp is not None or self.tensor is not None:
            raise ValueError("a sharded DiT cannot be made a pipeline stage's")
        self.blocks = nn.ModuleList(self.blocks[i - self.layers.start] for i in layers)
        self.layers = layers
        return self


def init_dit_params(cfg: DiTConfig, generator: torch.Generator,
                    device=None) -> DiT:
    """A DiT with random weights drawn from ``generator`` directly in
    ``cfg.param_dtype`` on ``device``. The distributions follow the JAX
    ``init_dit_params``: xavier-uniform projections, N(0, 0.02) time/text
    embedders, N(0, 1/dim) modulation tables, zero output projection."""
    return DiT(cfg, device=device, generator=generator)


# ================================================================= pieces

CONTEXT_MODES = ("auto", "ring", "ulysses", "none")


@dataclasses.dataclass(frozen=True)
class _ContextSplit:
    """This rank's share of a context-parallel forward: the attention mode,
    the context group, this rank's token block and the number of blocks."""

    mode: str  # "ring" | "ulysses"
    group: object
    index: int
    size: int


def context_split(cfg: DiTConfig, mesh, tokens: int, hw: int) -> _ContextSplit | None:
    """How a forward over ``tokens`` tokens of ``hw`` a frame splits over
    ``mesh``'s context axis (a mesh, or a pipeline stage's ``InnerAxes``),
    or None to run it whole: no mesh, a context
    axis of 1, ``"none"``, or tokens that do not split into whole frames or
    whole parts of one frame per rank (JAX's fallbacks: its attention runs
    unsharded when the sequence does not divide, its fused norms when the
    frames do not map). ``"auto"`` takes Ulysses when the heads divide the
    context size, else the ring: the heads of a tensor rank (JAX's rule,
    its heads staying tensor-split inside its context shard_map); the ring
    refuses ``attn_qk_int8``."""
    if cfg.context_parallel not in CONTEXT_MODES:
        raise ValueError(f"context_parallel must be one of {CONTEXT_MODES}, got "
                         f"{cfg.context_parallel!r}")
    cp = 1 if mesh is None else mesh.shape.get("context", 1)
    if cp == 1 or cfg.context_parallel == "none" or not frames_map_locally(tokens, hw, cp):
        return None
    mode = cfg.context_parallel
    if mode == "auto":
        tp = mesh.shape.get("tensor", 1) if mesh.shape.get("pipe", 1) == 1 else 1
        heads = cfg.num_heads // tp if cfg.num_heads % tp == 0 else cfg.num_heads
        mode = "ulysses" if heads % cp == 0 else "ring"
    if mode == "ring":
        context.check_ring_qk_int8(cfg.attn_qk_int8)
    return _ContextSplit(mode, mesh.group("context"), mesh.index("context"), cp)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.reshape(b, s, h * d)


def _lin(p: L.Linear, x, weights: dict | None, **kw):
    """``p``'s product, with its LoRA-merged weight or side branch (a
    tuple, ``lora.attached_weights``) when ``weights`` holds one; ``kw``
    goes to ``layers.linear``."""
    w = None if weights is None else weights.get(p)
    if isinstance(w, tuple):
        return L.linear(p, x, side=w, **kw)
    return L.linear(p, x, w, **kw)


def _row(p: L.Linear, x, weights: dict | None, tp: sharding.TensorSplit | None):
    """A row-parallel product: under ``tp`` this rank's rows of ``p`` on
    its columns of ``x`` (LoRA branch included), summed over the tensor
    group in x's dtype, then the bias added once; the whole product
    without ``tp``."""
    if tp is None:
        return _lin(p, x, weights)
    y = C.reduce_from_tensor(_lin(p, x, weights, bias=False, group=tp.group), tp.group)
    return y + p.bias.to(y.dtype)


def _columns(x, tp: sharding.TensorSplit | None):
    """The input of a column-parallel group: ``x`` itself, its gradient
    summed over the tensor group under ``tp``."""
    return x if tp is None else C.copy_to_tensor(x, tp.group)


def _qk_norm(p: L.RMSNorm, x, cfg: DiTConfig, tp: sharding.TensorSplit | None):
    """K4 on q or k; under ``tp`` on this rank's columns, its statistics
    summed over the tensor group (``rms_norm_tensor``)."""
    if tp is None:
        return rms_norm_fused(p, x, cfg.eps)
    return rms_norm_tensor(p, x, tp.group, tp.index, tp.size, cfg.eps)


def _heads(cfg: DiTConfig, tp: sharding.TensorSplit | None) -> int:
    return cfg.num_heads if tp is None else cfg.num_heads // tp.size


def _self_attention(p: SelfAttention, x, rope_cos, rope_sin, cfg: DiTConfig, weights,
                    cp: _ContextSplit | None = None, tp: sharding.TensorSplit | None = None):
    """Self-attention; with ``cp`` over this rank's token block, through the
    ring or Ulysses over the context group; with ``tp`` on this rank's
    heads."""
    x = _columns(x, tp)
    q = _qk_norm(p.q_norm, _lin(p.q, x, weights), cfg, tp)
    k = _qk_norm(p.k_norm, _lin(p.k, x, weights), cfg, tp)
    v = _lin(p.v, x, weights)
    q, k, v = (_split_heads(t, _heads(cfg, tp)) for t in (q, k, v))
    cos, sin = rope_cos[:, None, :], rope_sin[:, None, :]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cp is None:
        out = dot_product_attention(q, k, v, qk_int8=cfg.attn_qk_int8)
    elif cp.mode == "ring":
        out = context.ring_attention_inner(q, k, v, cp.group)
    else:
        out = context.ulysses_attention_inner(q, k, v, cp.group, qk_int8=cfg.attn_qk_int8)
    return _row(p.o, _merge_heads(out), weights, tp)


def _cross_attention(p: CrossAttention, x, text_ctx, img_ctx, cfg: DiTConfig, weights,
                     tp: sharding.TensorSplit | None = None):
    """Text branch + image branch, summed; with ``tp`` on this rank's
    heads."""
    h = _heads(cfg, tp)
    q = _split_heads(_qk_norm(p.q_norm, _lin(p.q, _columns(x, tp), weights), cfg, tp), h)
    text_ctx = _columns(text_ctx, tp)
    k = _qk_norm(p.k_norm, _lin(p.k, text_ctx, weights), cfg, tp)
    v = _lin(p.v, text_ctx, weights)
    out = dot_product_attention(q, _split_heads(k, h), _split_heads(v, h))
    if img_ctx is not None:
        img_ctx = _columns(img_ctx, tp)
        k_img = _qk_norm(p.k_img_norm, _lin(p.k_img, img_ctx, weights), cfg, tp)
        v_img = _lin(p.v_img, img_ctx, weights)
        out = out + dot_product_attention(q, _split_heads(k_img, h),
                                          _split_heads(v_img, h))
    return _row(p.o, _merge_heads(out), weights, tp)


def dit_block(p: DiTBlock, x, text_ctx, img_ctx, e, rope_cos, rope_sin, hw: int,
              cfg: DiTConfig, weights: dict | None = None,
              cp: _ContextSplit | None = None,
              tp: sharding.TensorSplit | None = None) -> torch.Tensor:
    """One transformer block. x (B, S, dim) stream; e (B, T, 6, dim) fp32
    time projection; hw tokens per latent frame; ``weights`` maps a linear
    layer to the weight that stands in for its own (LoRA-merged); with
    ``cp`` the stream, e, the RoPE rows and hw are this rank's context
    shard's; with ``tp`` the block's projections hold this rank's columns
    or rows (Megatron's layout) and the stream, the norms, the modulation
    and the residuals stay whole on every rank."""
    mods = e + p.scale_shift_table.float()[None, None]
    shift_msa, scale_msa, gate_msa, c_shift, c_scale, c_gate = (
        mods[:, :, i].contiguous() for i in range(6))

    norm_x = layer_norm_modulate(x, scale_msa, shift_msa, hw, cfg.eps)
    attn = _self_attention(p.self_attn, norm_x, rope_cos, rope_sin, cfg, weights, cp, tp)
    x = gated_residual(x, attn, gate_msa, hw)

    # cross-attention: affine fp32 LayerNorm, plain residual add
    norm2 = getattr(p, "norm2", None)
    norm_x = L.layer_norm(norm2, x, cfg.eps, out_dtype=x.dtype)
    x = x + _cross_attention(p.cross_attn, norm_x, text_ctx, img_ctx, cfg, weights, tp)

    norm_x = _columns(layer_norm_modulate(x, c_scale, c_shift, hw, cfg.eps), tp)
    ff = _row(p.ffn.fc2, L.gelu_tanh(_lin(p.ffn.fc1, norm_x, weights)), weights, tp)
    return gated_residual(x, ff, c_gate, hw)


class _MatmulOnly:
    """The selective-checkpoint policy of ``remat="matmul_only"``: keep the
    outputs of 2-D products, recompute everything else. Inside
    :meth:`recomputed` (the LoRA merge) products are recomputed too. One
    instance serves one block call, its forward and its recompute."""

    SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten._int_mm.default)

    def __init__(self):
        self.skip = False

    def __call__(self, ctx, op, *args, **kwargs):
        if op in self.SAVED and not self.skip:
            return ckpt.CheckpointPolicy.MUST_SAVE
        return ckpt.CheckpointPolicy.PREFER_RECOMPUTE

    @contextlib.contextmanager
    def recomputed(self):
        self.skip = True
        try:
            yield
        finally:
            self.skip = False


def _whole(module: nn.Module):
    """The gather of a module of a whole (unsharded) model: nothing to do."""
    return contextlib.nullcontext()


def _lora_block(p: DiTBlock, adapters, lora_weights, policy: _MatmulOnly | None, x,
                text_ctx, img_ctx, e, rope_cos, rope_sin, hw: int, cfg: DiTConfig,
                cp: _ContextSplit | None = None, gather=_whole,
                tp: sharding.TensorSplit | None = None) -> torch.Tensor:
    """A block, its FSDP shards gathered for its duration by ``gather(p)``
    and its LoRA targets' weights made first by ``lora_weights(block,
    adapters, tp)`` (merged, or side branches; this tensor rank's share),
    inside whatever checkpoint wraps it, so the gathered and merged
    weights live one block at a time (a recompute gathers again)."""
    with gather(p):
        weights = None
        if adapters is not None:
            with policy.recomputed() if policy is not None else contextlib.nullcontext():
                weights = lora_weights(p, adapters, tp=tp)
        return dit_block(p, x, text_ctx, img_ctx, e, rope_cos, rope_sin, hw, cfg, weights, cp,
                         tp)


def _run_block(cfg: DiTConfig, blk, adapters, lora_weights, *args) -> torch.Tensor:
    """``_lora_block`` under ``cfg.remat`` when autograd records."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return _lora_block(blk, adapters, lora_weights, None, *args)
    if cfg.remat == "full":
        return ckpt.checkpoint(_lora_block, blk, adapters, lora_weights, None, *args,
                               use_reentrant=False, preserve_rng_state=False)
    if cfg.remat == "matmul_only":
        policy = _MatmulOnly()
        return ckpt.checkpoint(
            _lora_block, blk, adapters, lora_weights, policy, *args, use_reentrant=False,
            preserve_rng_state=False,
            context_fn=functools.partial(ckpt.create_selective_checkpoint_contexts, policy))
    raise ValueError(f"unknown remat mode {cfg.remat!r}")


# ================================================================= forward

def _patchify(x: torch.Tensor, cfg: DiTConfig):
    """(B, C, T, H, W) -> (B, S, C*pt*ph*pw) tokens, feature order
    (c, kt, kh, kw), plus the post-patch grid."""
    pt, ph, pw = cfg.patch_size
    b, c, t, h, w = x.shape
    gt, gh, gw = t // pt, h // ph, w // pw
    x = x.reshape(b, c, gt, pt, gh, ph, gw, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, gt * gh * gw, c * pt * ph * pw), (gt, gh, gw)


def _unpatchify(tokens: torch.Tensor, grid, cfg: DiTConfig) -> torch.Tensor:
    """(B, S, pt*ph*pw*out) -> (B, out, T, H, W), feature order (pt, ph, pw, c)."""
    pt, ph, pw = cfg.patch_size
    gt, gh, gw = grid
    b = tokens.shape[0]
    x = tokens.reshape(b, gt, gh, gw, pt, ph, pw, cfg.out_channels)
    x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, cfg.out_channels, gt * pt, gh * ph, gw * pw)


def _condition_embeddings(m: DiT, cfg: DiTConfig, timesteps, text_emb, image_emb,
                          gather=_whole):
    """Returns (temb (B,T,dim) fp32, t_proj (B,T,6,dim) fp32, text_ctx, img_ctx);
    each embedder's FSDP shards gathered by ``gather`` while it runs."""
    sin_emb = L.sinusoidal_timestep_embedding(timesteps, cfg.freq_dim)
    te = m.time_embed
    with gather(te):
        temb = L.linear(te.fc2, F.silu(L.linear(te.fc1, sin_emb.float())))
    # the reference casts temb to the stream dtype before time_proj and the
    # blocks upcast again: kept for parity
    with gather(m.time_proj):
        t_proj = L.linear(m.time_proj, F.silu(temb.to(cfg.dtype)))
    t_proj = t_proj.float().reshape(*temb.shape[:-1], 6, cfg.dim)

    tx = m.text_embed
    with gather(tx):
        text_ctx = L.linear(tx.fc2, L.gelu_tanh(L.linear(tx.fc1, text_emb.to(cfg.dtype))))

    img_ctx = None
    if image_emb is not None and cfg.image_dim is not None:
        ie = m.img_embed
        with gather(ie):
            # fp32 LayerNorm (eps 1e-5) -> linear -> exact GELU -> linear -> norm
            h = L.layer_norm(ie.norm1, image_emb, eps=1e-5, out_dtype=cfg.dtype)
            h = L.linear(ie.fc2, F.gelu(L.linear(ie.fc1, h)))
            img_ctx = L.layer_norm(ie.norm2, h, eps=1e-5, out_dtype=cfg.dtype)
    return temb.float(), t_proj, text_ctx, img_ctx


def dit_forward(model: DiT, x: torch.Tensor, timesteps: torch.Tensor,
                text_emb: torch.Tensor, image_emb: torch.Tensor | None = None,
                layer_mask=None, lora: lora_lib.LoRA | None = None,
                lora_attach: bool = False, cache_blocks: tuple[int, int] | None = None,
                cache: torch.Tensor | None = None, cache_refresh: bool = True, mesh=None):
    """Velocity prediction.

    Args:
      x: (B, C_in, T, H, W) noisy latents plus condition channels.
      timesteps: (B,) shared or (B, T) per latent frame, in [0, 1000).
      text_emb: (B, L, text_dim); image_emb: (B, 257, image_dim) or None.
      layer_mask: optional (num_layers,) 0/1 values on the host (a sequence;
        a tensor is read to the host once); 0 skips a block (skip-layer
        guidance).
      lora: optional adapters, merged block by block as
        ``W + (alpha / r) * a @ b``, or with ``lora_attach`` added as side
        branches ``(x @ a) @ ((alpha / r) * b)`` (QLoRA over a quantized
        base, where merging raises).
      cache_blocks, cache, cache_refresh: the Δ-DiT step cache
        (arXiv:2406.01125). Blocks [a, b) contribute a token delta that
        changes slowly across solver steps. With ``cache_refresh`` (a host
        bool) every block runs and the sum of blocks [a, b)'s deltas
        ``out - in``, accumulated block by block in the stream dtype, is
        the new cache; otherwise blocks [a, b) are skipped and ``cache``
        (zeros when None) is added once before block a. Returns ``(out,
        new_cache)`` when ``cache_blocks`` is set. Exact when every step
        refreshes.
      mesh: a ``parallel.mesh.Mesh``; with a context axis above 1 each rank
        of a context group takes its contiguous block of the tokens after
        the patch embedding, with its rows of the RoPE tables and its
        frames of every per-frame modulation (:func:`context_split`), runs
        the blocks on it with ring or Ulysses self-attention (cross-attention
        attends its queries to the whole text and image context) and the
        output head, and all-gathers the head's output, so every rank
        returns the whole velocity. The cache is then this rank's block.
        With an fsdp axis above 1 ``model`` holds this rank's shards
        (``parallel.sharding.shard_params``): each block's are gathered just
        before it runs and dropped after it (a block that the mask or the
        cache skips is gathered by no rank), the embedders' and the head's
        where they are used; when the fsdp degree divides the batch each
        rank runs its rows and the head's output is gathered over fsdp
        too, else every rank runs the whole batch (the gathers' backward
        then takes this rank's slice of the gradient instead of summing
        the ranks'; the LoRA adapters, whole on every rank, have their
        gradients summed over fsdp when it split the batch); an fsdp line
        holds the same token block under context parallelism, and a data
        line runs the same request. Beside a pipe axis the rows never split
        over fsdp: each rank holds its fsdp shards of its stage's blocks,
        every fsdp rank of a stage runs the stage's microbatches whole
        (JAX's batch splits over data only inside ``gpipe_scan``), and the
        gathers' backward takes this rank's slice. With a
        tensor axis above 1 ``model`` holds this rank's columns / rows of
        the block projections (``shard_params``; the heads must divide the
        degree): each block runs on this rank's heads, the row products and
        K4's statistics are summed over the tensor group, and every rank
        holds the whole stream and returns the whole velocity; it composes
        with the fsdp axis (the gathers run inside the rank's tensor slice),
        the context axis (Ulysses when the rank's heads divide the context
        degree, under "auto") and the data axis. With a
        pipe axis above 1 the blocks run as a GPipe pipeline
        (:func:`_pipeline_blocks`): every rank runs the embeddings and the
        head, and its stage's blocks, which ``model`` holds and nothing
        else of the stack (``DiT(..., layers=)``); the context axis then
        splits the tokens inside the stages, the data axis the batch, and
        the head's output is gathered over both. Inputs are the same on
        every rank of the mesh (a training step passes its data line's
        rows under ``Mesh.data_line``: the same on every rank of the line,
        not split over data).
    Returns:
      (B, C_out, T, H, W) in cfg.dtype (and the cache when active).
    """
    cfg = model.cfg
    b = x.shape[0]
    pipe = 1 if mesh is None else mesh.shape.get("pipe", 1)
    if pipe == 1 and model.layers != range(cfg.num_layers):
        raise ValueError(f"the DiT holds blocks {model.layers} of {cfg.num_layers}: a "
                         "stage-local model runs under its pipe mesh only")
    if isinstance(layer_mask, torch.Tensor):
        layer_mask = layer_mask.tolist()
    if cache_blocks is not None:
        if layer_mask is not None or pipe > 1:
            raise ValueError("cache_blocks is incompatible with SLG layer masks and "
                             "pipeline parallelism")
        lo, hi = cache_blocks
        if not 0 <= lo <= hi <= cfg.num_layers:
            raise ValueError(f"cache_blocks {cache_blocks} out of range")
    gathers = []  # (group, dim): the head's output gathered over them, in order
    tp = sharding.tensor_plan(model, mesh)
    fsdp = sharding.fsdp_gather(model, mesh, b)
    gather = _whole if fsdp is None else fsdp
    if fsdp is not None and fsdp.summed:  # this rank's rows (never beside a pipe axis)
        ranks, rank = mesh.shape["fsdp"], mesh.index("fsdp")
        x, timesteps, text_emb, image_emb = (
            t if t is None or t.shape[0] != b else t.chunk(ranks, dim=0)[rank]
            for t in (x, timesteps, text_emb, image_emb))
        b //= ranks
        gathers.append((fsdp.group, 0))
    tokens, grid = _patchify(x.to(cfg.dtype), cfg)
    gt, gh, gw = grid
    hw = gh * gw
    with gather(model.patch_embed):
        tokens = L.linear(model.patch_embed, tokens)

    if timesteps.dim() == 1:
        timesteps = timesteps[:, None].expand(b, gt)
    temb, t_proj, text_ctx, img_ctx = _condition_embeddings(
        model, cfg, timesteps, text_emb, image_emb, gather)

    # the tables hold every global position: a shard takes its rows
    tables = temporal_skip_rope_tables if cfg.temporal_skip else rope_3d_tables
    cos, sin = tables(cfg.rope, gt, gh, gw, device=x.device)
    lora_weights = None
    if lora is not None:
        # the adapters are whole on every rank: when each fsdp rank ran its
        # own rows, their gradients are summed over the fsdp group
        summed = fsdp is not None and fsdp.summed and torch.is_grad_enabled()
        lora_weights = functools.partial(
            lora_lib.attached_weights if lora_attach else lora_lib.merged_weights,
            scaling=lora.cfg.scaling, summed=fsdp.group if summed else None)
    if pipe > 1:
        tokens, cp = _pipeline_blocks(model, mesh, tokens, text_ctx, img_ctx, t_proj, cos,
                                      sin, hw, layer_mask, lora, lora_weights, gather)
        if cp is not None:
            (temb,), hw = local_frame_slice((temb,), hw, tokens.shape[1], cp.index)
            gathers.append((cp.group, 1))
        if pp.splits_data(mesh, b):
            temb = temb.chunk(mesh.shape["data"], dim=0)[mesh.index("data")]
            gathers.append((mesh.group("data"), 0))
        return _head(model, tokens, temb, hw, grid, gathers, gather)

    cp = context_split(cfg, mesh, tokens.shape[1], hw)
    if cp is not None:
        s_loc = tokens.shape[1] // cp.size
        rows = slice(cp.index * s_loc, (cp.index + 1) * s_loc)
        tokens, cos, sin = tokens[:, rows].contiguous(), cos[rows], sin[rows]
        (t_proj, temb), hw = local_frame_slice((t_proj, temb), hw, s_loc, cp.index)
        gathers.append((cp.group, 1))
    if cache_blocks is not None and not cache_refresh and cache is None:
        cache = torch.zeros_like(tokens)

    delta = None
    for i, blk in enumerate(model.blocks):
        if layer_mask is not None and float(layer_mask[i]) <= 0.5:
            continue
        cached = cache_blocks is not None and lo <= i < hi
        if cache_blocks is not None and i == lo and not cache_refresh:
            tokens = tokens + cache
        if cached and not cache_refresh:
            continue
        adapters = None if lora is None else lora.blocks[i]
        out = _run_block(cfg, blk, adapters, lora_weights, tokens, text_ctx, img_ctx,
                         t_proj, cos, sin, hw, cfg, cp, gather, tp)
        if cached:
            delta = out - tokens if delta is None else delta + (out - tokens)
        tokens = out

    out = _head(model, tokens, temb, hw, grid, gathers, gather)
    if cache_blocks is None:
        return out
    if not cache_refresh:
        return out, cache
    return out, torch.zeros_like(tokens) if delta is None else delta


def _head(model: DiT, tokens, temb, hw: int, grid, gathers, gather=_whole) -> torch.Tensor:
    """The output head on this rank's tokens (its FSDP shards gathered by
    ``gather``), its output gathered over each (group, dim) of ``gathers``
    in turn, then unpatchified."""
    head, cfg = model.head, model.cfg
    with gather(head):
        mods = head.scale_shift_table.float()[None, None] + temb[:, :, None, :]
        shift, scale = mods[:, :, 0].contiguous(), mods[:, :, 1].contiguous()
        normed = layer_norm_modulate(tokens, scale, shift, hw, cfg.eps)
        out = L.linear(head.proj, normed)
    for group, dim in gathers:
        out = C.gather_sequence_autograd(out, group, dim)
    return _unpatchify(out, grid, cfg)


def _pipeline_blocks(model: DiT, mesh, tokens, text_ctx, img_ctx, t_proj, cos, sin, hw: int,
                     layer_mask, lora, lora_weights, gather=_whole):
    """The blocks as a GPipe pipeline over ``mesh``'s pipe axis (JAX's
    pipe branch of ``dit_forward``): this rank's stage runs its blocks
    (``stage_range``) inside ``gpipe_scan``, the time projection and the
    text and image context microbatched with the tokens. When the tokens
    split into whole frames or parts of one frame over the context axis
    (:func:`context_split` on the rank's context group, an ``InnerAxes``),
    they split inside the stages: each block takes its rows of the global
    RoPE tables and its frames of the time projection. A skip-layer mask
    skips blocks by global index. With an fsdp axis the stage's blocks
    are this rank's shards: each is gathered by ``gather`` (the fsdp
    path's ``sharding.Gather``, unsummed: every fsdp rank of the stage runs
    its microbatches whole) just before it runs in a tick and dropped
    after; a bubble tick or a masked block gathers nothing, on both fsdp
    peers alike. Returns this rank's share of the output tokens (its batch
    rows when the batch splits over data, its token block under context
    parallelism) and the context split or None.

    Gradients (``pipeline_parallel``'s notes): a stage's blocks get theirs
    on their own rank only; the embedders and the head the same whole
    gradient on every rank of a pipe line; under context each rank's is
    its token block's share, which a trainer sums over the context group.
    A training step gives the line's rows under ``Mesh.data_line``, so
    nothing here splits over data (``train/train_step.py``)."""
    cfg = model.cfg
    layers = pp.stage_range(cfg.num_layers, mesh)
    if model.layers != layers:
        raise ValueError(f"pipe stage {mesh.index('pipe')} runs blocks {layers}; the DiT "
                         f"holds {model.layers} (build it stage-local, or keep_layers)")
    inner = InnerAxes(context=mesh.group("context"), context_size=mesh.shape.get("context", 1))
    cp = context_split(cfg, inner, tokens.shape[1], hw)
    stage = [(i, j) for j, i in enumerate(layers)]  # (global index, position)

    def block(lp, x_cur, ctx):
        i, j = lp
        if layer_mask is not None and float(layer_mask[i]) <= 0.5:
            return x_cur
        t_ctx, i_ctx, tp = ctx
        cos_l, sin_l, hw_l = cos, sin, hw
        if cp is not None:
            s_loc = x_cur.shape[1]
            rows = slice(cp.index * s_loc, (cp.index + 1) * s_loc)
            cos_l, sin_l = cos[rows], sin[rows]
            (tp,), hw_l = local_frame_slice((tp,), hw, s_loc, cp.index)
        adapters = None if lora is None else lora.blocks[j]
        return _run_block(cfg, model.blocks[j], adapters, lora_weights, x_cur, t_ctx, i_ctx,
                          tp, cos_l, sin_l, hw_l, cfg, cp, gather)

    out = pp.gpipe_scan(block, stage, tokens, (text_ctx, img_ctx, t_proj), mesh,
                        context_axis="context" if cp is not None else None,
                        num_layers=cfg.num_layers)
    return out, cp
