"""The training step: rectified-flow velocity loss, AdamW with clipping and
warm-up, gradient accumulation, EMA.

The port of ``chronoedit_tpu/train/train_step.py``. JAX's step is one
jitted pure function over an optax chain; here the step runs eagerly and
updates the parameters, the optimizer's moments and the EMA in place.
:class:`Optimizer` reproduces the optax chain the JAX package builds:

- ``clip_by_global_norm``: ``select(|g| < max, g, (g / |g|) * max)`` with
  the norm cast to the gradient's dtype, on the device (``torch.where``:
  no read of the norm on the host, so a step runs under
  ``utils/sanitize.no_host_sync``; ``torch.nn.utils.clip_grad_norm_``
  would add 1e-6 to the norm);
- ``adamw`` over ``warmup_constant_schedule(0, lr, warmup_steps)``: the
  first update has learning rate 0. ``torch.optim.AdamW`` computes the same
  update (decoupled decay scaled by lr, eps outside the square root);
- ``grad_accum = k > 1``: ``optax.MultiSteps``. Each micro-step folds its
  gradient into a running mean ``acc + (g - acc) / (mini_step + 1)`` held in
  the parameter's dtype (Welford, as optax: not a sum divided by k); every
  k-th micro-step clips and applies AdamW to the mean and zeroes it. The
  warm-up counts applied updates.

``grad_norm`` is the norm of the micro-step's raw gradient, before
clipping. The EMA moves after each applied update, at the applied count,
in both the full-parameter and the LoRA step (JAX's full-parameter rule;
JAX's LoRA step moves it every micro-step at the micro-step count, which
differs only under accumulation, see ``ROADMAP.md`` queue 3). The random
draws (train time u and the noise) are arguments of :func:`velocity_loss`,
so a caller can feed the same draws to JAX and here;
:func:`draw_train_noise` makes them from a ``torch.Generator``.

Under a mesh (``make_train_step(..., mesh=)``, JAX's argument) the model
holds this rank's shards (``parallel/sharding.shard_params``; under a pipe
axis only its stage's blocks, ``DiT(..., layers=)``) and the step is given
its data line's rows (``parallel/distributed.host_local_to_global``).

**The batch layout.** The step's forward runs the line's rows under the
mesh as one data line sees it (:func:`forward_mesh`, the data axis folded
away), then averages the loss and every gradient over data
(:func:`data_mean`). So under pipe x data the pipeline does not split the
batch over data again: it runs the line's rows in ``min(B_line, pipe)``
microbatches, where JAX's ``gpipe_scan`` takes the global batch and splits
each microbatch over data inside its ``shard_map``; both end with the
global loss's gradient counted once. (Serving keeps JAX's layout: the
global batch on every rank, split inside the pipeline.)

After the backward each trainable leaf's gradient is the global loss's,
restricted to the rank's shard; which collective covers which leaf:

- ``context``: when the forward splits the tokens over the context group
  (:func:`context_group`: ring or Ulysses attention, whole frames a rank),
  every leaf is whole on every rank of the group, the head runs on the
  rank's own tokens and the gathered output's backward gives the rank its
  slice. Each rank's gradient is its token block's share of the global
  loss's: :func:`context_sum` sums it over the group (not a mean: the loss
  is whole on every rank). A forward that runs whole (tokens that do not
  split into whole frames a rank, ``"none"``) gives every rank the whole
  gradient, and nothing is summed;
- ``pipe``: a stage's block leaves get their gradient on their own rank
  only. The embedders get the same whole gradient on every rank of a pipe
  line (the pipeline's entry sums its inputs' gradients over pipe,
  ``parallel/pipeline_parallel.py``), and so does the head (every rank
  computes the loss on the replicated output): no collective;
- ``fsdp``: a split leaf's gradient is reduce-scattered over the fsdp
  group (or sliced, when every rank ran the whole batch) by the gather's
  backward, a whole model leaf's summed over it (``sharding.Gather``), the
  whole LoRA adapters' summed over it in their merge (``models/lora.py``).
  Beside a pipe axis every fsdp rank of a stage runs the line's rows
  whole (JAX's ``gpipe_scan`` splits the batch over data only), so each
  split leaf takes its slice of the one gradient, a stage's block leaves
  and the embedders' and head's alike, and nothing is summed over fsdp;
- ``tensor``: a column or row leaf's gradient is its rank's own; a leaf
  whole over the tensor group gets the same gradient on every rank, bitwise
  (the stream is whole on every rank, and each column group's input
  gradient is summed over the group by ``copy_to_tensor``), except those
  each rank used a slice of (the q / k norm weights, the LoRA adapters),
  which ``sum_grad_autograd`` sums in the forward's graph;
- ``data``: every leaf's gradient and the loss are averaged over the data
  group here (:func:`data_mean`), in the gradient's dtype.

:func:`global_norm` then sums each shard's squares and completes the sums
over the tensor, fsdp and pipe groups a leaf is split over (a block leaf
over pipe: each stage's blocks counted once, each other leaf once), in
fp32: ``optax.global_norm`` over the global arrays, for the clip and the
reported ``grad_norm``. AdamW, the accumulation's running mean and the
EMA are elementwise on the local shards. Every rank draws ``u`` and the
noise for the global batch from the same generator and keeps its data
line's rows (:func:`draw_train_noise` with a mesh; a context or pipe line
draws alike), so a mesh run draws what one process draws for the same
global batch. The LoRA step refuses context and pipe (``ROADMAP.md``
queue 1, item 3.3, ``train/lora_train.py``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable

import torch

from chronoedit_tpu_torch.core import rectified_flow as rf
from chronoedit_tpu_torch.models import dit as dit_lib
from chronoedit_tpu_torch.models import vae as vae_lib
from chronoedit_tpu_torch.parallel import collectives as C
from chronoedit_tpu_torch.parallel.mesh import (AXIS_CONTEXT, AXIS_DATA, AXIS_FSDP, AXIS_PIPE,
                                                AXIS_TENSOR)
from chronoedit_tpu_torch.pipeline.edit_pipeline import PipelineConfig, prepare_condition
from chronoedit_tpu_torch.train.ema import EMAConfig, ema_update

# (tensor group, fsdp group, pipe group) a leaf's shards are split over,
# None where the leaf is whole along that axis
Split = tuple[object | None, object | None, object | None]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-5
    weight_decay: float = 0.01
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 1000
    total_steps: int = 100_000
    grad_accum: int = 1  # micro-batches per optimizer step (optax.MultiSteps)
    rectified_flow: rf.RectifiedFlowConfig = rf.RectifiedFlowConfig()
    ema: EMAConfig = EMAConfig()


def _degree(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.shape.get(axis, 1)


def check_lora_mesh(mesh) -> None:
    """Raise ValueError for a mesh (or ``MeshConfig``) the LoRA step does not
    train under: a context or pipe axis above 1 (JAX's LoRA step takes no
    mesh)."""
    for axis in (AXIS_CONTEXT, AXIS_PIPE):
        n = _degree(mesh, axis)
        if n > 1:
            raise ValueError(f"LoRA training under {axis}={n} is not ported yet (ROADMAP.md "
                             f"queue 1, item 3.3: LoRA under context or pipe); the LoRA step "
                             f"trains over data, fsdp and tensor, the full-parameter step "
                             f"also over context and pipe")


def leaf_splits(module: torch.nn.Module, mesh) -> list[Split] | None:
    """For each parameter of ``module`` (a sharded DiT, or LoRA adapters,
    whole on every rank), the groups its shards are split over under
    ``mesh``: ``model.tensor`` / ``model.fsdp`` name the leaves split over
    tensor / fsdp, and under a pipe axis every block leaf (``blocks.*``) is
    split over pipe (each stage holds its own; beside an fsdp axis also
    over fsdp where the plan splits it); None without a mesh."""
    if mesh is None:
        return None
    plans = [(getattr(module, axis, None), mesh.group(name))
             for axis, name in (("tensor", AXIS_TENSOR), ("fsdp", AXIS_FSDP))]
    pipe = mesh.group(AXIS_PIPE)
    return [tuple(group if plan is not None and plan.dims.get(n) is not None else None
                  for plan, group in plans)
            + (pipe if n.startswith("blocks.") else None,)
            for n, _ in module.named_parameters()]


def _sum_over(partial: torch.Tensor, group) -> torch.Tensor:
    """Sums of squares completed over ``group``'s shards."""
    return C.all_reduce(partial, group)


def global_norm(tensors, splits: list[Split] | None = None) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, fp32 (optax.global_norm).
    With ``splits`` (:func:`leaf_splits`) each tensor is a shard: the
    squares of the leaves split alike are summed locally, then over the
    tensor, the fsdp and the pipe group each is split over, so a leaf
    whole along an axis counts once; every rank gets the same bits."""
    tensors = list(tensors)
    if splits is None:
        return torch.sqrt(sum(t.float().square().sum() for t in tensors))
    zero = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
    keys = list(itertools.product((False, True), repeat=3))
    partial = dict.fromkeys(keys, zero)  # (split over tensor, fsdp, pipe) -> sum of squares
    groups = [None, None, None]
    for t, split in zip(tensors, splits):
        key = tuple(g is not None for g in split)
        partial[key] = partial[key] + t.float().square().sum()
        groups = [g if g is not None else h for g, h in zip(groups, split)]
    for axis, group in enumerate(groups):  # every rank sums the same keys
        if group is not None:
            split = [k for k in keys if k[axis]]
            summed = _sum_over(torch.stack([partial[k] for k in split]), group).unbind()
            partial.update(zip(split, summed))
    return torch.sqrt(sum(partial[k] for k in keys))


def forward_mesh(mesh):
    """The mesh a step's forward runs under: ``mesh`` as one data line
    sees it (``Mesh.data_line``: the batch is the line's rows, averaged
    over data after the backward), None without one."""
    return None if mesh is None else mesh.data_line()


def context_group(dit_cfg: dit_lib.DiTConfig, mesh, shape: tuple[int, ...]):
    """The context group the forward of a (..., T, H, W) latent batch by a
    DiT of ``dit_cfg`` splits its tokens over under ``mesh``
    (``dit_lib.context_split``, the rule ``dit_forward`` and its pipeline
    stages apply), None when it runs them whole."""
    if mesh is None or mesh.group(AXIS_CONTEXT) is None:
        return None
    pt, ph, pw = dit_cfg.patch_size
    t, h, w = shape[-3:]
    hw = (h // ph) * (w // pw)
    split = dit_lib.context_split(dit_cfg, mesh, (t // pt) * hw, hw)
    return None if split is None else split.group


def context_sum(tensors, group) -> list[torch.Tensor]:
    """Each tensor summed over the context ``group``, in its dtype (each
    rank's gradient is its token block's share); the tensors themselves
    when the forward did not split over context (None)."""
    if group is None:
        return list(tensors)
    return [C.all_reduce(t.contiguous(), group) for t in tensors]


def data_mean(tensors, mesh) -> list[torch.Tensor]:
    """Each tensor averaged over ``mesh``'s data group, in its dtype (summed
    over the group, then divided by the degree); the tensors themselves
    without a data axis."""
    group = None if mesh is None else mesh.group(AXIS_DATA)
    if group is None:
        return list(tensors)
    n = mesh.shape[AXIS_DATA]
    return [C.all_reduce(t.contiguous(), group).div_(n) for t in tensors]


def warmup_lr(cfg: TrainConfig, count: int) -> float:
    """optax ``warmup_constant_schedule(0, lr, warmup_steps)`` at ``count``
    applied updates."""
    if cfg.warmup_steps <= 0:
        return cfg.lr
    frac = 1.0 - min(max(count / cfg.warmup_steps, 0.0), 1.0)
    return (0.0 - cfg.lr) * frac + cfg.lr


class Optimizer:
    """The port of JAX's ``make_optimizer``: optax ``chain(clip_by_global_norm,
    adamw)``, under ``MultiSteps`` when ``cfg.grad_accum > 1``, over a list
    of parameters, updating them in place. ``gradient_step`` counts applied
    updates, ``mini_step`` the micro-steps of the accumulation under way,
    ``acc`` holds its running mean (None without accumulation). Under a
    mesh the parameters are shards and ``splits`` (:func:`leaf_splits`)
    says how, for the global norm."""

    def __init__(self, params: list[torch.Tensor], cfg: TrainConfig,
                 splits: list[Split] | None = None):
        self.params, self.cfg, self.splits = params, cfg, splits
        self.adamw = torch.optim.AdamW(params, lr=0.0, betas=cfg.betas, eps=cfg.eps,
                                       weight_decay=cfg.weight_decay)
        self.gradient_step = 0
        self.mini_step = 0
        self.acc = ([torch.zeros_like(p) for p in params] if cfg.grad_accum > 1
                    else None)

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor]) -> bool:
        """One micro-step with ``grads``; returns whether it applied an
        update (every step without accumulation, every k-th with)."""
        if self.acc is None:
            self._apply(grads)
            return True
        n = self.mini_step + 1
        for a, g in zip(self.acc, grads):
            a.add_((g.to(a.dtype) - a) / n)
        if n < self.cfg.grad_accum:
            self.mini_step = n
            return False
        self._apply(self.acc)
        for a in self.acc:
            a.zero_()
        self.mini_step = 0
        return True

    def _apply(self, grads: list[torch.Tensor]) -> None:
        """Clip by the global norm (on the device), then one AdamW update at
        the warm-up's learning rate for ``gradient_step``."""
        cfg = self.cfg
        g_norm = global_norm(grads, self.splits)
        below = g_norm < cfg.grad_clip
        for p, g in zip(self.params, grads):
            p.grad = torch.where(below, g, (g / g_norm.to(g.dtype)) * cfg.grad_clip)
        for group in self.adamw.param_groups:
            group["lr"] = warmup_lr(cfg, self.gradient_step)
        self.adamw.step()
        for p in self.params:
            p.grad = None
        self.gradient_step += 1


@dataclasses.dataclass
class TrainState:
    """Full-parameter training state: the model (its parameters are the
    trained ones), the optimizer, the EMA copies (None when disabled) and
    the micro-step count."""

    model: dit_lib.DiT
    optimizer: Optimizer
    ema_params: list[torch.Tensor] | None
    step: int = 0

    @property
    def params(self) -> list[torch.Tensor]:
        return self.optimizer.params


def make_train_state(model: dit_lib.DiT, cfg: TrainConfig, mesh=None) -> TrainState:
    """Every parameter of ``model`` becomes trainable; the EMA starts as a
    copy of them. Under ``mesh`` the model holds this rank's shards (under
    a pipe axis, its stage's blocks)."""
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    ema = [p.detach().clone() for p in params] if cfg.ema.enabled else None
    return TrainState(model, Optimizer(params, cfg, leaf_splits(model, mesh)), ema)


def edit_training_batch(vae: vae_lib.VAE, pipe_cfg: PipelineConfig, video: torch.Tensor,
                        is_video_prior: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(clean latents fp32 (B, z, Tl, h, w), condition (B, tfac + z, Tl, h,
    w)) from a raw edit-pair clip (B, 3, T, H, W) in [-1, 1]: the first
    frame is the source, the last the edit target, repeated tfac times so
    the clip encodes to 2 latent frames (Tl = 2). ``is_video_prior`` keeps
    the whole trajectory: the latents of every frame but the last,
    followed by the edit target's latent frame (JAX's option)."""
    vcfg = pipe_cfg.vae
    tfac = vcfg.temporal_factor
    first, last = video[:, :, :1], video[:, :, -1:]
    edit_clip = torch.cat([first] + [last] * tfac, dim=2)
    latents = vae_lib.vae_encode(vae, edit_clip).float()
    if is_video_prior:
        prior = vae_lib.vae_encode(vae, video[:, :, :-1]).float()
        latents = torch.cat([prior, latents[:, :, 1:]], dim=2)
    num_frames = vcfg.pixel_frames(latents.shape[2])
    condition = prepare_condition(vae, pipe_cfg, first[:, :, 0], num_frames)
    return latents, condition


def draw_train_noise(generator: torch.Generator, latents: torch.Tensor,
                     rf_cfg: rf.RectifiedFlowConfig, mesh=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(u (B,), noise like latents, fp32) from ``generator``. Under a
    ``mesh`` with a data axis of D, ``latents`` are this data line's B rows:
    the draws are made for the global batch of D x B rows and this line's
    block is kept."""
    lines = 1 if mesh is None else mesh.shape.get(AXIS_DATA, 1)
    b = latents.shape[0]
    u = rf.sample_train_time(generator, lines * b, rf_cfg)
    noise = torch.randn((lines * b, *latents.shape[1:]), generator=generator,
                        device=generator.device)
    if lines == 1:
        return u, noise
    rows = slice(mesh.index(AXIS_DATA) * b, (mesh.index(AXIS_DATA) + 1) * b)
    return u[rows], noise[rows]


def velocity_loss(model: dit_lib.DiT, dit_cfg: dit_lib.DiTConfig,
                  rf_cfg: rf.RectifiedFlowConfig, latents: torch.Tensor,
                  condition: torch.Tensor, text_emb: torch.Tensor,
                  image_emb: torch.Tensor | None, u: torch.Tensor, noise: torch.Tensor,
                  lora=None, lora_attach: bool = False, mesh=None) -> torch.Tensor:
    """Time-weighted velocity MSE for given draws u (B,) and noise; under
    ``mesh``, of this data line's rows (the forward runs under
    :func:`forward_mesh`)."""
    b = latents.shape[0]
    timesteps, sigmas = rf.discretize_time(u, rf_cfg)
    x_t, v_target = rf.get_interpolation(noise.float(), latents.float(), sigmas)
    xin = torch.cat([x_t.to(dit_cfg.dtype), condition.to(dit_cfg.dtype)], dim=1)
    v_pred = dit_lib.dit_forward(model, xin, timesteps, text_emb, image_emb, lora=lora,
                                 lora_attach=lora_attach, mesh=forward_mesh(mesh))
    per_sample = (v_pred.float() - v_target).square().reshape(b, -1).mean(dim=1)
    return (rf.train_time_weight(timesteps, rf_cfg) * per_sample).mean()


def apply_step(loss: torch.Tensor, params: list[torch.Tensor], optimizer: Optimizer,
               ema_params: list[torch.Tensor] | None, cfg: TrainConfig, mesh=None,
               context=None) -> dict:
    """Backward through ``loss`` to ``params``, the gradients summed over
    the ``context`` group the forward split its tokens over (None: it did
    not), the gradients and the loss averaged over ``mesh``'s data group,
    one optimizer micro-step, and one EMA step at the applied count when it
    applied an update."""
    grads = context_sum(torch.autograd.grad(loss, params), context)
    grads = data_mean(grads, mesh)
    loss = data_mean([loss.detach()], mesh)[0]
    g_norm = global_norm(grads, optimizer.splits)
    if optimizer.update(grads) and ema_params is not None:
        ema_update(ema_params, params, optimizer.gradient_step - 1, cfg.ema)
    return {"loss": loss, "grad_norm": g_norm}


def make_train_step(dit_cfg: dit_lib.DiTConfig, cfg: TrainConfig, mesh=None
                    ) -> Callable[..., dict]:
    """``step(state, batch, generator=None, *, u=None, noise=None)`` runs
    one micro-step in place and returns {"loss", "grad_norm"}; batch =
    {"latents", "condition", "text_emb", "image_emb" (optional)}, this data
    line's rows under ``mesh``. The draws come from ``generator`` unless u
    and noise (for the batch's rows) are given."""

    def step(state: TrainState, batch: dict, generator: torch.Generator | None = None,
             *, u: torch.Tensor | None = None, noise: torch.Tensor | None = None) -> dict:
        if u is None or noise is None:
            u, noise = draw_train_noise(generator, batch["latents"], cfg.rectified_flow, mesh)
        loss = velocity_loss(state.model, dit_cfg, cfg.rectified_flow,
                             batch["latents"], batch["condition"], batch["text_emb"],
                             batch.get("image_emb"), u, noise, mesh=mesh)
        context = context_group(state.model.cfg, forward_mesh(mesh), batch["latents"].shape)
        metrics = apply_step(loss, state.params, state.optimizer, state.ema_params, cfg, mesh,
                             context)
        state.step += 1
        return metrics

    return step
