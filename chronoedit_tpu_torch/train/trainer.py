"""Training loop: the ImaginaireTrainer equivalent.

The port of ``chronoedit_tpu/train/trainer.py`` (responsibilities mirrored
from ``chronoedit/_ext/imaginaire/trainer.py``): the iteration loop over
``grad_accum`` micro-batches, callback hooks, periodic checkpoints and
resume, validation, deferred non-finite-loss checks with rewind or abort,
the profiler window and the host-sync guard. It trains every parameter of
the DiT (``train_step.make_train_step``), as JAX's ``Trainer`` does.

Random draws: JAX splits one key from the start of each ``train`` call, so
a resumed run draws other numbers than the uninterrupted one. The port
seeds each micro-step's ``torch.Generator`` from ``(seed, micro-step
count)`` and each validation's from ``(seed, iteration)``, so a resume
continues the uninterrupted run bitwise. A caller that needs other draws
(the tests replay JAX's) replaces ``_step_fn`` / ``_val_fn``.

Under a mesh (``Trainer(..., mesh=)``: data, fsdp, tensor, context and
pipe, and their compositions) every rank runs the loop on its shards of a
model sharded by ``parallel/sharding.shard_params`` (under pipe, a
stage-local model holding its stage's blocks, beside fsdp its fsdp slices
of them) and its data line's
batches (``parallel/distributed.host_local_to_global``); the step sums the
gradients over context and averages the loss over ``data``
(``train/train_step.py``), so every rank reads the same loss and the
non-finite check and the rewind decide alike on all of them (a rank that
rewound while its peers stepped would hang the world).
Validation losses are averaged over the processes (``collate_metrics``);
checkpoints are sharded (``train/checkpoint.py``: a stage's blocks under
their global names), and saving is collective. Callbacks run on the ranks
that are given them: the CLI gives them to rank 0, as JAX's. A collective
callback (``Callback.collective``: ``StragglerDetector``,
``ReplicaConsistencyCallback``) must be given to every rank; ``train``
raises on every rank when the ranks hold different numbers of them.
"""

from __future__ import annotations

import dataclasses
import os
import time as _time
from typing import Any, Iterator

import torch

from chronoedit_tpu_torch.models import dit as dit_lib
from chronoedit_tpu_torch.train.callbacks import Callback, CallbackBus
from chronoedit_tpu_torch.train.checkpoint import CheckpointConfig, CheckpointManager
from chronoedit_tpu_torch.train.train_step import (
    TrainConfig, TrainState, draw_train_noise, make_train_state, make_train_step,
    velocity_loss)
from chronoedit_tpu_torch.utils import sanitize


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    max_iter: int = 1000
    save_every: int = 500
    validate_every: int = 0  # 0 = off
    validate_batches: int = 4
    profile_start: int = -1  # iteration to start a torch.profiler trace, -1=off
    profile_steps: int = 5
    profile_dir: str = "profiles"
    # non-finite-loss policy: after this many *consecutive* non-finite
    # losses, rewind to the latest checkpoint (if a checkpointer is
    # configured) or abort (the reference pairs its unstable-loss counts,
    # wandb_log.py:59-120, with checkpoint resume). 0 disables the check.
    nan_abort_after: int = 10
    # utils/sanitize.no_host_sync around each micro-batch step call: error on
    # any synchronising CUDA call (a stray float()/.item()/bool() in a loss
    # hook) that would stall the device queue. The trainer's own deferred
    # loss flush and validation stay outside.
    guard_host_sync: bool = False


def _generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, stream)."""
    return torch.Generator(device=device).manual_seed((seed << 32) + stream)


class Trainer:
    def __init__(
        self,
        dit_cfg: dit_lib.DiTConfig,
        train_cfg: TrainConfig,
        trainer_cfg: TrainerConfig,
        checkpoint_cfg: CheckpointConfig | None = None,
        callbacks: list[Callback] | None = None,
        mesh=None,
    ):
        self.dit_cfg = dit_cfg
        self.train_cfg = train_cfg
        self.cfg = trainer_cfg
        self.mesh = mesh
        self.callbacks = CallbackBus(callbacks)
        self.checkpoints = CheckpointManager(checkpoint_cfg) if checkpoint_cfg else None
        # step(state, batch, generator) -> metrics, in place;
        # val(state, batch, generator) -> loss
        self._step_fn = None
        self._val_fn = None
        self._profiler = None

    # ------------------------------------------------------------- state

    def init_state(self, model: dit_lib.DiT) -> TrainState:
        """A train state over every parameter of ``model`` (this rank's
        shards under a mesh, its stage's blocks under pipe), restored from
        the latest checkpoint when there is one."""
        state = make_train_state(model, self.train_cfg, self.mesh)
        if self.checkpoints is not None:
            restored = self.checkpoints.restore(state)
            if restored is not None:
                state = restored
        return state

    # ------------------------------------------------------------- loop

    def validate(self, state: TrainState, val_data: Iterator[dict[str, Any]],
                 generator: torch.Generator) -> dict[str, float]:
        """Average the (EMA-free) velocity loss over validation batches
        (reference validation-every-N, trainer.py:149-263)."""
        from chronoedit_tpu_torch.parallel.distributed import collate_metrics

        if self._val_fn is None:
            rf_cfg = self.train_cfg.rectified_flow

            def val_fn(state, batch, generator):
                u, noise = draw_train_noise(generator, batch["latents"], rf_cfg, self.mesh)
                return velocity_loss(state.model, self.dit_cfg, rf_cfg, batch["latents"],
                                     batch["condition"], batch["text_emb"],
                                     batch.get("image_emb"), u, noise, mesh=self.mesh)

            self._val_fn = val_fn
        losses = []
        with torch.no_grad():
            for _ in range(self.cfg.validate_batches):
                losses.append(float(self._val_fn(state, next(val_data), generator)))
        return collate_metrics({"val_loss": sum(losses) / len(losses)})

    def _rewind_or_abort(self, state: TrainState, it: int, unstable: int) -> TrainState:
        """Non-finite-loss recovery: restore the latest checkpoint, or abort
        when there is nothing to rewind to."""
        if self.checkpoints is not None:
            restored = self.checkpoints.restore(state)
            if restored is not None:
                self.callbacks.on_unstable_rewind(self, it, restored.step)
                return restored
        raise RuntimeError(
            f"loss non-finite for {unstable} consecutive steps at iteration "
            f"{it} and no checkpoint to rewind to")

    def _start_profile(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=acts)
        self._profiler.start()

    def _stop_profile(self) -> None:
        """Stop the profiler and write its Chrome trace to ``profile_dir``."""
        self._profiler.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        self._profiler.export_chrome_trace(os.path.join(
            self.cfg.profile_dir, f"trace_iter{self.cfg.profile_start}.json"))
        self._profiler = None

    def _check_collective_callbacks(self) -> None:
        """Raise on every rank at once unless each process of the world
        holds as many collective callbacks as the others: a rank without
        one would leave its peers waiting in its collective until
        ``distributed.TIMEOUT``."""
        from chronoedit_tpu_torch.parallel.distributed import all_gather_float, process_count

        if process_count() == 1:
            return
        mine = sum(bool(getattr(cb, "collective", False)) for cb in self.callbacks.callbacks)
        counts = [int(c) for c in all_gather_float(mine)]
        if len(set(counts)) > 1:
            raise ValueError(f"collective callbacks (StragglerDetector, "
                             f"ReplicaConsistencyCallback) must be given to every rank; the "
                             f"ranks hold {counts}")

    def train(
        self,
        state: TrainState,
        data: Iterator[dict[str, Any]],
        seed: int = 0,
        val_data: Iterator[dict[str, Any]] | None = None,
    ) -> TrainState:
        """Run iterations ``state.step // grad_accum`` .. ``max_iter - 1`` in
        place; batches are dicts of tensors on the model's device."""
        from chronoedit_tpu_torch.parallel.distributed import is_primary
        from chronoedit_tpu_torch.utils import easy_io
        from chronoedit_tpu_torch.utils.config import config_to_dict

        self._check_collective_callbacks()
        if self._step_fn is None:
            self._step_fn = make_train_step(self.dit_cfg, self.train_cfg, self.mesh)
        device = next(state.model.parameters()).device

        # serialize the resolved configs at job start (reference
        # trainer.py:104-109 dumps pkl+yaml), once for the world
        if self.checkpoints is not None and is_primary():
            easy_io.dump(
                {"dit": config_to_dict(self.dit_cfg),
                 "train": config_to_dict(self.train_cfg),
                 "trainer": config_to_dict(self.cfg)},
                f"{self.checkpoints.directory}/config.json")

        self.callbacks.on_train_start(self)
        # state.step counts *micro*-steps (one per _step_fn call); the loop
        # counts iterations of grad_accum micro-batches each
        grad_accum = max(self.train_cfg.grad_accum, 1)
        start = state.step // grad_accum
        metrics: dict[str, Any] = {}
        unstable = 0
        # deferred non-finite checks: reading a device loss every step would
        # force a host sync on the hot path, so losses are buffered (device
        # scalars, no readback) and checked in batches
        pending: list[tuple[int, torch.Tensor]] = []
        for it in range(start, self.cfg.max_iter):
            self.callbacks.on_step_start(self, it)
            if self.cfg.profile_start == it:
                self._start_profile()

            # gradient accumulation: TrainConfig.grad_accum drives both the
            # optimizer (which applies an update every k-th micro-step) and
            # this micro-batch loop. Metrics are averaged over the
            # micro-batches of one iteration.
            accum_metrics = []
            data_s = 0.0
            for _ in range(grad_accum):
                gen = _generator(device, seed, 2 * state.step)
                t0 = _time.perf_counter()
                batch = next(data)
                data_s += _time.perf_counter() - t0
                if self.cfg.guard_host_sync:
                    with sanitize.no_host_sync():
                        metrics = self._step_fn(state, batch, gen)
                else:
                    metrics = self._step_fn(state, batch, gen)
                accum_metrics.append(metrics)
            if grad_accum > 1:
                metrics = {k: sum(m[k] for m in accum_metrics) / len(accum_metrics)
                           for k in accum_metrics[0]}
            # host-side data-fetch wall time for this iteration (the
            # reference's DetailedDataLoadingSpeedMonitor feeds on it; see
            # callbacks.DataSpeedMonitor)
            metrics = {**metrics, "data_time_s": data_s}

            if (self._profiler is not None
                    and it == self.cfg.profile_start + self.cfg.profile_steps):
                self._stop_profile()

            finite = True
            if self.cfg.nan_abort_after > 0:
                pending.append((it, metrics["loss"]))
                save_due = (self.checkpoints is not None
                            and (it + 1) % self.cfg.save_every == 0)
                # validation must also see flushed (finite-checked) params
                val_due = (val_data is not None and self.cfg.validate_every > 0
                           and (it + 1) % self.cfg.validate_every == 0)
                # flush at the batch boundary, before any save/validate, and
                # at end: one host sync per nan_abort_after steps
                if (len(pending) >= self.cfg.nan_abort_after or save_due
                        or val_due or it == self.cfg.max_iter - 1):
                    rewound = False
                    for pit, loss_dev in pending:
                        finite = bool(torch.isfinite(loss_dev.float()))
                        unstable = 0 if finite else unstable + 1
                        if unstable >= self.cfg.nan_abort_after:
                            state = self._rewind_or_abort(state, pit, unstable)
                            unstable = 0
                            rewound = True
                            break
                    pending.clear()
                    if rewound:
                        continue

            if (val_data is not None and self.cfg.validate_every > 0
                    and (it + 1) % self.cfg.validate_every == 0):
                gen = _generator(device, seed, 2 * it + 1)
                metrics = {**metrics, **self.validate(state, val_data, gen)}

            self._last_state = state  # for sampling callbacks
            self.callbacks.on_step_end(self, it, metrics)
            # never persist a state whose loss just went non-finite: a
            # poisoned checkpoint would defeat the rewind policy
            if (self.checkpoints is not None and finite
                    and (it + 1) % self.cfg.save_every == 0):
                self.checkpoints.save(it + 1, state)
                self.callbacks.on_checkpoint_save(self, it + 1)

        if self.checkpoints is not None:
            if self.checkpoints.latest_step() != self.cfg.max_iter:
                self.checkpoints.save(self.cfg.max_iter, state, force=True)
            self.checkpoints.wait_until_finished()
        self.callbacks.on_train_end(self)
        return state
