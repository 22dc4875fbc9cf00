"""Callback bus + built-in training callbacks.

The port of ``chronoedit_tpu/train/callbacks.py``. The reference fans ~30
hooks out to a callback group (``utils/callback.py:46-103``); built-ins
include iteration speed, grad-clip stats, device monitoring, heartbeat
liveness stamps and periodic sample draws (SURVEY §5.5). Host-side
equivalents here; anything device-side (grad norms, loss) arrives through
the metrics dict as device scalars, read by the callbacks that log them.

Port-specific: :class:`DeviceMonitorCallback` reads
``torch.cuda.memory_stats``; :class:`ParamStatsCallback` reads the state's
tensors (by top-level module); :class:`ReplicaConsistencyCallback`
compares every tensor's digest across the ranks of the process world
(``parallel/consistency.py``) and raises on a divergence;
:class:`StragglerDetector` all-gathers each process's step time over the
world (in one process it never fires).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class Callback:
    # True for a callback that runs a collective over the world: every
    # process must then hold it (``Trainer.train`` refuses otherwise)
    collective = False

    def on_train_start(self, trainer): ...
    def on_step_start(self, trainer, step: int): ...
    def on_step_end(self, trainer, step: int, metrics: dict[str, Any]): ...
    def on_checkpoint_save(self, trainer, step: int): ...
    def on_unstable_rewind(self, trainer, step: int, restored_step: int): ...
    def on_train_end(self, trainer): ...


class CallbackBus:
    """Fan any hook out to every registered callback (CallBackGroup
    equivalent)."""

    def __init__(self, callbacks: list[Callback] | None = None):
        self.callbacks = list(callbacks or [])

    def __getattr__(self, hook: str):
        if hook.startswith("_"):
            raise AttributeError(hook)

        def fanout(*args, **kw):
            for cb in self.callbacks:
                getattr(cb, hook, lambda *a, **k: None)(*args, **kw)

        return fanout


class IterSpeedCallback(Callback):
    """it/s + rolling average (the IterSpeed callback)."""

    def __init__(self, log_every: int = 50, log_fn=print):
        self.log_every = log_every
        self.log_fn = log_fn
        self._t0 = None

    def on_train_start(self, trainer):
        self._t0 = time.perf_counter()

    def on_step_end(self, trainer, step, metrics):
        if step % self.log_every == 0 and step > 0:
            dt = time.perf_counter() - self._t0
            self.log_fn(f"[iter {step}] {self.log_every / dt:.2f} it/s "
                        f"loss={float(metrics.get('loss', float('nan'))):.4f}")
            self._t0 = time.perf_counter()


class DataSpeedMonitor(Callback):
    """Data-fetch wall-time stats (the reference's
    DetailedDataLoadingSpeedMonitor callback): consumes the per-iteration
    ``data_time_s`` metric the trainer records around ``next(data)`` and
    logs avg/max fetch time plus the fraction of step time spent waiting on
    data every ``log_every`` iterations."""

    def __init__(self, log_every: int = 100, log_fn=print):
        self.log_every = log_every
        self.log_fn = log_fn
        self._times: list[float] = []
        self._t0 = None

    def on_train_start(self, trainer):
        self._t0 = time.perf_counter()

    def on_step_end(self, trainer, step, metrics):
        if "data_time_s" in metrics:
            self._times.append(float(metrics["data_time_s"]))
        if step % self.log_every == 0 and self._times:
            wall = time.perf_counter() - self._t0
            avg = sum(self._times) / len(self._times)
            frac = sum(self._times) / max(wall, 1e-9)
            self.log_fn(
                f"[iter {step}] data fetch avg={avg * 1e3:.1f}ms "
                f"max={max(self._times) * 1e3:.1f}ms "
                f"({100 * frac:.1f}% of step time)")
            self._times.clear()
            self._t0 = time.perf_counter()


class LossLoggerCallback(Callback):
    """JSONL metrics log + unstable-loss counting (WandbCallback's
    loss-record/unstable-count behaviour, wandb_log.py:59-120, minus the
    wandb dependency — see MetricsWriter for sinks)."""

    def __init__(self, path: str | None = None, log_every: int = 10):
        self.path = path
        self.log_every = log_every
        self.unstable_count = 0
        self._f = None

    def on_train_start(self, trainer):
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._f = open(self.path, "a")

    def on_step_end(self, trainer, step, metrics):
        loss = float(metrics.get("loss", float("nan")))
        if not (loss == loss):  # NaN
            self.unstable_count += 1
        if self._f and step % self.log_every == 0:
            rec = {"step": step,
                   **{k: float(v) for k, v in metrics.items()
                      if hasattr(v, "__float__")}}
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def on_train_end(self, trainer):
        if self._f:
            self._f.close()


class HeartbeatCallback(Callback):
    """Periodic liveness timestamp (HeartBeat callback, heart_beat.py:29-70).

    ``path`` is an easy_io URI, so stamps can go to local/NFS paths or an
    object store (``s3://bucket/job/heartbeat.txt``) exactly like the
    reference's S3 heartbeats."""

    def __init__(self, path: str = "heartbeat.txt", every_s: float = 60.0):
        self.path = path
        self.every_s = every_s
        self._last = 0.0

    def on_step_end(self, trainer, step, metrics):
        now = time.time()
        if now - self._last >= self.every_s:
            self._last = now
            from chronoedit_tpu_torch.utils import easy_io

            easy_io.put(self.path, f"{now} step={step}\n".encode())


class DeviceMonitorCallback(Callback):
    """Periodic accelerator memory stats (the DeviceMonitor GPU-stats
    callback): logs each CUDA device's allocated bytes
    (``torch.cuda.memory_stats``) against its memory; without a CUDA
    device it says so and logs no number."""

    def __init__(self, every_n: int = 100, log_fn=print):
        self.every_n = every_n
        self.log_fn = log_fn

    def on_step_end(self, trainer, step, metrics):
        if step % self.every_n:
            return
        import torch

        if not torch.cuda.is_available():
            self.log_fn("[device cpu] no CUDA device: memory not measured")
            return
        for d in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(d)
            used = stats.get("allocated_bytes.all.current", 0) / 2**30
            peak = stats.get("allocated_bytes.all.peak", 0) / 2**30
            limit = torch.cuda.get_device_properties(d).total_memory / 2**30
            self.log_fn(f"[device {d}] {used:.2f}/{limit:.2f} GiB in use "
                        f"(peak {peak:.2f} GiB)")


class ManualGarbageCollection(Callback):
    """Disable automatic gc and collect on a fixed cadence — removes GC
    pauses from the step-time distribution (ManualGarbageCollection
    callback)."""

    def __init__(self, every_n: int = 100):
        self.every_n = every_n

    def on_train_start(self, trainer):
        import gc

        gc.disable()

    def on_step_end(self, trainer, step, metrics):
        if step % self.every_n == 0:
            import gc

            gc.collect()

    def on_train_end(self, trainer):
        import gc

        gc.enable()


class WandbCallback(Callback):
    """Optional Weights & Biases metrics sink (WandbCallback,
    wandb_log.py:34-120). No-ops cleanly when wandb is unavailable."""

    def __init__(self, project: str = "chronoedit-tpu", run_name: str | None = None,
                 log_every: int = 10, config: dict | None = None):
        self.project = project
        self.run_name = run_name
        self.log_every = log_every
        self.config = config
        self._run = None

    def on_train_start(self, trainer):
        try:
            import wandb

            self._run = wandb.init(project=self.project, name=self.run_name,
                                   config=self.config)
        except Exception:
            self._run = None

    def on_step_end(self, trainer, step, metrics):
        if self._run is None or step % self.log_every:
            return
        self._run.log({k: float(v) for k, v in metrics.items()
                       if hasattr(v, "__float__")}, step=step)

    def on_train_end(self, trainer):
        if self._run is not None:
            self._run.finish()


class EveryNDrawSample(Callback):
    """Periodically draw validation samples during training (the
    EveryNDrawSample callback, every_n_draw_sample.py:65-130: sampling under
    the EMA weights with a guidance sweep).

    ``sample_fn(params, guidance) -> (C, T, H, W) [-1,1] array``; outputs go
    to ``{out_dir}/iter{N}_g{guidance}`` via the visualize writers.

    The render runs on the rank that holds the callback, on that rank's
    model (``data/item_dataset.make_sample_fn``): under a trainer's pipe
    axis a rank holds only its stage's blocks, so ``on_train_start`` raises
    ``ValueError`` there; under the other axes give it to a rank whose
    model is whole (no fsdp or tensor split).
    """

    def __init__(self, every_n: int, sample_fn, out_dir: str = "samples",
                 guidance_sweep: tuple[float, ...] = (5.0,), use_ema: bool = True):
        self.every_n = every_n
        self.sample_fn = sample_fn
        self.out_dir = out_dir
        self.guidance_sweep = guidance_sweep
        self.use_ema = use_ema

    def on_train_start(self, trainer):
        mesh = getattr(trainer, "mesh", None)
        pipe = 1 if mesh is None else mesh.shape.get("pipe", 1)
        if pipe > 1:
            raise ValueError(f"EveryNDrawSample renders on one rank's model, and under pipe="
                             f"{pipe} a rank holds only its stage's blocks: render from a "
                             f"checkpoint instead (train/checkpoint.load_params into a whole "
                             f"model)")

    def on_step_end(self, trainer, step, metrics):
        if step == 0 or step % self.every_n:
            return
        from chronoedit_tpu_torch.utils.visualize import save_img_or_video

        state = getattr(trainer, "_last_state", None)
        params = None
        if state is not None:
            params = state.ema_params if (self.use_ema and state.ema_params
                                          is not None) else state.params
        for g in self.guidance_sweep:
            sample = self.sample_fn(params, g)
            save_img_or_video(
                os.path.join(self.out_dir, f"iter{step:07d}_g{g:g}"), sample)


class StepTimeoutWatchdog(Callback):
    """Raise if any step exceeds a wall-clock budget (SIGALRM watchdog,
    trainer.py:146-147 — exception-based here; SIGALRM is process-global
    and hostile to async runtimes)."""

    def __init__(self, timeout_s: float = 1800.0):
        self.timeout_s = timeout_s
        self._t = None

    def on_step_start(self, trainer, step):
        self._t = time.perf_counter()

    def on_step_end(self, trainer, step, metrics):
        if self._t is not None:
            dt = time.perf_counter() - self._t
            if dt > self.timeout_s:
                raise TimeoutError(
                    f"training step {step} took {dt:.0f}s > {self.timeout_s:.0f}s")


class ReplicaConsistencyCallback(Callback):
    """Periodic replica-divergence check on the training state — the SPMD
    analog of a race sanitizer (parallel/consistency.py; SURVEY §5.2).

    Every ``every_n`` steps, every replicated leaf of the train state is
    hashed per addressable shard; replicas covering the same global index
    must be bitwise identical (under the trainer's mesh, along each axis
    the leaves its lines keep whole: ``check_state_replicas``).
    Divergence (nondeterministic collective,
    host-dependent state leaking into "replicated" params, restore race)
    raises by default — the failure is silent otherwise and compounds every
    step."""

    collective = True

    def __init__(self, every_n: int = 2000, abort: bool = True):
        self.every_n = every_n
        self.abort = abort

    def on_step_end(self, trainer, step, metrics):
        if (step + 1) % self.every_n:
            return
        from chronoedit_tpu_torch.parallel.consistency import (check_replica_consistency,
                                                               check_state_replicas)

        state = getattr(trainer, "_last_state", None)
        if state is None:
            return
        mesh = getattr(trainer, "mesh", None)
        if mesh is None:
            bad = check_replica_consistency(state)
        else:  # a line's replicas, along each axis (sharded leaves differ)
            bad = [f"{axis}: {path}" for axis, paths in
                   check_state_replicas(state, mesh).items() for path in paths]
        if bad:
            msg = (f"replica divergence at step {step} in {len(bad)} "
                   f"leaves: {bad[:5]}")
            if self.abort:
                raise RuntimeError(msg)
            print(f"[consistency] WARNING {msg}")


class StragglerDetector(Callback):
    """Cross-host straggler detection (StragglerDetectorV2, misc.py:539-620).

    Every ``every_n`` steps, per-host step times are all-gathered across
    processes and compared: a host whose time exceeds ``rel_threshold`` x
    the fleet median is a straggler. After ``max_consecutive`` consecutive
    straggler reports the detector raises (the reference's raise-after-10
    policy), so the job scheduler can reschedule the slow host. Single
    process -> trivially never fires.

    ``gather_fn(x: float) -> np.ndarray`` is injectable for tests; the
    default all-gathers every process's value over the world
    (``parallel.distributed.all_gather_float``; one process: itself alone),
    so every process must hold one and reach the same steps.
    """

    collective = True

    def __init__(self, every_n: int = 50, rel_threshold: float = 1.5,
                 max_consecutive: int = 10, gather_fn=None, log_fn=print):
        self.every_n = every_n
        self.rel_threshold = rel_threshold
        self.max_consecutive = max_consecutive
        self.gather_fn = gather_fn or self._default_gather
        self.log_fn = log_fn
        self._t = None
        self._acc = 0.0
        self._n = 0
        self._consecutive = 0

    @staticmethod
    def _default_gather(value: float):
        import numpy as np

        from chronoedit_tpu_torch.parallel.distributed import all_gather_float

        return np.asarray(all_gather_float(value))

    def on_step_start(self, trainer, step):
        self._t = time.perf_counter()

    def on_step_end(self, trainer, step, metrics):
        if self._t is None:
            return
        self._acc += time.perf_counter() - self._t
        self._n += 1
        if step == 0 or step % self.every_n or self._n == 0:
            return
        mine = self._acc / self._n
        self._acc = 0.0
        self._n = 0
        times = self.gather_fn(mine)
        if len(times) < 2:
            return
        import numpy as np

        median = float(np.median(times))
        if median > 0 and mine > self.rel_threshold * median:
            self._consecutive += 1
            self.log_fn(
                f"[straggler] this host {mine*1e3:.0f} ms/step vs fleet "
                f"median {median*1e3:.0f} ms "
                f"({self._consecutive}/{self.max_consecutive})")
            if self._consecutive >= self.max_consecutive:
                raise RuntimeError(
                    f"host is a persistent straggler: {mine*1e3:.0f} ms/step "
                    f"vs median {median*1e3:.0f} ms for "
                    f"{self._consecutive} consecutive reports")
        else:
            self._consecutive = 0


class ParamStatsCallback(Callback):
    """Periodic parameter-magnitude stats (the ModelParamStats callback):
    global L2 norm of the trained tensors plus one norm per top-level module
    (of the model, or of the adapters), from the live state."""

    def __init__(self, every_n: int = 500, log_fn=print):
        self.every_n = every_n
        self.log_fn = log_fn

    def on_step_end(self, trainer, step, metrics):
        if step == 0 or step % self.every_n:
            return
        state = getattr(trainer, "_last_state", None)
        if state is None:
            return
        owner = state.model if hasattr(state, "model") else state.lora
        parts: dict[str, float] = {}
        for name, p in owner.named_parameters():
            if p.requires_grad:
                top = name.split(".", 1)[0]
                parts[top] = parts.get(top, 0.0) + float(p.detach().float().square().sum())
        total = sum(parts.values()) ** 0.5
        self.log_fn(f"[params @ {step}] |θ|={total:.3e} " +
                    " ".join(f"{k}={v ** 0.5:.2e}" for k, v in sorted(parts.items())))
