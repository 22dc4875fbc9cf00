"""Profiling + failure detection utilities.

The port of ``chronoedit_tpu/utils/profiling.py`` (the reference
observability stack, SURVEY §5.1, §5.3):

- :func:`profile_trace` — a ``torch.profiler`` trace of a block, written
  as a Chrome trace under ``log_dir`` (JAX's is a ``jax.profiler`` trace;
  the reference's torch.profiler chrome traces, utils/profiling.py:36-85).
- :class:`SectionTimer` — per-section wall times (TrainingTimer,
  misc.py:338-392).
- :class:`StepTimeMonitor` — per-step latency statistics with outlier
  flagging; the single-host analogue of StragglerDetectorV2's per-rank
  kernel-time comparison (misc.py:539-620): on a mesh, feed it each host's
  step time and compare via the report.

``SectionTimer`` and ``StepTimeMonitor`` are copies of JAX's.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import os
import statistics
import time

import torch

_TRACES = itertools.count()


@dataclasses.dataclass
class Trace:
    """What :func:`profile_trace` yields: the Chrome trace's path (written
    when the block exits) and the profiler, for ``key_averages()``."""

    path: str
    profile: torch.profiler.profile | None


def kernel_names(path: str) -> list[str]:
    """The device kernels' names in a Chrome trace, in trace order."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "kernel"]


@contextlib.contextmanager
def profile_trace(log_dir: str = "profiles", enabled: bool = True,
                  device: torch.device | str | None = None):
    """Trace the block with ``torch.profiler`` and write a Chrome trace
    (view with Perfetto or ``chrome://tracing``) to
    ``log_dir/trace_<pid>_<n>.json``; yields a :class:`Trace`.

    ``device`` is where the block's work runs: by default the card
    (``utils/platform.cuda_device``, which raises without one); the CPU
    only when asked for. On a card the trace records CUDA activity beside
    the host's, and one that holds no kernel event raises ``RuntimeError``
    after it is written: the card's work went untraced. ``enabled=False``
    traces nothing and writes nothing (the path is empty)."""
    from chronoedit_tpu_torch.utils.platform import cuda_device

    if not enabled:
        yield Trace("", None)
        return
    device = cuda_device() if device is None else torch.device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    trace = Trace(os.path.join(log_dir, f"trace_{os.getpid()}_{next(_TRACES)}.json"),
                  torch.profiler.profile(activities=acts))
    trace.profile.start()
    try:
        yield trace
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        trace.profile.stop()
    trace.profile.export_chrome_trace(trace.path)
    if device.type == "cuda" and not kernel_names(trace.path):
        raise RuntimeError(f"the trace of work on {device} holds no CUDA kernel event "
                           f"({trace.path})")


class SectionTimer:
    """Accumulating named-section timer::

        with timer.section("dataloader"): batch = next(it)
        timer.report() -> {"dataloader": {...}}
    """

    def __init__(self):
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> dict[str, dict[str, float]]:
        return {
            name: {"total_s": self.totals[name], "count": self.counts[name],
                   "mean_s": self.totals[name] / max(self.counts[name], 1)}
            for name in self.totals
        }

    def reset(self):
        self.totals.clear()
        self.counts.clear()


class StepTimeMonitor:
    """Rolling step-time stats; flags stragglers/outliers.

    ``record()`` each step; ``is_outlier`` marks steps slower than
    ``threshold`` x the rolling median; after ``max_consecutive`` consecutive
    outliers, ``should_raise`` turns True (StragglerDetectorV2's
    raise-after-10 behaviour, misc.py:539-620).
    """

    def __init__(self, window: int = 100, threshold: float = 1.5,
                 max_consecutive: int = 10):
        self.window = collections.deque(maxlen=window)
        self.threshold = threshold
        self.max_consecutive = max_consecutive
        self.consecutive = 0

    def record(self, step_time_s: float) -> bool:
        """Returns True if this step is an outlier."""
        median = statistics.median(self.window) if len(self.window) >= 5 else None
        self.window.append(step_time_s)
        if median is None:
            return False
        outlier = step_time_s > self.threshold * median
        self.consecutive = self.consecutive + 1 if outlier else 0
        return outlier

    @property
    def should_raise(self) -> bool:
        return self.consecutive >= self.max_consecutive

    def report(self) -> dict[str, float]:
        if not self.window:
            return {}
        vals = list(self.window)
        return {
            "mean_s": statistics.fmean(vals),
            "median_s": statistics.median(vals),
            "p95_s": sorted(vals)[int(0.95 * (len(vals) - 1))],
            "max_s": max(vals),
        }
