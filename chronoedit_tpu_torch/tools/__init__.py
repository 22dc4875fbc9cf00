"""Experiment entry points of the port (the first two the counterparts of
the JAX package's ``tools/`` scripts of the same names). Run from the
repository root:

- ``python -m chronoedit_tpu_torch.tools.exp_flash_paired``: the
  grouped-KV flash forward (X1) against the ungrouped kernel (K1/K5) at the
  reasoning self-attention's 28,800 tokens;
- ``python -m chronoedit_tpu_torch.tools.exp_flash_bwd_grouped --shapes
  edit|reasoning|both``: the grouped flash backward (X2) against K6/K7 at
  the edit's 7,200 and the reasoning's 28,800 tokens;
- ``python -m chronoedit_tpu_torch.tools.exp_norm_ring``: K4's and K2's
  device time at the main paths' shapes, on an input used again and on one
  just written, by CUDA events and by the profiler (the card only; it has
  no JAX counterpart).

The first two run on the card (``utils.platform.cuda_device``) unless the
caller passes ``device=torch.device("cpu")``, as the tests do: the CPU runs
the plain twins, so its checks exercise the control flow and it measures no
time. The bounds and helpers below are the one copy that the tools and
``chip_smoke.py`` both judge the attention kernels by.
"""

from __future__ import annotations

import statistics
import time
from collections import Counter

import torch

from chronoedit_tpu_torch.kernels import build

# A bf16 kernel against its fp32 twin. K1 (and every flash forward) rounds
# P to bf16 before P.V (<= 2**-9 per weight, fp32 accumulation), so its
# output may differ by two bf16 steps (2**-7 relative) at the case's
# largest output, and never by more than 1e-2 (outputs reach ~1.3 against
# KV 512 and 257, ~0.13 in self-attention). Its LSE is fp32 throughout.
ULP_BF16 = 2.0 ** -7
K1_OUT_STEPS = 2.0
K1_OUT_MAX_TOL = 1e-2
K1_LSE_TOL = 1e-3
# K6/K7 (and X2) against their twin (both from the same bf16 inputs, lse
# and dsum): the kernels round P and dS to bf16 before the products that
# use them, as JAX does, and round the outputs to bf16. A CPU emulation of
# exactly those roundings at 3,600 x {3,600, 512, 257} put the largest
# error at 0.98 bf16 steps of max|ref| and the normwise relative error at
# 2.6e-3. Bounds: 3 steps of max|ref|, and 1e-2 normwise (a lost or doubled
# tile errs by the output's own size in that norm).
K67_MAX_STEPS = 3.0
K67_NORM_REL = 1e-2
# fp32 elements of one q chunk's (B, H, rows, Skv) score matrix in the twin
PLAIN_SCORE_ELEMS = 2 ** 31


def plain_rows(b: int, h: int, skv: int) -> int:
    """q rows per chunk of the plain attention twin (bounded fp32 scores)."""
    return max(1, PLAIN_SCORE_ELEMS // (b * h * skv))


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def k67_check(got: torch.Tensor, want: torch.Tensor) -> dict:
    """A backward gradient against its reference: {max, tol, rel, ok}, ok
    when finite, within K67_MAX_STEPS bf16 steps of max|want| and within
    K67_NORM_REL normwise."""
    err, tol = max_err(got, want), K67_MAX_STEPS * ULP_BF16 * float(want.float().abs().max())
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    ok = err <= tol and rel <= K67_NORM_REL and bool(torch.isfinite(got).all())
    return {"max": err, "tol": tol, "rel": rel, "ok": ok}


# The device's wait before a timed call, in clock cycles: at least
# SLEEP_CYCLES (17 ms at 2 GHz, far above a wrapper's host time) and four
# times the host's time for the last warm-up call at 2 GHz; doubled until
# the host has enqueued the whole call before the device reaches the start
# event. One wait a call: calls queued behind one wait can fill the
# device's launch queue (a plain twin's hundreds of launches a call), and
# the host then waits for the device whatever the wait.
SLEEP_CYCLES = 1 << 25
MAX_SLEEP_CYCLES = 1 << 34
# Launches of the timed calls that cuda_ms discarded and made again, by
# kernel name and by (kernel name, shape key) as ``build.SHAPE_LAUNCHES``
# keys them: a caller that counts launches around cuda_ms sees its loops'
# launches plus these.
DISCARDED: Counter = Counter()
DISCARDED_BY_SHAPE: Counter = Counter()


def _launch_counts() -> tuple[Counter, Counter]:
    return Counter(build.LAUNCHES), Counter({(name, key): n
                                             for name, counts in build.SHAPE_LAUNCHES.items()
                                             for key, n in counts.items()})


def cuda_ms(fn, reps: int = 10, warmup: int = 2, before=None) -> float:
    """Median device time of ``fn`` in ms: CUDA events around each call, with
    the host's enqueue time kept outside them. A device-side wait
    (``torch.cuda._sleep``) is enqueued before each call's start event
    (``before``, if given, runs between the two, outside the timed span);
    once ``fn`` and the end event are enqueued, the start event must not
    have been reached yet (``start.query()`` false), so the device ran the
    call back to back. If it had been reached, the reading is discarded (the
    call's launches added to ``DISCARDED``), the wait doubles and the call is
    made again. Raises if ``fn`` waits for the device itself (no wait is
    then long enough)."""
    host_s = 0.0
    for _ in range(warmup):
        if before is not None:
            before()
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
    times = []
    cycles = min(MAX_SLEEP_CYCLES, max(SLEEP_CYCLES, int(4 * host_s * 2e9)))
    while len(times) < reps:
        counts = _launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        if before is not None:
            before()
        start.record()
        fn()
        end.record()
        reached = start.query()
        torch.cuda.synchronize()
        if not reached:
            times.append(start.elapsed_time(end))
            continue
        now = _launch_counts()
        DISCARDED.update(now[0] - counts[0])
        DISCARDED_BY_SHAPE.update(now[1] - counts[1])
        if cycles >= MAX_SLEEP_CYCLES:
            raise RuntimeError("cuda_ms: the device reached the start event before the call was "
                               "enqueued, at the longest wait: does the call synchronise?")
        cycles *= 2
    return statistics.median(times)


def call_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median time of ``fn`` in ms from CUDA events recorded on an idle
    device around the whole call: the device reaches the start event at once
    and then waits for the host, so a short kernel's reading includes its
    wrapper's host time (what a caller that does not queue ahead sees)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rate(flops: float, ms: float | None) -> str:
    """'<ms> ms (<TFLOP/s>)' of one call, or 'not measured' on the CPU."""
    if ms is None:
        return "time not measured (CPU)"
    return f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s)"


def describe(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU (plain twins)"
