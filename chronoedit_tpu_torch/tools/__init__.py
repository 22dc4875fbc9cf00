"""Experiment entry points of the port, the counterparts of the JAX
package's ``tools/`` scripts of the same names. Run from the repository
root:

- ``python -m chronoedit_tpu_torch.tools.exp_flash_paired``: the
  grouped-KV flash forward (X1) against the ungrouped kernel (K1/K5) at the
  reasoning self-attention's 28,800 tokens;
- ``python -m chronoedit_tpu_torch.tools.exp_flash_bwd_grouped --shapes
  edit|reasoning|both``: the grouped flash backward (X2) against K6/K7 at
  the edit's 7,200 and the reasoning's 28,800 tokens.

Both run on the card (``utils.platform.cuda_device``) unless the caller
passes ``device=torch.device("cpu")``, as the tests do: the CPU runs the
plain twins, so its checks exercise the control flow and it measures no
time. The bounds and helpers below are the one copy that the tools and
``chip_smoke.py`` both judge the attention kernels by.
"""

from __future__ import annotations

import statistics

import torch

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


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms, from CUDA events around each call."""
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
