"""Experiment: K4's and K2's device time on the card, and what the input's
place in the cache does to it.

K4 (``csrc/rms_norm.cu``) and K2 (``csrc/ln_modulate.cu``) run through the
production wrappers at every shape the main paths give them
(``PRODUCTION_ROWS`` of a (1, rows, 5120) bf16 stream; K2 with frames of
the edit's 3,600 rows), each timed four ways:

- ``ms``: the device time (``tools.cuda_ms``) of repeated calls on one
  input, as ``chip_smoke.py``'s kernel table times them;
- ``written_ms``: the same, with the input rewritten (``x.copy_(y)``, a
  stream of the same size) ahead of each timed call, outside its events, as
  in a forward, where a projection or a residual has just written it;
- ``profile_ms``, ``profile_written_ms``: the kernel's mean duration in a
  ``torch.profiler`` trace of the same two sequences, which checks the
  CUDA-event timer against the profiler's own device clock;
- ``call_ms``: the whole call, host included (``tools.call_ms``).

It uses nothing but the wrappers, so this file and
``tools/__init__.py`` copied into a checkout of an earlier commit time that
commit's K4 and K2 the same way, and runs of both checkouts in one call
compare two designs on one card.

Run on the card: ``python -m chronoedit_tpu_torch.tools.exp_norm_ring``.
"""

from __future__ import annotations

import statistics

import torch

from chronoedit_tpu_torch.ops import fused_norms as fn
from chronoedit_tpu_torch.ops import layers as L
from chronoedit_tpu_torch.tools import call_ms, cuda_ms, describe
from chronoedit_tpu_torch.utils.platform import cuda_device

D = 5120
HW = 3600  # the edit's rows a frame (45 x 80 patches)
EPS = 1e-6
REPS = 10
# the main paths' rows of each kernel: the edit's and the reasoning
# forward's tokens, and for K4 also the text and CLIP keys
PRODUCTION_ROWS = {"rms_norm": (7200, 28800, 512, 257), "ln_modulate": (7200, 28800)}


def _call(name: str, x: torch.Tensor, g: torch.Generator):
    """The production wrapper of ``name`` on ``x``, as a thunk."""
    rows = x.shape[1]
    if name == "rms_norm":
        norm = L.RMSNorm(D, device=x.device, dtype=torch.bfloat16)
        with torch.no_grad():
            norm.scale.copy_(1.0 + 0.1 * torch.randn(D, generator=g, device=x.device))
        return lambda: fn.rms_norm_fused(norm, x, EPS)
    scale, shift = (0.1 * torch.randn((1, rows // HW, D), generator=g, device=x.device)
                    for _ in range(2))
    return lambda: fn.layer_norm_modulate(x, scale, shift, HW, EPS)


def profile_ms(name: str, call, before=None) -> float:
    """Mean duration in ms of the kernels whose name holds ``name`` in a
    ``torch.profiler`` trace of ``REPS`` calls (``before`` ahead of each)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            if before is not None:
                before()
            call()
        torch.cuda.synchronize()
    spans = [(e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    if len(spans) != REPS:
        raise AssertionError(f"profile of {name}: {len(spans)} kernels traced, {REPS} launched")
    return statistics.mean(spans)


def main(device: torch.device | None = None) -> dict[tuple, dict]:
    """Time each kernel at each of its shapes; returns {(kernel, rows):
    {ms, written_ms, profile_ms, profile_written_ms, call_ms}}."""
    dev = cuda_device() if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError("exp_norm_ring: times kernels, so runs only on a CUDA device")
    g = torch.Generator(device=dev).manual_seed(0)
    print(f"K4 / K2, (1, rows, {D}) bf16 on {describe(dev)}", flush=True)
    results = {}
    with torch.no_grad():
        for name, sizes in PRODUCTION_ROWS.items():
            for rows in sizes:
                x, y = (torch.randn((1, rows, D), generator=g, device=dev, dtype=torch.bfloat16)
                        * 2.0 + 0.5 for _ in range(2))
                call = _call(name, x, g)
                write = lambda: x.copy_(y)  # noqa: E731
                row = {"ms": cuda_ms(call, REPS), "written_ms": cuda_ms(call, REPS, before=write),
                       "profile_ms": profile_ms(name, call),
                       "profile_written_ms": profile_ms(name, call, before=write),
                       "call_ms": call_ms(call, REPS)}
                results[(name, rows)] = row
                print(f"{name} rows={rows}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()),
                      flush=True)
    return results


if __name__ == "__main__":
    main()
