"""Experiment: the grouped-KV flash forward (X1) on the card.

Counterpart of the JAX package's ``tools/exp_flash_paired.py``. X1
(``csrc/flash_fwd.cu``, ``flash_fwd_grouped_wgmma_kernel<n>``) is built
from K1/K5's machinery (a TMA ring feeding warp-specialised ``wgmma``):
its ring stage is n 64-row KV tiles behind one barrier pair, a consumer
issues all n score products before any softmax work, takes one combined
row max and rescales the accumulator once, then runs each tile's P.V as
soon as its P is built; n = 1 is the production kernel K1/K5 (128-row
tiles, with FA3's overlap of one tile's scores under the last one's P.V),
so the table compares like with like. :func:`main` holds every n against the group-1
kernel on the first 256 q rows (as the JAX tool does) and the whole output
and LSE against the q-chunked fp32 twin, then times n = 1, 2, 3, 4 with
CUDA events.

Run on the card: ``python -m chronoedit_tpu_torch.tools.exp_flash_paired``
(B = 2, 28,800 tokens, 40 heads of 128, bf16: the reasoning
self-attention).
"""

from __future__ import annotations

import torch

from chronoedit_tpu_torch.ops import flash_attention as fa
from chronoedit_tpu_torch.tools import (K1_LSE_TOL, K1_OUT_MAX_TOL, K1_OUT_STEPS, ULP_BF16,
                                        cuda_ms, describe, max_err, plain_rows, rate)
from chronoedit_tpu_torch.utils.platform import cuda_device

GROUPS = (1, 2, 3, 4)
CHECK_ROWS = 256  # q rows of the check against the group-1 kernel
TOKENS = 28800  # the reasoning self-attention's
REPS = 5  # timed calls per group, after one warm-up


def paired_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                 n: int = 2) -> torch.Tensor:
    """Attention output with n KV tiles a step: X1 for n = 2, 3, 4, K1/K5
    for n = 1 (the twin on CPU tensors)."""
    return fa.flash_attention_with_lse(q, k, v, scale, group=n)[0]


def main(B: int = 2, S: int = TOKENS, H: int = 40, D: int = 128,
         device: torch.device | None = None, reps: int = REPS) -> dict[int, dict]:
    """Check and time every group at (B, S, H, D) bf16 self-attention.
    Raises if a group disagrees; returns {n: {err_vs_group1, err_vs_plain,
    lse_err, ms}} (ms None on the CPU)."""
    dev = cuda_device() if device is None else torch.device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    scale = D ** -0.5
    flops = 4 * B * H * S * S * D
    print(f"grouped flash forward, q/k/v {(B, S, H, D)} bf16 on {describe(dev)}", flush=True)

    head = q[:, :CHECK_ROWS].contiguous()
    base = paired_flash(head, k, v, scale, 1)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, scale, q_chunk=plain_rows(B, H, S))
    tol = min(K1_OUT_MAX_TOL, K1_OUT_STEPS * ULP_BF16 * float(ref.float().abs().max()))
    results = {}
    for n in GROUPS:
        # two kernels each within tol of the twin are within 2 tol of each other
        e_head = max_err(paired_flash(head, k, v, scale, n), base)
        out, lse = fa.flash_attention_with_lse(q, k, v, scale, group=n)
        e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
        del out, lse
        ms = (cuda_ms(lambda: paired_flash(q, k, v, scale, n), reps, warmup=1)
              if dev.type == "cuda" else None)
        print(f"group {n}: {rate(flops, ms)}; first {CHECK_ROWS} rows against group 1 "
              f"{e_head:.3e} (tol {2 * tol:.3e}); against the twin: out {e_out:.3e} (tol "
              f"{tol:.3e}), lse {e_lse:.3e} (tol {K1_LSE_TOL})", flush=True)
        if not (e_head <= 2 * tol and e_out <= tol and e_lse <= K1_LSE_TOL):
            raise AssertionError(f"grouped flash forward, group {n}, disagrees")
        results[n] = {"err_vs_group1": e_head, "err_vs_plain": e_out, "lse_err": e_lse,
                      "ms": ms}
    return results


if __name__ == "__main__":
    main()
