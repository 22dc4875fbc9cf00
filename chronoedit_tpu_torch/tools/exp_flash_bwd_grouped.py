"""Experiment: the grouped flash backward (X2) on the card.

Counterpart of the JAX package's ``tools/exp_flash_bwd_grouped.py``. X2's
dQ side takes n_dq 64-row KV tiles a step and its dK/dV side n_dkv 32-row
q tiles a step behind one barrier pair (``csrc/flash_bwd.cu``: K6's and
K7's kernels with that ring stage, ``flash_bwd_dq_wgmma_kernel<64 n>`` and
``flash_bwd_dkv_wgmma_kernel<32 n>``). At n = 2 that stage is K6's or K7's
own, so the variant runs their instantiation; at n = 4 one barrier pair
covers two of their steps. A side whose group is 1 runs K6 (dQ) or K7
(dK, dV). :func:`run_shape` runs production (1, 1), which is K6/K7,
then JAX's variants (2, 1), (1, 2), (2, 2), (4, 1), (4, 4) and (2, 4) on
the same inputs. It holds each variant's dQ, dK and dV against K6/K7's
whole, and against the fp32 twin on the rows of three 128-row tiles (the
first, the middle and the last, every batch and head), each within 3 bf16
steps of max|ref| and 1e-2 normwise, and times each whole backward (dsum
reduction, dQ and dK/dV) with CUDA events.

Run on the card: ``python -m chronoedit_tpu_torch.tools.exp_flash_bwd_grouped
[--shapes edit|reasoning|both]`` (B = 2, 40 heads of 128, bf16; the edit's
7,200 tokens and the reasoning's 28,800, the latter with fewer timed
calls).
"""

from __future__ import annotations

import argparse

import torch

from chronoedit_tpu_torch.ops import flash_attention as fa
from chronoedit_tpu_torch.tools import cuda_ms, describe, k67_check, plain_rows, rate
from chronoedit_tpu_torch.utils.platform import cuda_device

# (n_dq, n_dkv): production first, then the JAX tool's variants
VARIANTS = ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 4), (2, 4))
# shape name: (tokens, timed calls per variant)
SHAPES = {"edit": (7200, 5), "reasoning": (28800, 2)}
TILE = 128  # rows of a sampled tile of the twin check


def grouped_backward(q, k, v, out, dout, lse, scale: float, n_dq: int = 2, n_dkv: int = 2):
    """(dq, dk, dv) from the forward's out and lse (B, Sq, H): X2 with n_dq
    KV tiles a step for dQ and n_dkv q tiles a step for dK, dV, K6 or K7 on
    a side whose group is 1 (the twin on CPU tensors)."""
    return fa.flash_attention_bwd(q, k, v, out, dout, lse, scale, group_dq=n_dq,
                                  group_dkv=n_dkv)


def sample_rows(s: int) -> torch.Tensor:
    """Rows of the first, the middle and the last ``TILE``-row tile of s
    (the last one ragged where ``TILE`` does not divide s)."""
    starts = sorted({0, s // 2 // TILE * TILE, (s - 1) // TILE * TILE})
    return torch.cat([torch.arange(a, min(a + TILE, s)) for a in starts])


def sampled_twin(q, k, v, out, dout, lse, scale: float, rows: torch.Tensor):
    """The fp32 twin's dQ on q rows ``rows`` and its dK, dV on KV rows
    ``rows``. Given lse and dsum from the whole forward, a dQ row needs only
    its own q row and a dK or dV row only its own k and v rows, so these
    are the whole twin's rows at a fraction of its cost."""
    dq = fa.flash_attention_bwd_plain(q[:, rows], k, v, out[:, rows], dout[:, rows],
                                      lse[:, rows], scale, need_dkv=False)[0]
    b, _, h, _ = q.shape
    _, dk, dv = fa.flash_attention_bwd_plain(q, k[:, rows], v[:, rows], out, dout, lse, scale,
                                             q_chunk=plain_rows(b, h, len(rows)), need_dq=False)
    return dq, dk, dv


def run_shape(S: int, B: int = 2, H: int = 40, D: int = 128,
              device: torch.device | None = None, reps: int = 5) -> dict[tuple, dict]:
    """Every variant at (B, S, H, D) bf16 self-attention. Raises if a
    variant disagrees with production or with the twin on the sampled rows;
    returns {(n_dq, n_dkv): {dq, dk, dv (max errors against production),
    twin (the largest against the twin), ms}} (ms None on the CPU)."""
    dev = cuda_device() if device is None else torch.device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v, dout = (torch.randn((B, S, H, D), generator=g, device=dev, dtype=torch.bfloat16)
                     for _ in range(4))
    scale = D ** -0.5
    out, lse = fa.flash_attention_with_lse(q, k, v, scale)
    flops = 5 * 2 * B * H * S * S * D  # S, dP, dQ, dK, dV products
    print(f"== grouped flash backward, S={S}, q/k/v {(B, S, H, D)} bf16 on {describe(dev)}",
          flush=True)
    rows = sample_rows(S).to(dev)
    twin = sampled_twin(q, k, v, out, dout, lse, scale, rows)
    ref, results = None, {}
    for n_dq, n_dkv in VARIANTS:
        got = grouped_backward(q, k, v, out, dout, lse, scale, n_dq, n_dkv)
        if ref is None:
            ref = got
        errs, twin_err = {}, 0.0
        for name, a, b, t in zip(("dq", "dk", "dv"), got, ref, twin):
            prod, vs_twin = k67_check(a, b), k67_check(a[:, rows], t)
            for what, c in (("production", prod), (f"the twin on {len(rows)} rows", vs_twin)):
                if not c["ok"]:
                    raise AssertionError(
                        f"grouped backward ({n_dq}, {n_dkv}): {name} disagrees with {what}: "
                        f"max {c['max']:.3e} (tol {c['tol']:.3e}), normwise {c['rel']:.3e}")
            errs[name] = prod["max"]
            twin_err = max(twin_err, vs_twin["max"])
        del got
        # the check's call was the warm-up
        ms = (cuda_ms(lambda: grouped_backward(q, k, v, out, dout, lse, scale, n_dq, n_dkv),
                      reps, warmup=0) if dev.type == "cuda" else None)
        label = "production" if (n_dq, n_dkv) == (1, 1) else f"dq x{n_dq}, dkv x{n_dkv}"
        print(f"{label:16s}: {rate(flops, ms)}; max err against production dq "
              f"{errs['dq']:.3e}, dk {errs['dk']:.3e}, dv {errs['dv']:.3e}; against the twin "
              f"on {len(rows)} rows {twin_err:.3e}", flush=True)
        results[(n_dq, n_dkv)] = {**errs, "twin": twin_err, "ms": ms}
    return results


def main(argv: list[str] | None = None, device: torch.device | None = None, B: int = 2,
         H: int = 40, D: int = 128, tokens: dict[str, int] | None = None) -> dict[str, dict]:
    """Run the shapes ``--shapes`` names; ``tokens`` overrides their token
    counts (small CPU runs). Returns {shape: run_shape's result}."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--shapes", default="both", choices=["edit", "reasoning", "both"])
    a = p.parse_args(argv)
    results = {}
    for name, (seq, reps) in SHAPES.items():
        if a.shapes in (name, "both"):
            seq = seq if tokens is None else tokens[name]
            results[name] = run_shape(seq, B, H, D, device, reps)
    return results


if __name__ == "__main__":
    main()
