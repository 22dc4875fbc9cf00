"""Drive the PyTorch port's paths once on one NVIDIA GPU: the 8-step 720p
edit from a checkpoint directory (weights, LoRA and the UMT5 / CLIP
encoders loaded from files), the 29-frame temporal-reasoning edit, LoRA
fine-tuning of the full-width DiT at the edit's geometry, quantized serving (w4a16 with
int8-score attention, and the mixed2 recipe), and the two attention
experiments (the grouped flash forward X1 and backward X2).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` (sm_90a) and no network; it imports
nothing of JAX. Phases, in order; any failure raises, so the exit code is
non-zero and no result line is printed:

1. require CUDA; print torch/CUDA versions and the card's name and power
   limit (``nvidia-smi``);
2. build the kernels from ``chronoedit_tpu_torch/csrc`` (``kernels/build.py``,
   one ``nvcc`` per source in parallel) and print each kernel's registers
   and spills, each template instantiation under its own name, and for
   every instantiation a kernel row launches the highest register its SASS
   uses (above ptxas's count for the warp-specialised kernels, which
   rebalance with ``setmaxnreg``) and its local-memory traffic, which must
   be none;
3. hold each kernel against its plain PyTorch twin on the card at the main
   paths' shapes in bf16, with device times for both (CUDA events with the
   host's enqueue kept outside them, ``tools.cuda_ms``; the short calls,
   K2-K4 and the cross-attention ones, also with the whole call's time,
   host included, ``call_ms``), for PyTorch's own
   call where one computes the same function (``library_ms``: SDPA, and
   its backward asked for each backward kernel's own gradients, and
   ``torch.nn.functional.rms_norm`` beside K4, timed as yardsticks, never
   called by the port) and each
   kernel's bound (the larger of FLOPs over 989 TFLOP/s and bytes over
   3.35 TB/s): first K1 and X1 at every group at B = 2, 4 heads, over
   ragged (Sq, Skv) pairs (``RAGGED_CASES``: one row, tile tails, a batch
   boundary inside a tile) and K6/K7 and X2 (both sides at group 2, then
   4) over the same pairs (with a global LSE, as a ring hop's backward
   gets it, and one case with scores near -100; X2 also bitwise against a
   second call, and compared bitwise with K6/K7's), K9 over the same
   pairs (the int8 rule lowered) and K8 on both grids at ragged M (1, 130,
   257), N = 136 and K = 256, each also bitwise against a second call of
   itself, then K1 and X1
   (2, 3 and 4 KV tiles a step) and K6/K7 (against the q-chunked backward
   twin, and a second call bitwise the first) at the edit's 7,200 tokens
   against KV 7,200, 512 and 257, X2 (every grouped variant of the
   experiment, each also bitwise against a second call and compared
   bitwise with K6/K7's) against KV 7,200 and 257, K2 and K4 over ragged
   frame and batch boundaries (``RAGGED_NORM_CASES``, D = 5,120 and 256)
   and K2-K4 at the edit's stream, K2 and K4 also at the reasoning
   forward's 28,800 rows and K4 at the text and CLIP keys' 512 and 257
   rows (``NORM_ROWS``; each also bitwise against 20 more calls), and
   the flash kernel at the reasoning self-attention's 28,800 tokens as K5 and X1 (against the
   q-chunked twin, computed once); K8 (the int4 matmul) at the
   five projection shapes of a 720p forward and the three at the reasoning
   forward's 28,800 rows, against its twin and against
   cuBLAS on the dequantized bf16 weight (a yardstick, not the same
   function), and K9 (int8 scores) at 28,800 tokens against its q-chunked
   twin and SDPA in bf16, both also bitwise against a second call of
   themselves. This runs before the model exists: the plain
   attention needs ~35 GB;
4. the experiment entry points at full width (B = 2, 40 heads of 128):
   ``chronoedit_tpu_torch.tools.exp_flash_paired.main()`` (X1 at 28,800
   tokens) and ``exp_flash_bwd_grouped.main(["--shapes", "both"])`` (X2 at
   7,200 and 28,800 tokens, K6/K7 and every X2 variant also held against
   the twin on three 128-row tiles of both batches), each checked and
   timed by the tool itself, with the launch counters zeroed just before
   each and read just after: they must be exactly what the tool's loops
   imply (X1's and X2's launches in the kernel table are these);
5. small references: the serving slice at 2 blocks x 2 heads of 128 on the
   card (bf16, kernels) against the same weights on the CPU (fp32, plain
   twins), as PSNR over the [-1, 1] pixel range: the edit, and reasoning
   mode with the frame drop and without it, W-tiled streaming VAE; the edit
   quantized int8, w4a16 and mixed2, and the reasoning drop in w4a16 with
   int8 scores (the rule lowered so that K9 runs at these lengths), each on
   the same quantized weights on both sides; the encoders at full width
   and two blocks, as dB over the CPU output's peak: UMT5 (bf16, 512 token
   ids with a 300-token mask), CLIP ViT-H (bf16, 16 heads of 80 through
   SDPA, a 720p frame through ``preprocess``) and XLM-R with its head
   (fp32), each with the launch counters zeroed before it and zero after
   (no encoder runs a hand-written kernel); then two
   LoRA steps and two full-parameter steps of that DiT (loss, gradient
   cosine, grad_norm, then Adam's first moment and the update, against the
   CPU);
6. the main paths: ``chronoedit_14b_distilled`` at full width and depth
   (40 blocks x 5120, bf16, random weights from a seeded generator, built
   outside ``inference_mode`` so that it can train), the full-width VAE, a
   seeded UMT5-XXL and CLIP ViT-H and a rank-32 LoRA are written as a
   checkpoint directory in the reference's layout under the git-ignored
   ``build/`` (diffusers DiT shards in bf16, ``Wan2.1_VAE.pth``, the UMT5
   file in bf16, the CLIP file in fp16, a diffusers LoRA in bf16; the free
   disk is checked first), freed, and loaded back through
   ``load_pipeline(..., loras=[(lora, 1.0)])``; against the same models
   drawn again from their seeds, every DiT tensor is bitwise the original,
   or for the LoRA's targets the fp32 merge of the file's bf16 adapters
   rounded once to bf16, the VAE and the encoders bitwise the originals
   after their files' casts. The loaded pipeline encodes 512 token ids and the 720p
   image (``encode_prompt``, ``encode_image``; no kernel launch) and serves
   a cold and a warm edit from those embeddings; the encoders are dropped,
   and the same pipeline serves two more 720p edits, then two 29-frame
   reasoning edits (the whole trajectory, k = 8; the drop, k = 2) through
   ``__call__``, then takes three
   rank-32 LoRA steps (``make_lora_train_step``, remat "full") on 720p mock
   edit pairs; then quantizes that DiT in place to w4a16 (Lloyd grid) and
   serves two 720p edits and a w4a16 + int8-score reasoning edit (k = 2),
   and loads the bf16 model again from the same files, quantizes it to
   mixed2 and serves one edit; the directory is removed at the end,
   whatever happened. The launch counters are zeroed just before each
   edit and each step and must then show exactly the launches the path
   implies, by kernel, by attention KV length and by the int4 matmul's
   rows (none of them grouped); write, load (per component, the LoRA merge
   among them), encode, stage and step times, peak memory (of the
   load's check, with the encoders and without), the memory after each
   quantization, each quantized output's PSNR against the bf16 output of
   the same request and noise (random weights: no bar), a
   tiled-against-untiled streaming decode of an 8-frame latent trajectory
   (fp32) and an unchanged-base checksum follow;
7. print the command's seconds, the kernel table as one JSON line, the
   card line again, and last
   ``{"ok": true, "device": {...}}``.

``--profile`` adds one warm ``torch.profiler`` pass over each stage (DiT
forward, VAE encode, VAE decode) of both serving paths at their shapes,
over one LoRA train step and over one w4a16 and one mixed2 DiT forward at
7,200 tokens, printing each one's device idle share and
writing its per-kernel table to ``chiprun_out/profile_<stage>.txt`` under
the repository root.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
from collections import Counter
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

# The attention kernels' bounds (K1_*, K67_*, with their reasons) and the
# CUDA-event timers (``cuda_ms``: the device alone; ``call_ms``: the whole
# call, host included) are the experiment tools' own, so that both judge a
# kernel alike. Tolerances, each with its reason: K2-K4 compute in fp32 and
# round once to bf16, as their twins do, so they may differ by one bf16
# rounding step (ULP_BF16) at the output's largest magnitude.
from chronoedit_tpu_torch.tools import (K1_LSE_TOL, K1_OUT_MAX_TOL, K1_OUT_STEPS, K67_MAX_STEPS,
                                        K67_NORM_REL, ULP_BF16, call_ms, cuda_ms, k67_check,
                                        max_err)

# Training references: the 2-block DiT in bf16 on the card against fp32 on
# the CPU (same weights, batch and draws). The same comparison with the
# bf16 side also on the CPU (the twins in bf16) gave a loss within 9.3e-5
# relative, a gradient cosine of 0.99997 and a grad_norm within 6.6e-4; the
# card adds the kernels' bf16 P and dS (2.6e-3 normwise per attention
# gradient, see K67_*). Bounds: the loss within 5e-3 relative, grad_norm
# within 2e-2, the cosine of the whole gradient at least 0.999 (a relative
# error of 4.5 %); a missing block or a wrong gradient misses all three by
# orders of magnitude.
TRAIN_LOSS_REL = 5e-3
TRAIN_NORM_REL = 2e-2
TRAIN_GRAD_COS = 0.999
# The update, after two steps on the same batch and draws (the first at the
# warm-up's learning rate 0, which must leave every weight's bits as they
# were; the clip set to act at half the reference's gradient norm): Adam's
# first moment is 0.19 x the clipped gradient, so it may differ as the
# gradient does (cosine 0.999: 4.5 % normwise); the update is close to
# lr x sign(g), which flips where |g| is within the bf16 error, and bf16
# weights round it. The same comparison with the bf16 side on the CPU gave
# the moment within 7.8e-3 and the update within 8.9e-2 (LoRA) and 9.7e-2
# (full) normwise. The update's error grows as the square root of the
# gradient's (the share of flipped signs grows with it), so its bound of
# 0.25 allows 8x that gradient error. A doubled learning rate, a missing
# clip or a skipped warm-up errs by 100 % in one of these norms.
TRAIN_LR = 1e-2
TRAIN_MOMENT_REL = 5e-2
TRAIN_UPDATE_REL = 0.25
# K8 against its twin: the dequantized bf16 weight is bitwise the twin's;
# both sum in fp32 (in another order) and round once to bf16, so an output
# may differ by one bf16 step, at most one step of max|ref|. K9 against
# its twin: the integer scores and their fp32 dequantization are the same;
# the kernel rounds P to bf16 as K1 does, so K1's bounds apply.
K8_OUT_STEPS = 1.0
# The card's published peaks (H100 SXM, dense bf16 and int8 tensor cores;
# HBM3), for each kernel's bound: the larger of the operations' time (each
# type at its peak) and bytes / bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12
# bf16 on the card against fp32 on the CPU; the repo's fidelity bar
MIN_PSNR_DB = 35.0
# The W-tiled streaming decode against the untiled one, both fp32 on the
# card with TF32 off: the tiles' halo covers the receptive field, so the
# two compute the same sums, and differ only where cuDNN picks another
# algorithm (another summation order) for the narrower tile. A misplaced
# tile or a short halo errs by the output's own scale, 1,000x this bound.
TILED_DECODE_TOL = 1e-3
# The encoders at full width and two blocks, bf16 on the card against fp32
# on the CPU (same weights), as PSNR over the reference's peak magnitude.
# ``python -m chronoedit_tpu_torch.tools.encoder_bounds --device cpu``
# builds these same encoders and reads, with the bf16 side on the CPU,
# 57.90 dB (UMT5, the valid tokens of a 300-of-512 mask) and 59.35 dB (CLIP
# on a 720p frame) when sound; with one fault planted, 51.91 dB (UMT5's
# logits scaled by head_dim**-0.5), 37.42 (pad keys let in), 32.19 (CLIP's
# LayerNorm scales not loaded) and 14.38 (no antialiasing in preprocess).
# The bound lies between the sound readings and the closest fault; a tanh
# GELU in CLIP (59.34 dB) is below what it can see. XLM-R computes in fp32
# on both sides (TF32 off): only the summation order differs, at about 1e-6
# relative (over 100 dB).
ENCODER_MIN_DB = 55.0
XLMR_MIN_DB = 80.0
# UMT5's and XLM-R's vocabularies in phase 5: an embedding lookup's table
# size does not change the arithmetic, and the full ones would take 4 and
# 1 GB of fp32 on the CPU
SMALL_VOCAB = 4096
# prompt length of the loaded path's 512 token ids (the rest is padding)
PROMPT_LEN = 300
# the checkpoint directory the main path writes and loads, under the
# repository's git-ignored build/; removed when the run ends
CHECKPOINT_DIR = Path(__file__).resolve().parent / "build" / "smoke_checkpoint"
# the rank-32 LoRA file's alpha: alpha / rank = 0.5 scales every delta
LORA_ALPHA = 16.0

EDIT_H, EDIT_W = 720, 1280
TEXT_TOKENS = 512
IMAGE_TOKENS = 257
REASONING_FRAMES = 29
# the edit's self-attention: 2 latent frames x 45 x 80 patches
EDIT_TOKENS = 2 * (EDIT_H // 16) * (EDIT_W // 16)
# reasoning self-attention: 8 latent frames x 45 x 80 patches
REASONING_TOKENS = 8 * (EDIT_H // 16) * (EDIT_W // 16)
# q rows per chunk of the plain twin at 28,800 tokens: ~8 GB of fp32 scores
Q_CHUNK = 1800
# (Sq, Skv) of phase 3's ragged and batch-boundary check of K1/K5 at B = 2:
# one row; tails of a q and a KV tile; one row past a tile; the edit's q
# against the image context; a short q against the edit's KV
RAGGED_CASES = ((1, 1), (127, 257), (129, 129), (7200, 257), (200, 7200))
# K2-K4 at the main paths' (1, rows, 5120) streams: the edit's and the
# reasoning forward's tokens, and for K4 also the text and CLIP keys
NORM_ROWS = {"ln_modulate": (EDIT_TOKENS, REASONING_TOKENS), "gated_residual": (EDIT_TOKENS,),
             "rms_norm": (EDIT_TOKENS, REASONING_TOKENS, TEXT_TOKENS, IMAGE_TOKENS)}
# (B, T, hw) of phase 3's ragged K2/K4 check: frames of 37 rows across a
# batch boundary; then frames short enough that one block's rows span three
# or more frames (K2 reuses a modulation slot), down to a frame a row
RAGGED_NORM_CASES = ((2, 3, 37), (2, 150, 8), (2, 700, 1))
# calls of K2-K4 held bitwise against the first on the same inputs
NORM_REPEATS = 20
# X1's KV tiles a step, and X2's (n_dq, n_dkv) variants (the experiment's,
# without production's (1, 1), which is K6/K7)
X1_GROUPS = (2, 3, 4)
X2_VARIANTS = ((2, 1), (1, 2), (2, 2), (4, 1), (4, 4), (2, 4))
# the grouped kernels' launch names: none of the main paths launches them
GROUPED = ("flash_fwd_grouped", "flash_bwd_dq_grouped", "flash_bwd_dkv_grouped")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def host_s(fn):
    """(result, seconds) of ``fn`` on the host clock, ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bound(flops: float, nbytes: float, int8_ops: float = 0.0) -> dict:
    """The least time the card could take: {bound_ms, bound_by}."""
    t_ops = (flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def add_rows(a: dict, b: dict) -> dict:
    """Two calls of one kernel as one row: times and bounds add, errors max;
    a call time (``call_ms``) stays only where both rows have one."""
    out = dict(b)
    for key in ("ms", "plain_ms", "bound_ms"):
        out[key] = a[key] + b[key]
    out["library_ms"] = (None if a["library_ms"] is None or b["library_ms"] is None
                         else a["library_ms"] + b["library_ms"])
    if "call_ms" in a and "call_ms" in b:
        out["call_ms"] = a["call_ms"] + b["call_ms"]
    else:
        out.pop("call_ms", None)
    out["max_abs_err"] = max(a["max_abs_err"], b["max_abs_err"])
    out["bound_by"] = a["bound_by"] if a["bound_ms"] >= b["bound_ms"] else b["bound_by"]
    return out


def psnr(got: torch.Tensor, want: torch.Tensor) -> float:
    mse = float((got.double() - want.double()).square().mean())
    return math.inf if mse == 0 else 10.0 * math.log10(2.0 ** 2 / mse)


def peak_db(got: torch.Tensor, want: torch.Tensor) -> float:
    """PSNR over the reference's peak magnitude (features, not pixels)."""
    mse = float((got.double() - want.double()).square().mean())
    peak = float(want.double().abs().max())
    return math.inf if mse == 0 else 10.0 * math.log10(peak ** 2 / mse)


# ----------------------------------------------------------- phase 3

def accumulate(results: dict, name: str, row: dict, case: str | None = None) -> None:
    """Add a kernel's row for one call shape to ``results[name]``
    (``add_rows``); with ``case``, also keep its time under
    ``results[name]["ms_by_case"][case]``, and its call time, where the row
    has one, under ``["call_ms_by_case"][case]``."""
    prev = results.get(name, {})
    results[name] = add_rows(prev, row) if prev else dict(row)
    for key, by_case in (("ms", "ms_by_case"), ("call_ms", "call_ms_by_case")):
        cases = dict(prev.get(by_case, {}))
        if case is not None and key in row:
            cases[case] = row[key]
        if cases:
            results[name][by_case] = cases


def compare_kernels(dev: torch.device) -> dict[str, dict]:
    """Each kernel against its plain twin at main-path shapes; returns
    {name: {max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms}}
    (rows over several shapes also hold ``ms_by_case``; K2-K4's and K1's
    cross-attention cases also the call time, ``call_ms``)."""
    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    ragged_flash_check(randn)
    ragged_flash_bwd_check(randn)
    ragged_qk8_check(randn)
    ragged_int4_check(g)
    results = {}
    s, h, d = EDIT_TOKENS, 40, 128
    q = randn(1, s, h, d)
    for skv, what in ((s, "self"), (TEXT_TOKENS, "text"), (IMAGE_TOKENS, "image")):
        k, v = randn(1, skv, h, d), randn(1, skv, h, d)
        ref = flash_reference(q, k, v)
        accumulate(results, "flash_fwd", compare_flash("K1", what, q, k, v, ref), f"kv={skv}")
        for n in X1_GROUPS:
            accumulate(results, "flash_fwd_grouped",
                       compare_flash("X1", what, q, k, v, ref, group=n), f"n={n} kv={skv}")
        del ref
        # X2 against the self-attention's and the ragged image context's KV
        for name, rows in compare_flash_bwd(what, q, k, v, grouped=what != "text").items():
            for row, case in rows:
                accumulate(results, name, row, case)
    del q, k, v
    torch.cuda.empty_cache()

    results.update(compare_norms(randn))
    dim = h * d

    # K5: the same kernel over the reasoning self-attention's 28,800 tokens,
    # and X1 there against the same twin reference; K9 on the same q, k, v
    q, k, v = (randn(1, REASONING_TOKENS, h, d) for _ in range(3))
    ref = flash_reference(q, k, v, q_chunk=Q_CHUNK)
    results["flash_fwd_streamed"] = compare_flash("K5", "self", q, k, v, ref)
    for n in X1_GROUPS:
        accumulate(results, "flash_fwd_grouped", compare_flash("X1", "self", q, k, v, ref, group=n),
                   f"n={n} kv={REASONING_TOKENS}")
    del ref
    torch.cuda.empty_cache()
    results["flash_fwd_qk8"] = compare_qk8(q, k, v)
    del q, k, v
    torch.cuda.empty_cache()

    # K8 at the projections of a 720p forward and of a reasoning forward's
    # 28,800 tokens: M x K x N
    for m, k_in, n in ((EDIT_TOKENS, dim, dim), (EDIT_TOKENS, dim, 13824),
                       (EDIT_TOKENS, 13824, dim), (TEXT_TOKENS, dim, dim),
                       (IMAGE_TOKENS, dim, dim), (REASONING_TOKENS, dim, dim),
                       (REASONING_TOKENS, dim, 13824), (REASONING_TOKENS, 13824, dim)):
        accumulate(results, "int4_matmul", compare_int4(g, m, k_in, n))
    return results


def norm_calls(name: str, x, dim: int, hw: int, randn) -> tuple:
    """K2, K3 or K4 on the (B, S, dim) stream ``x`` (frames of ``hw`` rows):
    (kernel, twin, bytes moved (inputs read once, the output written once),
    PyTorch's own call or None), each a function of no arguments."""
    from chronoedit_tpu_torch.ops import fused_norms as fn
    from chronoedit_tpu_torch.ops import layers as L

    b, s, _ = x.shape
    row_bytes = x.numel() * 2
    if name == "ln_modulate":
        scale, shift = (0.1 * randn(b, s // hw, dim, dtype=torch.float32) for _ in range(2))
        return (lambda: fn.layer_norm_modulate(x, scale, shift, hw),
                lambda: fn.ln_modulate_plain(x, scale, shift, hw),
                2 * row_bytes + 2 * scale.numel() * 4, None)
    if name == "gated_residual":
        delta, gate = randn(b, s, dim), 0.1 * randn(b, s // hw, dim, dtype=torch.float32)
        return (lambda: fn.gated_residual(x, delta, gate, hw),
                lambda: fn.gated_residual_plain(x, delta, gate, hw),
                3 * row_bytes + gate.numel() * 4, None)
    norm = L.RMSNorm(dim, device=x.device, dtype=torch.bfloat16)
    with torch.no_grad():
        norm.scale.copy_(1.0 + 0.1 * randn(dim))
    # PyTorch's rms_norm applies the weight before its one rounding; K4
    # rounds, then applies the weight in bf16: a yardstick, not the same
    # function
    return (lambda: fn.rms_norm_fused(norm, x), lambda: fn.rms_norm_plain(norm.scale, x),
            2 * row_bytes + dim * 2,
            lambda: torch.nn.functional.rms_norm(x, (dim,), norm.scale, 1e-6))


def check_norm(label: str, kernel, plain) -> float:
    """A K2-K4 call against its twin, within one bf16 rounding step of
    max|ref| (ULP_BF16), and ``NORM_REPEATS`` more calls each bitwise the
    first (a fixed sum order; a ring stage read before its row landed, or
    after the next one did, would differ). Returns the largest error."""
    got, ref = kernel(), plain()
    err, tol = max_err(got, ref), ULP_BF16 * float(ref.float().abs().max())
    same = sum(torch.equal(got, kernel()) for _ in range(NORM_REPEATS))
    print(f"{label}: max|out-ref| {err:.3e} (tol {tol:.3e}); {same} of {NORM_REPEATS} more "
          f"calls bitwise the first")
    if not err <= tol or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label} disagrees with its twin")
    if same != NORM_REPEATS:
        raise AssertionError(f"{label}: calls on the same inputs differ")
    return err


def compare_norms(randn) -> dict[str, dict]:
    """K2-K4: first K2 and K4 over ``RAGGED_NORM_CASES`` at D = 5,120 and
    256, then each at its ``NORM_ROWS`` shapes (1, rows, 5120) with frames
    of the edit's hw = 3,600 rows, against the twin (``check_norm``), with
    the device time (``cuda_ms``), the call time (``call_ms``), the twin's
    and, for K4, ``torch.nn.functional.rms_norm``'s device time, and beside
    them the device time of a plain copy of the stream (``x.clone()``), the
    memory system's practical rate for such traffic. Returns
    {name: row} over the shapes (``ms_by_case``, ``call_ms_by_case``)."""
    for b, t, hw in RAGGED_NORM_CASES:
        for dim in (5120, 256):
            x = randn(b, t * hw, dim) * 2.0 + 0.5
            for name in ("ln_modulate", "rms_norm"):
                kernel, plain, _, _ = norm_calls(name, x, dim, hw, randn)
                with torch.no_grad():
                    check_norm(f"{name} ragged B={b} T={t} hw={hw} D={dim}", kernel, plain)
    results = {}
    dim, hw = 40 * 128, EDIT_TOKENS // 2
    for name, sizes in NORM_ROWS.items():
        for rows in sizes:
            x = randn(1, rows, dim) * 2.0 + 0.5
            kernel, plain, nbytes, library = norm_calls(name, x, dim, hw, randn)
            with torch.no_grad():
                err = check_norm(f"{name} x {tuple(x.shape)}", kernel, plain)
                ms, call, plain_ms = cuda_ms(kernel), call_ms(kernel), cuda_ms(plain)
                library_ms = None if library is None else cuda_ms(library)
                copy_ms = cuda_ms(x.clone)
            # about 10 operations an element: far under the bytes
            row = {"max_abs_err": err, "ms": ms, "call_ms": call, "plain_ms": plain_ms,
                   **bound(10 * x.numel(), nbytes), "library_ms": library_ms}
            print(f"   kernel {ms:.4f} ms on the device ({call:.4f} ms a call), plain "
                  f"{plain_ms:.3f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}): "
                  f"{row['bound_ms'] / ms:.1%} of the bound; a copy of the stream (x.clone(): "
                  f"its bytes read and written once, no arithmetic) {copy_ms:.4f} ms; " + (
                      "no single PyTorch call computes it" if library is None else
                      f"torch.nn.functional.rms_norm (weight before the rounding) "
                      f"{library_ms:.4f} ms"))
            accumulate(results, name, row, f"rows={rows}")
            del x
    return results


def ragged_flash_check(randn) -> None:
    """K1/K5 and X1 at every group through ``flash_attention_with_lse`` at
    B = 2, 4 heads of 128, over ``RAGGED_CASES``, against the plain twin
    under K1's bounds: a tensor map that read a row of the next batch, or a
    wrong mask on the zero-filled tail of a tile or step, shows here."""
    from chronoedit_tpu_torch.ops import flash_attention as fa

    for sq, skv in RAGGED_CASES:
        q = randn(2, sq, 4, 128)
        k, v = randn(2, skv, 4, 128), randn(2, skv, 4, 128)
        scale = q.shape[-1] ** -0.5
        ref, ref_lse = fa.flash_attention_plain(q, k, v, scale)
        ref_max = float(ref.float().abs().max())
        tol = min(K1_OUT_MAX_TOL, K1_OUT_STEPS * ULP_BF16 * ref_max)
        for group in (1, *X1_GROUPS):
            out, lse = fa.flash_attention_with_lse(q, k, v, scale, group=group)
            e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
            label = "K1" if group == 1 else f"X1 group {group}"
            print(f"{label} ragged q {tuple(q.shape)} kv {skv}: max|out-ref| {e_out:.3e} (tol "
                  f"{tol:.3e}), max|lse-ref| {e_lse:.3e} (tol {K1_LSE_TOL})")
            if not (e_out <= tol and e_lse <= K1_LSE_TOL and bool(torch.isfinite(out).all())):
                raise AssertionError(f"{label} disagrees with its twin at q {sq}, kv {skv}, B = 2")


def ragged_flash_bwd_check(randn) -> None:
    """K6 and K7, and X2 at each of its instantiations (both sides at group
    2, then at 4), through ``flash_attention_bwd`` at B = 2, 4 heads of 128,
    over ``RAGGED_CASES``, against the q-chunked twin under the K67 bounds.
    O and the LSE come from a forward over the case's KV and 64 more keys,
    as a ring hop's backward gets them (over its own single key the case
    (1, 1) would give dQ = dK = 0 up to rounding): a tensor map that read a
    row of the next batch, or a q row past Sq left live, shows here. A last
    case, (64, 129) with every score near -100 (q near 3, k near -3), holds
    the mask of the KV columns past Skv: zero-filled K rows cancel an
    unmasked column's P = exp(-lse) while it is finite, but here it
    overflows and inf times a zero row is NaN. X2's gradients are also held
    bitwise against a second call of themselves and compared bitwise with
    K6/K7's."""
    from chronoedit_tpu_torch.ops import flash_attention as fa

    for sq, skv, far in [(*case, False) for case in RAGGED_CASES] + [(64, 129, True)]:
        q, dout = randn(2, sq, 4, 128), randn(2, sq, 4, 128)
        k, v = randn(2, skv + 64, 4, 128), randn(2, skv + 64, 4, 128)
        if far:
            q, k = 3.0 + 0.1 * q, -3.0 + 0.1 * k
        scale = q.shape[-1] ** -0.5
        out, lse = fa.flash_attention_with_lse(q, k, v, scale)
        k, v = k[:, :skv].contiguous(), v[:, :skv].contiguous()
        ref = fa.flash_attention_bwd_plain(q, k, v, out, dout, lse, scale, q_chunk=Q_CHUNK)
        base = None
        for n in (1, 2, 4):
            label = "K6/K7" if n == 1 else f"X2 ({n}, {n})"
            got = fa.flash_attention_bwd(q, k, v, out, dout, lse, scale, group_dq=n, group_dkv=n)
            for name, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
                c = k67_check(g_, r_)
                print(f"{label} ragged q {tuple(q.shape)} kv {skv} (global LSE"
                      f"{', scores near -100' if far else ''}): {name} max err "
                      f"{c['max']:.3e} (tol {c['tol']:.3e}), normwise {c['rel']:.3e} (tol "
                      f"{K67_NORM_REL})")
                if not c["ok"]:
                    raise AssertionError(f"{label} {name} disagrees with its twin at q {sq}, "
                                         f"kv {skv}, B = 2")
            if base is None:
                base = got
                continue
            x2_determinism(label, f"ragged q {sq} kv {skv}", got, base,
                           lambda: fa.flash_attention_bwd(q, k, v, out, dout, lse, scale,
                                                          group_dq=n, group_dkv=n))


def x2_determinism(label: str, where: str, got, k67, again) -> None:
    """X2's (dq, dk, dv) ``got``: a second call (``again()``) must be
    bitwise the first; prints whether they are also bitwise K6/K7's
    ``k67`` on the same inputs (the design's expectation, not a bound)."""
    second = again()
    if not all(torch.equal(a, b) for a, b in zip(got, second)):
        raise AssertionError(f"{label} at {where}: two calls on the same inputs differ")
    same = [name for name, a, b in zip(("dq", "dk", "dv"), got, k67) if torch.equal(a, b)]
    print(f"{label} {where}: a second call is bitwise the first (dq, dk, dv); bitwise K6/K7's: "
          f"{', '.join(same) if same else 'none'}")


def int4_case(g: torch.Generator, m: int, k: int, n: int, grid: str = "lloyd"):
    """x (m, k) and a random (n, k) weight quantized w4a16 on ``grid``:
    (K8's arguments, its output, the twin's output, max error, bound).
    Raises unless K8 is within K8_OUT_STEPS bf16 steps of max|ref|, finite,
    and a second call is bitwise the first."""
    from chronoedit_tpu_torch.ops import int4_matmul as i4
    from chronoedit_tpu_torch.ops import layers as L
    from chronoedit_tpu_torch.ops import quant

    dev = g.device
    lin = L.Linear(k, n, device=dev, dtype=torch.bfloat16, generator=g)
    leaf = quant.quantize_linear_params_int4(lin, grid=grid)
    del lin
    x = torch.randn((m, k), generator=g, device=dev, dtype=torch.bfloat16)
    args = (x, leaf.packed, leaf.scales, leaf.table)
    got, ref = i4.int4_matmul(*args), i4.int4_matmul_plain(*args)
    again = i4.int4_matmul(*args)
    err, ref_max = max_err(got, ref), float(ref.float().abs().max())
    tol = K8_OUT_STEPS * ULP_BF16 * ref_max
    same = bool(torch.equal(got, again))
    print(f"K8 int4_matmul {m} x {k} x {n} ({grid} grid): max|out-ref| {err:.3e} "
          f"(tol {tol:.3e}, max|ref| {ref_max:.3f}); a second call bitwise equal: {same}")
    if not (err <= tol and bool(torch.isfinite(got).all()) and same):
        raise AssertionError(f"K8 disagrees with its twin (or itself) at {m} x {k} x {n}, "
                             f"{grid} grid")
    del got, ref, again
    return args, err


def ragged_int4_check(g: torch.Generator) -> None:
    """K8 on both grids at ragged M (1, 130, 257: partial 256-row tiles),
    N = 136 (a partial 128-column tile) and K = 256 (one scale group a
    half): a tensor map that reads past an edge, a tile row or column
    stored past M or N, or a wrong table shows here."""
    for grid in ("uniform", "lloyd"):
        for m in (1, 130, 257):
            int4_case(g, m, 256, 136, grid)


def compare_int4(g: torch.Generator, m: int, k: int, n: int) -> dict:
    """K8 against its twin on x (m, k) and a random (n, k) weight quantized
    w4a16 on the Lloyd grid (``int4_case``). CUDA-event times of K8, of the
    twin and of cuBLAS on the already dequantized bf16 weight (the
    yardstick ``library_ms``: not the same function, the weight's
    dequantization is not in it). Returns a row."""
    from chronoedit_tpu_torch.ops import int4_matmul as i4

    args, err = int4_case(g, m, k, n)
    x, packed, scales, table = args
    w = i4.dequantize(packed, scales, table).to(torch.bfloat16)
    ms = cuda_ms(lambda: i4.int4_matmul(*args))
    plain = cuda_ms(lambda: i4.int4_matmul_plain(*args), reps=3, warmup=1)
    library = cuda_ms(lambda: torch.matmul(x, w.T))
    flops = 2 * m * k * n
    # x read, packed weight, scales and table read, y written
    nbytes = 2 * m * k + n * k // 2 + 4 * scales.numel() + 60 + 2 * m * n
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain, "library_ms": library,
           **bound(flops, nbytes)}
    print(f"   kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
          f"{row['bound_ms'] / ms:.1%} of the bound), twin {plain:.3f} ms, cuBLAS "
          f"on the dequantized bf16 weight {library:.3f} ms ({ms / library:.2f}x its time), "
          f"bound {row['bound_ms']:.3f} ms ({row['bound_by']})")
    del w
    torch.cuda.empty_cache()
    return row


def ragged_qk8_check(randn) -> None:
    """K9 through ``flash_attention_qk_int8`` (the int8 rule lowered, so that
    every length takes it) at B = 2, 4 heads of 128, over ``RAGGED_CASES``,
    against the twin on the same int8 inputs under K1's bounds: a tensor map
    that read a row of the next batch, or a k scale or mask misplaced on the
    zero-filled tail of a tile, shows here. Then a second call, bitwise the
    first."""
    from chronoedit_tpu_torch.ops import flash_attention as fa

    saved = fa.QK8_RESIDENT_KV_BYTES
    fa.QK8_RESIDENT_KV_BYTES = 0
    try:
        for sq, skv in RAGGED_CASES:
            q = randn(2, sq, 4, 128)
            k, v = randn(2, skv, 4, 128), randn(2, skv, 4, 128)
            scale = q.shape[-1] ** -0.5
            out = fa.flash_attention_qk_int8(q, k, v, scale)
            again = fa.flash_attention_qk_int8(q, k, v, scale)
            q8, qs, k8, ks = fa.quantize_qk(q, k)
            ref = fa.flash_attention_qk_int8_plain(q8, k8, v, qs, ks, scale)
            err, ref_max = max_err(out, ref), float(ref.float().abs().max())
            tol = min(K1_OUT_MAX_TOL, K1_OUT_STEPS * ULP_BF16 * ref_max)
            same = bool(torch.equal(out, again))
            print(f"K9 ragged q {tuple(q.shape)} kv {skv}: max|out-ref| {err:.3e} (tol "
                  f"{tol:.3e}); a second call bitwise equal: {same}")
            if not (err <= tol and bool(torch.isfinite(out).all()) and same):
                raise AssertionError(f"K9 disagrees with its twin (or itself) at q {sq}, "
                                     f"kv {skv}, B = 2")
    finally:
        fa.QK8_RESIDENT_KV_BYTES = saved


def compare_qk8(q, k, v) -> dict:
    """K9 against its q-chunked twin on the int8 inputs of the same q, k, v
    (the torch prologue, timed apart): K1's bounds. CUDA-event times of K9,
    of the twin and of SDPA in bf16 (the yardstick ``library_ms``: float
    scores, not the same function). Returns a row."""
    from chronoedit_tpu_torch.ops import flash_attention as fa

    scale = q.shape[-1] ** -0.5
    q8, qs, k8, ks = fa.quantize_qk(q, k)
    out = fa._forward_qk8(q8, k8, v, qs, ks, scale)
    same = bool(torch.equal(out, fa._forward_qk8(q8, k8, v, qs, ks, scale)))
    ref = fa.flash_attention_qk_int8_plain(q8, k8, v, qs, ks, scale, q_chunk=Q_CHUNK)
    err, ref_max = max_err(out, ref), float(ref.float().abs().max())
    tol = min(K1_OUT_MAX_TOL, K1_OUT_STEPS * ULP_BF16 * ref_max)
    print(f"K9 flash_fwd_qk8 q {tuple(q.shape)} kv {k.shape[1]}: max|out-ref| {err:.3e} "
          f"(tol {tol:.3e}, max|ref| {ref_max:.3f}); a second call bitwise equal: {same}")
    if not (err <= tol and bool(torch.isfinite(out).all()) and same):
        raise AssertionError("K9 disagrees with its twin (or itself)")
    del out, ref
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: fa._forward_qk8(q8, k8, v, qs, ks, scale))
    prologue = cuda_ms(lambda: fa.quantize_qk(q, k), reps=3)
    plain = cuda_ms(lambda: fa.flash_attention_qk_int8_plain(q8, k8, v, qs, ks, scale,
                                                             q_chunk=Q_CHUNK), reps=3, warmup=1)
    library = cuda_ms(lambda: sdpa(q, k, v, scale))
    b, sq, h, d = q.shape
    unit = 2 * b * h * sq * k.shape[1] * d  # one (Sq x Skv x D) product
    # q8, k8 read (1 byte), v read and O written (bf16), the fp32 scales
    nbytes = b * h * d * (sq + k.shape[1]) + 2 * b * h * d * (k.shape[1] + sq) \
        + 4 * b * h * (sq + k.shape[1])
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain, "library_ms": library,
           **bound(unit, nbytes, int8_ops=unit)}
    print(f"   kernel {ms:.3f} ms ({2 * unit / ms / 1e9:.1f} TOP/s, {row['bound_ms'] / ms:.1%} of "
          f"the bound), prologue (torch) {prologue:.3f} ms, twin {plain:.3f} ms, "
          f"SDPA bf16 {library:.3f} ms, bound {row['bound_ms']:.3f} ms ({row['bound_by']}: the "
          f"s8 scores at {PEAK_INT8_OPS / 1e12:.0f} TOPS plus P.V at "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s)")
    torch.cuda.empty_cache()
    return row


def sdpa(q, k, v, scale):
    """PyTorch's own attention on BSHD tensors (transposed views, no copy):
    the yardstick ``library_ms``, never called by the port."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale)


def attention_bytes(q, k, n_q_like: int, n_kv_like: int, n_row_f32: int) -> int:
    """Bytes of n_q_like (B, Sq, H, D) and n_kv_like (B, Skv, H, D) bf16
    tensors plus n_row_f32 (B, H, Sq) fp32 rows."""
    b, sq, h, d = q.shape
    return 2 * d * b * h * (n_q_like * sq + n_kv_like * k.shape[1]) + 4 * n_row_f32 * b * h * sq


def flash_reference(q, k, v, q_chunk: int | None = None) -> dict:
    """The plain twin's output and LSE on (q, k, v), with CUDA-event times
    of the twin and of SDPA: computed once and shared by the rows of every
    group of the flash forward on these inputs."""
    from chronoedit_tpu_torch.ops import flash_attention as fa

    scale = q.shape[-1] ** -0.5
    out, lse = fa.flash_attention_plain(q, k, v, scale, q_chunk=q_chunk)
    plain = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, scale, q_chunk=q_chunk),
                    reps=3, warmup=1)
    torch.cuda.empty_cache()
    return {"out": out, "lse": lse, "plain_ms": plain,
            "library_ms": cuda_ms(lambda: sdpa(q, k, v, scale))}


def compare_flash(kid: str, what: str, q, k, v, ref: dict, group: int = 1) -> dict:
    """The flash kernel with ``group`` KV tiles a step (1: K1/K5; 2-4:
    X1) against the twin's ``flash_reference`` on (q, k, v): output within
    two bf16 steps of max|ref| (at most 1e-2), LSE within 1e-3; its
    device time beside the twin's and SDPA's, and for cross-attention also
    its call time (``call_ms``). Returns a kernel row."""
    from chronoedit_tpu_torch.ops import flash_attention as fa

    scale = q.shape[-1] ** -0.5
    skv = k.shape[1]
    out, lse = fa.flash_attention_with_lse(q, k, v, scale, group=group)
    e_out, e_lse = max_err(out, ref["out"]), max_err(lse, ref["lse"])
    ref_max = float(ref["out"].float().abs().max())
    out_tol = min(K1_OUT_MAX_TOL, K1_OUT_STEPS * ULP_BF16 * ref_max)
    label = f"{kid} flash_fwd" + (f" group {group}" if group > 1 else "")
    print(f"{label} {what:5s} q {tuple(q.shape)} kv {skv}: max|out-ref| "
          f"{e_out:.3e} (tol {out_tol:.3e}, max|ref| {ref_max:.3f})"
          f", max|lse-ref| {e_lse:.3e} (tol {K1_LSE_TOL})")
    if not (e_out <= out_tol and e_lse <= K1_LSE_TOL):
        raise AssertionError(f"{label} disagrees with its twin at kv={skv}")
    del out, lse

    def call():
        return fa.flash_attention_with_lse(q, k, v, scale, group=group)

    ms = cuda_ms(call)
    plain, library = ref["plain_ms"], ref["library_ms"]
    flops = 4 * q.shape[0] * q.shape[2] * q.shape[1] * skv * q.shape[3]
    row = {"max_abs_err": e_out, "ms": ms, "plain_ms": plain, "library_ms": library,
           **bound(flops, attention_bytes(q, k, 2, 2, 1))}
    if what != "self":  # cross-attention: a short call, its host time beside
        row["call_ms"] = call_ms(call)
    print(f"   kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s)"
          + (f" on the device ({row['call_ms']:.3f} ms a call)" if "call_ms" in row else "")
          + f", plain {plain:.3f} ms, SDPA {library:.3f} ms, bound {row['bound_ms']:.3f} ms "
          f"({row['bound_by']}); {row['bound_ms'] / ms:.1%} of the bound, {ms / library:.2f}x "
          f"SDPA's time")
    return row


def compare_flash_bwd(what: str, q, k, v, grouped: bool) -> dict[str, list[tuple]]:
    """K6 (dQ) and K7 (dK, dV) against the q-chunked fp32 twin on the same
    bf16 q, k, v, the forward kernel's O and LSE and a random dO: each
    gradient within K67_MAX_STEPS bf16 steps of its max|ref| and within
    K67_NORM_REL normwise. With ``grouped``, every X2 variant
    (``X2_VARIANTS``) against the same twin reference with the same bounds.
    CUDA-event times of each kernel (its wrapper, which adds the dsum
    reduction; X2's dQ and dK/dV kernels timed apart for each group size)
    and, for each kernel's own outputs alone (dQ for K6; dK and dV for K7),
    of the twin and of SDPA's backward asked for just those gradients (the
    same yardsticks for X2's kernels). A second K6/K7 call on the same
    inputs must be bitwise the first (no atomics). Returns
    {name: [(row, case)]}: K6/K7's rows under ``flash_bwd_dq`` / ``flash_bwd_dkv`` (case None),
    X2's under ``flash_bwd_dq_grouped`` / ``flash_bwd_dkv_grouped``, one
    for each group size (case "n=<n> kv=<Skv>")."""
    from chronoedit_tpu_torch.ops import flash_attention as fa

    scale = q.shape[-1] ** -0.5
    b, sq, h, d = q.shape
    skv = k.shape[1]
    out, lse = fa.flash_attention_with_lse(q, k, v, scale)
    dout = torch.randn(out.shape, device=q.device, dtype=q.dtype,
                       generator=torch.Generator(device=q.device).manual_seed(skv))
    ref = fa.flash_attention_bwd_plain(q, k, v, out, dout, lse, scale, q_chunk=Q_CHUNK)

    def check(label: str, got) -> dict[str, float]:
        errs = {}
        for name, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
            c = k67_check(g_, r_)
            print(f"{label} flash_bwd {what:5s} kv {skv}: {name} max err {c['max']:.3e} (tol "
                  f"{c['tol']:.3e}, {K67_MAX_STEPS:g} steps of max|ref|), normwise "
                  f"{c['rel']:.3e} (tol {K67_NORM_REL})")
            if not c["ok"]:
                raise AssertionError(f"{label} {name} disagrees with its twin at kv={skv}")
            errs[name] = c["max"]
        return errs

    got = fa.flash_attention_bwd(q, k, v, out, dout, lse, scale)
    errs = check("K6/K7", got)
    again = fa.flash_attention_bwd(q, k, v, out, dout, lse, scale)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"K6/K7 at kv={skv}: two calls on the same inputs differ")
    print(f"K6/K7 flash_bwd {what:5s} kv {skv}: a second call is bitwise the first (dq, dk, dv)")
    del again
    x2_errs = {}
    for pair in X2_VARIANTS if grouped else ():
        def x2_call(pair=pair):
            return fa.flash_attention_bwd(q, k, v, out, dout, lse, scale, group_dq=pair[0],
                                          group_dkv=pair[1])
        x2 = x2_call()
        x2_errs[pair] = check(f"X2 {pair}", x2)
        x2_determinism(f"X2 {pair}", f"flash_bwd {what:5s} kv {skv}", x2, got, x2_call)
        del x2
    del ref, got
    torch.cuda.empty_cache()

    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        lib_out = sdpa(qg, kg, vg, scale)
    unit = 2 * b * h * sq * skv * d  # FLOPs of one (Sq x Skv x D) product
    rows = {}
    # the wrapper asked for no gradient launches nothing: its checks, the
    # lse copy and the dsum reduction, which every time below includes
    wrapper = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, out, dout, lse, scale,
                                                     need_dq=False, need_dkv=False))
    print(f"   the wrapper alone (lse copy, dsum = rowsum(dO * O) in torch): {wrapper:.3f} ms, "
          f"inside each kernel time below")
    # K6: S, dP, dS k; reads q, k, v, dO, lse, dsum, writes dQ.
    # K7: S^T, dP^T, P^T dO, dS^T q; reads q, k, v, dO, lse, dsum, writes dK, dV
    for name, side, wrt, flops, nbytes, outs in (
            ("flash_bwd_dq", 0, (qg,), 3 * unit, attention_bytes(q, k, 3, 2, 2), ("dq",)),
            ("flash_bwd_dkv", 1, (kg, vg), 4 * unit, attention_bytes(q, k, 2, 4, 2),
             ("dk", "dv"))):
        flags = {"need_dq": side == 0, "need_dkv": side == 1}
        ms = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, out, dout, lse, scale, **flags))
        plain = cuda_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, out, dout, lse, scale, q_chunk=Q_CHUNK, **flags), reps=3, warmup=1)
        library = cuda_ms(lambda: torch.autograd.grad(lib_out, wrt, dout.transpose(1, 2),
                                                      retain_graph=True))
        yardsticks = {"plain_ms": plain, "library_ms": library, **bound(flops, nbytes)}
        rows[name] = [({"max_abs_err": max(errs[o] for o in outs), "ms": ms, **yardsticks},
                       None)]
        print(f"   {name}: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), twin {plain:.3f} "
              f"ms, SDPA backward for {'dQ' if side == 0 else 'dK, dV'} {library:.3f} ms, bound "
              f"{yardsticks['bound_ms']:.3f} ms ({yardsticks['bound_by']}); "
              f"{yardsticks['bound_ms'] / ms:.1%} of the bound, {ms / library:.2f}x SDPA's "
              f"backward")
        if not grouped:
            continue
        # X2's kernel for this side alone, at each of its group sizes (a
        # side at group 1 is K6/K7, timed above)
        rows[name + "_grouped"] = []
        for n in sorted({pair[side] for pair in X2_VARIANTS} - {1}):
            group = {"group_dq" if side == 0 else "group_dkv": n}
            t = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, out, dout, lse, scale,
                                                       **flags, **group))
            err = max(x2_errs[p_][o] for p_ in X2_VARIANTS if p_[side] == n for o in outs)
            rows[name + "_grouped"].append(({"max_abs_err": err, "ms": t, **yardsticks},
                                            f"n={n} kv={skv}"))
            print(f"   {name}_grouped (X2), {n} tiles a step: kernel {t:.3f} ms "
                  f"({flops / t / 1e9:.1f} TFLOP/s); {yardsticks['bound_ms'] / t:.1%} of the "
                  f"bound, {t / library:.2f}x SDPA's backward")
    del lib_out
    torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------- phase 4

def expected_tool_launches(calls: list[tuple[str, int, int]]
                           ) -> tuple[dict[str, int], dict[str, dict[int, int]]]:
    """The launch counters after ``calls``, a list of (kernel name, KV
    length, launches), in ``read_launches``'s form."""
    from chronoedit_tpu_torch.kernels import build

    by_name = dict.fromkeys(build.LAUNCHES, 0)
    by_kv = {name: {} for name in build.SHAPE_LAUNCHES}
    for name, kv, count in calls:
        by_name[name] += count
        by_kv[name][kv] = by_kv[name].get(kv, 0) + count
    return by_name, by_kv


def paired_tool_calls() -> list[tuple[str, int, int]]:
    """``exp_flash_paired.main()``'s launches at its defaults: group 1 on the
    256-row head (the base of the head check), then for each group the
    head, the whole check, the warm-up and the timed calls, all over
    ``TOKENS`` KV rows; group 1 is K1/K5, the rest X1."""
    from chronoedit_tpu_torch.tools import exp_flash_paired as xp

    calls = [("flash_fwd", xp.TOKENS, 1)]
    for n in xp.GROUPS:
        calls.append(("flash_fwd" if n == 1 else "flash_fwd_grouped", xp.TOKENS, 3 + xp.REPS))
    return calls


def bwd_tool_calls() -> list[tuple[str, int, int]]:
    """``exp_flash_bwd_grouped.main(["--shapes", "both"])``'s launches: for
    each shape one forward, then for each variant the check's backward and
    the timed ones; each side runs K6 or K7 at group 1, X2's kernel at 2 or
    4."""
    from chronoedit_tpu_torch.tools import exp_flash_bwd_grouped as xb

    calls = []
    for seq, reps in xb.SHAPES.values():
        calls.append(("flash_fwd", seq, 1))
        for n_dq, n_dkv in xb.VARIANTS:
            calls.append(("flash_bwd_dq" + ("_grouped" if n_dq > 1 else ""), seq, 1 + reps))
            calls.append(("flash_bwd_dkv" + ("_grouped" if n_dkv > 1 else ""), seq, 1 + reps))
    return calls


def experiment_tools() -> dict[str, int]:
    """Both experiment entry points at full width, as a user runs them:
    ``exp_flash_paired.main()`` (X1 at 2 x 28,800 tokens) and
    ``exp_flash_bwd_grouped.main(["--shapes", "both"])`` (X2 at 2 x 7,200
    and 2 x 28,800 tokens, each backward also held against the twin on
    three 128-row tiles of every batch and head); each checks every group
    against the ungrouped kernels (and against the twin) and prints its
    timing table. The counters are zeroed just before each and read just
    after: they must equal the launches the tool's loops imply, by kernel
    and by KV length, plus those of any timed calls that ``cuda_ms``
    discarded and made again (``tools.DISCARDED``). Returns {grouped kernel
    name: launches}."""
    from chronoedit_tpu_torch import tools
    from chronoedit_tpu_torch.kernels import build
    from chronoedit_tpu_torch.tools import exp_flash_bwd_grouped, exp_flash_paired

    launches = {}
    for label, run, calls in (
            ("exp_flash_paired", exp_flash_paired.main, paired_tool_calls()),
            ("exp_flash_bwd_grouped", lambda: exp_flash_bwd_grouped.main(["--shapes", "both"]),
             bwd_tool_calls())):
        tools.DISCARDED.clear()
        tools.DISCARDED_BY_SHAPE.clear()
        build.reset_launches()
        _, secs = host_s(run)
        got = read_launches()
        want = expected_tool_launches(calls)
        for name, n in tools.DISCARDED.items():
            want[0][name] += n
        for (name, kv), n in tools.DISCARDED_BY_SHAPE.items():
            want[1][name][kv] = want[1][name].get(kv, 0) + n
        print(f"{label}: {secs:.1f} s; launches {got[0]}, by KV length {got[1]}; "
              f"discarded timing attempts' launches {dict(tools.DISCARDED)}")
        if got != want:
            raise AssertionError(f"{label}: launches {got}, its loops imply {want}")
        launches.update({name: got[0][name] for name in GROUPED if got[0][name]})
        torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------- phases 5, 6

def redraw_zero_projections(dit, vae, g: torch.Generator) -> None:
    """The init zeroes the DiT's output projection and the VAE attention
    projections (as the JAX init does), which would make the velocity zero
    whatever the blocks compute. Redraw them U(+-1/sqrt(fan_in))."""
    with torch.no_grad():
        for w in (dit.head.proj.weight, vae.encoder.mid.attn.proj.weight,
                  vae.decoder.mid.attn.proj.weight):
            limit = 1.0 / math.sqrt(w[0].numel())
            w.uniform_(-limit, limit, generator=g)


def request(cfg, dev, seed: int, h: int, w: int, text_tokens: int):
    """An edit request: image in [-1, 1], prompt and CLIP embeddings."""
    g = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.dit
    return dict(
        image=torch.rand((1, 3, h, w), generator=g, device=dev) * 2.0 - 1.0,
        prompt_emb=torch.randn((1, text_tokens, d.text_dim), generator=g, device=dev),
        image_emb=torch.randn((1, d.image_tokens, d.image_dim), generator=g, device=dev),
    )


def small_references(dev: torch.device) -> dict[str, float]:
    """The slice at 2 blocks x 2 heads of 128 on ``dev`` in bf16 against the
    same weights in fp32 on the CPU: the 64x64 edit, and 29-frame reasoning
    at 64x256 with the VAE W-tiled 4 ways (streaming encode and decode),
    with the drop (k = 2) and without it (k = 8); then the edit quantized
    int8, w4a16 and mixed2, and the drop in w4a16 with int8 scores, each on
    the CPU model's quantized weights copied bit for bit to the card.
    Returns PSNRs in dB."""
    from chronoedit_tpu_torch.configs import chronoedit_14b_distilled
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.models import vae as vae_lib
    from chronoedit_tpu_torch.ops import flash_attention as fa
    from chronoedit_tpu_torch.ops import quant
    from chronoedit_tpu_torch.pipeline.edit_pipeline import ChronoEditPipeline

    def small(dtype):
        cfg = chronoedit_14b_distilled(dtype=dtype, param_dtype=dtype)
        return dataclasses.replace(
            cfg,
            dit=dataclasses.replace(cfg.dit, num_heads=2, ffn_dim=512, num_layers=2,
                                    text_dim=64, image_dim=32, image_tokens=9),
            vae=dataclasses.replace(cfg.vae, dim=8, num_res_blocks=1))

    cpu = torch.device("cpu")
    ref_cfg, dev_cfg = small(torch.float32), small(torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    dit = dit_lib.init_dit_params(ref_cfg.dit, g)
    vae = vae_lib.init_vae_params(ref_cfg.vae, g)
    redraw_zero_projections(dit, vae, g)
    dev_dit, dev_vae = dit_lib.DiT(dev_cfg.dit, device=dev), vae_lib.VAE(dev_cfg.vae, device=dev)
    dev_dit.load_state_dict(dit.state_dict())
    dev_vae.load_state_dict(vae.state_dict())

    def compare(label, entry, tiles, h, w, noise, shape, dits=(dit, dev_dit), **kw):
        ref_pipe = ChronoEditPipeline(dataclasses.replace(ref_cfg, vae_spatial_tiles=tiles),
                                      dits[0], vae)
        dev_pipe = ChronoEditPipeline(dataclasses.replace(dev_cfg, vae_spatial_tiles=tiles),
                                      dits[1], dev_vae)
        req = request(ref_cfg, cpu, 2, h, w, 16)
        want = getattr(ref_pipe, entry)(**req, latents=noise, **kw)
        got = getattr(dev_pipe, entry)(**{k: v.to(dev) for k, v in req.items()},
                                       latents=noise.to(dev), **kw)
        if (tuple(got.shape) != shape or got.shape != want.shape
                or not bool(torch.isfinite(got).all())):
            raise AssertionError(f"small reference {label}: bad output {tuple(got.shape)}")
        db = psnr(got.float().cpu(), want)
        print(f"small reference ({label}, 2 blocks x 2 heads, {h}x{w}, "
              f"{ref_cfg.num_steps} steps): card bf16 vs CPU fp32 {db:.2f} dB "
              f"(bar {MIN_PSNR_DB} dB)")
        if not db >= MIN_PSNR_DB:
            raise AssertionError(f"small reference {label}: PSNR {db:.2f} dB < {MIN_PSNR_DB} dB")
        return db

    edit_noise = torch.randn((1, 16, 2, 8, 8), generator=g)
    results = {"edit": compare("edit", "edit_image", None, 64, 64, edit_noise, (1, 3, 64, 64))}
    noise = torch.randn((1, 16, 8, 8, 32), generator=g)
    for k, frames in ((2, 5), (ref_cfg.num_steps, REASONING_FRAMES)):
        results[f"reasoning k={k}"] = compare(
            f"reasoning k={k}, 4 VAE tiles", "__call__", 4, 64, 256, noise,
            (1, 3, frames, 64, 256), enable_temporal_reasoning=True,
            num_temporal_reasoning_steps=k)

    def quantized(mode, upgrade=(), qk_int8=False):
        """(CPU DiT, card DiT) quantized from the float weights on the CPU,
        the card's leaves overwritten with the CPU's bits."""
        ref_q, dev_q = dit_lib.DiT(ref_cfg.dit), dit_lib.DiT(dev_cfg.dit, device=dev)
        for m in (ref_q, dev_q):
            m.load_state_dict(dit.state_dict())
            quant.quantize_dit(m, mode=mode, upgrade=upgrade)
            m.cfg = dataclasses.replace(m.cfg, attn_qk_int8=qk_int8)
        dev_q.load_state_dict(ref_q.state_dict())
        return ref_q, dev_q

    for label, mode, upgrade in (("int8", "int8", ()), ("w4a16", "int4", ()),
                                 ("mixed2", "int4_a8", quant.INT4_MIXED2_UPGRADE)):
        results[f"edit {label}"] = compare(f"edit, {label}", "edit_image", None, 64, 64,
                                           edit_noise, (1, 3, 64, 64),
                                           dits=quantized(mode, upgrade))
    # JAX's rule keeps int8 scores for KV past 12,288 tokens; lowered here so
    # that K9 (and its twin) serve the reference's 512- and 128-token
    # self-attention
    resident = fa.QK8_RESIDENT_KV_BYTES
    fa.QK8_RESIDENT_KV_BYTES = 0
    try:
        results["reasoning k=2 w4a16 qk8"] = compare(
            "reasoning k=2, w4a16 + int8 scores, 4 VAE tiles", "__call__", 4, 64, 256, noise,
            (1, 3, 5, 64, 256), dits=quantized("int4", qk_int8=True),
            enable_temporal_reasoning=True, num_temporal_reasoning_steps=2)
    finally:
        fa.QK8_RESIDENT_KV_BYTES = resident
    return results


def redraw_layer_norms(model, g: torch.Generator) -> None:
    """CLIP's LayerNorms start at ones and zeros, which every dtype holds
    exactly; redraw them (scale 1 + 0.1 N, bias 0.1 N), so that whether
    they are kept in fp32 shows."""
    from chronoedit_tpu_torch.ops import layers as L

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, L.LayerNorm):
                m.scale.normal_(1.0, 0.1, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)


def encoder_references(dev: torch.device) -> dict[str, float]:
    """The encoders at full width and two blocks on ``dev`` against the same
    weights in fp32 on the CPU: UMT5 (dim 4,096, 64 heads, ffn 10,240) in
    bf16 on 512 token ids with a ``PROMPT_LEN`` mask, CLIP (dim 1,280, 16
    heads of 80; three layers, of which the penultimate path runs two) in
    bf16 on a 720p frame through ``preprocess``, and XLM-R with its pooled
    head (dim 1,024, 16 heads) in fp32 on two ragged sequences. The launch
    counters are zeroed before each and must read zero after: no encoder
    runs a hand-written kernel. Returns dB over the reference's peak."""
    from chronoedit_tpu_torch.kernels import build
    from chronoedit_tpu_torch.models import clip, umt5
    from chronoedit_tpu_torch.models import xlm_roberta as xlmr

    f32 = dict(dtype=torch.float32, param_dtype=torch.float32)
    g = torch.Generator().manual_seed(4)
    results = {}

    def compare(label, fn, ref, bar):
        want = fn(ref[0], torch.device("cpu"))
        build.reset_launches()
        got, secs = host_s(lambda: fn(ref[1], dev))
        got = got.float().cpu()
        db = peak_db(got, want)
        launched = {k: v for k, v in build.LAUNCHES.items() if v}
        print(f"encoder reference ({label}): card {secs:.3f} s, {tuple(got.shape)}, "
              f"{db:.2f} dB over the CPU fp32 peak {float(want.abs().max()):.4f} "
              f"(bound {bar} dB); hand-written kernel launches {launched or 'none'}")
        if got.shape != want.shape or not bool(torch.isfinite(got).all()) or not db >= bar:
            raise AssertionError(f"encoder reference {label}: the card disagrees with the CPU")
        if launched:
            raise AssertionError(f"encoder reference {label}: launched {launched}")
        results[label] = db

    def pair(make, cfg_dev, cfg_ref):
        ref = make(cfg_ref)
        on_dev = type(ref)(cfg_dev, device=dev)
        on_dev.load_state_dict(ref.state_dict())
        return ref, on_dev

    t5_cfg = umt5.UMT5Config(vocab_size=SMALL_VOCAB, num_layers=2)
    t5 = pair(lambda c: umt5.init_umt5_params(c, g), t5_cfg,
              dataclasses.replace(t5_cfg, **f32))
    ids = torch.randint(0, SMALL_VOCAB, (1, TEXT_TOKENS), generator=g)
    mask = (torch.arange(TEXT_TOKENS) < PROMPT_LEN).long()[None]

    def t5_fn(model, device):
        out = umt5.UMT5TextEncoder(model).encode_ids(ids.to(device), mask.to(device))
        if bool(out[:, PROMPT_LEN:].any()):
            raise AssertionError("UMT5: the outputs past the prompt are not zero")
        return out[:, :PROMPT_LEN]

    compare(f"UMT5, 2 blocks, {PROMPT_LEN} of {TEXT_TOKENS} ids", t5_fn, t5, ENCODER_MIN_DB)
    del t5

    clip_cfg = clip.CLIPVisionConfig(num_layers=3)

    def make_clip(c):
        model = clip.init_clip_vision_params(c, g)
        redraw_layer_norms(model, g)
        return model

    towers = pair(make_clip, clip_cfg, dataclasses.replace(clip_cfg, **f32))
    image = torch.rand((1, 3, EDIT_H, EDIT_W), generator=g) * 2.0 - 1.0
    compare(f"CLIP, 2 blocks of 16 x 80, {EDIT_H}x{EDIT_W} frame",
            lambda model, device: clip.CLIPImageEncoder(model)(image.to(device)), towers,
            ENCODER_MIN_DB)
    del towers

    xcfg = xlmr.XLMRobertaConfig(vocab_size=SMALL_VOCAB, num_layers=2, out_dim=1024)
    towers = pair(lambda c: xlmr.init_xlm_roberta_params(c, g), xcfg, xcfg)
    xids = torch.randint(2, SMALL_VOCAB, (2, 77), generator=g)
    xids[0, 40:] = xcfg.pad_id

    def xlmr_fn(model, device):
        with torch.no_grad():
            return xlmr.xlm_roberta_encode(model, xids.to(device))

    compare("XLM-R with head, 2 blocks, fp32", xlmr_fn, towers, XLMR_MIN_DB)
    return results


def small_training_config(dtype, remat: str):
    """The small references' DiT (2 blocks x 2 heads of 128) for training."""
    from chronoedit_tpu_torch.configs import chronoedit_14b

    d = chronoedit_14b(dtype=dtype, param_dtype=dtype).dit
    return dataclasses.replace(d, num_heads=2, ffn_dim=512, num_layers=2, text_dim=64,
                               image_dim=32, image_tokens=9, remat=remat)


def training_references(dev: torch.device) -> dict[str, float]:
    """Two LoRA steps and two full-parameter steps of the 2-block DiT at the
    64x64 edit's geometry: on ``dev`` in bf16 with the kernels (K6/K7 in
    the backward) and remat "full", against the same weights, batch and
    draws in fp32 on the CPU with the twins. Compares the loss (relative),
    the cosine of the whole gradient vector, the first step's loss and
    grad_norm (relative), and after the second step Adam's first moment
    and the update of every trained weight (normwise). Returns the
    readings."""
    from chronoedit_tpu_torch.core.rectified_flow import RectifiedFlowConfig
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.models import lora as lora_lib
    from chronoedit_tpu_torch.train import lora_train, train_step

    cpu = torch.device("cpu")
    ref_cfg = small_training_config(torch.float32, "none")
    dev_cfg = small_training_config(torch.bfloat16, "full")
    g = torch.Generator().manual_seed(3)
    ref_dit = dit_lib.init_dit_params(ref_cfg, g)
    with torch.no_grad():  # a zero head would stop every gradient
        w = ref_dit.head.proj.weight
        w.uniform_(-w.shape[1] ** -0.5, w.shape[1] ** -0.5, generator=g)
    ref_lora = lora_lib.init_lora_params(g, ref_dit, lora_lib.LoRAConfig())
    with torch.no_grad():  # b = 0 would give a zero gradient to every a
        for blk in ref_lora.blocks:
            for _, ad in lora_lib.iter_adapters(blk):
                ad.b.normal_(0.0, 0.02, generator=g)
    batch = {"latents": torch.randn((1, 16, 2, 8, 8), generator=g),
             "condition": torch.randn((1, 20, 2, 8, 8), generator=g),
             "text_emb": torch.randn((1, 16, 64), generator=g),
             "image_emb": torch.randn((1, 9, 32), generator=g)}
    u, noise = torch.tensor([0.6]), torch.randn((1, 16, 2, 8, 8), generator=g)
    rf = RectifiedFlowConfig()

    def on(device, cfg):
        dit = dit_lib.DiT(cfg, device=device)
        dit.load_state_dict(ref_dit.state_dict())
        lora = lora_lib.LoRA(dit, lora_lib.LoRAConfig(), device=device)
        lora.load_state_dict(ref_lora.state_dict())
        return dit, lora, {k: v.to(device) for k, v in batch.items()}, u.to(device), noise.to(device)

    def flat(tensors):
        return torch.cat([x.detach().double().flatten().cpu() for x in tensors])

    def rel(got, want):
        return float((got - want).norm() / want.norm())

    readings = {}
    for mode in ("lora", "full"):
        sides, tcfg = {}, None
        for name, device, cfg in (("ref", cpu, ref_cfg), ("dev", dev, dev_cfg)):
            dit, lora, b, u_, noise_ = on(device, cfg)
            params = list(lora.parameters()) if mode == "lora" else list(dit.parameters())
            for p in params:
                p.requires_grad_(True)
            loss = train_step.velocity_loss(dit, cfg, rf, b["latents"], b["condition"],
                                            b["text_emb"], b["image_emb"], u_, noise_,
                                            lora=lora if mode == "lora" else None)
            grad = flat(torch.autograd.grad(loss, params))
            if tcfg is None:  # the clip acts on both sides
                tcfg = train_step.TrainConfig(lr=TRAIN_LR, warmup_steps=1,
                                              grad_clip=0.5 * float(grad.norm()))
            if mode == "lora":
                state = lora_train.make_lora_train_state(lora, tcfg)
                step = functools.partial(lora_train.make_lora_train_step(cfg, tcfg), state, dit)
            else:
                state = train_step.make_train_state(dit, tcfg)
                step = functools.partial(train_step.make_train_step(cfg, tcfg), state)
            before = [p.detach().clone() for p in params]
            metrics = step(b, u=u_, noise=noise_)
            if not all(torch.equal(p, q) for p, q in zip(params, before)):
                raise AssertionError(f"training reference {mode}: the warm-up step moved a weight")
            step(b, u=u_, noise=noise_)
            update = flat([p.detach().float() - q.float() for p, q in zip(params, before)])
            moment = flat([state.optimizer.adamw.state[p]["exp_avg"] for p in params])
            sides[name] = (float(loss.detach()), grad, float(metrics["loss"]),
                           float(metrics["grad_norm"]), update, moment)
            del dit, lora, state, step, params, before
        (l_ref, g_ref, sl_ref, gn_ref, up_ref, m_ref) = sides["ref"]
        (l_dev, g_dev, sl_dev, gn_dev, up_dev, m_dev) = sides["dev"]
        loss_rel = abs(l_dev - l_ref) / abs(l_ref)
        cos = float(g_ref @ g_dev / (g_ref.norm() * g_dev.norm()))
        step_rel = abs(sl_dev - sl_ref) / abs(sl_ref)
        norm_rel = abs(gn_dev - gn_ref) / gn_ref
        moment_rel, update_rel = rel(m_dev, m_ref), rel(up_dev, up_ref)
        print(f"training reference ({mode}, 2 blocks x 2 heads, 64x64 edit geometry): "
              f"loss card bf16 {l_dev:.6f} vs CPU fp32 {l_ref:.6f}, relative {loss_rel:.2e} "
              f"(bound {TRAIN_LOSS_REL}); gradient cosine over {g_ref.numel()} entries "
              f"{cos:.6f} (bound {TRAIN_GRAD_COS}); the step's loss relative {step_rel:.2e} "
              f"(bound {TRAIN_LOSS_REL}), grad_norm {gn_dev:.4e} vs {gn_ref:.4e}, relative "
              f"{norm_rel:.2e} (bound {TRAIN_NORM_REL}); after the second step (lr {TRAIN_LR}, "
              f"clip {tcfg.grad_clip:.4e}) Adam's first moment {moment_rel:.3e} (bound "
              f"{TRAIN_MOMENT_REL}), the update {update_rel:.3e} (bound "
              f"{TRAIN_UPDATE_REL}) normwise, |update| {float(up_ref.norm()):.4e}")
        if not (loss_rel <= TRAIN_LOSS_REL and cos >= TRAIN_GRAD_COS
                and step_rel <= TRAIN_LOSS_REL and norm_rel <= TRAIN_NORM_REL and gn_dev > 0
                and moment_rel <= TRAIN_MOMENT_REL and update_rel <= TRAIN_UPDATE_REL
                and float(up_ref.norm()) > 0):
            raise AssertionError(f"training reference {mode}: the card disagrees with the CPU")
        readings[mode] = {"loss_rel": loss_rel, "grad_cos": cos, "norm_rel": norm_rel,
                          "moment_rel": moment_rel, "update_rel": update_rel}
    return readings


def expected_launches(cfg, tokens: list[int], int4: bool = False,
                      qk8: bool = False) -> tuple[dict[str, int], dict[str, dict[int, int]]]:
    """Kernel launches of one edit whose step i self-attends over tokens[i]:
    per block and step 3 attentions (self, text, image), 2 LN-modulates, 2
    gated residuals and 5 RMSNorms (self q, k; cross q; text k; image k),
    plus the head's LN-modulate, and no backward. With ``int4`` (w4a16)
    every block's 12 projections run K8: 8 over the step's tokens, 2 over
    the text and 2 over the image context; with ``qk8`` self-attention past
    JAX's resident KV length runs K9 instead of the flash forward. No
    grouped kernel runs. Returns
    ({name: count}, {name: {KV length or int4 rows: count}}), as
    ``read_launches``."""
    from chronoedit_tpu_torch.ops.flash_attention import uses_int8_scores

    n, steps = cfg.dit.num_layers, len(tokens)
    by_kv = {TEXT_TOKENS: n * steps, IMAGE_TOKENS: n * steps}
    qk8_kv, rows = {}, {}
    for s in tokens:
        counts = qk8_kv if qk8 and uses_int8_scores(s, cfg.dit.head_dim, 2) else by_kv
        counts[s] = counts.get(s, 0) + n
        if int4:
            for m, per_block in ((s, 8), (TEXT_TOKENS, 2), (IMAGE_TOKENS, 2)):
                rows[m] = rows.get(m, 0) + per_block * n
    by_name = {"flash_fwd": sum(by_kv.values()), "ln_modulate": (2 * n + 1) * steps,
               "gated_residual": 2 * n * steps, "rms_norm": 5 * n * steps,
               "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
               "int4_matmul": sum(rows.values()), "flash_fwd_qk8": sum(qk8_kv.values()),
               **dict.fromkeys(GROUPED, 0)}
    return by_name, {"flash_fwd": by_kv, "flash_bwd_dq": {}, "flash_bwd_dkv": {},
                     "int4_matmul": rows, "flash_fwd_qk8": qk8_kv,
                     **{name: {} for name in GROUPED}}


def read_launches() -> tuple[dict[str, int], dict[str, dict[int, int]]]:
    """A copy of the launch counters: ({name: count}, {name: {KV length or
    int4 rows: count}})."""
    from chronoedit_tpu_torch.kernels import build

    return dict(build.LAUNCHES), {k: dict(v) for k, v in build.SHAPE_LAUNCHES.items()}


def build_model(dev: torch.device, cfg):
    """The full-size pipeline with seeded random weights on the card; the
    same bits on every call."""
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.models import vae as vae_lib
    from chronoedit_tpu_torch.pipeline.edit_pipeline import ChronoEditPipeline

    g = torch.Generator(device=dev).manual_seed(0)
    dit = dit_lib.init_dit_params(cfg.dit, g, device=dev)
    vae = vae_lib.init_vae_params(cfg.vae, g, device=dev)
    redraw_zero_projections(dit, vae, g)
    return ChronoEditPipeline(cfg, dit, vae)


def build_encoders(dev: torch.device, dit):
    """A seeded UMT5-XXL, CLIP ViT-H (LayerNorms redrawn) and rank-32 LoRA
    over ``dit`` (b drawn non-zero), on the card; the same bits on every
    call."""
    from chronoedit_tpu_torch.models import clip, umt5
    from chronoedit_tpu_torch.models import lora as lora_lib

    g = torch.Generator(device=dev).manual_seed(40)
    t5 = umt5.init_umt5_params(umt5.UMT5Config(), g, dev)
    tower = clip.init_clip_vision_params(clip.CLIPVisionConfig(), g, dev)
    redraw_layer_norms(tower, g)
    lora = lora_lib.init_lora_params(g, dit, lora_lib.LoRAConfig())
    with torch.no_grad():
        for blk in lora.blocks:
            for _, ad in lora_lib.iter_adapters(blk):
                ad.b.normal_(0.0, 0.02, generator=g)
    return t5, tower, lora


def checkpoint_bytes(*models) -> int:
    """Bytes the checkpoint directory takes: each model's parameters in
    their file dtype, ``(model, bytes per element)``."""
    return sum(p.numel() * size for model, size in models for p in model.parameters())


def write_checkpoint(root: Path, pipe, t5, tower, lora) -> None:
    """Write the reference's checkpoint layout under ``root``: the DiT as
    diffusers safetensors shards of 4 blocks each in bf16 (the patch
    embedding as its Conv3d), ``Wan2.1_VAE.pth`` in fp32, the UMT5-XXL file
    in bf16, the open-clip file's ``visual.`` tower in fp16 (the patch
    embedding as its Conv2d) and a diffusers LoRA in bf16 with alpha
    ``LORA_ALPHA``. The host holds one file's tensors at a time."""
    from safetensors.torch import save_file

    from chronoedit_tpu_torch.models import clip, umt5
    from chronoedit_tpu_torch.models import weights as w

    d = pipe.config.dit
    (root / "transformer").mkdir(parents=True)
    t0 = time.perf_counter()
    sd = w.export_diffusers_dit(pipe.dit)
    sd["patch_embedding.weight"] = sd["patch_embedding.weight"].reshape(
        d.dim, d.in_channels, *d.patch_size)
    shards: dict[int, list[str]] = {}
    for ref in sd:
        shards.setdefault(int(ref.split(".")[1]) // 4 + 1 if ref.startswith("blocks.") else 0,
                          []).append(ref)
    for k, refs in enumerate(shards.values()):
        save_file({ref: sd[ref].cpu() for ref in refs},
                  str(root / "transformer" / f"diffusion_pytorch_model-{k + 1:05d}-of-"
                      f"{len(shards):05d}.safetensors"))
    del sd
    seconds = {"dit": time.perf_counter() - t0}

    def host(model, names, dtype, shape):
        params = dict(model.named_parameters())
        return {ref: params[name].detach().to(dtype).cpu().reshape(shape(ref, params[name]))
                for ref, name in names.items()}

    def vae_shape(ref, v):  # RMS gains (C, 1, 1, 1); the spatial resample a Conv2d
        if ref.endswith(".gamma"):
            return (v.shape[0], 1, 1, 1)
        return v.shape[:2] + v.shape[3:] if ".resample." in ref and v.dim() == 5 else v.shape

    p = tower.cfg.patch_size
    for kind, model, names, dtype, shape, name in (
            ("vae", pipe.vae, w.wan_vae_names(pipe.vae.cfg), torch.float32, vae_shape,
             "Wan2.1_VAE.pth"),
            ("umt5", t5, umt5.reference_names(t5.cfg), torch.bfloat16, lambda ref, v: v.shape,
             "models_t5_umt5-xxl-enc-bf16.pth"),
            ("clip", tower, clip.reference_names(tower.cfg), torch.float16,
             lambda ref, v: (v.shape[0], 3, p, p) if "patch" in ref else v.shape,
             "models_clip_open-clip-xlm-roberta-large-vit-huge-14_fp16.pth")):
        t0 = time.perf_counter()
        torch.save(host(model, names, dtype, shape), root / name)
        seconds[kind] = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_file({k: v.cpu() if k.endswith("alpha") else v.to(torch.bfloat16).cpu()
               for k, v in w.export_diffusers_lora(lora, alpha=LORA_ALPHA).items()},
              str(root / "distill_lora.safetensors"))
    seconds["lora"] = time.perf_counter() - t0
    print(f"   write seconds by file kind (device to host included): "
          f"{ {k: round(v, 1) for k, v in seconds.items()} }")


def check_loaded(label: str, loaded, original, expect=None) -> None:
    """Every parameter of ``loaded`` bitwise ``original``'s of the same name
    after a cast to the loaded dtype, or ``expect(name, original's)`` where
    that gives one (cast the same way)."""
    got, want = dict(loaded.named_parameters()), dict(original.named_parameters())
    if got.keys() != want.keys():
        raise AssertionError(f"loaded {label}: other parameters than the original's")
    bad = []
    for name, p in got.items():
        value = (expect(name, want[name]) if expect else None)
        value = want[name] if value is None else value
        if not torch.equal(p, value.to(p.dtype)):
            bad.append(name)
    print(f"loaded {label}: {len(got) - len(bad)} of {len(got)} tensors bitwise as expected")
    if bad:
        raise AssertionError(f"loaded {label}: {len(bad)} tensors differ, e.g. {bad[:4]}")


def loaded_path(dev: torch.device, cfg, launches: tuple[Counter, Counter]):
    """The production start from files: build the seeded model
    (``build_model``) and a seeded UMT5-XXL, CLIP ViT-H and rank-32 LoRA
    (``build_encoders``), write them in the reference's layout
    (``write_checkpoint``) to ``CHECKPOINT_DIR``, free them, then
    ``load_pipeline(cfg, dir, loras=[(lora, 1.0)])``. Against the same
    models drawn again from their seeds: every DiT tensor no adapter
    targets must be bitwise the original, every targeted one the fp32 merge
    of the file's bf16 adapters rounded once to bf16, the VAE and the
    encoders bitwise the originals after their files' casts. Then
    ``encode_prompt`` on 512 token ids with a ``PROMPT_LEN`` mask and
    ``encode_image`` (no hand-written kernel may launch), and a cold and a
    warm 720p edit from those embeddings with exact launch counts. The
    encoders are dropped before it returns the pipeline. Built and loaded
    outside ``inference_mode``: the training path trains this DiT."""
    from chronoedit_tpu_torch.kernels import build
    from chronoedit_tpu_torch.models import umt5
    from chronoedit_tpu_torch.models import lora as lora_lib
    from chronoedit_tpu_torch.pipeline.loader import load_pipeline

    d = cfg.dit
    print(f"main path: {d.num_layers} blocks x {d.dim} wide, ffn {d.ffn_dim}, "
          f"{cfg.num_steps} steps, guidance {cfg.guidance_scale}, shift {cfg.flow_shift}")
    shutil.rmtree(CHECKPOINT_DIR, ignore_errors=True)
    def build_all():
        pipe = build_model(dev, cfg)
        return pipe, build_encoders(dev, pipe.dit)

    (pipe, (t5, tower, lora)), secs = host_s(build_all)
    count = {name: sum(p.numel() for p in m.parameters())
             for name, m in (("DiT", pipe.dit), ("UMT5", t5), ("CLIP", tower))}
    print(f"random init {secs:.1f} s: DiT {count['DiT'] / 1e9:.2f} B parameters, UMT5-XXL "
          f"{count['UMT5'] / 1e9:.2f} B, CLIP ViT-H {count['CLIP'] / 1e6:.1f} M, rank-32 LoRA "
          f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card)")

    need = checkpoint_bytes((pipe.dit, 2), (pipe.vae, 4), (t5, 2), (tower, 2), (lora, 2))
    CHECKPOINT_DIR.parent.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(CHECKPOINT_DIR.parent).free
    print(f"checkpoint directory {CHECKPOINT_DIR}: needs {need / 1e9:.2f} GB, "
          f"{free / 1e9:.2f} GB free")
    if free < need + 2**30:
        raise AssertionError(f"disk: the checkpoint needs {need} bytes and {free} are free")
    _, secs = host_s(lambda: write_checkpoint(CHECKPOINT_DIR, pipe, t5, tower, lora))
    written = sum(f.stat().st_size for f in CHECKPOINT_DIR.rglob("*") if f.is_file())
    print(f"wrote the checkpoint in {secs:.1f} s: {written / 1e9:.2f} GB "
          f"({written / secs / 1e9:.2f} GB/s, device to host included)")
    del pipe, t5, tower, lora
    torch.cuda.empty_cache()

    lora_path = str(CHECKPOINT_DIR / "distill_lora.safetensors")
    torch.cuda.reset_peak_memory_stats()
    pipe, load_s = host_s(lambda: load_pipeline(cfg, str(CHECKPOINT_DIR),
                                                 loras=[(lora_path, 1.0)], device=dev))
    print(f"load_pipeline in {load_s:.1f} s (seconds per component "
          f"{ {k: round(v, 2) for k, v in pipe.load_seconds.items()} }, the LoRA merge "
          f"included in 'loras'): {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    def check():
        # the encoders first (the LoRA drawn after them is kept, rounded as
        # its file holds it), then the DiT and VAE: one original at a time
        t5, tower, lora = build_encoders(dev, pipe.dit)
        check_loaded("UMT5", pipe.text_encoder.model, t5)
        check_loaded("CLIP", pipe.image_encoder.model, tower,
                     lambda name, p: p.to(torch.float16))
        del t5, tower
        torch.cuda.empty_cache()
        scaling = 1.0 * (LORA_ALPHA / lora.cfg.rank)
        targets = {f"blocks.{i}.{t.replace('/', '.')}.weight": ad
                   for i, blk in enumerate(lora.blocks) for t, ad in lora_lib.iter_adapters(blk)}

        def merged(name, w):
            if name not in targets:
                return None
            a, b = (x.to(torch.bfloat16).float() for x in (targets[name].a, targets[name].b))
            return (w.float() + ((a @ b) * scaling).T).to(w.dtype)

        original = build_model(dev, cfg)
        check_loaded("DiT", pipe.dit, original.dit, merged)
        check_loaded("VAE", pipe.vae, original.vae)
        print(f"   ({len(targets)} LoRA-targeted DiT weights among them)")

    torch.cuda.reset_peak_memory_stats()
    _, secs = host_s(check)
    torch.cuda.empty_cache()
    # the run's high-water mark: the loaded pipeline with both encoders and
    # a second DiT drawn from the seed, side by side
    print(f"   checked against the models drawn again from their seeds in {secs:.1f} s, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    with torch.inference_mode():
        g = torch.Generator(device=dev).manual_seed(41)
        req = request(cfg, dev, 42, EDIT_H, EDIT_W, TEXT_TOKENS)
        ids = torch.randint(0, umt5.UMT5Config().vocab_size, (1, TEXT_TOKENS), generator=g,
                            device=dev)
        mask = (torch.arange(TEXT_TOKENS, device=dev) < PROMPT_LEN).long()[None]
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        req["prompt_emb"], t5_s = host_s(lambda: pipe.encode_prompt(ids, mask))
        req["image_emb"], clip_s = host_s(lambda: pipe.encode_image(req["image"]))
        launched = {k: v for k, v in build.LAUNCHES.items() if v}
        print(f"encode_prompt ({TEXT_TOKENS} ids, {PROMPT_LEN} unmasked) {t5_s:.3f} s -> "
              f"{tuple(req['prompt_emb'].shape)}; encode_image ({EDIT_H}x{EDIT_W}) {clip_s:.3f} s "
              f"-> {tuple(req['image_emb'].shape)}; hand-written kernel launches "
              f"{launched or 'none'}")
        emb_ok = (tuple(req["prompt_emb"].shape) == (1, TEXT_TOKENS, d.text_dim)
                  and tuple(req["image_emb"].shape) == (1, IMAGE_TOKENS, d.image_dim)
                  and all(bool(torch.isfinite(req[k]).all()) for k in ("prompt_emb", "image_emb"))
                  and not bool(req["prompt_emb"][:, PROMPT_LEN:].any()))
        if launched or not emb_ok:
            raise AssertionError("the encoders launched a kernel or gave bad embeddings")
        times = []
        for label in ("cold", "warm"):
            serve(pipe.edit_image, cfg, dev, f"loaded edit ({label})", 42, (1, 3, EDIT_H, EDIT_W),
                  [EDIT_TOKENS] * cfg.num_steps, launches, req=req, times=times)
        with_encoders = torch.cuda.max_memory_allocated() / 2**30
        pipe.text_encoder = pipe.image_encoder = None
        torch.cuda.empty_cache()
    print(f"from files to the first edit: load {load_s:.1f} s + encode "
          f"{t5_s + clip_s:.2f} s + cold edit {times[0]:.2f} s; warm edit {times[1]:.2f} s; "
          f"peak {with_encoders:.2f} GiB with the encoders, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated after dropping them")
    return pipe


def serve(entry, cfg, dev, label: str, seed: int, shape: tuple, tokens: list[int],
          launches: tuple[Counter, Counter], int4: bool = False, qk8: bool = False,
          req: dict | None = None, times: list | None = None, **kw) -> torch.Tensor:
    """One 720p edit through ``entry`` (the pipeline or its ``edit_image``)
    of ``req`` (default: the seeded ``request``), with the launch counters
    zeroed just before it and read just after: they must equal what the
    path implies (``expected_launches``), and are added to ``launches`` (by
    name, flash forwards by KV length); its seconds are appended to
    ``times`` when given. Returns the output, fp32 on the CPU."""
    from chronoedit_tpu_torch.kernels import build

    req = req or request(cfg, dev, seed, EDIT_H, EDIT_W, TEXT_TOKENS)
    gen = torch.Generator(device=dev).manual_seed(100 + seed)
    want = expected_launches(cfg, tokens, int4=int4, qk8=qk8)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    out, secs = host_s(lambda: entry(**req, generator=gen, **kw))
    if times is not None:
        times.append(secs)
    got = read_launches()
    print(f"{label}: {secs:.2f} s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB, launches {got[0]}, by KV length / int4 rows {got[1]}")
    if got != want:
        raise AssertionError(f"{label}: launches {got}, the path implies {want}")
    if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}: output {tuple(out.shape)} is not finite {shape}")
    print(f"   output {tuple(out.shape)} finite, mean {float(out.float().mean()):.4f}, "
          f"std {float(out.float().std()):.4f}")
    for total, counts in zip(launches, (got[0], got[1]["flash_fwd"])):
        total.update(counts)
    return out.float().cpu()


def stages(pipe, dev, num_frames: int, seed: int, suffix: str = ""):
    """The stages of a 720p edit with ``num_frames`` pixel frames as warm
    callables: one DiT forward, the VAE encode (``prepare_condition``) and
    the decode of random latents. Returns ({name: fn}, the latents, the
    encode's seconds)."""
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.models import vae as vae_lib
    from chronoedit_tpu_torch.pipeline.edit_pipeline import prepare_condition

    cfg = pipe.config
    g = torch.Generator(device=dev).manual_seed(seed)
    req = request(cfg, dev, seed, EDIT_H, EDIT_W, TEXT_TOKENS)

    def encode():
        return prepare_condition(pipe.vae, cfg, req["image"], num_frames)

    cond, enc_s = host_s(encode)
    x = torch.randn((1, cfg.vae.z_dim) + tuple(cond.shape[2:]), generator=g, device=dev)
    xin = torch.cat([x, cond], dim=1).to(cfg.dit.dtype)
    ts = torch.full((1,), 999.0, device=dev)
    return {
        f"dit_forward{suffix}": lambda: dit_lib.dit_forward(
            pipe.dit, xin, ts, req["prompt_emb"], req["image_emb"]),
        f"vae_encode{suffix}": encode,
        f"vae_decode{suffix}": lambda: vae_lib.vae_decode(pipe.vae, x),
    }, x, enc_s


def edit_path(pipe, dev, launches: tuple[Counter, Counter],
              profile_dir: Path | None) -> dict[int, torch.Tensor]:
    """Two 720p edits through ``edit_image``, then warm per-stage times (and
    profiles when ``profile_dir`` is set); adds their launches to
    ``launches``. Returns the edits by request seed."""
    cfg = pipe.config
    tokens = [EDIT_TOKENS] * cfg.num_steps
    outs = {seed: serve(pipe.edit_image, cfg, dev, f"edit {i} (warm)", seed,
                        (1, 3, EDIT_H, EDIT_W), tokens, launches)
            for i, seed in enumerate((10, 11))}

    fns, x, enc_s = stages(pipe, dev, cfg.num_frames, 12)
    _, dit_s = host_s(fns["dit_forward"])
    _, dec_s = host_s(fns["vae_decode"])
    print(f"VAE encode {enc_s:.3f} s, DiT forward (one step, {x.shape[2]}x"
          f"{x.shape[3]}x{x.shape[4]} latents) {dit_s:.3f} s, VAE decode {dec_s:.3f} s")
    if profile_dir is not None:
        profile_stages(fns, profile_dir)
    return outs


def reasoning_path(pipe, dev, launches: tuple[Counter, Counter],
                   profile_dir: Path | None) -> dict[int, torch.Tensor]:
    """Two 29-frame reasoning edits through ``__call__``: the whole
    trajectory (k = num_steps, 8 forwards at 28,800 tokens) and the drop
    (k = 2: two forwards at 28,800 tokens, the rest at 7,200); then warm
    stage times (the dual decode of each submode among them), the
    tiled-against-untiled decode check and, with
    ``profile_dir``, profiles. Adds the edits' launches to ``launches``;
    returns the edits by request seed."""
    cfg = pipe.config
    steps, outs = cfg.num_steps, {}
    for label, seed, k, frames in (("whole trajectory", 20, steps, REASONING_FRAMES),
                                   ("drop", 21, 2, 5)):
        tokens = [REASONING_TOKENS] * k + [EDIT_TOKENS] * (steps - k)
        outs[seed] = serve(pipe, cfg, dev, f"reasoning edit ({label}, k = {k})", seed,
                           (1, 3, frames, EDIT_H, EDIT_W), tokens, launches,
                           enable_temporal_reasoning=True, num_temporal_reasoning_steps=k)

    fns, x, enc_s = stages(pipe, dev, REASONING_FRAMES, 22, "_reasoning")
    _, dit_s = host_s(fns["dit_forward_reasoning"])
    video, dec_s = host_s(fns["vae_decode_reasoning"])
    print(f"reasoning stages: streaming VAE encode of {REASONING_FRAMES} frames "
          f"{enc_s:.3f} s, DiT forward (one step, {x.shape[2]}x{x.shape[3]}x"
          f"{x.shape[4]} latents, {REASONING_TOKENS} tokens) {dit_s:.3f} s, streaming "
          f"VAE decode of {x.shape[2]} latent frames to {tuple(video.shape)} {dec_s:.3f} s")
    # the dual decode each submode ends with: the whole trajectory's 8 latent
    # frames, or the [first, last] pair left after the drop
    for label, z in (("k = 8", x), ("k = 2", x[:, :, [0, -1]])):
        video, secs = host_s(functools.partial(pipe.decode, z, dual=True))
        print(f"dual decode ({label}) of {z.shape[2]} latent frames to "
              f"{tuple(video.shape)}: {secs:.3f} s")
    del video
    tiled_decode_check(pipe.vae, x)
    if profile_dir is not None:
        profile_stages(fns, profile_dir)
    return outs


def expected_train_launches(cfg) -> tuple[dict[str, int], dict[str, dict[int, int]]]:
    """Kernel launches of one LoRA step with remat "full": the forward and
    the backward's recompute each run every block's 3 attentions, 2
    LN-modulates, 2 gated residuals and 5 RMSNorms (the head's LN-modulate
    runs once, outside the blocks); the backward runs K6 for all 3
    attentions (q always needs a gradient) and K7 for self and text only
    (k_img/v_img are not LoRA targets and the image context is frozen).
    Returns ({name: count}, {name: {KV length: count}}), as
    ``read_launches``."""
    n = cfg.dit.num_layers
    by_name = {"flash_fwd": 2 * 3 * n, "ln_modulate": 2 * 2 * n + 1,
               "gated_residual": 2 * 2 * n, "rms_norm": 2 * 5 * n,
               "flash_bwd_dq": 3 * n, "flash_bwd_dkv": 2 * n,
               "int4_matmul": 0, "flash_fwd_qk8": 0, **dict.fromkeys(GROUPED, 0)}
    by_kv = {"flash_fwd": {EDIT_TOKENS: 2 * n, TEXT_TOKENS: 2 * n, IMAGE_TOKENS: 2 * n},
             "flash_bwd_dq": {EDIT_TOKENS: n, TEXT_TOKENS: n, IMAGE_TOKENS: n},
             "flash_bwd_dkv": {EDIT_TOKENS: n, TEXT_TOKENS: n},
             "int4_matmul": {}, "flash_fwd_qk8": {}, **{name: {} for name in GROUPED}}
    return by_name, by_kv


def base_checksum(model) -> int:
    """An exact integer checksum of every parameter's bits."""
    return sum(int(p.detach().view(torch.int16).sum(dtype=torch.int64))
               for p in model.parameters())


def training_path(pipe, dev, launches: tuple[Counter, Counter],
                  profile_dir: Path | None) -> dict:
    """The slice at full width: rank-32 LoRA on the default targets over the
    frozen bf16 DiT (remat "full"), three ``make_lora_train_step`` calls on
    720p mock edit pairs through ``mock_batch_iterator``. The counters are
    zeroed before each step and must show the launches the path implies;
    every loss and grad_norm is finite (grad_norm > 0), every adapter's b
    has moved after the second step (the warm-up gives the first update
    learning rate 0) and the base's bits are unchanged. Adds the steps'
    launches to ``launches``; returns the step readings."""
    from chronoedit_tpu_torch.data.mock import MockEditDataset, mock_batch_iterator
    from chronoedit_tpu_torch.kernels import build
    from chronoedit_tpu_torch.models import lora as lora_lib
    from chronoedit_tpu_torch.train import lora_train, train_step

    cfg = pipe.config
    d = cfg.dit
    dataset = MockEditDataset(height=EDIT_H, width=EDIT_W, text_tokens=TEXT_TOKENS,
                              text_dim=d.text_dim, image_tokens=d.image_tokens,
                              image_dim=d.image_dim, seed=30)
    batches_it = mock_batch_iterator(pipe.vae, cfg, dataset)
    (batches, secs) = host_s(lambda: [next(batches_it) for _ in range(3)])
    b0 = batches[0]
    print(f"training batches: 3 mock 720p edit pairs through edit_training_batch in "
          f"{secs:.2f} s: latents {tuple(b0['latents'].shape)}, condition "
          f"{tuple(b0['condition'].shape)}, text {tuple(b0['text_emb'].shape)}, image "
          f"{tuple(b0['image_emb'].shape)}")
    if (tuple(b0["latents"].shape) != (1, 16, 2, EDIT_H // 8, EDIT_W // 8)
            or tuple(b0["condition"].shape) != (1, 20, 2, EDIT_H // 8, EDIT_W // 8)):
        raise AssertionError("edit_training_batch gave the wrong shapes")

    g = torch.Generator(device=dev).manual_seed(31)
    lcfg = lora_lib.LoRAConfig()
    lora = lora_lib.init_lora_params(g, pipe.dit, lcfg)
    tcfg = train_step.TrainConfig(lr=1e-4, warmup_steps=1)
    state = lora_train.make_lora_train_state(lora, tcfg)
    step = lora_train.make_lora_train_step(pipe.dit.cfg, tcfg)
    n_lora = sum(p.numel() for p in lora.parameters())
    print(f"LoRA rank {lcfg.rank} on {len(lcfg.targets)} targets x {len(lora.blocks)} blocks: "
          f"{n_lora / 1e6:.2f} M fp32 parameters; remat {pipe.dit.cfg.remat!r}; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before the first step")
    checksum = base_checksum(pipe.dit)
    want = expected_train_launches(cfg)
    times, peaks = [], []
    for i, batch in enumerate(batches):
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        metrics, secs = host_s(lambda: step(state, pipe.dit, batch, g))
        got = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        times.append(secs)
        peaks.append(peak)
        print(f"LoRA train step {i} ({'cold' if i == 0 else 'warm'}): {secs:.3f} s, peak memory "
              f"{peak:.2f} GiB, loss {loss:.5f}, grad_norm {gnorm:.4e}; launches {got[0]}; "
              f"by KV length {got[1]}")
        if got != want:
            raise AssertionError(f"train step {i}: launches {got}, the path implies {want}")
        if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0):
            raise AssertionError(f"train step {i}: loss {loss}, grad_norm {gnorm}")
        for total, counts in zip(launches, (got[0], got[1]["flash_fwd"])):
            total.update(counts)
    moved = [bool(ad.b.detach().any()) for blk in lora.blocks
             for _, ad in lora_lib.iter_adapters(blk)]
    if not all(moved):
        raise AssertionError(f"{moved.count(False)} adapters' b did not move in 3 steps")
    if base_checksum(pipe.dit) != checksum:
        raise AssertionError("the frozen base's weights changed")
    warm = statistics.median(times[1:])
    print(f"LoRA training at 720p: first step {times[0]:.3f} s, median of the rest {warm:.3f} s, "
          f"peak {max(peaks):.2f} GiB; every b moved, base bits unchanged")
    if profile_dir is not None:
        profile_stages({"lora_train_step": lambda: step(state, pipe.dit, batches[0], g)},
                       profile_dir)
    return {"first_s": times[0], "warm_s": warm, "peak_gib": max(peaks)}


def w4a16_path(pipe, dev, launches: tuple[Counter, Counter], refs: dict[int, torch.Tensor],
               profile_dir: Path | None) -> None:
    """Quantize the pipeline's DiT in place to w4a16 (the Lloyd grid, all 12
    projections of every block: K8), then serve two 720p edits and the
    reasoning drop (k = 2) with int8 scores (K9 at 28,800 tokens), each
    with exact launch counts and its PSNR against the bf16 output of the
    same request and noise (``refs``, by seed); then a warm w4a16 DiT
    forward, profiled when ``profile_dir`` is set."""
    cfg = pipe.config
    _, secs = host_s(lambda: pipe.quantize(mode="int4"))
    print(f"quantized in place to w4a16 (Lloyd grid) in {secs:.1f} s: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated (DiT and VAE)")
    for i, seed in enumerate((10, 11)):
        out = serve(pipe.edit_image, cfg, dev, f"w4a16 edit {i}", seed, (1, 3, EDIT_H, EDIT_W),
                    [EDIT_TOKENS] * cfg.num_steps, launches, int4=True)
        print(f"   PSNR against the bf16 edit of the same request and noise "
              f"{psnr(out, refs[seed]):.2f} dB (random weights: no bar)")
    pipe.dit.cfg = dataclasses.replace(pipe.dit.cfg, attn_qk_int8=True)
    steps = cfg.num_steps
    out = serve(pipe, cfg, dev, "w4a16 + int8-score reasoning edit (drop, k = 2)", 21,
                (1, 3, 5, EDIT_H, EDIT_W), [REASONING_TOKENS] * 2 + [EDIT_TOKENS] * (steps - 2),
                launches, int4=True, qk8=True, enable_temporal_reasoning=True,
                num_temporal_reasoning_steps=2)
    print(f"   PSNR against the bf16 reasoning edit of the same request and noise "
          f"{psnr(out, refs[21]):.2f} dB (random weights: no bar)")
    pipe.dit.cfg = dataclasses.replace(pipe.dit.cfg, attn_qk_int8=False)
    fns, x, _ = stages(pipe, dev, cfg.num_frames, 12, "_w4a16")
    _, dit_s = host_s(fns["dit_forward_w4a16"])
    print(f"w4a16 DiT forward (one step, {x.shape[2]}x{x.shape[3]}x{x.shape[4]} latents) "
          f"{dit_s:.3f} s")
    if profile_dir is not None:
        profile_stages({"dit_forward_w4a16": fns["dit_forward_w4a16"]}, profile_dir)


def mixed2_path(pipe, dev, launches: tuple[Counter, Counter], refs: dict[int, torch.Tensor],
                profile_dir: Path | None) -> None:
    """Quantize the (bf16) pipeline's DiT in place to mixed2 (w4a8 with the
    INT4_MIXED2_UPGRADE projections at w8a8: cuBLASLt's int8 products, no
    K8) and serve one 720p edit with exact launch counts and its PSNR
    against the bf16 edit of the same request and noise; then a warm mixed2
    DiT forward, profiled when ``profile_dir`` is set."""
    from chronoedit_tpu_torch.ops import quant

    cfg = pipe.config
    _, secs = host_s(lambda: pipe.quantize(mode="int4_a8", upgrade=quant.INT4_MIXED2_UPGRADE))
    print(f"quantized in place to mixed2 in {secs:.1f} s: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated (DiT and VAE)")
    out = serve(pipe.edit_image, cfg, dev, "mixed2 edit", 10, (1, 3, EDIT_H, EDIT_W),
                [EDIT_TOKENS] * cfg.num_steps, launches)
    print(f"   PSNR against the bf16 edit of the same request and noise "
          f"{psnr(out, refs[10]):.2f} dB (random weights: no bar)")
    fns, x, _ = stages(pipe, dev, cfg.num_frames, 12, "_mixed2")
    _, dit_s = host_s(fns["dit_forward_mixed2"])
    print(f"mixed2 DiT forward (one step, {x.shape[2]}x{x.shape[3]}x{x.shape[4]} latents) "
          f"{dit_s:.3f} s")
    if profile_dir is not None:
        profile_stages({"dit_forward_mixed2": fns["dit_forward_mixed2"]}, profile_dir)


def tiled_decode_check(vae, x: torch.Tensor) -> None:
    """The card's W-tiled streaming decode of the latent trajectory ``x``
    against its untiled streaming decode, fp32 weights and TF32 off."""
    from chronoedit_tpu_torch.models import vae as vae_lib

    cfg32 = dataclasses.replace(vae.cfg, dtype=torch.float32, param_dtype=torch.float32)
    vae32 = vae_lib.VAE(cfg32, device=x.device)
    vae32.load_state_dict(vae.state_dict())
    z = x.float()
    tiled, tiled_s = host_s(lambda: vae_lib.vae_decode(vae32, z, streaming=True, spatial_tiles=4))
    untiled, untiled_s = host_s(lambda: vae_lib.vae_decode(vae32, z, streaming=True,
                                                           spatial_tiles=1))
    err = max_err(tiled, untiled)
    tol = TILED_DECODE_TOL * max(1.0, float(untiled.abs().max()))
    print(f"fp32 streaming decode of {tuple(z.shape)}: 4 W-tiles {tiled_s:.3f} s, untiled "
          f"{untiled_s:.3f} s; max|tiled-untiled| {err:.3e} (tol {tol:.3e})")
    if tiled.shape != untiled.shape or not err <= tol:
        raise AssertionError("the tiled streaming decode disagrees with the untiled one")


def busy_ms(events) -> float:
    """Time in ms during which at least one device-side event (kernel,
    copy, memset) ran: the union of their intervals, so that host-side ops,
    which the profiler also credits with their kernels' time, count once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, lo, hi = 0.0, None, None
    for start, end in spans:
        if hi is None or start > hi:
            total += 0.0 if hi is None else hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    return (total + (0.0 if hi is None else hi - lo)) / 1e3


def profile_stages(stages: dict, out_dir: Path) -> None:
    """One warm call of each stage under ``torch.profiler``: prints the wall
    time, the device's busy time and idle share, and writes the per-kernel
    table to ``out_dir/profile_<stage>.txt``."""
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    for name, fn in stages.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = host_s(fn)
        wall_ms, device_ms = wall * 1e3, busy_ms(prof.events())
        print(f"profile {name}: wall {wall_ms:.1f} ms, device busy {device_ms:.1f} ms, "
              f"idle share {1 - device_ms / wall_ms:.3f}")
        if device_ms <= 0.0:
            raise AssertionError(f"profile {name}: no device activity was traced")
        (out_dir / f"profile_{name}.txt").write_text(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=80, max_name_column_width=100))


# ----------------------------------------------------------- main

# name in the kernel table: (source, the TPU kernel it replaces, the
# kernel's symbols: each template instantiation the row's calls launch)
SOURCES = {
    "flash_fwd": ("chronoedit_tpu_torch/csrc/flash_fwd.cu",
                  "chronoedit_tpu/ops/flash_attention.py:188", ("flash_fwd_wgmma_kernel",)),
    "ln_modulate": ("chronoedit_tpu_torch/csrc/ln_modulate.cu",
                    "chronoedit_tpu/ops/fused_norms.py:87", ("ln_modulate_ring_kernel",)),
    "gated_residual": ("chronoedit_tpu_torch/csrc/gated_residual.cu",
                       "chronoedit_tpu/ops/fused_norms.py:177", ("gated_residual_kernel",)),
    "rms_norm": ("chronoedit_tpu_torch/csrc/rms_norm.cu",
                 "chronoedit_tpu/ops/fused_norms.py:251", ("rms_norm_ring_kernel",)),
    "flash_fwd_streamed": ("chronoedit_tpu_torch/csrc/flash_fwd.cu",
                           "chronoedit_tpu/ops/flash_attention.py:227",
                           ("flash_fwd_wgmma_kernel",)),
    "flash_bwd_dq": ("chronoedit_tpu_torch/csrc/flash_bwd.cu",
                     "chronoedit_tpu/ops/flash_attention.py:588",
                     ("flash_bwd_dq_wgmma_kernel<128>",)),
    "flash_bwd_dkv": ("chronoedit_tpu_torch/csrc/flash_bwd.cu",
                      "chronoedit_tpu/ops/flash_attention.py:618",
                      ("flash_bwd_dkv_wgmma_kernel<64>",)),
    "int4_matmul": ("chronoedit_tpu_torch/csrc/int4_matmul.cu",
                    "chronoedit_tpu/ops/int4_matmul.py:89", ("int4_matmul_wgmma_kernel",)),
    "flash_fwd_qk8": ("chronoedit_tpu_torch/csrc/flash_fwd_qk8.cu",
                      "chronoedit_tpu/ops/flash_attention.py:326",
                      ("flash_fwd_qk8_wgmma_kernel",)),
    "flash_fwd_grouped": ("chronoedit_tpu_torch/csrc/flash_fwd.cu",
                          "tools/exp_flash_paired.py:40",
                          tuple(f"flash_fwd_grouped_wgmma_kernel<{n}>" for n in X1_GROUPS)),
    # X2 is K6/K7 with a stage of 64 n KV rows / 32 n q rows: n = 2 is their
    # own instantiation, n = 4 the one with two of their steps a stage
    "flash_bwd_dq_grouped": ("chronoedit_tpu_torch/csrc/flash_bwd.cu",
                             "tools/exp_flash_bwd_grouped.py:41",
                             ("flash_bwd_dq_wgmma_kernel<128>", "flash_bwd_dq_wgmma_kernel<256>")),
    "flash_bwd_dkv_grouped": ("chronoedit_tpu_torch/csrc/flash_bwd.cu",
                              "tools/exp_flash_bwd_grouped.py:78",
                              ("flash_bwd_dkv_wgmma_kernel<64>",
                               "flash_bwd_dkv_wgmma_kernel<128>")),
}


def kernel_name(symbol: str) -> str:
    """A kernel's name from its mangled symbol, with an integer template
    argument as ``name<N>``: the last component of the (anonymous)
    namespace path, e.g. ``flash_fwd_grouped_kernel<3>``."""
    i = 3 if symbol.startswith("_ZN") else 2
    name = symbol
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        name, i = symbol[j:j + int(symbol[i:j])], j + int(symbol[i:j])
    arg = re.match(r"ILi(\d+)EE", symbol[i:])
    return f"{name}<{arg.group(1)}>" if arg else name


def print_ptxas(log: Path) -> None:
    """Each kernel's registers, spills and static shared memory from nvcc's
    ``-Xptxas=-v`` output (kept beside the library when it was built), each
    template instantiation under its own name, and every warning (C7512:
    wgmma serialized for want of registers)."""
    if not log.exists():
        print("ptxas: no build log (the library was built before)")
        return
    name = None
    for line in log.read_text().splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name = kernel_name(entry.group(1))
        elif name and ("registers" in line or "spill" in line):
            print(f"ptxas {name}: {line.split(':', 1)[-1].strip()}")
        elif "C75" in line or ("ptxas" in line and "warning" in line.lower()):
            print(f"ptxas warning: {line.strip()}")


def print_sass_registers(lib: Path) -> dict[str, tuple[int, int, int]]:
    """For each kernel of the table (``SOURCES``' symbols): the highest
    register its SASS names and its local-memory stores and loads
    (``cuobjdump -sass`` on the library). ptxas reports the launch bound's
    count for the kernels that rebalance registers with ``setmaxnreg``,
    whose consumer warpgroups may use more: only the SASS shows theirs.
    Returns {kernel name: (highest register, stores, loads)}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("sass: no cuobjdump")
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], check=True, capture_output=True, text=True,
                          timeout=300).stdout
    wanted = {symbol for _, _, symbols in SOURCES.values() for symbol in symbols}
    found = {}
    for fn in re.split(r"\n\s+Function : ", sass)[1:]:
        name = kernel_name(fn.split(maxsplit=1)[0])
        if name not in wanted:
            continue
        regs = max(int(r) for r in re.findall(r"\bR(\d+)\b", fn))
        stores, loads = (len(re.findall(rf"\b{op}\b", fn)) for op in ("STL", "LDL"))
        found[name] = (regs, stores, loads)
        print(f"sass {name}: {'setmaxnreg; ' if 'USETMAXREG' in fn else ''}highest register "
              f"R{regs}, {stores} local stores, {loads} local loads")
    return found


def check_no_spills(sass: dict[str, tuple[int, int, int]]) -> None:
    """Every instantiation of every kernel of the table has its SASS line
    and touches no local memory: a spill in a consumer's registers
    serializes its wgmma, and in a row kernel puts local-memory traffic
    beside the bytes that bound it. Without ``cuobjdump`` there is nothing
    to check (``print_sass_registers`` says so)."""
    if not sass:
        return
    for name, (_, _, symbols) in SOURCES.items():
        for symbol in symbols:
            if symbol not in sass:
                raise AssertionError(f"{name}: no SASS line for {symbol}")
            if sass[symbol][1] or sass[symbol][2]:
                raise AssertionError(f"{name}: {symbol} spills to local memory")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile one DiT forward and the VAE of each serving path, "
                             "one LoRA train step and one w4a16 and one mixed2 DiT forward")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    from chronoedit_tpu_torch.configs import chronoedit_14b_distilled
    from chronoedit_tpu_torch.kernels import build
    from chronoedit_tpu_torch.pipeline.loader import load_pipeline
    from chronoedit_tpu_torch.utils.platform import cuda_device

    t_start = time.perf_counter()
    # fp32 comparisons (the plain attention twin, the CPU reference) in full
    # fp32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = cuda_device()
    card = card_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(dev)}")
    print(f"card: {card}")

    _, secs = host_s(build.lib)
    print(f"kernels built and loaded in {secs:.1f} s: {build.library_path().name}")
    print_ptxas(build.build_log_path())
    check_no_spills(print_sass_registers(build.library_path()))

    profile_dir = Path(__file__).resolve().parent / "chiprun_out" if args.profile else None
    by_name, by_kv = Counter(), Counter()
    with torch.no_grad():
        results = compare_kernels(dev)
    torch.cuda.empty_cache()
    with torch.no_grad():
        tool_launches = experiment_tools()
    with torch.inference_mode():
        small_references(dev)
        encoder_references(dev)
    training_references(dev)
    cfg = chronoedit_14b_distilled()
    try:
        # loaded outside inference_mode: training saves these weights for backward
        pipe = loaded_path(dev, dataclasses.replace(
            cfg, dit=dataclasses.replace(cfg.dit, remat="full")), (by_name, by_kv))
        with torch.inference_mode():
            refs = edit_path(pipe, dev, (by_name, by_kv), profile_dir)
            refs.update(reasoning_path(pipe, dev, (by_name, by_kv), profile_dir))
        torch.cuda.empty_cache()
        training_path(pipe, dev, (by_name, by_kv), profile_dir)
        # quantized serving: the trained-on bf16 DiT quantized in place (its
        # bf16 weights freed as the walk goes), then the bf16 model loaded
        # again from the same files for mixed2, so that no two copies of the
        # DiT share the card
        with torch.inference_mode():
            w4a16_path(pipe, dev, (by_name, by_kv), refs, profile_dir)
            del pipe
            torch.cuda.empty_cache()
            pipe, secs = host_s(lambda: load_pipeline(
                cfg, str(CHECKPOINT_DIR), loras=[(str(CHECKPOINT_DIR / "distill_lora.safetensors"),
                                                  1.0)],
                with_text_encoder=False, with_image_encoder=False, device=dev))
            print(f"loaded the DiT and VAE again for mixed2 in {secs:.1f} s")
            mixed2_path(pipe, dev, (by_name, by_kv), refs, profile_dir)
    finally:
        shutil.rmtree(CHECKPOINT_DIR, ignore_errors=True)

    # K5 is the flash kernel's launches over the 28,800-token reasoning
    # self-attention; K1 the rest of them; X1 and X2 ran in phase 4 only
    launches = dict(by_name, flash_fwd_streamed=by_kv[REASONING_TOKENS], **tool_launches)
    launches["flash_fwd"] -= launches["flash_fwd_streamed"]
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **results[name])
               for name, (src, rep, _) in SOURCES.items()]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
