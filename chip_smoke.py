"""Drive the PyTorch port's paths once on one NVIDIA GPU: the 8-step 720p
edit from a checkpoint directory (weights, LoRA and the UMT5 / CLIP
encoders loaded from files), the 29-frame temporal-reasoning edit, serving
(the batching EditServer and its HTTP endpoint, classifier-free and
skip-layer guidance, the block cache, the video guardrails), LoRA
fine-tuning of the full-width DiT at the edit's geometry (remat "full" and
"matmul_only"), QLoRA over the w4a16 DiT, quantized serving (w4a16 with
int8-score attention, and the mixed2 recipe), the training CLI from the
checkpoint directory's files to an exported LoRA that serves an edit, the
full-parameter Trainer with checkpoints, resume and ``convert_weights``,
context, pipeline and tensor parallelism and FSDP over processes on the
one card, and the two attention experiments (the grouped flash forward X1 and
backward X2).

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
   rows (``NORM_ROWS``; each also bitwise against 20 more calls), K1
   (against KV 7,200, 512 and 257, the twin in q chunks) and K2-K4 at the
   edit's stream also at the serving phase's B = 2 and 4 (``BATCHES``), K4's
   two tensor-parallel passes (``rms_sumsq``, ``rms_norm_ss``) at a tensor
   rank's 2,560 and 1,280 columns over 7,200, 512 and 257 rows
   (``compare_norms_tp``: each against its twin, 20 more calls bitwise, and
   both over every column block against K4 on the whole row), and
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
   with batched CFG, with sequential CFG and skip-layer guidance, and with
   the block cache (period 2); the edit
   quantized int8, w4a16 and mixed2, and the reasoning drop in w4a16 with
   int8 scores (the rule lowered so that K9 runs at these lengths), each on
   the same quantized weights on both sides; the encoders at full width
   and two blocks, as dB over the CPU output's peak: UMT5 (bf16, 512 token
   ids with a 300-token mask), CLIP ViT-H (bf16, 16 heads of 80 through
   SDPA, a 720p frame through ``preprocess``) and XLM-R with its head
   (fp32), each with the launch counters zeroed before it and zero after
   (no encoder runs a hand-written kernel); then training that DiT
   (``TRAIN_CASES``): LoRA and full-parameter steps, each also with
   ``grad_accum = 2``, a LoRA step under remat "matmul_only", QLoRA over a
   w4a16 and an int4_a8 base (loss, gradient cosine, grad_norm, then after
   two applied updates Adam's first moment and the update, against the
   CPU), and each QLoRA adapter gradient against the bf16-base one (JAX's
   gate, cosine above 0.9); then the Ulysses trace (``ulysses_trace``: each
   projection shape through cuBLAS, K2 and K3 on half a frame and on a
   frame, K4 on those rows and K1 on 10 of 40 heads, against those rows or
   heads of the whole call at 7,200 tokens: the kernels must be bitwise,
   cuBLAS is reported); then context parallelism (``context_path``):
   the distilled model at full width cut to ``CP_BLOCKS`` blocks, seeded,
   its forwards at 28,800 and 7,200 tokens, a 720p edit and a reasoning
   edit with the drop (k = CP_DROP_K) in this one process, then worlds of 2 and 4
   worker processes on the same card (``parallel/launch.run_world``, gloo
   asked for explicitly: NCCL refuses two ranks on one device; the
   collectives staged through pinned host memory, a transport and not a
   scaling setup), each rank rebuilding the same weights (checked across
   ranks and against this process's digest) and running ring and Ulysses
   forwards at both lengths (held against this process's as dB over its
   peak, ``CP_MIN_DB``, beside two planted faults the phase reads itself;
   every rank's gathered output bitwise alike), the edit under a mesh of
   context 2 (CP_EDIT_STEPS steps) and the drop under context 4
   (CP_DROP_STEPS steps; against this process's at the fidelity bar), at 2
   the full-width VAE split over the rows (fp32: the edit's and the
   reasoning mode's encodes and decodes against this process's at
   TILED_DECODE_TOL, the bytes gathered exact, each rank's peak against
   one process's, a planted short halo), and at 4 the flash ring's forward and backward at full
   width and 28,800 tokens (against K1 and K6/K7 on the whole sequence,
   at their bounds); every worker's launches zeroed before and checked
   after each run, by kernel and by KV length (the ring's P hops at S / P,
   Ulysses' one call at S); each world's seconds, peak memory per rank
   and bytes staged printed; then ``run_inference --mesh context=1`` under
   ``torch.distributed.run``: NCCL as a world of one, rank 0 writing the
   edit, and beside it ``train --mesh fsdp=1`` (the Trainer, and the LoRA
   loop exporting its adapters), each an NCCL world of one;
6. the main paths: ``chronoedit_14b_distilled`` at full width, cut to
   MAIN_BLOCKS = 20 blocks (x 5120, bf16; the H100 machines this runs on
   end a command that writes more than 45 GiB to their disk, and at 40
   blocks, the directory 46.2 GB, the script overran its time limit),
   random weights from a seeded generator, built
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
   a cold and a warm edit from those embeddings; with the encoders still
   attached, ``scripts/gradio_paintbrush.run_edit`` edits a seeded 720p
   composite with a painted square (token ids for the prompts, 1 step),
   bitwise ``edit_image`` on the same crop, embeddings and noise
   (``paintbrush_check``), and the encoders embed the training CLI's
   prompts (``train_prompt_refs``); the encoders are dropped,
   and the same pipeline serves one more 720p edit, then two 29-frame
   reasoning edits (the whole trajectory at WHOLE_STEPS = 4 steps, k = 4;
   the drop, k = 2 of 8) through
   ``__call__``; then serves through ``EditServer(max_batch=4)`` with the
   bundled text blocklist (``server_path``): three requests in one window
   as one batch padded to 4, two as a batch of 2, the first three alone,
   a blocked prompt rejected at submit, and two concurrent POSTs through
   ``scripts/serve.make_handler``, each batch with exact launches and each
   batched frame held against its solo frame (``SERVE_MIN_DB``, set
   between the sound readings and planted faults this phase also reads);
   guidance 5 with a negative prompt, batched CFG (B = 2) and sequential
   CFG with block 9 skipped in the unconditional forward; the block cache
   over blocks CACHE_BLOCKS = [4, 16) every second step and adaptively
   (``guidance_cache_path``); the video guardrails at full size (SigLIP
   so400m + MLP, RetinaFace R50, seeded weights) on a 5-frame 720p clip,
   and their fp32 outputs on the card against the CPU (``GUARD_MIN_DB``;
   ``guardrail_path``); then takes three
   rank-32 LoRA steps (``make_lora_train_step``, remat "full") on 720p mock
   edit pairs and two under remat "matmul_only"; then quantizes that DiT in
   place to w4a16 (Lloyd grid), takes three rank-32 QLoRA steps over it (K8
   under autograd) and serves a 720p edit and a w4a16 + int8-score
   reasoning edit (k = 2); loads the bf16 model again from the same files,
   quantizes it to mixed2 and serves one edit; with the card free, runs
   pipeline parallelism (``pipeline_path``): worlds of pipe = 2 and 4
   processes on the card over host-staged gloo, each rank loading only its
   stage's blocks of the directory's DiT and LoRA (the bytes it read held
   to the files' headers), serving the 720p edit at MAIN_BLOCKS blocks (against the
   edit path's, seed 10), at pipe = 2 also batched CFG (against
   ``guidance_cache_path``'s) and the backward of a CP_BLOCKS-deep DiT
   (against one process, at K6/K7's bounds), at pipe = 4 then the
   reasoning drop over pipe 2 x context 2 in both modes at CP_BLOCKS
   blocks (against the context phase's one-process drop), every rank's
   launches held to the schedule's; then FSDP (``fsdp_path``): a world of
   fsdp = 2 processes, each rank loading its slice of every tensor of the
   directory's DiT with the LoRA fused into it (the bytes held to the
   headers, each shard's checksum to the one-process model's slice), one
   720p forward of its first FSDP_FORWARD_BLOCKS blocks bitwise one
   process's (the bytes staged held to the shards'; the one-process
   forward and slices from the model loaded for mixed2), then
   ``cp_model``'s weights at FSDP_BLOCKS blocks sharded: the edit, batched
   CFG (a row a rank) and the w4a16 edit quantized under fsdp, each at
   FSDP_SHORT_STEPS steps against one process, and the training checks
   (``mesh_train``, below); then a world of fsdp 2 x context 2 serving the
   FSDP_SHORT_STEPS-step edit in both modes, and the training checks
   under data 2 x fsdp 2; then tensor parallelism (``tensor_path``): a world of
   tensor = 2 processes, each rank loading its columns / rows of every
   block projection of the directory's DiT with the LoRA fused (bytes held
   to the headers, each leaf's checksum to the one-process model's slice),
   one 720p forward of its first TP_FORWARD_BLOCKS blocks against one
   process at TP_MIN_DB (the bytes staged held to the row reduces' and
   K4's statistics'), then ``tp_model``'s weights at TP_BLOCKS blocks
   split: the edit (TP_SHORT_STEPS steps), a 2-block forward sound and under three planted
   faults (K4 on local statistics, the row bias on every rank, JAX's
   packed-axis int4 slice), the w4a16 edit quantized under tensor (its
   leaves bitwise the whole quantized model's split) and the training
   checks with the sharded checkpoint; then a world of 4: the edit
   and the w4a16 edit at tensor 4 (fc2 padded to 28 int4 groups), batched
   CFG over tensor 2 x data 2, the edit over tensor 2 x context 2 in both
   modes and a forward over tensor 2 x fsdp 2, each against one process at
   TP_MIN_DB, serving under tensor 2 x context 2 (rank 0's ``EditServer``
   broadcasting three 720p requests' batches of SERVE_STEPS steps to the
   followers, each frame
   against the same request's ``pipe(...)`` in the world at SERVE_MIN_DB
   and one process at TP_MIN_DB, a follower drawing seed + 1 planted),
   the training checks under data 2 x tensor 2 and the
   checkpoint restored under data 2 x fsdp 2 for a step; every rank's
   launches held exactly, K4's two tensor passes among them. The training
   checks under a mesh (``mesh_train``, against ``mesh_train_refs``' one
   process on the same weights, batch and draws, written under ``build/``):
   one rank-32 LoRA step and two full-parameter Trainer steps (AdamW, the
   clip, EMA) at TP_BLOCKS blocks on two 720p pairs, at the training bars,
   beside planted faults read from the run's own tensors (the norm over
   local shards, the gradients left as each data line computed them, the
   replicated q / k norm weights unreduced over tensor; the gradients
   summed over data are planted in the CPU test). Then it runs the
   training CLIs: ``scripts/extract_umt5.main`` on the directory's
   UMT5-XXL over a column of the prompts' token ids (its pickles bitwise
   the loaded pipeline's ``encode_ids`` on the same ids), then
   ``scripts/train.main`` (rank-32 LoRA, remat "full", ``--grad-accum 2
   --max-iter 4``) from the directory's DiT shards on two 720p PNG pairs
   with those embeddings, and serves an edit with the
   exported LoRA through ``load_pipeline``; removes the directory and runs
   the ``Trainer`` (full-parameter, ``TRAINER_BLOCKS`` blocks at full
   width, ``grad_accum = 2``, validation, ``guard_host_sync``, whose
   guard must first raise on a device read; its checkpoints in the
   machine's memory, ``scratch_dir``) 4 iterations straight and 2 + a
   resume + 2 (the last save synchronous and timed), which must end
   bitwise equal; the straight run renders the edit under the EMA once
   (``EveryNDrawSample`` over ``data/item_dataset.make_sample_fn`` on a
   720p item with the CLI's first embedding, RENDER_STEPS steps, inside
   ``utils/profiling.profile_trace``): the frame bitwise a direct
   ``pipe(...)`` with the EMA copied in by hand, the trained parameters
   bitwise unchanged after it, its launches exact and its Chrome trace
   naming K1-K4's kernels (``render_check``); then times a restore of its checkpoint and round-trips
   it through ``convert_weights``; every directory is removed at the end, whatever
   happened. The launch counters are zeroed just before each
   edit and each step and must then show exactly the launches the path
   implies, by kernel, by attention KV length and by the int4 matmul's
   rows (none of them grouped); write, load (per component, the LoRA merge
   among them), encode, stage and step times, peak memory (of the
   load's check, with the encoders and without), the memory after each
   quantization, each quantized output's PSNR against the bf16 output of
   the same request and noise (random weights: no bar), a
   tiled-against-untiled streaming decode of an 8-frame latent trajectory
   (fp32) and an unchanged-base checksum follow;
7. print the command's seconds, the kernel table as one JSON line (its
   launches include the context, pipeline, FSDP and tensor phases'
   workers' and the mesh training's, not the planted faults'), the card
   line again, and last
   ``{"ok": true, "device": {...}}``.

``--profile`` adds one warm ``torch.profiler`` pass over each stage (DiT
forward, VAE encode, VAE decode) of both serving paths at their shapes,
over one LoRA and one QLoRA train step and over one w4a16 and one mixed2
DiT forward at 7,200 tokens, printing each one's device idle share and
writing its per-kernel table to ``chiprun_out/profile_<stage>.txt`` under
the repository root.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
from collections import Counter
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# The same bounds hold the accumulated steps (grad_accum = 2 over the same
# batch and draws: the mean of equal gradients is that gradient), the LoRA
# step under remat "matmul_only" (the same arithmetic, other tensors kept)
# and QLoRA (both sides on the same quantized bits; w4a16 adds the card's
# one bf16 rounding of each product, w4a8 the activations' int8 roundings,
# which may flip where x / xs lies within bf16 rounding of a .5). With the
# bf16 side also on the CPU: cosine 0.999973 for LoRA, full, both
# accumulated cases, matmul_only and QLoRA over w4a16, 0.999928 over w4a8;
# the update within 8.9e-2 / 9.7e-2 / 9.3e-2 / 0.126 (LoRA / full / w4a16 /
# w4a8). QLoRA's adapter gradient on the card against the bf16-base LoRA
# step's: JAX's gate (``tests/test_conditioner_lora_train.py``), cosine
# above 0.9 (0.988 with the bf16 side on the CPU); a quantized product with
# no gradient path (what JAX measured before its straight-through product)
# reads about 0.80.
TRAIN_QLORA_COS = 0.9
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
# The serving phase. The batcher's window: requests submitted together
# (the HTTP pair: two uploads of 21 MB) join one batch.
SERVER_WAIT_MS = 1000.0
# A batched request's frame against the same request served alone, both
# bf16 on the card, as PSNR over the [-1, 1] range. The bound lies between
# the sound readings and the closest planted fault, both read by this phase
# (``server_path``; H100 80GB HBM3, 700 W): sound, every batched frame
# bitwise its solo frame (inf dB: each row's GEMM, attention and norm
# arithmetic does not depend on the batch); faults, a request run with
# another request's noise 15.17 dB and a frame handed to another request
# 15.13 dB. The bound is the repo's fidelity bar, 35 dB: a batch whose
# GEMMs took another tiling (another bf16 summation order) would read near
# the 2-block references' 46-49 dB (bf16 against fp32) and pass. A
# modulation read from the wrong batch row cannot show at any bound here:
# every row of a batch shares its timestep, so the rows' modulations are
# equal.
SERVE_MIN_DB = 35.0
# the block cache's middle blocks at full depth, and the adaptive
# threshold: on the loaded model's 720p edit it refreshes on 7 of 8 steps
# (H100 80GB HBM3, 700 W); the run checks that its schedule mixes
CACHE_BLOCKS = (4, 16)
CACHE_THRESH = 0.05
# The guardrail models in fp32 on the card (TF32 off) against fp32 on the
# CPU, where only the summation order differs, over the CPU's peak. The
# bound lies between the sound readings and the closest of the other
# readings ``guardrail_path`` takes itself (H100 80GB HBM3, 700 W): sound,
# SigLIP 132.88 dB, RetinaFace loc / conf 127.04 / 129.29 dB; planted, an
# exact GELU for SigLIP's tanh one 83.21 dB (the closest), the control
# (TF32 on) 72.01 / 72.68 dB, RetinaFace's FPN upsampling `nearest` for
# `nearest-exact` 37.41 dB, a ResNet v1 bottleneck 30.07 dB, SigLIP's
# resize without antialiasing 15.32 dB. Each of them must read under it.
GUARD_MIN_DB = 95.0
BUILD_DIR = Path(__file__).resolve().parent / "build"  # git-ignored
# The H100 machines this runs on end a command that writes more than 45 GiB
# to their disk in all, deletions included; the machine's memory (/dev/shm)
# reads and writes at about 0.55 GB/s, a seventh of the disk's reads
# (H100 80GB HBM3 machine, 700.00 W). So the files read many times stay on
# the disk (the checkpoint directory: its DiT at MAIN_BLOCKS blocks, about
# 30 GB with the encoders; the mesh training's reference and checkpoint,
# 14.7 GB), and the Trainer's checkpoints, written and read once, go to a
# directory of this run's own in the memory (``scratch_dir``).


def scratch_dir() -> Path:
    """A new directory of this run's own under /dev/shm (raises when it
    cannot be made); the caller removes it."""
    return Path(tempfile.mkdtemp(prefix="chronoedit_smoke-", dir="/dev/shm"))


# the checkpoint directory the main path writes and loads; removed when the
# run ends
CHECKPOINT_DIR = BUILD_DIR / "smoke_checkpoint"
# the main path's model: the distilled 14B at full width, cut in depth. At
# 40 blocks the directory (46.23 GB) fits the disk's 45 GiB only with
# MESH_DIR in /dev/shm, and the script then took 1,369 s (H100 80GB HBM3,
# 700.00 W), past its 1,200 s limit
MAIN_BLOCKS = 20


def main_config(**kw):
    """``chronoedit_14b_distilled`` at MAIN_BLOCKS blocks: the model the
    checkpoint directory holds and every phase that loads it runs."""
    from chronoedit_tpu_torch.configs import chronoedit_14b_distilled

    cfg = chronoedit_14b_distilled(**kw)
    return dataclasses.replace(cfg, dit=dataclasses.replace(cfg.dit, num_layers=MAIN_BLOCKS))
# the rank-32 LoRA file's alpha: alpha / rank = 0.5 scales every delta
LORA_ALPHA = 16.0

EDIT_H, EDIT_W = 720, 1280
TEXT_TOKENS = 512
IMAGE_TOKENS = 257
REASONING_FRAMES = 29
# the whole-trajectory reasoning edit's steps (k = all of them): half the
# config's 8, so that the command stays inside its time limit
WHOLE_STEPS = 4
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
# the batch sizes of the serving phase's main paths (batched CFG and the
# server's pairs; the server's bucket of 4), at which phase 3 also holds
# K1-K4 against their twins on the edit's 7,200 tokens
BATCHES = (2, 4)
# calls of K2-K4 held bitwise against the first on the same inputs
NORM_REPEATS = 20
# X1's KV tiles a step, and X2's (n_dq, n_dkv) variants (the experiment's,
# without production's (1, 1), which is K6/K7)
X1_GROUPS = (2, 3, 4)
X2_VARIANTS = ((2, 1), (1, 2), (2, 2), (4, 1), (4, 4), (2, 4))
# the grouped kernels' launch names: none of the main paths launches them
GROUPED = ("flash_fwd_grouped", "flash_bwd_dq_grouped", "flash_bwd_dkv_grouped")
# K4's two tensor-parallel passes: launched only under a tensor axis
TP_NORMS = ("rms_sumsq", "rms_norm_ss")


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
    # K1 at the batched main paths' B = 2 (batched CFG, the server's pairs)
    # and B = 4 (the server's bucket); the twin in q chunks bounds its scores
    for b in BATCHES:
        q = randn(b, s, h, d)
        for skv, what in ((s, "self"), (TEXT_TOKENS, "text"), (IMAGE_TOKENS, "image")):
            k, v = randn(b, skv, h, d), randn(b, skv, h, d)
            ref = flash_reference(q, k, v, q_chunk=Q_CHUNK)
            accumulate(results, "flash_fwd", compare_flash("K1", what, q, k, v, ref),
                       f"B={b} kv={skv}")
            del ref, k, v
        del q
        torch.cuda.empty_cache()

    results.update(compare_norms(randn))
    results.update(compare_norms_tp(randn))
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
    256, then each at its ``NORM_ROWS`` shapes (1, rows, 5120) and at
    (B, 7200, 5120) for each of ``BATCHES``, with frames of the edit's
    hw = 3,600 rows, against the twin (``check_norm``), with
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
        for b, rows in [(1, rows) for rows in sizes] + [(b, EDIT_TOKENS) for b in BATCHES]:
            x = randn(b, rows, dim) * 2.0 + 0.5
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
            accumulate(results, name, row, f"rows={rows}" if b == 1 else f"B={b} rows={rows}")
            del x
    return results


# K4's tensor-parallel form (``rms_norm_tensor``): a tensor rank's local
# width of the 5,120-wide q and k at tensor = 2 and 4, over the rows of the
# self-attention (7,200) and the text and CLIP keys (512, 257)
TP_NORM_DIMS = (2560, 1280)
TP_NORM_ROWS = (EDIT_TOKENS, TEXT_TOKENS, IMAGE_TOKENS)
# pass (a)'s fp32 sums of squares against the twin's, relative to the
# largest: the two sum the same products in other orders
SUMSQ_REL = 1e-5


def compare_norms_tp(randn) -> dict[str, dict]:
    """K4's two tensor-parallel passes at each local width of
    ``TP_NORM_DIMS`` and rows of ``TP_NORM_ROWS``, a rank's block of a
    5,120-wide row: pass (a) (``rms_sumsq``) against its twin within
    ``SUMSQ_REL`` and bitwise over ``NORM_REPEATS`` more calls; pass (b)
    (``rms_norm_ss``, given the whole row's sums) against its twin as
    ``check_norm`` holds K4; and the two passes over every block of the
    row, the sums added in fp32 as the all-reduce adds them, against K4 on
    the whole row within one bf16 step. Device times of both passes and
    their twins; no PyTorch call computes either pass."""
    from chronoedit_tpu_torch.ops import fused_norms as fn

    results = {}
    full = 40 * 128
    for d in TP_NORM_DIMS:
        tp = full // d
        for rows in TP_NORM_ROWS:
            x = randn(1, rows, full) * 2.0 + 0.5
            w = (1.0 + 0.1 * randn(full)).contiguous()
            blocks = [x[..., i * d:(i + 1) * d].contiguous() for i in range(tp)]
            local, w_local = blocks[0], w[:d]
            with torch.no_grad():
                got, ref = fn._rms_sumsq_kernel(local), fn.rms_sumsq_plain(local)
                err = max_err(got, ref)
                same = sum(torch.equal(got, fn._rms_sumsq_kernel(local))
                           for _ in range(NORM_REPEATS))
                print(f"rms_sumsq x {tuple(local.shape)}: max|ss-ref| {err:.3e} (tol "
                      f"{SUMSQ_REL * float(ref.abs().max()):.3e}); {same} of {NORM_REPEATS} more "
                      f"calls bitwise the first")
                if not err <= SUMSQ_REL * float(ref.abs().max()) or same != NORM_REPEATS:
                    raise AssertionError(f"rms_sumsq at D={d}, {rows} rows disagrees with its "
                                         f"twin or with itself")
                ss = sum(fn._rms_sumsq_kernel(b) for b in blocks)
                kernel = functools.partial(fn._rms_norm_ss_kernel, w_local, local, ss, full,
                                           1e-6)
                plain = functools.partial(fn.rms_norm_ss_plain, w_local, local, ss, full, 1e-6)
                err_b = check_norm(f"rms_norm_ss x {tuple(local.shape)} of D={full}", kernel,
                                   plain)
                chained = torch.cat([fn._rms_norm_ss_kernel(w[i * d:(i + 1) * d], b, ss, full,
                                                            1e-6)
                                     for i, b in enumerate(blocks)], dim=-1)
                whole = fn._rms_norm_kernel(w, x, 1e-6)
                err_w, tol_w = max_err(chained, whole), ULP_BF16 * float(whole.float().abs().max())
                print(f"   both passes over the {tp} blocks against K4 on the whole row: "
                      f"{err_w:.3e} (tol {tol_w:.3e})")
                if not err_w <= tol_w:
                    raise AssertionError(f"K4's two passes at D={d}, {rows} rows disagree with "
                                         f"K4 on the whole row")
                for name, k_fn, p_fn, nbytes in (
                        ("rms_sumsq", lambda: fn._rms_sumsq_kernel(local),
                         lambda: fn.rms_sumsq_plain(local), local.numel() * 2 + rows * 4),
                        ("rms_norm_ss", kernel, plain,
                         2 * local.numel() * 2 + d * 2 + rows * 4)):
                    ms, call, plain_ms = cuda_ms(k_fn), call_ms(k_fn), cuda_ms(p_fn)
                    row = {"max_abs_err": err if name == "rms_sumsq" else err_b, "ms": ms,
                           "call_ms": call, "plain_ms": plain_ms,
                           **bound((2 if name == "rms_sumsq" else 10) * local.numel(), nbytes),
                           "library_ms": None}
                    print(f"   {name} {ms:.4f} ms on the device ({call:.4f} ms a call), plain "
                          f"{plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
                          f"({row['bound_by']}): {row['bound_ms'] / ms:.1%} of the bound; no "
                          f"single PyTorch call computes it")
                    accumulate(results, name, row, f"D={d} rows={rows}")
            del x, blocks
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
    with the drop (k = 2) and without it (k = 8); the edit with batched CFG,
    with sequential CFG and skip-layer guidance, and with the block cache;
    then the edit quantized int8, w4a16 and mixed2, and the drop in w4a16
    with int8 scores, each on the CPU model's quantized weights copied bit
    for bit to the card. Returns PSNRs in dB."""
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

    def compare(label, entry, tiles, h, w, noise, shape, dits=(dit, dev_dit), cfg_kw=None,
                **kw):
        cfg_kw = dict(cfg_kw or {}, vae_spatial_tiles=tiles)
        ref_pipe = ChronoEditPipeline(dataclasses.replace(ref_cfg, **cfg_kw), dits[0], vae)
        dev_pipe = ChronoEditPipeline(dataclasses.replace(dev_cfg, **cfg_kw), dits[1], dev_vae)
        req = request(ref_cfg, cpu, 2, h, w, 16)
        if "guidance_scale" in kw:  # a negative prompt for classifier-free guidance
            req["neg_prompt_emb"] = torch.randn(req["prompt_emb"].shape,
                                                generator=torch.Generator().manual_seed(3))
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
    # the serving forms: CFG batched (B = 2) and sequential with block 1
    # skipped in the unconditional forward, at guidance 5; the block cache
    # over block 1, refreshed every second step
    for label, cfg_kw, kw in (
            ("CFG batched, guidance 5", {}, dict(guidance_scale=5.0)),
            ("CFG sequential + SLG (1,), guidance 5", dict(cfg_batched=False),
             dict(guidance_scale=5.0, slg_layers=(1,))),
            ("block cache (1, 2), period 2", dict(cache_blocks=(1, 2), cache_period=2), {})):
        results[f"edit {label}"] = compare(f"edit, {label}", "edit_image", None, 64, 64,
                                           edit_noise, (1, 3, 64, 64), cfg_kw=cfg_kw, **kw)
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


# the training references' cases: (label, trained tensors, the card's remat,
# grad_accum, the base's quantization mode)
TRAIN_CASES = (("lora", "lora", "full", 1, None), ("full", "full", "full", 1, None),
               ("lora, grad_accum 2", "lora", "full", 2, None),
               ("full, grad_accum 2", "full", "full", 2, None),
               ("lora, remat matmul_only", "lora", "matmul_only", 1, None),
               ("QLoRA over w4a16", "lora", "full", 1, "int4"),
               ("QLoRA over int4_a8", "lora", "full", 1, "int4_a8"))


def training_references(dev: torch.device) -> dict[str, dict]:
    """Steps of the 2-block DiT at the 64x64 edit's geometry, each case of
    ``TRAIN_CASES`` on ``dev`` in bf16 with the kernels (K6/K7 in the
    backward, K8 under a w4a16 base) against the same weights, batch and
    draws in fp32 on the CPU with the twins (remat "none"): LoRA and
    full-parameter steps, each also with ``grad_accum = 2``, a LoRA step
    under remat "matmul_only", and QLoRA over a w4a16 and an int4_a8 base
    (the CPU model's quantized bits copied to the card). Compares the loss
    (relative), the cosine of the whole gradient vector, the first step's
    loss and grad_norm (relative), and after two applied updates (the first
    at the warm-up's learning rate 0, which must leave every weight's bits
    as they were, as must a micro-step that only accumulates) Adam's first
    moment and the update of every trained weight (normwise). On the card,
    each QLoRA adapter gradient against the bf16-base LoRA gradient, at
    JAX's gate (``TRAIN_QLORA_COS``). Returns the readings."""
    from chronoedit_tpu_torch.core.rectified_flow import RectifiedFlowConfig
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.models import lora as lora_lib
    from chronoedit_tpu_torch.ops import quant
    from chronoedit_tpu_torch.train import lora_train, train_step

    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(3)
    ref_dit = dit_lib.init_dit_params(small_training_config(torch.float32, "none"), g)
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
    quantized = {}  # mode -> the CPU's quantized state dict

    def on(side, device, cfg, qmode):
        dit = dit_lib.DiT(cfg, device=device)
        dit.load_state_dict(ref_dit.state_dict())
        if qmode is not None:
            quant.quantize_dit(dit, mode=qmode)
            if side == "ref":
                quantized[qmode] = dit.state_dict()
            else:  # the CPU's bits: the same quantized weights on both sides
                dit.load_state_dict(quantized[qmode])
        lora = lora_lib.LoRA(dit, lora_lib.LoRAConfig(), device=device)
        lora.load_state_dict(ref_lora.state_dict())
        return dit, lora, {k: v.to(device) for k, v in batch.items()}, u.to(device), noise.to(device)

    def flat(tensors):
        return torch.cat([x.detach().double().flatten().cpu() for x in tensors])

    def rel(got, want):
        return float((got - want).norm() / want.norm())

    def cosine(a, b):
        return float(a @ b / (a.norm() * b.norm()))

    readings, card_grads = {}, {}
    for label, mode, remat, accum, qmode in TRAIN_CASES:
        sides, tcfg = {}, None
        for name, device, cfg in (("ref", cpu, small_training_config(torch.float32, "none")),
                                  ("dev", dev, small_training_config(torch.bfloat16, remat))):
            dit, lora, b, u_, noise_ = on(name, device, cfg, qmode)
            params = list(lora.parameters()) if mode == "lora" else list(dit.parameters())
            for p in params:
                p.requires_grad_(True)
            loss = train_step.velocity_loss(
                dit, cfg, rf, b["latents"], b["condition"], b["text_emb"], b["image_emb"], u_,
                noise_, lora=lora if mode == "lora" else None,
                lora_attach=qmode is not None)
            grad = flat(torch.autograd.grad(loss, params))
            if tcfg is None:  # the clip acts on both sides
                tcfg = train_step.TrainConfig(lr=TRAIN_LR, warmup_steps=1, grad_accum=accum,
                                              grad_clip=0.5 * float(grad.norm()))
            if mode == "lora":
                state = lora_train.make_lora_train_state(lora, tcfg)
                step = functools.partial(lora_train.make_lora_train_step(cfg, tcfg), state, dit)
            else:
                state = train_step.make_train_state(dit, tcfg)
                step = functools.partial(train_step.make_train_step(cfg, tcfg), state)
            before = [p.detach().clone() for p in params]
            metrics = step(b, u=u_, noise=noise_)
            for _ in range(accum - 1):  # the rest of the first (lr 0) update
                step(b, u=u_, noise=noise_)
            if not all(torch.equal(p, q) for p, q in zip(params, before)):
                raise AssertionError(f"training reference {label}: the warm-up update or an "
                                     "accumulating micro-step moved a weight")
            for _ in range(accum):
                step(b, u=u_, noise=noise_)
            if state.optimizer.gradient_step != 2:
                raise AssertionError(f"training reference {label}: "
                                     f"{state.optimizer.gradient_step} updates, not 2")
            update = flat([p.detach().float() - q.float() for p, q in zip(params, before)])
            moment = flat([state.optimizer.adamw.state[p]["exp_avg"] for p in params])
            sides[name] = (float(loss.detach()), grad, float(metrics["loss"]),
                           float(metrics["grad_norm"]), update, moment)
            del dit, lora, state, step, params, before
        (l_ref, g_ref, sl_ref, gn_ref, up_ref, m_ref) = sides["ref"]
        (l_dev, g_dev, sl_dev, gn_dev, up_dev, m_dev) = sides["dev"]
        card_grads[label] = g_dev
        loss_rel = abs(l_dev - l_ref) / abs(l_ref)
        cos = cosine(g_ref, g_dev)
        step_rel = abs(sl_dev - sl_ref) / abs(sl_ref)
        norm_rel = abs(gn_dev - gn_ref) / gn_ref
        moment_rel, update_rel = rel(m_dev, m_ref), rel(up_dev, up_ref)
        print(f"training reference ({label}, 2 blocks x 2 heads, 64x64 edit geometry): "
              f"loss card bf16 {l_dev:.6f} vs CPU fp32 {l_ref:.6f}, relative {loss_rel:.2e} "
              f"(bound {TRAIN_LOSS_REL}); gradient cosine over {g_ref.numel()} entries "
              f"{cos:.6f} (bound {TRAIN_GRAD_COS}); the step's loss relative {step_rel:.2e} "
              f"(bound {TRAIN_LOSS_REL}), grad_norm {gn_dev:.4e} vs {gn_ref:.4e}, relative "
              f"{norm_rel:.2e} (bound {TRAIN_NORM_REL}); after two updates (lr {TRAIN_LR}, "
              f"clip {tcfg.grad_clip:.4e}, grad_accum {accum}) Adam's first moment "
              f"{moment_rel:.3e} (bound {TRAIN_MOMENT_REL}), the update {update_rel:.3e} "
              f"(bound {TRAIN_UPDATE_REL}) normwise, |update| {float(up_ref.norm()):.4e}")
        if not (loss_rel <= TRAIN_LOSS_REL and cos >= TRAIN_GRAD_COS
                and step_rel <= TRAIN_LOSS_REL and norm_rel <= TRAIN_NORM_REL and gn_dev > 0
                and moment_rel <= TRAIN_MOMENT_REL and update_rel <= TRAIN_UPDATE_REL
                and float(up_ref.norm()) > 0):
            raise AssertionError(f"training reference {label}: the card disagrees with the CPU")
        readings[label] = {"loss_rel": loss_rel, "grad_cos": cos, "norm_rel": norm_rel,
                           "moment_rel": moment_rel, "update_rel": update_rel}
    for label in ("QLoRA over w4a16", "QLoRA over int4_a8"):
        cos = cosine(card_grads[label], card_grads["lora"])
        print(f"{label} on the card: adapter gradient cosine against the bf16-base LoRA step "
              f"{cos:.4f} (JAX's gate {TRAIN_QLORA_COS})")
        if not cos > TRAIN_QLORA_COS:
            raise AssertionError(f"{label}: adapter gradient cosine {cos} against the bf16 base")
        readings[label]["float_base_cos"] = cos
    return readings


def expected_launches(cfg, tokens: list[int], int4: bool = False, qk8: bool = False,
                      blocks: list[list[int]] | None = None, image: bool = True
                      ) -> tuple[dict[str, int], dict[str, dict[int, int]]]:
    """Kernel launches of one edit whose step i self-attends over tokens[i]
    and runs forwards of ``blocks[i]`` blocks each (default one forward of
    every block; two under sequential CFG, fewer where skip-layer guidance
    or the block cache skips blocks; a batch launches each kernel once):
    per block 3 attentions (self, text, image), 2 LN-modulates, 2 gated
    residuals and 5 RMSNorms (self q, k; cross q; text k; image k), plus
    each forward's head LN-modulate, and no backward; without an ``image``
    context (no CLIP embedding) 2 attentions and 4 RMSNorms a block. With ``int4`` (w4a16)
    every block's 12 projections run K8: 8 over the step's tokens, 2 over
    the text and 2 over the image context; with ``qk8`` self-attention past
    JAX's resident KV length runs K9 instead of the flash forward. No
    grouped kernel runs. Returns
    ({name: count}, {name: {KV length or int4 rows: count}}), as
    ``read_launches``."""
    from chronoedit_tpu_torch.ops.flash_attention import uses_int8_scores

    blocks = blocks or [[cfg.dit.num_layers]] * len(tokens)
    by_kv = {TEXT_TOKENS: 0, IMAGE_TOKENS: 0} if image else {TEXT_TOKENS: 0}
    qk8_kv, rows = {}, {}
    n_blocks = n_forwards = 0
    for s, forwards in zip(tokens, blocks):
        for n in forwards:
            n_blocks += n
            n_forwards += 1
            by_kv[TEXT_TOKENS] += n
            if image:
                by_kv[IMAGE_TOKENS] += n
            counts = qk8_kv if qk8 and uses_int8_scores(s, cfg.dit.head_dim, 2) else by_kv
            counts[s] = counts.get(s, 0) + n
            if int4:
                for m, per_block in ((s, 8), (TEXT_TOKENS, 2), (IMAGE_TOKENS, 2)):
                    rows[m] = rows.get(m, 0) + per_block * n
    by_name = {"flash_fwd": sum(by_kv.values()), "ln_modulate": 2 * n_blocks + n_forwards,
               "gated_residual": 2 * n_blocks, "rms_norm": (5 if image else 4) * n_blocks,
               "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
               "int4_matmul": sum(rows.values()), "flash_fwd_qk8": sum(qk8_kv.values()),
               **dict.fromkeys(GROUPED + TP_NORMS, 0)}
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
        paintbrush_check(pipe, dev, launches)
        train_prompts = train_prompt_refs(pipe, dev)
        pipe.text_encoder = pipe.image_encoder = None
        torch.cuda.empty_cache()
    print(f"from files to the first edit: load {load_s:.1f} s + encode "
          f"{t5_s + clip_s:.2f} s + cold edit {times[0]:.2f} s; warm edit {times[1]:.2f} s; "
          f"peak {with_encoders:.2f} GiB with the encoders, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated after dropping them")
    return pipe, train_prompts


# the training data's prompts: TRAIN_PROMPTS seeded draws of TEXT_TOKENS
# ids, of which the first PROMPT_LEN are the prompt
TRAIN_PROMPTS = 2
PAINT_SEED = 43


def train_prompt_refs(pipe, dev) -> dict[str, list]:
    """The training CLI's prompts as token ids (numpy, ``PROMPT_LEN`` each)
    and their UMT5-XXL embeddings through the loaded pipeline's
    ``UMT5TextEncoder.encode_ids``, on the ids and mask that
    ``scripts/extract_umt5`` makes of them (fp32 numpy): what
    ``cli_path``'s run of that CLI on the same checkpoint must write,
    bitwise."""
    import numpy as np

    from chronoedit_tpu_torch.models import umt5
    from chronoedit_tpu_torch.scripts.extract_umt5 import padded_ids

    g = torch.Generator(device=dev).manual_seed(51)
    refs = {"ids": [], "emb": []}
    for _ in range(TRAIN_PROMPTS):
        draw = torch.randint(0, umt5.UMT5Config().vocab_size, (1, TEXT_TOKENS), generator=g,
                             device=dev)
        ids = draw[0, :PROMPT_LEN].cpu().numpy()
        padded, mask = padded_ids(ids, TEXT_TOKENS)
        emb = pipe.text_encoder.encode_ids(padded.to(dev), mask.to(dev))[0]
        refs["ids"].append(ids)
        refs["emb"].append(emb.float().cpu().numpy())
    if any(e.shape != (TEXT_TOKENS, pipe.config.dit.text_dim) or not np.isfinite(e).all()
           for e in refs["emb"]):
        raise AssertionError("the training prompts' UMT5 embeddings are not finite "
                             f"({TEXT_TOKENS}, {pipe.config.dit.text_dim})")
    return refs


def paintbrush_check(pipe, dev, launches: tuple[Counter, Counter]) -> None:
    """``scripts/gradio_paintbrush.run_edit`` on the loaded main model with
    its encoders: a seeded 720p background and a composite with a painted
    square, 512 seeded token ids for the prompt and 8 for the negative, one
    step; its frame must be bitwise ``edit_image`` on the same cropped
    composite, the encoders' embeddings of the same ids and a generator of
    the same seed, and each call's launches exactly one step's."""
    import numpy as np
    from PIL import Image

    from chronoedit_tpu_torch.models import umt5
    from chronoedit_tpu_torch.scripts import gradio_paintbrush as paintbrush

    cfg = pipe.config
    rng = np.random.default_rng(PAINT_SEED)
    background = rng.integers(0, 256, (EDIT_H, EDIT_W, 3), dtype=np.uint8)
    composite = background.copy()
    composite[200:400, 500:800] = (230, 40, 40)
    value = {"background": Image.fromarray(background), "composite": Image.fromarray(composite)}
    g = torch.Generator(device=dev).manual_seed(PAINT_SEED)
    vocab = umt5.UMT5Config().vocab_size
    ids = torch.randint(0, vocab, (1, TEXT_TOKENS), generator=g, device=dev)
    neg = torch.randint(0, vocab, (1, 8), generator=g, device=dev)
    seed = 100 + PAINT_SEED  # serve()'s generator seed for the reference call
    # run_edit draws its noise from its own generator of ``seed``
    got = serve(lambda value, generator: paintbrush.run_edit(
                    pipe, value, ids, 1, 1.0, seed=seed, negative_prompt=neg),
                cfg, dev, "paintbrush run_edit (1 step)", PAINT_SEED, (1, 3, EDIT_H, EDIT_W),
                [EDIT_TOKENS], launches, req={"value": value})
    image = paintbrush.composite_image(value, dev)
    req = dict(image=image, prompt_emb=pipe.encode_prompt(ids),
               neg_prompt_emb=pipe.encode_prompt(neg), image_emb=pipe.encode_image(image))
    want = serve(pipe.edit_image, cfg, dev, "edit_image on the same crop (1 step)", PAINT_SEED,
                 (1, 3, EDIT_H, EDIT_W), [EDIT_TOKENS], launches, req=req, num_steps=1,
                 guidance_scale=1.0)
    if not torch.equal(got, want):
        raise AssertionError(f"paintbrush: run_edit's frame is not edit_image's "
                             f"(max |diff| {float((got - want).abs().max())})")
    print("   paintbrush run_edit's frame bitwise edit_image's")


def serve(entry, cfg, dev, label: str, seed: int, shape: tuple, tokens: list[int],
          launches: tuple[Counter, Counter], int4: bool = False, qk8: bool = False,
          req: dict | None = None, times: list | None = None,
          blocks: list[list[int]] | None = None, **kw) -> torch.Tensor:
    """One 720p edit through ``entry`` (the pipeline or its ``edit_image``)
    of ``req`` (default: the seeded ``request``), with the launch counters
    zeroed just before it and read just after: they must equal what the
    path implies (``expected_launches``, with ``blocks`` per forward, or
    what ``blocks()`` returns after the edit), and are added to
    ``launches`` (by name, flash forwards by KV length); its
    seconds are appended to ``times`` when given. Returns the output, fp32
    on the CPU."""
    from chronoedit_tpu_torch.kernels import build

    req = req or request(cfg, dev, seed, EDIT_H, EDIT_W, TEXT_TOKENS)
    gen = torch.Generator(device=dev).manual_seed(100 + seed)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    out, secs = host_s(lambda: entry(**req, generator=gen, **kw))
    if times is not None:
        times.append(secs)
    got = read_launches()
    want = expected_launches(cfg, tokens, int4=int4, qk8=qk8,
                             blocks=blocks() if callable(blocks) else blocks)
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
    """A 720p edit through ``edit_image`` (the loaded path's warm edit is
    another), then warm per-stage times (and profiles
    when ``profile_dir`` is set); adds its launches to ``launches``.
    Returns the edit by request seed."""
    cfg = pipe.config
    tokens = [EDIT_TOKENS] * cfg.num_steps
    outs = {10: serve(pipe.edit_image, cfg, dev, "edit (warm)", 10, (1, 3, EDIT_H, EDIT_W),
                      tokens, launches)}

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
    trajectory (k = num_steps at WHOLE_STEPS steps, every forward at 28,800
    tokens) and the drop (k = 2 of the config's 8 steps: two forwards at
    28,800 tokens, the rest at 7,200); then warm stage times (the dual
    decode of each submode among them), the tiled-against-untiled decode
    check and, with ``profile_dir``, profiles. Adds the edits' launches to
    ``launches``; returns the edits by request seed."""
    cfg = pipe.config
    outs = {}
    for label, seed, steps, k, frames in (
            ("whole trajectory", 20, WHOLE_STEPS, WHOLE_STEPS, REASONING_FRAMES),
            ("drop", 21, cfg.num_steps, 2, 5)):
        tokens = [REASONING_TOKENS] * k + [EDIT_TOKENS] * (steps - k)
        outs[seed] = serve(pipe, cfg, dev, f"reasoning edit ({label}, {steps} steps, k = {k})",
                           seed, (1, 3, frames, EDIT_H, EDIT_W), tokens, launches,
                           num_steps=steps, enable_temporal_reasoning=True,
                           num_temporal_reasoning_steps=k)

    fns, x, enc_s = stages(pipe, dev, REASONING_FRAMES, 22, "_reasoning")
    _, dit_s = host_s(fns["dit_forward_reasoning"])
    print(f"reasoning stages: streaming VAE encode of {REASONING_FRAMES} frames "
          f"{enc_s:.3f} s, DiT forward (one step, {x.shape[2]}x{x.shape[3]}x"
          f"{x.shape[4]} latents, {REASONING_TOKENS} tokens) {dit_s:.3f} s")
    # the dual decode each submode ends with: the whole trajectory's 8 latent
    # frames, or the [first, last] pair left after the drop
    for label, z in (("k = 8", x), ("k = 2", x[:, :, [0, -1]])):
        video, secs = host_s(functools.partial(pipe.decode, z, dual=True))
        print(f"dual decode ({label}) of {z.shape[2]} latent frames to "
              f"{tuple(video.shape)}: {secs:.3f} s")
    del video
    # the tiling check on the trajectory's first 4 latent frames (13 video
    # frames): all 8 took 11 s more of the command's time limit
    tiled_decode_check(pipe.vae, x[:, :, :4].contiguous())
    if profile_dir is not None:
        profile_stages(fns, profile_dir)
    return outs


# ----------------------------------------------------------- serving

class TimedPipeline:
    """The pipeline as the batching server sees it (harness code): every
    batch's call has the launch counters zeroed just before it and read just
    after, in the batcher's thread, and they must be one edit's (each
    kernel launches once for the whole batch); its batch size, seconds and
    peak memory are kept in ``batches``, its launches added to
    ``launches``."""

    def __init__(self, pipe, launches: tuple[Counter, Counter]):
        self._pipe, self._launches = pipe, launches
        self.batches: list[tuple[int, float, float]] = []

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def __call__(self, image, *args, **kw):
        from chronoedit_tpu_torch.kernels import build

        cfg = self._pipe.config
        want = expected_launches(cfg, [EDIT_TOKENS] * cfg.num_steps)
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        out, secs = host_s(lambda: self._pipe(image, *args, **kw))
        got = read_launches()
        if got != want:
            raise AssertionError(f"server batch of {image.shape[0]}: launches {got}, "
                                 f"the path implies {want}")
        self.batches.append((image.shape[0], secs, torch.cuda.max_memory_allocated() / 2**30))
        for total, counts in zip(self._launches, (got[0], got[1]["flash_fwd"])):
            total.update(counts)
        return out


def post_edit(port: int, req: dict, seed: int) -> torch.Tensor:
    """One request through the HTTP endpoint: the edited frame."""
    import io
    import urllib.request

    import numpy as np

    buf = io.BytesIO()
    np.savez(buf, **{k: v.float().cpu().numpy() for k, v in req.items()})
    post = urllib.request.Request(f"http://127.0.0.1:{port}/edit?seed={seed}",
                                  data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(post, timeout=600) as r:
        with np.load(io.BytesIO(r.read())) as z:
            return torch.from_numpy(z["edit"])


def server_path(pipe, dev, launches: tuple[Counter, Counter]) -> dict:
    """``EditServer(max_batch=4, buckets (1, 2, 4))`` around the loaded
    pipeline with the bundled text blocklist attached: requests 20-22 queued
    in one window run as one batch padded to 4, requests 23-24 as a batch of
    2, then 20-22 one at a time, each batch with exact launches; a blocked
    prompt fails its own future at submit; requests 20 and 21 come again as
    two concurrent POSTs through ``scripts/serve.make_handler``. Each
    batched frame is held against the same request's solo frame
    (``SERVE_MIN_DB``), beside the planted faults' readings: request 20
    with request 21's noise (one more edit) and frames handed to the wrong
    request. Returns the readings."""
    import threading
    from http.server import ThreadingHTTPServer

    from chronoedit_tpu_torch.aux.guardrails import GuardrailBlocked, Guardrails, text_guardrail
    from chronoedit_tpu_torch.pipeline.server import EditServer, ServerConfig
    from chronoedit_tpu_torch.scripts import serve as serve_cli

    cfg = pipe.config
    reqs = {seed: request(cfg, dev, seed, EDIT_H, EDIT_W, TEXT_TOKENS) for seed in range(20, 25)}
    timed = TimedPipeline(pipe, launches)
    pipe.guardrails = Guardrails(text=text_guardrail())
    srv = EditServer(timed, ServerConfig(max_batch=4, buckets=(1, 2, 4),
                                         max_wait_ms=SERVER_WAIT_MS))
    httpd = None
    try:
        first = {s: srv.submit(**reqs[s], seed=s) for s in (20, 21, 22)}  # one window
        srv.start()
        batched = {s: f.result(timeout=600) for s, f in first.items()}
        pair = {s: srv.submit(**reqs[s], seed=s) for s in (23, 24)}
        batched.update({s: f.result(timeout=600) for s, f in pair.items()})
        solo = {s: srv.submit(**reqs[s], seed=s).result(timeout=600) for s in (20, 21, 22)}

        n_batches = srv.stats["batches"]
        blocked = srv.submit(**reqs[20], seed=20, prompt="a beheading video")
        if not (blocked.done() and isinstance(blocked.exception(), GuardrailBlocked)
                and srv.stats["rejected"] == 1 and srv.stats["batches"] == n_batches):
            raise AssertionError(f"the blocked prompt was not rejected at submit: {srv.stats}")

        httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve_cli.make_handler(srv))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        posted = {}
        threads = [threading.Thread(target=lambda s=s: posted.update(
            {s: post_edit(httpd.server_address[1], reqs[s], s)})) for s in (20, 21)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        health = srv.health()
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        srv.stop()
        pipe.guardrails = None
    want_stats = {"requests": 10, "batches": 6, "batched_requests": 10, "padded_slots": 1,
                  "rejected": 1, "errors": 0}
    sizes = [b for b, _, _ in timed.batches]
    print(f"server: batches of {sizes}, stats {srv.stats}, health {health}")
    if srv.stats != want_stats or sizes != [4, 2, 1, 1, 1, 2] or sorted(posted) != [20, 21]:
        raise AssertionError(f"server: stats {srv.stats} (want {want_stats}), batch sizes "
                             f"{sizes}, HTTP answers {sorted(posted)}")

    readings = {}
    for (size, secs, peak), label in zip(timed.batches, ("4 (3 requests + 1 pad)", "2", "1",
                                                          "1", "1", "2 (HTTP)")):
        print(f"   batch of {label}: {secs:.2f} s, {size / secs:.3f} slots/s, peak {peak:.2f} GiB")
    per_bucket = {b: statistics.median(s for size, s, _ in timed.batches[:5] if size == b)
                  for b in (1, 2, 4)}
    for b, secs in per_bucket.items():
        readings[f"bucket_{b}_s"] = secs
        readings[f"bucket_{b}_slots_per_s"] = b / secs
    # the batch of 4 served 3 requests and one pad slot
    readings["bucket_4_requests_per_s"] = 3 / per_bucket[4]
    readings["peak_gib_b4"] = timed.batches[0][2]
    print(f"server seconds per batch {per_bucket}; at bucket 4 {4 / per_bucket[4]:.3f} slots/s "
          f"({per_bucket[1] * 4 / per_bucket[4]:.3f}x bucket 1's {1 / per_bucket[1]:.3f}), "
          f"{3 / per_bucket[4]:.3f} requests/s with its one pad slot; peak at B = 4 "
          f"{timed.batches[0][2]:.2f} GiB")

    for s in (20, 21, 22):
        shapes_ok = tuple(batched[s].shape) == (3, EDIT_H, EDIT_W) == tuple(solo[s].shape)
        if not (shapes_ok and bool(torch.isfinite(batched[s]).all())):
            raise AssertionError(f"request {s}: batched frame {tuple(batched[s].shape)}")
    sound = {s: psnr(batched[s], solo[s]) for s in (20, 21, 22)}
    sound.update({f"{s} (HTTP)": psnr(posted[s], solo[s]) for s in (20, 21)})
    wrong_row = min(psnr(batched[a], solo[b]) for a in (20, 21, 22) for b in (20, 21, 22)
                    if a != b)
    swapped = serve(pipe.edit_image, cfg, dev, "planted fault: request 20 with request 21's noise",
                    20, (1, 3, EDIT_H, EDIT_W), [EDIT_TOKENS] * cfg.num_steps, launches,
                    req=reqs[20], latents=torch.randn(
                        (1, cfg.latent_channels, 2, EDIT_H // 8, EDIT_W // 8),
                        generator=torch.Generator(device=dev).manual_seed(21), device=dev))[0]
    noise_swap = psnr(swapped, solo[20])
    print(f"batched against solo frames, PSNR dB: { {k: round(v, 2) for k, v in sound.items()} } "
          f"(bound {SERVE_MIN_DB} dB); planted faults: request 20 with request 21's noise "
          f"{noise_swap:.2f} dB, a frame handed to another request (the closest pair) "
          f"{wrong_row:.2f} dB")
    if not min(sound.values()) >= SERVE_MIN_DB:
        raise AssertionError(f"a batched frame differs from its solo frame: {sound}")
    readings.update(sound_min_db=min(sound.values()), noise_swap_db=noise_swap,
                    wrong_row_db=wrong_row)
    return readings


def record_refreshes(log: list):
    """Patch ``dit_forward`` to log each call's ``cache_refresh`` (harness
    code); returns the undo."""
    from chronoedit_tpu_torch.models import dit as dit_lib

    forward = dit_lib.dit_forward

    def recording(*a, cache_refresh=True, **kw):
        log.append(bool(cache_refresh))
        return forward(*a, cache_refresh=cache_refresh, **kw)

    dit_lib.dit_forward = recording
    return lambda: setattr(dit_lib, "dit_forward", forward)


def guidance_cache_path(pipe, dev, launches: tuple[Counter, Counter]) -> dict:
    """Guidance 5 with a negative prompt, batched CFG (one forward of B = 2
    a step) and sequential CFG with block 9 skipped in the unconditional
    forward (n + n - 1 blocks a step); then the block cache over blocks
    CACHE_BLOCKS on the 8-step edit, every second step (all and the rest
    of the blocks on alternate steps) and adaptive (``CACHE_THRESH``; its
    schedule must mix refresh and reuse). Each edit with exact launches; seconds and the
    cached edits' PSNR against the uncached edit of the same request
    (reported, no bar)."""
    cfg = pipe.config
    n = cfg.dit.num_layers
    steps = cfg.num_steps
    tokens = [EDIT_TOKENS] * steps
    shape = (1, 3, EDIT_H, EDIT_W)
    neg = torch.randn((1, TEXT_TOKENS, cfg.dit.text_dim),
                      generator=torch.Generator(device=dev).manual_seed(PP_NEG_SEED), device=dev)
    readings, times = {}, []
    try:
        # the pipeline phase's reference for its guided edit
        readings["cfg"] = serve(pipe.edit_image, cfg, dev, "CFG batched, guidance 5",
                                PP_CFG_SEED, shape, tokens, launches, times=times,
                                neg_prompt_emb=neg, guidance_scale=5.0)
        pipe.config = dataclasses.replace(cfg, cfg_batched=False)
        serve(pipe.edit_image, cfg, dev, "CFG sequential + SLG (9,), guidance 5", PP_CFG_SEED,
              shape, tokens, launches, times=times, blocks=[[n, n - 1]] * steps, neg_prompt_emb=neg,
              guidance_scale=5.0, slg_layers=(9,))
        readings.update(cfg_batched_s=times[0], cfg_slg_s=times[1])

        pipe.config = cfg
        ref = serve(pipe.edit_image, cfg, dev, "uncached edit", 31, shape, tokens, launches,
                    times=times)
        lo, hi = CACHE_BLOCKS
        pipe.config = dataclasses.replace(cfg, cache_blocks=CACHE_BLOCKS, cache_period=2)
        period = serve(pipe.edit_image, cfg, dev, f"cached edit {CACHE_BLOCKS}, period 2", 31,
                       shape, tokens, launches, times=times,
                       blocks=[[n] if i % 2 == 0 else [n - (hi - lo)] for i in range(steps)])
        sched = []
        undo = record_refreshes(sched)
        try:
            pipe.config = dataclasses.replace(cfg, cache_blocks=CACHE_BLOCKS,
                                              cache_thresh=CACHE_THRESH)
            # the schedule is read from the edit's own forwards once it ran
            adaptive = serve(pipe.edit_image, cfg, dev, f"cached edit {CACHE_BLOCKS}, adaptive "
                             f"threshold {CACHE_THRESH}", 31, shape, tokens, launches,
                             times=times,
                             blocks=lambda: [[n] if r else [n - (hi - lo)] for r in sched])
        finally:
            undo()
        if not 1 < sum(sched) < steps:
            raise AssertionError(f"adaptive threshold {CACHE_THRESH}: schedule {sched} does "
                                 f"not mix")
    finally:
        pipe.config = cfg
    uncached_s, period_s, adaptive_s = times[2:5]
    readings.update(uncached_s=uncached_s, period2_s=period_s, adaptive_s=adaptive_s,
                    period2_db=psnr(period, ref), adaptive_db=psnr(adaptive, ref),
                    schedule=sched)
    print(f"block cache {CACHE_BLOCKS}: period 2 {period_s:.2f} s, PSNR "
          f"{readings['period2_db']:.2f} dB; adaptive threshold {CACHE_THRESH} schedule {sched}, {adaptive_s:.2f} s, "
          f"PSNR {readings['adaptive_db']:.2f} dB; against the uncached edit {uncached_s:.2f} s "
          f"(random weights: PSNR reported, no bar)")
    return readings


def seeded_guardrail_models(g: torch.Generator):
    """Full-size SigLIP so400m + the safety MLP and RetinaFace R50 on the CPU
    in fp32 with seeded weights (harness code; the published weights are a
    download): linears and convolutions N(0, 1/fan_in), RetinaFace's heads
    100x smaller (box sizes are exponentials of their output), norms 1 +
    0.1 N, biases 0.02 N, BatchNorm statistics drawn; the classifier's
    class-0 (Safe) bias raised by 10, so that the slot passes random
    frames."""
    from chronoedit_tpu_torch.aux import face_detector as fd
    from chronoedit_tpu_torch.aux import safety_classifier as sc

    siglip = sc.SigLIPVision(sc.SigLIPVisionConfig())
    classifier = sc.SafetyClassifier(siglip.cfg.hidden_size)
    retina = fd.RetinaFace(fd.RetinaFaceConfig())
    with torch.no_grad():
        for name, p in [*siglip.named_parameters(), *classifier.named_parameters()]:
            if p.dim() == 2:
                p.normal_(0.0, p.shape[1] ** -0.5, generator=g)
            elif name.endswith(("scale", "bn_var")):
                p.normal_(1.0, 0.1, generator=g).abs_()
            elif p.dim() == 3:  # the position embedding and the probe
                p.normal_(0.0, p.shape[-1] ** -0.5, generator=g)
            else:
                p.normal_(0.0, 0.02, generator=g)
        classifier.layers[-1].bias[0] += 10.0
        heads = {id(m) for m in retina.heads.modules()}
        for m in retina.modules():
            if isinstance(m, fd.Conv):
                std = m.weight[0].numel() ** -0.5 * (0.01 if id(m) in heads else 1.0)
                m.weight.normal_(0.0, std, generator=g)
                m.bias.normal_(0.0, 0.02, generator=g)
    return siglip, classifier, retina


@contextlib.contextmanager
def tf32():
    """TF32 in matmuls and cuDNN convolutions for the block (the run keeps
    it off)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def guardrail_path(dev: torch.device) -> dict:
    """The video guardrail at full size: ``check_video`` with the SigLIP +
    MLP classifier and RetinaFace face blur on one 5-frame 720p clip on the
    card (fp32), timed; then the card against the CPU in fp32 (TF32 off):
    the SigLIP embeddings of two frames and RetinaFace's loc / conf on one
    720p frame, at least ``GUARD_MIN_DB`` over the CPU's peak, and each
    under it with TF32 on (the control) and with each planted fault. No
    hand-written kernel launches (SDPA at head dim 72, cuDNN
    convolutions)."""
    import copy
    from unittest import mock

    import numpy as np
    import torch.nn.functional as F

    from chronoedit_tpu_torch.aux import face_detector as fd
    from chronoedit_tpu_torch.aux import safety_classifier as sc
    from chronoedit_tpu_torch.aux.guardrails import Guardrails, video_guardrail
    from chronoedit_tpu_torch.kernels import build
    from chronoedit_tpu_torch.ops import layers as L

    g = torch.Generator().manual_seed(50)
    cpu_models = seeded_guardrail_models(g)
    siglip, classifier, retina = (copy.deepcopy(m).to(dev) for m in cpu_models)
    n_params = sum(p.numel() for m in cpu_models for p in m.parameters())
    boxes = []
    detect = fd.make_face_detect_fn(retina)
    guard = Guardrails(video=video_guardrail(
        classify_fn=sc.make_classify_fn(siglip, classifier),
        face_detect_fn=lambda f: boxes.append(detect(f)) or boxes[-1]))
    clip = torch.rand((1, 3, 5, EDIT_H, EDIT_W), generator=g).to(dev) * 2.0 - 1.0
    build.reset_launches()
    guard.check_video(clip)  # warm-up: cuDNN's algorithm choice, allocator
    boxes.clear()
    out, secs = host_s(lambda: guard.check_video(clip))
    launched = {k: v for k, v in build.LAUNCHES.items() if v}
    frames = ((clip[0].permute(1, 2, 3, 0).cpu().numpy() + 1) * 127.5).clip(0, 255)
    frames = frames.astype(np.uint8)
    _, classify_s = host_s(lambda: guard.video.checks[0][1](frames))
    _, detect_s = host_s(lambda: [detect(f) for f in frames])
    print(f"guardrails: SigLIP so400m + MLP and RetinaFace R50 ({n_params / 1e6:.1f} M fp32 "
          f"parameters) check_video on a 5-frame {EDIT_H}x{EDIT_W} clip {secs:.3f} s (of which "
          f"the classifier slot, host resize included, {classify_s:.3f} s and face detection "
          f"{detect_s:.3f} s, each alone); faces blurred per frame {[len(b) for b in boxes]}; "
          f"hand-written kernel launches {launched or 'none'}")
    if (out.shape != clip.shape or out.dtype != clip.dtype or out.device != clip.device
            or launched):
        raise AssertionError("check_video returned another tensor or launched a kernel")

    pixels = sc.preprocess(frames[:2], siglip.cfg)
    bgr = torch.from_numpy(np.ascontiguousarray(
        (frames[0][..., ::-1].astype(np.float32) - fd._BGR_MEANS).transpose(2, 0, 1)))[None]
    readings = {"check_video_s": secs, "classify_s": classify_s, "detect_s": detect_s}
    # the bound's readings beside the sound one: a lower precision (TF32)
    # and planted faults, each on the card against the sound CPU reference
    s_px = siglip.cfg.image_size
    unsmoothed = torch.from_numpy(np.ascontiguousarray(frames[:2])).permute(0, 3, 1, 2).float()
    unsmoothed = F.interpolate(unsmoothed, size=(s_px, s_px), mode="bicubic",
                               align_corners=False).round().clamp(0, 255)
    unsmoothed = (unsmoothed / 255.0 - 0.5) / 0.5

    def v1_bottleneck(blk, x, stride):  # ResNet v1: the stride on the 1x1 conv
        out = fd._conv(blk["conv1"], x, stride=stride, relu=True)
        out = fd._conv(blk["conv3"], fd._conv(blk["conv2"], out, pad=1, relu=True))
        return F.relu(out + (fd._conv(blk["down"], x, stride=stride) if "down" in blk else x))

    controls = {
        "SigLIP": {"no antialias in the resize": (contextlib.nullcontext, unsmoothed),
                   "exact GELU for the tanh one": (
                       lambda: mock.patch.object(L, "gelu_tanh", F.gelu), None)},
        "RetinaFace": {"FPN upsampling nearest for nearest-exact": (
                           lambda: mock.patch.object(fd, "_upsample_to", lambda x, like: (
                               F.interpolate(x, size=like.shape[2:], mode="nearest"))), None),
                       "ResNet v1 bottleneck": (
                           lambda: mock.patch.object(fd, "_bottleneck", v1_bottleneck), None)}}
    card_models = (siglip, classifier, retina)
    for label, fn, inputs in (
            ("SigLIP embedding, 2 frames", lambda m, x: (sc.siglip_encode(m[0], x),),
             pixels),
            ("RetinaFace loc / conf, one 720p frame",
             lambda m, x: fd.retinaface_forward(m[2], x), bgr)):
        want = fn(cpu_models, inputs)

        def card_db(x):
            return min(peak_db(a.float().cpu(), b) for a, b in zip(fn(card_models, x.to(dev)),
                                                                    want))

        got = fn(card_models, inputs.to(dev))
        dbs = [peak_db(a.float().cpu(), b) for a, b in zip(got, want)]
        print(f"guardrail reference ({label}): card fp32 against CPU fp32 "
              f"{', '.join(f'{d:.2f}' for d in dbs)} dB over the CPU's peak (bound "
              f"{GUARD_MIN_DB} dB)")
        readings[label] = min(dbs)
        with tf32():
            seen = {"TF32 on (the control)": card_db(inputs)}
        for fault, (planted, x) in controls[label.split()[0]].items():
            with planted():
                seen[f"planted: {fault}"] = card_db(inputs if x is None else x)
        print("   " + "; ".join(f"{k} {v:.2f} dB ({'under' if v < GUARD_MIN_DB else 'over'} "
                                 f"the bound)" for k, v in seen.items()))
        readings.update({f"{label}: {k}": v for k, v in seen.items()})
        if not min(dbs) >= GUARD_MIN_DB:
            raise AssertionError(f"guardrail reference {label}: {dbs} dB")
        if not max(seen.values()) < GUARD_MIN_DB:
            raise AssertionError(f"guardrail reference {label}: the bound {GUARD_MIN_DB} dB "
                                 f"does not see {seen}")
    # the detector's forward alone (warm, one frame): the rest of a
    # detection is the host's decode and NMS
    _, readings["retinaface_forward_s"] = host_s(lambda: fd.retinaface_forward(
        retina, bgr.to(dev)))
    print(f"RetinaFace forward alone on one {EDIT_H}x{EDIT_W} frame "
          f"{readings['retinaface_forward_s'] * 1e3:.1f} ms (fp32, TF32 off) against "
          f"{detect_s / len(frames) * 1e3:.1f} ms a frame for the whole detection")
    return readings


def expected_train_launches(cfg, remat: str = "full", lora: bool = True, int4: bool = False,
                            image: bool = True, steps: int = 1, forwards: int = 0
                            ) -> tuple[dict[str, int], dict[str, dict[int, int]]]:
    """Kernel launches of ``steps`` train steps at the edit's geometry and
    ``forwards`` forward-only passes (validation). A step runs the blocks'
    forward once, and again in the backward's recompute unless ``remat`` is
    "none" ("matmul_only" recomputes every kernel: it keeps products
    only): each block's attentions (self, text, and image unless ``image``
    is False), 2 LN-modulates, 2 gated residuals and the RMSNorms (self q,
    k; cross q; text k; image k), with the head's LN-modulate once a
    forward. The backward runs K6 for every attention (q always needs a
    gradient) and K7 for self and text, and for the image one too when
    every parameter trains (``lora`` False: the image context then needs a
    gradient; LoRA leaves k_img / v_img frozen). ``int4`` (QLoRA over
    w4a16): each block's 12 projections run K8 in each forward, 8 over the
    edit's tokens and 2 each over the text and image contexts. Returns
    ({name: count}, {name: {KV length or int4 rows: count}}), as
    ``read_launches``."""
    n = cfg.dit.num_layers
    fwd = steps * (1 if remat == "none" else 2) + forwards
    kvs = [EDIT_TOKENS, TEXT_TOKENS] + ([IMAGE_TOKENS] if image else [])
    dkv = [EDIT_TOKENS, TEXT_TOKENS] if lora else kvs
    rows = {EDIT_TOKENS: 8 * n * fwd, TEXT_TOKENS: 2 * n * fwd}
    if image:
        rows[IMAGE_TOKENS] = 2 * n * fwd
    rows = rows if int4 else {}
    by_name = {"flash_fwd": len(kvs) * n * fwd, "ln_modulate": 2 * n * fwd + steps + forwards,
               "gated_residual": 2 * n * fwd, "rms_norm": (len(kvs) + 2) * n * fwd,
               "flash_bwd_dq": len(kvs) * n * steps, "flash_bwd_dkv": len(dkv) * n * steps,
               "int4_matmul": sum(rows.values()), "flash_fwd_qk8": 0,
               **dict.fromkeys(GROUPED + TP_NORMS, 0)}
    by_kv = {"flash_fwd": {kv: n * fwd for kv in kvs},
             "flash_bwd_dq": {kv: n * steps for kv in kvs},
             "flash_bwd_dkv": {kv: n * steps for kv in dkv},
             "int4_matmul": rows, "flash_fwd_qk8": {}, **{name: {} for name in GROUPED}}
    return by_name, by_kv


def base_checksum(model) -> int:
    """``tensor_checksum`` summed over every parameter and buffer
    (quantized leaves hold buffers)."""
    return sum(tensor_checksum(t) for t in list(model.parameters()) + list(model.buffers()))


def train_batches(pipe, n: int = 3) -> list[dict]:
    """``n`` 720p mock edit pairs through ``mock_batch_iterator`` (the
    pipeline's VAE encodes them): the training paths' batches."""
    from chronoedit_tpu_torch.data.mock import MockEditDataset, mock_batch_iterator

    cfg = pipe.config
    d = cfg.dit
    dataset = MockEditDataset(height=EDIT_H, width=EDIT_W, text_tokens=TEXT_TOKENS,
                              text_dim=d.text_dim, image_tokens=d.image_tokens,
                              image_dim=d.image_dim, seed=30)
    batches_it = mock_batch_iterator(pipe.vae, cfg, dataset)
    batches, secs = host_s(lambda: [next(batches_it) for _ in range(n)])
    b0 = batches[0]
    print(f"training batches: {n} mock 720p edit pairs through edit_training_batch in "
          f"{secs:.2f} s: latents {tuple(b0['latents'].shape)}, condition "
          f"{tuple(b0['condition'].shape)}, text {tuple(b0['text_emb'].shape)}, image "
          f"{tuple(b0['image_emb'].shape)}")
    if (tuple(b0["latents"].shape) != (1, 16, 2, EDIT_H // 8, EDIT_W // 8)
            or tuple(b0["condition"].shape) != (1, 20, 2, EDIT_H // 8, EDIT_W // 8)):
        raise AssertionError("edit_training_batch gave the wrong shapes")
    return batches


def lora_steps(label: str, base, state, step, batches, dev, launches: tuple[Counter, Counter],
               want, n: int) -> dict:
    """``n`` LoRA steps of ``state`` over ``base`` on ``batches`` (cycled),
    each with the counters zeroed just before it and compared with ``want``
    just after; loss and grad_norm finite (grad_norm > 0). Adds the launches
    to ``launches``; returns the first step's seconds, the median of the
    rest and the peak memory."""
    from chronoedit_tpu_torch.kernels import build

    g = torch.Generator(device=dev).manual_seed(31)
    times, peaks = [], []
    for i in range(n):
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        metrics, secs = host_s(lambda: step(state, base, batches[i % len(batches)], g))
        got = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        times.append(secs)
        peaks.append(peak)
        print(f"{label} step {i} ({'cold' if i == 0 else 'warm'}): {secs:.3f} s, peak memory "
              f"{peak:.2f} GiB, loss {loss:.5f}, grad_norm {gnorm:.4e}; launches {got[0]}; "
              f"by KV length / int4 rows {got[1]}")
        if got != want:
            raise AssertionError(f"{label} step {i}: launches {got}, the path implies {want}")
        if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0):
            raise AssertionError(f"{label} step {i}: loss {loss}, grad_norm {gnorm}")
        for total, counts in zip(launches, (got[0], got[1]["flash_fwd"])):
            total.update(counts)
    warm = statistics.median(times[1:])
    print(f"{label} at 720p: first step {times[0]:.3f} s, median of the rest {warm:.3f} s, "
          f"peak {max(peaks):.2f} GiB")
    return {"first_s": times[0], "warm_s": warm, "peak_gib": max(peaks)}


def free() -> None:
    """Collect what was dropped (an optimizer's state sits in reference
    cycles) and return the cached blocks to the card."""
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def compact_workers():
    """Worker processes started inside take expandable segments
    (``PYTORCH_CUDA_ALLOC_CONF``, read when a process starts), so that each
    rank's reserved memory stays near what it holds and P ranks' peaks fit
    on the card side by side: without it the pipe-4 world of
    ``pipeline_path`` ran out of memory in its VAE encode in some runs on
    an H100 80GB HBM3 (78-79 GiB in use, about 13 GiB held by the failing
    rank), and in others one rank's VAE decode gave other bits than its
    peers' from the same latents, with 6 GiB of the card free
    (``--trace-pipe-ranks``): the replicated decode under memory
    pressure, not the pipeline. One rank to a card, as torchrun runs
    them, has the card's memory to itself."""
    old = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        yield
    finally:
        if old is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = old


def wait_for_card(label: str, need_gib: float, timeout: float = 120.0) -> None:
    """Return once the card has ``need_gib`` GiB free (``mem_get_info``,
    over every process), printing what it found: a world of worker
    processes that just ended may not have handed all its memory back
    yet. Raises after ``timeout`` seconds."""
    t0 = time.perf_counter()
    while True:
        free_b, total = torch.cuda.mem_get_info()
        waited = time.perf_counter() - t0
        if free_b >= need_gib * 2 ** 30:
            print(f"{label}: {free_b / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB of the card "
                  f"free after {waited:.1f} s (this process holds "
                  f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB)", flush=True)
            return
        if waited > timeout:
            raise AssertionError(f"{label}: {free_b / 2 ** 30:.2f} GiB of the card free after "
                                 f"{waited:.0f} s, {need_gib} needed")
        time.sleep(1.0)


def check_adapters_moved(label: str, lora) -> None:
    """Every adapter's b has moved from its zero init."""
    from chronoedit_tpu_torch.models import lora as lora_lib

    moved = [bool(ad.b.detach().any()) for blk in lora.blocks
             for _, ad in lora_lib.iter_adapters(blk)]
    if not all(moved):
        raise AssertionError(f"{label}: {moved.count(False)} adapters' b did not move")


def training_path(pipe, dev, launches: tuple[Counter, Counter], batches: list[dict],
                  profile_dir: Path | None) -> dict:
    """The slice at full width: rank-32 LoRA on the default targets over the
    frozen bf16 DiT, three ``make_lora_train_step`` calls under remat
    "full", then two under remat "matmul_only" (fresh adapters: the seconds
    and peak memory of keeping the blocks' products), on 720p mock edit
    pairs. The counters are zeroed before each step and must show the
    launches the path implies; every loss and grad_norm is finite
    (grad_norm > 0), every adapter's b has moved after each mode's steps
    (the warm-up gives the first update learning rate 0) and the base's bits
    are unchanged. Adds the steps' launches to ``launches``; returns the
    step readings by remat mode."""
    from chronoedit_tpu_torch.models import lora as lora_lib
    from chronoedit_tpu_torch.train import lora_train, train_step

    cfg = pipe.config
    checksum = base_checksum(pipe.dit)
    lcfg = lora_lib.LoRAConfig()
    tcfg = train_step.TrainConfig(lr=1e-4, warmup_steps=1)
    out = {}
    for remat, n in (("full", 3), ("matmul_only", 2)):
        pipe.dit.cfg = dataclasses.replace(pipe.dit.cfg, remat=remat)
        lora = lora_lib.init_lora_params(torch.Generator(device=dev).manual_seed(31), pipe.dit,
                                         lcfg)
        state = lora_train.make_lora_train_state(lora, tcfg)
        step = lora_train.make_lora_train_step(pipe.dit.cfg, tcfg)
        n_lora = sum(p.numel() for p in lora.parameters())
        print(f"LoRA rank {lcfg.rank} on {len(lcfg.targets)} targets x {len(lora.blocks)} "
              f"blocks: {n_lora / 1e6:.2f} M fp32 parameters; remat {remat!r}; "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before the first step")
        out[remat] = lora_steps(f"LoRA train (remat {remat})", pipe.dit, state, step, batches,
                                dev, launches, expected_train_launches(cfg, remat=remat), n)
        check_adapters_moved(f"LoRA (remat {remat})", lora)
        if profile_dir is not None and remat == "full":
            g = torch.Generator(device=dev).manual_seed(32)
            profile_stages({"lora_train_step": lambda: step(state, pipe.dit, batches[0], g)},
                           profile_dir)
        del lora, state, step
        free()
    pipe.dit.cfg = dataclasses.replace(pipe.dit.cfg, remat="full")
    if base_checksum(pipe.dit) != checksum:
        raise AssertionError("the frozen base's weights changed")
    print("LoRA training: every b moved in each mode, base bits unchanged")
    return out


def w4a16_path(pipe, dev, launches: tuple[Counter, Counter], refs: dict[int, torch.Tensor],
               batches: list[dict], profile_dir: Path | None) -> dict:
    """Quantize the pipeline's DiT in place to w4a16 (the Lloyd grid, all 12
    projections of every block: K8), outside ``inference_mode`` (QLoRA
    trains over it); three QLoRA steps (rank 32, remat "full": the adapters
    as side branches, K8 under autograd in the forward and the recompute)
    with exact launches by kernel, KV length and K8 rows, finite loss and
    grad_norm, every b moved and the base's bits (its int4 buffers)
    unchanged; then, in ``inference_mode``, a 720p edit and the reasoning
    drop (k = 2) with int8 scores (K9 at 28,800 tokens), each with exact
    launch counts and its PSNR against the bf16 output of the same request
    and noise (``refs``, by seed); then a warm w4a16 DiT forward, profiled
    when ``profile_dir`` is set. Returns the QLoRA step readings."""
    from chronoedit_tpu_torch.models import lora as lora_lib
    from chronoedit_tpu_torch.train import lora_train, train_step

    cfg = pipe.config
    _, secs = host_s(lambda: pipe.quantize(mode="int4"))
    print(f"quantized in place to w4a16 (Lloyd grid) in {secs:.1f} s: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated (DiT and VAE)")
    checksum = base_checksum(pipe.dit)
    lcfg = lora_lib.LoRAConfig()
    if not lora_lib.base_is_quantized(pipe.dit, lcfg):
        raise AssertionError("the w4a16 base does not read as quantized")
    lora = lora_lib.init_lora_params(torch.Generator(device=dev).manual_seed(33), pipe.dit, lcfg)
    tcfg = train_step.TrainConfig(lr=1e-4, warmup_steps=1)
    state = lora_train.make_lora_train_state(lora, tcfg)
    step = lora_train.make_lora_train_step(pipe.dit.cfg, tcfg)
    print(f"QLoRA rank {lcfg.rank} over the w4a16 base (remat {pipe.dit.cfg.remat!r}): "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before the first step")
    readings = lora_steps("QLoRA train (w4a16 base)", pipe.dit, state, step, batches, dev,
                          launches, expected_train_launches(cfg, int4=True), 3)
    check_adapters_moved("QLoRA", lora)
    if base_checksum(pipe.dit) != checksum:
        raise AssertionError("the quantized base's bits changed")
    print("QLoRA: every b moved, the base's int4 bits unchanged")
    if profile_dir is not None:
        g = torch.Generator(device=dev).manual_seed(34)
        profile_stages({"qlora_train_step": lambda: step(state, pipe.dit, batches[0], g)},
                       profile_dir)
    del lora, state, step
    free()

    with torch.inference_mode():
        out = serve(pipe.edit_image, cfg, dev, "w4a16 edit", 10, (1, 3, EDIT_H, EDIT_W),
                    [EDIT_TOKENS] * cfg.num_steps, launches, int4=True)
        print(f"   PSNR against the bf16 edit of the same request and noise "
              f"{psnr(out, refs[10]):.2f} dB (random weights: no bar)")
        pipe.dit.cfg = dataclasses.replace(pipe.dit.cfg, attn_qk_int8=True)
        steps = cfg.num_steps
        out = serve(pipe, cfg, dev, "w4a16 + int8-score reasoning edit (drop, k = 2)", 21,
                    (1, 3, 5, EDIT_H, EDIT_W),
                    [REASONING_TOKENS] * 2 + [EDIT_TOKENS] * (steps - 2),
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
    return readings


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


def write_train_data(root: Path, prompts: dict[str, list]) -> Path:
    """A metadata directory for the training CLI, written as a user writes
    it: a 720p ``image`` / ``edit_image`` PNG pair (seeded noise) and a
    ``.npy`` of the prompt's token ids for each of ``prompts`` (from
    ``train_prompt_refs``), then ``scripts/extract_umt5`` on the checkpoint
    directory's UMT5-XXL over the ids column, which writes the ``umt5_emb``
    pickles and column. Each pickle must be bitwise the loaded pipeline's
    ``encode_ids`` on the same ids (``prompts["emb"]``). Returns
    ``metadata.csv``."""
    import csv
    import pickle

    import numpy as np
    from PIL import Image

    from chronoedit_tpu_torch.scripts import extract_umt5

    root.mkdir(parents=True)
    rng = np.random.default_rng(50)
    rows = []
    for i, ids in enumerate(prompts["ids"]):
        for name in ("image", "edit_image"):
            Image.fromarray(rng.integers(0, 256, (EDIT_H, EDIT_W, 3), dtype=np.uint8)).save(
                root / f"{name}{i}.png")
        np.save(root / f"ids{i}.npy", ids)
        rows.append(f"image{i}.png,edit_image{i}.png,edit {i},ids{i}.npy")
    meta = root / "metadata.csv"
    meta.write_text("image,edit_image,prompt,prompt_ids\n" + "\n".join(rows) + "\n")
    argv = ["--metadata", str(meta), "--checkpoint-dir", str(CHECKPOINT_DIR),
            "--ids-column", "prompt_ids", "--output-dir", str(root / "umt5")]
    outs, secs = host_s(lambda: extract_umt5.main(argv))
    written = [row["umt5_emb"] for row in csv.DictReader(open(meta))]
    for i, (out, want) in enumerate(zip(outs, prompts["emb"])):
        with open(out, "rb") as f:
            got = pickle.load(f)
        if got.dtype != want.dtype or got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"extract_umt5: row {i}'s pickle is not encode_ids' on the "
                                 f"same ids ({got.dtype} {got.shape})")
    if written != outs or len(outs) != len(prompts["ids"]):
        raise AssertionError(f"extract_umt5: metadata's umt5_emb column {written}, wrote {outs}")
    print(f"training data: {len(outs)} 720p PNG pairs; extract_umt5 (UMT5-XXL from the "
          f"checkpoint directory, {TEXT_TOKENS} ids with {PROMPT_LEN} unmasked) in {secs:.1f} s, "
          f"its pickles bitwise encode_ids' on the same ids, the umt5_emb column written")
    free()
    return meta


def cli_path(dev: torch.device, cfg, launches: tuple[Counter, Counter],
             prompts: dict[str, list]) -> dict:
    """The training CLIs as a user runs them: ``scripts.extract_umt5`` for
    the prompts' embeddings (``write_train_data``), then
    ``scripts.train.main`` with
    ``--experiment chronoedit_14b --lora-rank 32 --remat full --grad-accum
    2 --max-iter 4`` over the checkpoint directory's diffusers shards
    (``--base-checkpoint``) on that metadata file of two 720p pairs with
    their UMT5 embeddings, encoded by the CLI's random VAE.
    Four step calls (micro-steps, as JAX's loop counts them: two applied
    updates, the second at a learning rate above 0) with exact launches
    (no image context: the metadata path has none), every b moved, the
    exported ``lora.safetensors`` equal to the trained adapters; then
    ``load_pipeline(cfg, dir, loras=[(that file, 1.0)])`` serves one 720p
    edit with exact launches. Returns the readings and the first prompt's
    embedding as the CLI wrote it."""
    import pickle

    from safetensors.torch import load_file

    from chronoedit_tpu_torch.kernels import build
    from chronoedit_tpu_torch.models import lora as lora_lib
    from chronoedit_tpu_torch.models import weights as w
    from chronoedit_tpu_torch.pipeline.loader import load_pipeline
    from chronoedit_tpu_torch.scripts import train as train_cli

    data_dir, out_dir = CHECKPOINT_DIR.parent / "smoke_train_data", CHECKPOINT_DIR / "trained"
    meta = write_train_data(data_dir, prompts)
    with open(data_dir / "umt5" / f"{0:08d}.pkl", "rb") as f:
        first_emb = pickle.load(f)
    argv = ["--experiment", "chronoedit_14b", "--set", f"dit.num_layers={MAIN_BLOCKS}",
            "--lora-rank", "32", "--remat", "full",
            "--grad-accum", "2", "--max-iter", "4", "--base-checkpoint",
            str(CHECKPOINT_DIR / "transformer" / "*.safetensors"), "--data", str(meta),
            "--base-path", str(data_dir), "--checkpoint-dir", str(out_dir)]
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    state, secs = host_s(lambda: train_cli.main(argv))
    got = read_launches()
    want = expected_train_launches(cfg, image=False, steps=4)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"training CLI ({' '.join(argv[:12])} ...): {secs:.1f} s from the call to the "
          f"exported file (DiT load, VAE encodes and 4 micro-steps), peak {peak:.2f} GiB; "
          f"{state.step} step calls, {state.optimizer.gradient_step} applied updates; launches "
          f"{got[0]}, by KV length {got[1]}")
    if got != want:
        raise AssertionError(f"training CLI: launches {got}, the path implies {want}")
    if state.step != 4 or state.optimizer.gradient_step != 2:
        raise AssertionError("training CLI: not 4 micro-steps and 2 updates")
    check_adapters_moved("training CLI", state.lora)
    path = out_dir / "lora.safetensors"
    sd = load_file(str(path))
    modules = {t: m for m, t in w.LORA_NAMES.items()}  # target -> diffusers module
    n_equal = 0
    for i, blk in enumerate(state.lora.blocks):
        for target, ad in lora_lib.iter_adapters(blk):
            prefix = f"transformer.blocks.{i}.{modules[target]}"
            for key, t in (("lora_A.weight", ad.a.T), ("lora_B.weight", ad.b.T)):
                if not torch.equal(sd[f"{prefix}.{key}"], t.detach().cpu()):
                    raise AssertionError(f"exported {prefix}.{key} differs from the trained one")
                n_equal += 1
    print(f"   {path.name}: {path.stat().st_size / 1e6:.1f} MB, {n_equal} adapter tensors "
          f"bitwise the trained ones (fp32, alpha = rank)")
    del state
    free()
    pipe, load_s = host_s(lambda: load_pipeline(cfg, str(CHECKPOINT_DIR), loras=[(str(path), 1.0)],
                                                 with_text_encoder=False,
                                                 with_image_encoder=False, device=dev))
    print(f"loaded the pipeline with the trained LoRA in {load_s:.1f} s "
          f"({ {k: round(v, 2) for k, v in pipe.load_seconds.items()} })")
    with torch.inference_mode():
        serve(pipe.edit_image, cfg, dev, "edit with the CLI-trained LoRA", 13,
              (1, 3, EDIT_H, EDIT_W), [EDIT_TOKENS] * cfg.num_steps, launches)
    del pipe
    free()
    shutil.rmtree(data_dir, ignore_errors=True)
    return {"seconds": secs, "peak_gib": peak, "prompt_emb": first_emb}



# the Trainer's DiT: the 14B model's width at this depth (full-parameter
# training of all 40 blocks needs about 197 GB: 16.39 B parameters x 12
# bytes of bf16 parameters, gradients, two AdamW moments, EMA and
# accumulator)
TRAINER_BLOCKS = 1
# the training-time render (EveryNDrawSample over make_sample_fn): after
# iteration RENDER_EVERY of the straight run, RENDER_STEPS solver steps, and
# the hand-written kernels its trace must name
RENDER_EVERY = 2
RENDER_STEPS = 2
RENDER_KERNELS = ("flash_fwd_wgmma_kernel", "ln_modulate_ring_kernel", "gated_residual_kernel",
                  "rms_norm_ring_kernel")


def trainer_path(dev: torch.device, launches: tuple[Counter, Counter], root: Path,
                 prompt_emb) -> dict:
    """The ``Trainer`` (full-parameter, the only mode JAX's runs) on the 14B
    DiT's width at ``TRAINER_BLOCKS`` blocks, remat "none", 720p mock pairs
    from a seeded full-width VAE: ``grad_accum = 2``, a checkpoint every 2
    iterations, validation every 2 (one batch), ``guard_host_sync`` on (no
    synchronising CUDA call inside a micro-step), the iteration-speed,
    heartbeat, device-monitor and loss-logger callbacks, and the launch
    counters zeroed at each iteration's start and read at its end (two
    micro-steps, and a validation forward where due). 4 iterations straight
    (no checkpoints), then 2 with a checkpoint at 2, a fresh trainer
    resuming from it, and 2 more: the two end states (parameters, EMA, moments, accumulator,
    counters) must be bitwise equal (K6/K7 are deterministic). Then a timed
    synchronous save and restore of the state (GB/s), and the checkpoint
    through ``convert_weights`` to diffusers safetensors and back, bitwise.
    The straight run also renders the edit under the EMA weights once,
    after iteration RENDER_EVERY (``render_check``: ``EveryNDrawSample``
    over ``make_sample_fn`` on a one-item ``PromptItemDataset`` of a 720p
    image and ``prompt_emb``, the first training prompt's embedding as
    ``extract_umt5`` wrote it). Its files go under ``root``, which it
    removes. Returns the readings."""
    from chronoedit_tpu_torch.configs import chronoedit_14b
    from chronoedit_tpu_torch.data.mock import MockEditDataset, mock_batch_iterator
    from chronoedit_tpu_torch.kernels import build
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.models import vae as vae_lib
    from chronoedit_tpu_torch.scripts import convert_weights
    from chronoedit_tpu_torch.train import callbacks as cb
    from chronoedit_tpu_torch.train import checkpoint as ck
    from chronoedit_tpu_torch.train import train_step
    from chronoedit_tpu_torch.train.trainer import Trainer, TrainerConfig
    from chronoedit_tpu_torch.utils import sanitize

    pipe_cfg = chronoedit_14b()
    cfg = dataclasses.replace(pipe_cfg.dit, num_layers=TRAINER_BLOCKS, remat="none")
    small = dataclasses.replace(pipe_cfg, dit=cfg)
    vae = vae_lib.init_vae_params(pipe_cfg.vae, torch.Generator(device=dev).manual_seed(60),
                                  device=dev)
    it = mock_batch_iterator(vae, small, MockEditDataset(
        height=EDIT_H, width=EDIT_W, text_tokens=TEXT_TOKENS, text_dim=cfg.text_dim,
        image_tokens=cfg.image_tokens, image_dim=cfg.image_dim, seed=61))
    batches, val = [next(it) for _ in range(8)], [next(it) for _ in range(2)]
    del it
    torch.cuda.empty_cache()
    renders = []
    tcfg = train_step.TrainConfig(lr=1e-4, warmup_steps=1, grad_accum=2)
    iter_s = []

    class Launches(cb.Callback):
        """Zero the counters as an iteration starts; at its end they must
        hold its two micro-steps and, where due, one validation forward."""

        def on_step_start(self, trainer, step):
            torch.cuda.synchronize()
            self.t0 = time.perf_counter()
            build.reset_launches()

        def on_step_end(self, trainer, step, metrics):
            torch.cuda.synchronize()
            iter_s.append(time.perf_counter() - self.t0)
            got = read_launches()
            want = expected_train_launches(small, remat="none", lora=False, steps=2,
                                           forwards=int("val_loss" in metrics))
            if got != want:
                raise AssertionError(f"Trainer iteration {step}: launches {got}, the path "
                                     f"implies {want}")
            for total, counts in zip(launches, (got[0], got[1]["flash_fwd"])):
                total.update(counts)

    def model():
        dit = dit_lib.init_dit_params(cfg, torch.Generator(device=dev).manual_seed(62),
                                      device=dev)
        with torch.no_grad():  # a zero head would stop every block's gradient
            w = dit.head.proj.weight
            w.uniform_(-w.shape[1] ** -0.5, w.shape[1] ** -0.5,
                       generator=torch.Generator(device=dev).manual_seed(63))
        return dit

    class SaveTime(cb.Callback):
        """The seconds of each save: from the last step-end hook (the save
        follows it) to the save's own hook."""

        def on_step_end(self, trainer, step, metrics):
            self.t0 = time.perf_counter()

        def on_checkpoint_save(self, trainer, step):
            save_s.append(time.perf_counter() - self.t0)

    save_s = []

    def run(directory, max_iter, skip, checkpoints=True, async_save=True, render=False):
        lines = []
        dit = model()
        callbacks = [Launches(), cb.IterSpeedCallback(log_every=1, log_fn=lines.append),
                     cb.HeartbeatCallback(path=str(directory / "heartbeat.txt"), every_s=0.0),
                     cb.DeviceMonitorCallback(every_n=1, log_fn=lines.append),
                     cb.LossLoggerCallback(str(directory / "loss.jsonl"), log_every=1),
                     SaveTime()]
        if render:  # after Launches, which reads the iteration's own counts first
            callbacks.append(cb.EveryNDrawSample(
                RENDER_EVERY, render_check(small, dit, vae, root, prompt_emb, dev, launches,
                                           renders),
                out_dir=str(directory / "samples"), guidance_sweep=(1.0,)))
        trainer = Trainer(cfg, tcfg, TrainerConfig(max_iter=max_iter, save_every=2,
                                                   validate_every=2, validate_batches=1,
                                                   guard_host_sync=True),
                          ck.CheckpointConfig(directory=str(directory), max_to_keep=1,
                                              async_save=async_save)
                          if checkpoints else None, callbacks)
        state = trainer.init_state(dit)
        state = trainer.train(state, iter(batches[2 * skip:]), val_data=iter(val[skip // 2:]))
        for line in lines:
            print(f"   {line}")
        return state

    # the guard bites on the card: a read of a device value inside it raises
    try:
        with sanitize.no_host_sync():
            float(torch.ones(2, device=dev).sum())
    except RuntimeError as e:
        print(f"no_host_sync on the card: a float() of a device sum raised ({e})")
    else:
        raise AssertionError("no_host_sync let a device read through")
    print(f"Trainer: the 14B DiT's width at {TRAINER_BLOCKS} blocks, full-parameter, "
          f"grad_accum 2, remat 'none', 720p mock pairs, guard_host_sync on")
    torch.cuda.reset_peak_memory_stats()
    straight, secs = host_s(lambda: run(root / "a", 4, 0, checkpoints=False, render=True))
    peak = torch.cuda.max_memory_allocated() / 2**30
    if len(renders) != 1:
        raise AssertionError(f"the training-time render ran {len(renders)} times, not once")
    del vae
    want = ck.state_tensors(straight), ck.state_counters(straight)
    n_params = sum(p.numel() for p in straight.params)
    print(f"Trainer, {n_params / 1e9:.3f} B parameters, 4 iterations straight (no "
          f"checkpoints): {secs:.1f} s, "
          f"iterations {[round(t, 3) for t in iter_s]} s, peak {peak:.2f} GiB, counters "
          f"{want[1]}")
    shutil.rmtree(root / "a", ignore_errors=True)
    del iter_s[:]
    first = run(root / "b", 2, 0)
    del first
    free()
    del save_s[:]
    resumed, secs = host_s(lambda: run(root / "b", 4, 2, async_save=False))
    got = ck.state_tensors(resumed), ck.state_counters(resumed)
    differ = [k for k in want[0] if not torch.equal(want[0][k], got[0][k])]
    print(f"Trainer, 2 iterations (an async save at 2) then a resume from that checkpoint "
          f"and 2 more (a synchronous save at 4): {secs:.1f} s for the resumed part, "
          f"iterations {[round(t, 3) for t in iter_s]} s; against the straight run "
          f"{len(want[0]) - len(differ)} of {len(want[0])} tensors bitwise, counters {got[1]} "
          f"vs {want[1]}")
    if differ or got[1] != want[1]:
        raise AssertionError(f"the resumed run differs from the straight one: {differ[:4]}")

    nbytes = sum(t.numel() * t.element_size() for t in got[0].values())
    mgr = ck.CheckpointManager(ck.CheckpointConfig(directory=str(root / "b"),
                                                   async_save=False))
    save_s = save_s[-1]  # the resumed run's save at 4
    _, restore_s = host_s(lambda: mgr.restore(straight))
    again = [k for k, t in ck.state_tensors(straight).items() if not torch.equal(t, got[0][k])]
    print(f"checkpoint of the state: {nbytes / 1e9:.2f} GB; synchronous save {save_s:.2f} s "
          f"({nbytes / save_s / 1e9:.2f} GB/s, device to host included), restore into the live "
          f"state {restore_s:.2f} s ({nbytes / restore_s / 1e9:.2f} GB/s); restored "
          f"{'bitwise' if not again else f'with {len(again)} tensors differing'}")
    if again:
        raise AssertionError(f"the restored state differs: {again[:4]}")

    flags = ["--experiment", "chronoedit_14b", "--num-layers", str(TRAINER_BLOCKS)]
    dst = root / "dit.safetensors"
    _, to_s = host_s(lambda: convert_weights.main(
        ["checkpoint-to-diffusers", str(root / "b"), str(dst)] + flags))
    _, from_s = host_s(lambda: convert_weights.main(
        ["diffusers-to-checkpoint", str(dst), str(root / "params")] + flags))
    back = ck.load_params(str(root / "params"))
    params = dict(zip((n for n, _ in resumed.model.named_parameters()), resumed.params))
    differ = [n for n, p in params.items() if not torch.equal(back[n].to(dev), p)]
    print(f"convert_weights: checkpoint-to-diffusers {to_s:.1f} s, diffusers-to-checkpoint "
          f"{from_s:.1f} s; {len(params) - len(differ)} of {len(params)} parameters back "
          f"bitwise")
    if differ or back.keys() != params.keys():
        raise AssertionError(f"convert_weights round trip differs: {differ[:4]}")
    shutil.rmtree(root, ignore_errors=True)
    del straight, resumed, want, got, params, back
    free()
    return {"peak_gib": peak, "save_gbps": nbytes / save_s / 1e9,
            "restore_gbps": nbytes / restore_s / 1e9, "checkpoint_gb": nbytes / 1e9,
            "render": renders[0]}


def render_check(pipe_cfg, dit, vae, root: Path, prompt_emb, dev,
                 launches: tuple[Counter, Counter], renders: list):
    """The ``sample_fn`` that ``EveryNDrawSample`` calls in the Trainer:
    ``make_sample_fn`` over a one-item ``PromptItemDataset`` (a seeded
    720p image and ``prompt_emb``, written under ``root``) on a pipeline of
    the trained ``dit`` and ``vae``, RENDER_STEPS steps, traced by
    ``utils/profiling.profile_trace``. Around the render it checks that the
    frame is bitwise a direct ``pipe(...)`` call with the EMA copied into
    the DiT by hand (the trained parameters copied back after), that the
    trained parameters are bitwise unchanged and in their own storage
    after it, that the launch counters hold exactly one render's (no image
    context: the item has no CLIP embedding), added to ``launches``, and
    that the Chrome trace names every kernel of RENDER_KERNELS. Appends the
    readings to ``renders``; gives the callback the edited frame."""
    from chronoedit_tpu_torch.data.item_dataset import (PromptItemDataset, make_sample_fn,
                                                        write_item_dataset)
    from chronoedit_tpu_torch.kernels import build
    from chronoedit_tpu_torch.pipeline.edit_pipeline import ChronoEditPipeline
    from chronoedit_tpu_torch.utils.profiling import kernel_names, profile_trace

    g = torch.Generator(device=dev).manual_seed(64)
    image = (torch.rand((3, EDIT_H, EDIT_W), generator=g, device=dev) * 2 - 1).cpu().numpy()
    write_item_dataset(str(root / "items"), [{"prompt": "edit 0", "image": image,
                                               "t5_text_embeddings": prompt_emb}])
    items = PromptItemDataset(str(root / "items"), max_t5_length=TEXT_TOKENS)
    pipe = ChronoEditPipeline(pipe_cfg, dit, vae)
    fn = make_sample_fn(pipe, items, num_steps=RENDER_STEPS)

    def sample(params, guidance):
        own = list(dit.parameters())
        before = [p.detach().clone() for p in own]
        ptrs = [p.data_ptr() for p in own]
        if all(torch.equal(e, p) for e, p in zip(params, own)):
            raise AssertionError("the render's EMA equals the trained parameters")
        torch.cuda.synchronize()
        build.reset_launches()
        with profile_trace(str(root / "trace"), device=dev) as trace:
            frame, secs = host_s(lambda: fn(params, guidance))
        got = read_launches()
        want = expected_launches(pipe_cfg, [EDIT_TOKENS] * RENDER_STEPS, image=False)
        moved = [i for i, (p, b, ptr) in enumerate(zip(own, before, ptrs))
                 if p.data_ptr() != ptr or not torch.equal(p, b)]
        with torch.no_grad():  # the EMA by hand, then the trained weights back
            for p, e in zip(own, params):
                p.copy_(e)
            item = items[0]
            direct = pipe(torch.as_tensor(item["image"])[None].to(dev),
                          torch.as_tensor(item["t5_text_embeddings"])[None].to(dev),
                          guidance_scale=guidance, num_steps=RENDER_STEPS,
                          generator=torch.Generator(device=dev).manual_seed(item["__idx__"]))
            for p, b in zip(own, before):
                p.copy_(b)
        direct = direct[0].float().cpu().numpy()
        names = kernel_names(trace.path)
        missing = [k for k in RENDER_KERNELS if not any(k in n for n in names)]
        print(f"training-time render (EveryNDrawSample, EMA weights, {RENDER_STEPS} steps, "
              f"guidance {guidance}): {secs:.2f} s, frame {frame.shape}; launches {got[0]}, by "
              f"KV length {got[1]}; its trace {Path(trace.path).name}: {len(names)} kernel "
              f"events, {len(set(names))} distinct")
        if got != want:
            raise AssertionError(f"render: launches {got}, the path implies {want}")
        if moved:
            raise AssertionError(f"render: {len(moved)} trained parameters changed: {moved[:4]}")
        if frame.shape != direct.shape or not (frame == direct).all():
            raise AssertionError("render: the frame is not the direct call's with the EMA")
        if missing:
            raise AssertionError(f"render: the trace names no {missing}")
        print(f"   the frame bitwise pipe(...) with the EMA loaded by hand; all {len(own)} trained "
              f"parameters bitwise unchanged after it; the trace names {list(RENDER_KERNELS)}")
        for total, counts in zip(launches, (got[0], got[1]["flash_fwd"])):
            total.update(counts)
        renders.append({"seconds": secs, "kernel_events": len(names)})
        # the edit's frame, the clip's last, which the callback writes as a
        # PNG (a 5-frame clip would need imageio, which the card's machine
        # lacks)
        return frame[:, -1]

    return sample


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


# ----------------------------------------------------------- context parallelism

# The context-parallel phase (``context_path``) runs the DiT at full width
# (5,120; 40 heads of 128; FFN 13,824) cut in depth to CP_BLOCKS blocks: its
# P worker processes on the one card each hold a replica, and the parent
# held the unsharded reference; at 40 blocks that would be (P + 1) x 30.5
# GiB, at 4 blocks a replica is about 3.7 GB with the embedders.
CP_BLOCKS = 4
# the context sizes: 2 (the edit's 7,200 tokens one frame a rank,
# reasoning's 28,800 four) and 4 (half a frame; two frames)
CP_WORLDS = (2, 4)
# A context-parallel forward (bf16, on every rank) against the same
# forward in one process on the same weights and inputs, as PSNR over the
# reference's peak. The bound lies between the sound readings (ring and
# Ulysses at both lengths and both sizes) and the planted faults that this
# phase also reads: the ring's hops merged with equal weights instead of by
# their LSE, and each rank given the RoPE rows of the rank before it. Read
# by this phase (H100 80GB HBM3, 700.00 W): the ring 54.20-54.41 dB (one
# bf16 rounding of each hop's output), Ulysses bitwise, or 88.62 dB at P =
# 4 and 7,200 tokens (half a frame a rank); the faults 23.10-31.56 dB.
CP_MIN_DB = 40.0
# seconds a world of workers may take before it is ended and the phase fails
CP_TIMEOUT = 900.0
# the context phase's edit (P = 2) and reasoning drop (P = 4; the pipeline
# phase's drops too) run 2 and 2 of the distilled model's 8 steps, the drop
# after CP_DROP_K reasoning steps: cut from 8 steps (k = 2) to make room
# for the sharded VAE's check and serving, every check kept
CP_EDIT_STEPS = 2
CP_DROP_STEPS = 2
CP_DROP_K = 1
# the KV length past which the flash forward plays K5's part, as in JAX (it
# streams KV past 6 MiB of K and V: 12,288 tokens at D = 128 in bf16)
STREAMED_KV = 12288
# the ring's backward at attention level: full width at 28,800 tokens
CP_BWD_SHAPE = (1, REASONING_TOKENS, 40, 128)


def cp_model(dev, cfg):
    """The CP_BLOCKS-deep pipeline with ``build_model``'s seeded weights,
    then, from a seeded generator (the same bits in every process on the
    card), each block's attention and FFN gates redrawn N(1, 0.1) and its
    self-attention's q and k norm scales doubled. The init's modulation is
    O(1e-2), so a block's attention barely moves the bf16 stream, and its
    scores are N(0, 1) over thousands of keys, so attention is diffuse and
    every ring hop's LSE nearly the same: what the planted faults perturb
    would not show. With the gates only, the first full card run of this
    phase read the ring whose hops were merged with equal weights at
    53.44-53.55 dB against one process, beside the sound ring's
    53.73-54.03 dB (H100 80GB HBM3, 700.00 W). Doubling both norms
    quadruples the scores' spread (standard deviation about 4)."""
    pipe = build_model(dev, cfg)
    g = torch.Generator(device=dev).manual_seed(5)
    with torch.no_grad():
        for blk in pipe.dit.blocks:
            for row in (2, 5):  # gate_msa, c_gate
                blk.scale_shift_table[row].normal_(1.0, 0.1, generator=g)
            blk.self_attn.q_norm.scale.mul_(2.0)
            blk.self_attn.k_norm.scale.mul_(2.0)
    return pipe


def cp_config():
    """The edit model at full width, CP_BLOCKS deep."""
    from chronoedit_tpu_torch.configs import chronoedit_14b_distilled

    cfg = chronoedit_14b_distilled()
    return dataclasses.replace(cfg, dit=dataclasses.replace(cfg.dit, num_layers=CP_BLOCKS))


def cp_inputs(cfg, dev, tokens: int, seed: int = 30) -> tuple:
    """A DiT forward's inputs at ``tokens`` tokens of 720p latent frames,
    the same on every process of the card (seeded on the device)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    d, frames = cfg.dit, tokens // ((EDIT_H // 16) * (EDIT_W // 16))
    x = torch.randn((1, d.in_channels, frames, EDIT_H // 8, EDIT_W // 8), generator=g,
                    device=dev).to(d.dtype)
    ts = torch.full((1,), 999.0, device=dev)
    req = request(cfg, dev, seed, EDIT_H, EDIT_W, TEXT_TOKENS)
    return x, ts, req["prompt_emb"], req["image_emb"]


def cp_launches(cfg, forwards: list[tuple[int, str, int]], blocks: int | None = None,
                microbatches: int = 1):
    """The launch counters one rank reads after ``forwards``, each (tokens,
    mode, context size): per block the ring's P hops at KV tokens / P, or
    one attention at KV tokens (Ulysses: the whole sequence, H / P heads;
    or unsharded), the cross-attention at the text's and CLIP's KV (queries
    the rank's tokens), 2 LN-modulates, 2 gated residuals and 5 RMSNorms,
    and each forward's head LN-modulate; in ``read_launches``' form. A
    pipeline stage runs ``blocks`` of them (default every block), once per
    microbatch."""
    n = (blocks if blocks is not None else cfg.dit.num_layers) * microbatches
    calls = []
    for tokens, mode, p in forwards:
        calls += ([("flash_fwd", tokens // p, p * n)] if mode == "ring"
                  else [("flash_fwd", tokens, n)])
        calls += [("flash_fwd", TEXT_TOKENS, n), ("flash_fwd", IMAGE_TOKENS, n)]
    by_name, by_kv = expected_tool_launches(calls)
    by_name.update(ln_modulate=(2 * n + 1) * len(forwards), gated_residual=2 * n * len(forwards),
                   rms_norm=5 * n * len(forwards))
    return by_name, by_kv


def _equal_merge(q, k, v, group, scale):
    """A planted fault: the ring's hops averaged with equal weights instead
    of weighted by their LSE (launches as the ring)."""
    import torch.distributed as dist

    from chronoedit_tpu_torch.ops.flash_attention import flash_attention_with_lse
    from chronoedit_tpu_torch.parallel import collectives

    n, kv, outs, lse = dist.get_world_size(group), [k, v], [], None
    for step in range(n):
        o, lse_i = flash_attention_with_lse(q, *kv, scale)
        outs.append(o.float())
        lse = lse_i if lse is None else torch.logaddexp(lse, lse_i)
        if step != n - 1:
            kv = collectives.ring_shift(kv, group)
    return (sum(outs) / n).to(q.dtype), lse.contiguous()


@contextlib.contextmanager
def planted(fault: str | None, p: int):
    """Plant ``fault`` for the duration: "equal_merge" (``_equal_merge``) or
    "rope_rows" (each rank's RoPE rows those of the rank before it)."""
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.parallel import context

    saved = (context._ring_flash_forward, dit_lib.temporal_skip_rope_tables)
    if fault == "equal_merge":
        context._ring_flash_forward = _equal_merge
    elif fault == "rope_rows":
        def rolled(*a, **kw):
            cos, sin = saved[1](*a, **kw)
            return (torch.roll(t, cos.shape[0] // p, 0) for t in (cos, sin))
        dit_lib.temporal_skip_rope_tables = rolled
    try:
        yield
    finally:
        context._ring_flash_forward, dit_lib.temporal_skip_rope_tables = saved


def _cp_run(label: str, fn, want, rank: int, keep: bool) -> dict:
    """``fn()`` with the launch counters zeroed just before and read just
    after (they must be ``want``) and the bytes staged through the host
    counted; returns its seconds, launches, bytes, output digest and, with
    ``keep``, the output (fp32, numpy)."""
    from chronoedit_tpu_torch.kernels import build
    from chronoedit_tpu_torch.parallel import collectives
    from chronoedit_tpu_torch.parallel.consistency import tree_digest

    staged = collectives.STAGED_BYTES["bytes"]
    build.reset_launches()
    out, secs = host_s(fn)
    got = read_launches()
    if want is not None and got != want:
        raise AssertionError(f"rank {rank} {label}: launches {got}, the path implies {want}")
    res = {"secs": secs, "launches": got, "digest": tree_digest(out),
           "staged": collectives.STAGED_BYTES["bytes"] - staged,
           "finite": bool(torch.isfinite(out).all())}
    if keep:
        res["out"] = out.float().cpu().numpy()
    return res


def _ring_backward(rank: int, p: int, dev, mesh) -> dict:
    """The flash ring at attention level, forward and backward, at full
    width and 28,800 tokens: the gathered output and dq, dk, dv; rank 0
    also computes the whole sequence's K1 and K6/K7 in its own process
    (outside the counted launches) and holds the ring against them."""
    from chronoedit_tpu_torch.ops import flash_attention as fa
    from chronoedit_tpu_torch.parallel import context
    from chronoedit_tpu_torch.parallel.consistency import tree_digest

    g = torch.Generator(device=dev).manual_seed(77)
    q, k, v, dout = (torch.randn(CP_BWD_SHAPE, generator=g, device=dev, dtype=torch.bfloat16)
                     for _ in range(4))
    local = [context.split_sequence(t, mesh, seq_dim=1).contiguous().requires_grad_()
             for t in (q, k, v)]
    d_local = context.split_sequence(dout, mesh, seq_dim=1).contiguous()
    kv = CP_BWD_SHAPE[1] // p
    kept = {}

    def run():
        kept["out"] = context.ring_attention(*local, mesh)
        kept["out"].backward(d_local)
        return kept["out"].detach()

    want = expected_tool_launches([(name, kv, p) for name in
                                   ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")])
    res = _cp_run("ring backward", run, want, rank, False)
    out = context.gather_sequence(kept.pop("out").detach(), mesh, seq_dim=1)
    grads = [context.gather_sequence(t.grad, mesh, seq_dim=1) for t in local]
    if rank == 0:
        scale = CP_BWD_SHAPE[-1] ** -0.5
        ref_out, lse = fa.flash_attention_with_lse(q, k, v, scale)
        ref = fa.flash_attention_bwd(q, k, v, ref_out, dout, lse, scale)
        e_out = max_err(out, ref_out)
        res["out_err"] = e_out
        res["out_tol"] = min(K1_OUT_MAX_TOL, K1_OUT_STEPS * ULP_BF16 *
                             float(ref_out.float().abs().max()))
        res["checks"] = {name: k67_check(g_, r_) for name, g_, r_ in zip(("dq", "dk", "dv"),
                                                                        grads, ref)}
    res["grad_digests"] = [tree_digest(t) for t in grads]
    return res


def cp_worker(rank: int, p: int, plan: dict) -> dict:
    """One rank of a world of ``p`` processes on the one card, joined over
    gloo (NCCL refuses two ranks on one device), its collectives staged
    through pinned host memory. It builds the CP_BLOCKS-deep model from the
    parent's seeds (the same bits on every rank: the replica check below
    and the digest the parent compares prove it), loads the kernels the
    parent built, and runs ``plan``: DiT forwards (tokens, mode, planted
    fault), the 720p edit, the reasoning edit with the drop, and the
    ring's backward; each with its launch counters zeroed just before it
    and held to what the path implies just after. Rank 0 returns the
    outputs; every rank their digests, its seconds, staged bytes and peak
    memory."""
    from chronoedit_tpu_torch.kernels import build
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.parallel import consistency
    from chronoedit_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(plan["device"])
    build.lib()  # the parent's build, loaded: every source hashes the same
    mesh = make_mesh(MeshConfig(data=-1, context=p), device=dev)
    cfg = cp_config()
    res = {"forwards": {}}
    with torch.inference_mode():
        pipe = cp_model(dev, cfg)
        pipe.mesh = mesh
        res["diverged"] = consistency.check_replica_consistency(pipe.dit)
        if rank == 0:
            res["digest"] = consistency.tree_digest(pipe.dit)
        for tokens, mode, fault in plan["forwards"]:
            pipe.dit.cfg = dataclasses.replace(cfg.dit, context_parallel=mode)
            args = cp_inputs(cfg, dev, tokens)
            with planted(fault, p):
                res["forwards"][(tokens, mode, fault)] = _cp_run(
                    f"forward {tokens} {mode} {fault}", functools.partial(
                        dit_lib.dit_forward, pipe.dit, *args, mesh=mesh),
                    cp_launches(cfg, [(tokens, mode, p)]), rank, rank == 0)
        pipe.dit.cfg = cfg.dit  # "auto": Ulysses, 40 heads over 2 or 4
        if plan.get("edit"):
            req = request(cfg, dev, 40, EDIT_H, EDIT_W, TEXT_TOKENS)
            gen = torch.Generator(device=dev).manual_seed(140)
            res["edit"] = _cp_run("edit", functools.partial(
                pipe.edit_image, **req, num_steps=CP_EDIT_STEPS, generator=gen),
                cp_launches(cfg, [(EDIT_TOKENS, "ulysses", p)] * CP_EDIT_STEPS), rank, rank == 0)
        if plan.get("drop"):
            req = request(cfg, dev, 41, EDIT_H, EDIT_W, TEXT_TOKENS)
            gen = torch.Generator(device=dev).manual_seed(141)
            res["drop"] = _cp_run(
                "reasoning drop", functools.partial(
                    pipe, **req, enable_temporal_reasoning=True,
                    num_temporal_reasoning_steps=CP_DROP_K, num_steps=CP_DROP_STEPS,
                    generator=gen),
                cp_launches(cfg, [(REASONING_TOKENS, "ulysses", p)] * CP_DROP_K
                            + [(EDIT_TOKENS, "ulysses", p)] * (CP_DROP_STEPS - CP_DROP_K)), rank,
                rank == 0)
    vae = pipe.vae
    del pipe
    free()
    if plan.get("vae"):
        with torch.inference_mode():
            res["vae"] = vae_worker(rank, mesh, vae)
    del vae
    free()
    if plan.get("ring_backward"):
        res["ring_backward"] = _ring_backward(rank, p, dev, mesh)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return res


# ----------------------------------------------------------- the sharded VAE

# The VAE split over rows (``models/vae.py`` under a mesh), in the context
# phase's world of 2 on the one card: at 720p the 90 latent rows go 45 a
# rank over context 2; a rank runs the decoder's stages on 73 of them (45 +
# 2 x 14 halo rows, clamped at the image's edge) and the encoder's on 520 of
# the 720 pixel rows (360 + 2 x 80), then all-gathers its interior. Each
# case below runs in fp32 with TF32 off on every rank and in this process
# unsharded, and is held at TILED_DECODE_TOL: the halo covers the receptive
# field, so only cuDNN's choice of algorithm for the shorter block differs.
# "dual decode" is the reasoning mode's ``ChronoEditPipeline.decode``: the
# 7-frame trajectory streamed with 4 W-tiles inside each rank's rows, then
# the [first, last] edit clip.
VAE_CASES = ("edit encode", "edit decode", "reasoning encode", "dual decode")
# planted: halos of one latent row (8 pixel rows, 1 latent row) in place of
# 80 and 14, on the edit's decode
VAE_SHORT_HALOS = (8, 1)
# predicted before the first run: a rank's VAE peak over one process's
# (its block's share of the rows, plus the gathered output)
VAE_PEAK_RATIO = {"edit encode": 520 / 720, "reasoning encode": 520 / 720,
                  "edit decode": 73 / 90, "dual decode": 73 / 90}


def vae_inputs(dev) -> dict:
    """Each case's input, seeded on the device (the same bits in every
    process of the card): the edit's 5-frame condition clip and the
    reasoning mode's 29-frame one ([image, zeros], as ``prepare_condition``
    builds them), 2 latent frames and an 8-frame trajectory."""
    g = torch.Generator(device=dev).manual_seed(42)
    image = torch.rand((1, 3, 1, EDIT_H, EDIT_W), generator=g, device=dev) * 2 - 1

    def clip(frames):
        return torch.cat([image, torch.zeros((1, 3, frames - 1, EDIT_H, EDIT_W), device=dev)], 2)

    def latents(frames):
        return torch.randn((1, 16, frames, EDIT_H // 8, EDIT_W // 8), generator=g, device=dev)

    return {"edit encode": clip(5), "reasoning encode": clip(REASONING_FRAMES),
            "edit decode": latents(2), "dual decode": latents(8)}


def vae_fp32(vae):
    """An fp32 copy of ``vae`` on its device."""
    from chronoedit_tpu_torch.models import vae as vae_lib

    cfg32 = dataclasses.replace(vae.cfg, dtype=torch.float32, param_dtype=torch.float32)
    out = vae_lib.VAE(cfg32, device=vae.encoder.conv_in.weight.device)
    out.load_state_dict(vae.state_dict())
    return out


def vae_case(vae, case: str, x: torch.Tensor, mesh) -> dict:
    """One case under ``mesh`` (None: one process), with this process's
    peak memory over what it held before, its seconds and the bytes it
    staged through the host."""
    from chronoedit_tpu_torch.models import vae as vae_lib
    from chronoedit_tpu_torch.parallel import collectives
    from chronoedit_tpu_torch.pipeline.edit_pipeline import ChronoEditPipeline

    if case.endswith("encode"):
        def fn():
            return vae_lib.vae_encode(vae, x, mesh=mesh)
    else:
        pipe = ChronoEditPipeline(cp_config(), None, vae, mesh=mesh)

        def fn():
            return pipe.decode(x, dual=case == "dual decode")
    free()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    staged = collectives.STAGED_BYTES["bytes"]
    out, secs = host_s(fn)
    return {"out": out, "secs": secs, "peak": torch.cuda.max_memory_allocated() - held,
            "staged": collectives.STAGED_BYTES["bytes"] - staged}


def vae_gathered_bytes(vae_cfg, case: str, p: int) -> int:
    """The bytes a rank of ``p`` stages in ``case``'s all-gathers: its
    block of the encoder's bottleneck (fp32, the mid block's channels), or
    of the decoded pixels."""
    rows, w = EDIT_H // 8 // p, EDIT_W // 8
    if case.endswith("encode"):
        frames = 2 if case == "edit encode" else vae_cfg.latent_frames(REASONING_FRAMES)
        return 4 * vae_cfg.dim * vae_cfg.dim_mult[-1] * frames * rows * w
    clips = [2] if case == "edit decode" else [7, 2]  # the dual decode's two
    return sum(4 * 3 * vae_cfg.pixel_frames(t) * rows * 8 * w * 8 for t in clips)


def vae_worker(rank: int, mesh, vae) -> dict:
    """The sharded VAE's cases on this rank of the context phase's world of
    2 (fp32 copy of ``vae``, TF32 off), then the edit's decode with the
    halos planted short. Rank 0 returns the outputs; every rank their
    digests, seconds, peaks and staged bytes."""
    from chronoedit_tpu_torch.models import vae as vae_lib
    from chronoedit_tpu_torch.parallel.consistency import tree_digest

    vae = vae_fp32(vae)
    inputs = vae_inputs(mesh.device)
    res = {}
    for case in VAE_CASES:
        r = vae_case(vae, case, inputs[case], mesh)
        out = r.pop("out")
        r["digest"] = tree_digest(out)
        if rank == 0:
            r["out"] = out.cpu().numpy()
        res[case] = r
        del out
    saved = vae_lib._encoder_halo, vae_lib._decoder_halo
    vae_lib._encoder_halo = lambda cfg: VAE_SHORT_HALOS[0]
    vae_lib._decoder_halo = lambda cfg: VAE_SHORT_HALOS[1]
    try:
        short = vae_case(vae, "edit decode", inputs["edit decode"], mesh)["out"]
    finally:
        vae_lib._encoder_halo, vae_lib._decoder_halo = saved
    res["short halo"] = {"digest": tree_digest(short)}
    if rank == 0:
        res["short halo"]["out"] = short.cpu().numpy()
    return res


def vae_references(vae) -> dict:
    """Each case in this process, unsharded (fp32 copy, TF32 off): the
    outputs on the host, seconds and peaks."""
    vae = vae_fp32(vae)
    inputs = vae_inputs(vae.encoder.conv_in.weight.device)
    refs = {}
    for case in VAE_CASES:
        r = vae_case(vae, case, inputs[case], None)
        r["out"] = r["out"].cpu()
        refs[case] = r
    return refs


def check_sharded_vae(results: list[dict], refs: dict, vae_cfg, card: str, dev) -> dict:
    """The world's sharded VAE against this process's: every rank's digest
    alike, rank 0's output within TILED_DECODE_TOL, the planted short halo
    outside it, each rank's staged bytes its blocks' exactly; each rank's
    peak over one process's printed beside the prediction."""
    p = len(results)
    summary = {}
    for case in VAE_CASES + ("short halo",):
        per_rank = [r["vae"][case] for r in results]
        if any(r["digest"] != per_rank[0]["digest"] for r in per_rank):
            raise AssertionError(f"sharded VAE {case}: the ranks' outputs differ")
        want = refs["edit decode" if case == "short halo" else case]
        got = torch.from_numpy(per_rank[0]["out"])
        err = max_err(got, want["out"]) if got.shape == want["out"].shape else math.inf
        tol = TILED_DECODE_TOL * max(1.0, float(want["out"].abs().max()))
        if case == "short halo":
            print(f"   sharded VAE, planted halos of {VAE_SHORT_HALOS} rows: max err {err:.3e} "
                  f"against one process (must exceed {tol:.3e})")
            if not err > tol:
                raise AssertionError("the planted short halo reads within TILED_DECODE_TOL")
            summary["short_halo_err"] = err
            continue
        staged = [r["staged"] for r in per_rank]
        gathered = vae_gathered_bytes(vae_cfg, case, p)
        ratio = [r["peak"] / want["peak"] for r in per_rank]
        print(f"   sharded VAE {case} {tuple(want['out'].shape)} over context {p}: rank 0 "
              f"{per_rank[0]['secs']:.2f} s (one process {want['secs']:.2f} s; {p} processes "
              f"share the card: not a speed), every rank bitwise alike, max err {err:.3e} "
              f"against one process (tol {tol:.3e}); staged {staged} B a rank (predicted "
              f"{gathered}); peak {[round(r['peak'] / 2 ** 30, 3) for r in per_rank]} GiB a "
              f"rank against one process's {want['peak'] / 2 ** 30:.3f} GiB: "
              f"{[round(x, 3) for x in ratio]} (predicted {VAE_PEAK_RATIO[case]:.3f}) ({card})")
        if not err <= tol:
            raise AssertionError(f"sharded VAE {case}: {err:.3e} against one process > {tol:.3e}")
        # a CPU rehearsal stages nothing: only CUDA tensors go through the host
        if dev.type == "cuda" and any(b != gathered for b in staged):
            raise AssertionError(f"sharded VAE {case}: staged {staged} B, predicted {gathered}")
        summary[case] = {"err": err, "peak_ratio": ratio, "staged": staged[0]}
    return summary


def cp_plan(p: int) -> dict:
    """What a world of ``p`` runs on ``cuda:0``: ring and Ulysses forwards at
    both lengths, both planted faults at the edit's length, and the edit
    (P = 2) or the reasoning drop and the ring's backward (P = 4)."""
    forwards = [(tokens, mode, None) for tokens in (REASONING_TOKENS, EDIT_TOKENS)
                for mode in ("ring", "ulysses")]
    forwards += [(EDIT_TOKENS, "ring", "equal_merge"), (EDIT_TOKENS, "ulysses", "rope_rows")]
    return {"forwards": forwards, "edit": p == 2, "vae": p == 2, "drop": p == 4,
            "ring_backward": p == 4, "device": "cuda:0"}


def nccl_cli(card: str) -> float:
    """The CLIs under ``torch.distributed.run --nproc-per-node 1``, each a
    world of one over NCCL (``init_distributed``'s choice for a CUDA rank),
    started together: ``run_inference --mesh context=1`` on the distilled
    model at full width and depth on random weights (``--smoke``), rank 0
    writing the edit; ``train --mesh fsdp=1`` full-parameter (the Trainer,
    ``--smoke``: 2 iterations) and with ``--lora-rank 32`` (2 micro-steps,
    rank 0 exporting the adapters), the 14B model's width at
    MESH_CLI_BLOCKS blocks on the CLI's mock pairs. Returns their
    seconds."""
    out = CHECKPOINT_DIR.parent / "cp_nccl_edit.png"
    lora_dir = CHECKPOINT_DIR.parent / "nccl_train_lora"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    shutil.rmtree(lora_dir, ignore_errors=True)
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "1", "-m"]
    train = [*run, "chronoedit_tpu_torch.scripts.train", "--experiment", "chronoedit_14b",
             "--set", f"dit.num_layers={MESH_CLI_BLOCKS}", "--data", "mock", "--mesh", "fsdp=1"]
    cmds = {"run_inference --mesh context=1": [
                *run, "chronoedit_tpu_torch.scripts.run_inference", "--smoke", "--experiment",
                "chronoedit_14b_distilled", "--mesh", "context=1", "--output", str(out)],
            "train --mesh fsdp=1": [*train, "--smoke"],
            "train --mesh fsdp=1 --lora-rank 32": [
                *train, "--lora-rank", "32", "--max-iter", "2", "--checkpoint-dir",
                str(lora_dir)]}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, cmd in cmds.items()}
    outs = {name: p.communicate(timeout=600) for name, p in procs.items()}
    secs = time.perf_counter() - t0
    done = {"run_inference --mesh context=1": out.exists(),
            "train --mesh fsdp=1": "done at step 2" in outs["train --mesh fsdp=1"][0],
            "train --mesh fsdp=1 --lora-rank 32": (lora_dir / "lora.safetensors").exists()}
    for name, (stdout, stderr) in outs.items():
        print(stdout[-1500:], end="")
        if procs[name].returncode != 0 or not done[name] or "over nccl" not in stdout:
            raise AssertionError(f"{name} under torchrun: rc {procs[name].returncode}\n"
                                 f"{stderr[-4000:]}")
    out.unlink()
    shutil.rmtree(lora_dir, ignore_errors=True)
    print(f"NCCL, worlds of 1 through the CLIs under torchrun, started together: {secs:.1f} s; "
          f"rank 0 wrote the edit, the Trainer ran 2 iterations, the LoRA loop exported its "
          f"adapters ({card})")
    return secs


def context_path(dev, launches: tuple[Counter, Counter]) -> dict:
    """Context parallelism on the one card: worlds of P = 2 and 4 processes
    on ``cuda:0`` over host-staged gloo (a check of correctness and of the
    per-rank kernel launches, not a scaling figure), against this process's
    unsharded forwards, edit and reasoning drop on the same weights and
    inputs, and at P = 2 the VAE split over the rows against this
    process's (``vae_references``, ``check_sharded_vae``); then NCCL at a
    world of 1 through the CLI. Adds the workers' launches (forwards,
    edits, the ring's backward; not the planted faults) to ``launches``."""
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.parallel import consistency
    from chronoedit_tpu_torch.parallel.launch import run_world

    card = card_line()
    cfg = cp_config()
    t_phase = time.perf_counter()
    with torch.inference_mode():
        pipe = cp_model(dev, cfg)
        digest = consistency.tree_digest(pipe.dit)
        refs = {}
        for tokens in (REASONING_TOKENS, EDIT_TOKENS):
            out, secs = host_s(lambda: dit_lib.dit_forward(pipe.dit, *cp_inputs(cfg, dev, tokens)))
            refs[tokens] = out.float().cpu()
            print(f"context_path: one process, {CP_BLOCKS}-block forward at {tokens} tokens "
                  f"{secs:.3f} s")
        req = request(cfg, dev, 40, EDIT_H, EDIT_W, TEXT_TOKENS)
        refs["edit"] = pipe.edit_image(
            **req, num_steps=CP_EDIT_STEPS,
            generator=torch.Generator(device=dev).manual_seed(140)).float().cpu()
        req = request(cfg, dev, 41, EDIT_H, EDIT_W, TEXT_TOKENS)
        refs["drop"] = pipe(**req, enable_temporal_reasoning=True,
                            num_temporal_reasoning_steps=CP_DROP_K, num_steps=CP_DROP_STEPS,
                            generator=torch.Generator(device=dev).manual_seed(141)).float().cpu()
        # the sharded VAE's references, alone on the card before any world
        # runs: beside the world of 2 the card reached 67.3 of 79.2 GiB (H100
        # 80GB HBM3), a peak that rests on how the two runs interleave
        vae_refs, vae_secs = host_s(lambda: vae_references(pipe.vae))
    del pipe
    free()
    print(f"context_path: the one-process VAE references (fp32) in {vae_secs:.1f} s, "
          f"before the worlds")

    sound, faults, summary = {}, {}, {}
    for p in CP_WORLDS:
        plan = cp_plan(p)
        results, secs = host_s(lambda: run_world(cp_worker, p, (p, plan), backend="gloo",
                                                 device=plan["device"], timeout=CP_TIMEOUT,
                                                 threads=2))
        print(f"context_path P = {p}: {p} processes sharing one card over host-staged gloo "
              f"(not a scaling figure): the world's {secs:.1f} s, peak memory per rank "
              f"{[round(r['peak_gib'], 2) for r in results]} GiB ({card})")
        if results[0]["digest"] != digest or any(r["diverged"] for r in results):
            raise AssertionError(f"P = {p}: the ranks' weights differ from the parent's or "
                                 f"from each other's: {[r['diverged'] for r in results]}")
        print(f"   weights: every rank's replica bitwise the others' (check_replica_consistency) "
              f"and the parent's (tree_digest)")
        runs = [(key, "forwards") for key in plan["forwards"]]
        runs += [(name, None) for name in ("edit", "drop") if plan.get(name)]
        for key, group in runs:
            per_rank = [r[group][key] if group else r[key] for r in results]
            first = per_rank[0]
            if any(r["digest"] != first["digest"] for r in per_rank) or not first["finite"]:
                raise AssertionError(f"P = {p} {key}: the ranks' outputs differ or are not "
                                     f"finite")
            got = torch.from_numpy(first["out"])
            if group:
                tokens, mode, fault = key
                db = peak_db(got, refs[tokens])
                (faults if fault else sound)[(p,) + key] = db
                label = f"forward {tokens} tokens {mode}" + (f", planted {fault}" if fault else "")
            else:
                db = psnr(got, refs[key])
                label = {"edit": f"720p edit ({CP_EDIT_STEPS} steps)",
                         "drop": f"reasoning drop (k = {CP_DROP_K}, {CP_DROP_STEPS} steps)"}[key]
                if not db >= MIN_PSNR_DB:
                    raise AssertionError(f"P = {p} {label}: {db:.2f} dB against one process "
                                         f"< {MIN_PSNR_DB} dB")
            print(f"   {label}: rank 0 {first['secs']:.3f} s, {first['staged'] / 1e9:.3f} GB "
                  f"staged a rank, every rank bitwise alike, {db:.2f} dB against one process; "
                  f"launches {first['launches'][0]}, flash by KV {first['launches'][1]['flash_fwd']}")
            summary[f"P{p} {label}"] = db
            if not (group and key[2]):  # the planted faults are checks, not the path
                for r in per_rank:
                    launches[0].update(r["launches"][0])
                    launches[1].update(r["launches"][1]["flash_fwd"])
        if plan.get("vae"):
            summary["vae"] = check_sharded_vae(results, vae_refs, cfg.vae, card, dev)
        if plan.get("ring_backward"):
            rb = results[0]["ring_backward"]
            if any(r["ring_backward"]["grad_digests"] != rb["grad_digests"] for r in results):
                raise AssertionError(f"P = {p} ring backward: the ranks' gradients differ")
            print(f"   ring backward {CP_BWD_SHAPE} over {p} ranks: rank 0 {rb['secs']:.3f} s, "
                  f"{rb['staged'] / 1e9:.3f} GB staged a rank; output against one process's K1 "
                  f"{rb['out_err']:.3e} (tol {rb['out_tol']:.3e}); launches {rb['launches'][0]}")
            for name, c in rb["checks"].items():
                print(f"   {name} against one process's K6/K7: max err {c['max']:.3e} (tol "
                      f"{c['tol']:.3e}), normwise {c['rel']:.3e} (tol {K67_NORM_REL})")
            if not (rb["out_err"] <= rb["out_tol"] and all(c["ok"] for c in rb["checks"].values())):
                raise AssertionError(f"P = {p}: the ring's backward disagrees with K6/K7")
            for r in results:
                launches[0].update(r["ring_backward"]["launches"][0])
                launches[1].update(r["ring_backward"]["launches"][1]["flash_fwd"])
    print(f"context_path: sound {min(sound.values()):.2f}-{max(sound.values()):.2f} dB, planted "
          f"faults {min(faults.values()):.2f}-{max(faults.values()):.2f} dB "
          f"(CP_MIN_DB {CP_MIN_DB}) ({card})")
    low = {k: v for k, v in sound.items() if not v >= CP_MIN_DB}
    high = {k: v for k, v in faults.items() if v >= CP_MIN_DB}
    if low or high:
        raise AssertionError(f"context_path: sound readings under CP_MIN_DB {low}, planted "
                             f"faults over it {high}")
    summary["nccl_cli_s"] = nccl_cli(card)
    print(f"context_path: {time.perf_counter() - t_phase:.1f} s ({card})")
    # the one-process drop is the pipeline phase's reference too
    summary["drop_ref"] = refs["drop"]
    return summary


# ----------------------------------------------------------- the Ulysses trace

# Ulysses at P = 4 and 7,200 tokens reads 88.62 dB against one process in
# ``context_path``, not bitwise: each rank then projects 1,800 rows (half a
# frame), at P = 2 3,600 (a frame), which is bitwise. The trace holds parts of those sizes
# against the whole at the DiT's widths, TRACE_DIMS (model, FFN, the head's
# output: 16 channels x the 2 x 2 patch).
TRACE_DIMS = (5120, 13824, 64)


def ulysses_trace(dev) -> dict[str, bool]:
    """Which op of the DiT gives other bits on a part of the 720p edit's
    7,200 rows than on the whole: each projection shape of a block and the
    head's (``F.linear``, cuBLAS) on 1,800 and 3,600 rows against those
    rows of the 7,200-row product; K2 and K3 on half a frame and on a frame
    (the frame's modulation, ``local_frame_slice``), K4 on those rows, K1
    on 10 of the 40 heads (a Ulysses rank's self-attention at P = 4) and
    on those q rows against the text's and CLIP's KV (its cross-attention),
    each against those rows or heads of the whole call. A kernel that
    differs is a fault of the port and fails the run; cuBLAS is reported.
    Returns {case: bitwise}."""
    import torch.nn.functional as F

    from chronoedit_tpu_torch.ops import fused_norms as fn
    from chronoedit_tpu_torch.ops import layers as L
    from chronoedit_tpu_torch.ops.flash_attention import flash_attention

    g = torch.Generator(device=dev).manual_seed(90)
    (s, (d, f, o)), hw = (EDIT_TOKENS, TRACE_DIMS), EDIT_TOKENS // 2
    trace_rows = (s // 4, s // 2)  # a Ulysses rank's rows at P = 4 and 2

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    def parts(whole, call, rows):
        return all(torch.equal(call(r, rows), whole[:, r:r + rows]) for r in range(0, s, rows))

    same = {}
    x, delta = randn(1, s, d), randn(1, s, d)
    with torch.no_grad():
        for name, (din, dout) in {f"q/k/v/o {d}x{d}": (d, d), f"fc1 {d}x{f}": (d, f),
                                  f"fc2 {f}x{d}": (f, d), f"head {d}x{o}": (d, o)}.items():
            xin = x if din == d else randn(1, s, din)
            w, b = randn(dout, din) / math.sqrt(din), randn(dout) * 0.1
            whole = F.linear(xin, w, b)
            for rows in trace_rows:
                same[f"cuBLAS {name}, {rows} rows"] = parts(
                    whole, lambda r, n: F.linear(xin[:, r:r + n], w, b), rows)
        scale, shift, gate = (randn(1, 2, d, dtype=torch.float32) for _ in range(3))
        norm = L.RMSNorm(d, device=dev, dtype=torch.bfloat16)
        norm.scale.normal_(1.0, 0.1, generator=g)
        k2 = fn.layer_norm_modulate(x, scale, shift, hw)
        k3 = fn.gated_residual(x, delta, gate, hw)
        k4 = fn.rms_norm_fused(norm, x)

        def local(r, n):
            (sc, sh, ga), hw_l = fn.local_frame_slice((scale, shift, gate), hw, n, r // n)
            return [t.contiguous() for t in (x[:, r:r + n], delta[:, r:r + n], sc, sh, ga)], hw_l

        for rows in trace_rows:
            def k2_part(r, n):
                (xs, _, sc, sh, _), hw_l = local(r, n)
                return fn.layer_norm_modulate(xs, sc, sh, hw_l)

            def k3_part(r, n):
                (xs, ds, _, _, ga), hw_l = local(r, n)
                return fn.gated_residual(xs, ds, ga, hw_l)

            same[f"K2, {rows} rows"] = parts(k2, k2_part, rows)
            same[f"K3, {rows} rows"] = parts(k3, k3_part, rows)
            same[f"K4, {rows} rows"] = parts(
                k4, lambda r, n: fn.rms_norm_fused(norm, x[:, r:r + n].contiguous()), rows)
        q, k, v = (randn(1, s, 40, 128) for _ in range(3))
        k1 = flash_attention(q, k, v, 128 ** -0.5)
        same["K1, 10 of 40 heads"] = all(
            torch.equal(flash_attention(*(t[:, :, h:h + 10].contiguous() for t in (q, k, v)),
                                        128 ** -0.5), k1[:, :, h:h + 10])
            for h in range(0, 40, 10))
        for kv in (TEXT_TOKENS, IMAGE_TOKENS):
            kc, vc = (randn(1, kv, 40, 128) for _ in range(2))
            whole = flash_attention(q, kc, vc, 128 ** -0.5)
            for rows in trace_rows:
                same[f"K1 at KV {kv}, {rows} q rows"] = parts(
                    whole, lambda r, n: flash_attention(q[:, r:r + n].contiguous(), kc, vc,
                                                        128 ** -0.5), rows)
    print("ulysses_trace: part of the edit's rows (heads) against those of the whole call: "
          + "; ".join(f"{k} {'bitwise' if v else 'DIFFERS'}" for k, v in same.items()))
    # on the CPU the wrappers run the twins, whose matmuls may round by shape
    bad = [k for k, v in same.items() if not v and not k.startswith("cuBLAS")]
    if bad and dev.type == "cuda":
        raise AssertionError(f"ulysses_trace: kernels that are not row-independent: {bad}")
    return same


# ----------------------------------------------------------- pipeline parallelism

# The pipeline phase (``pipeline_path``) runs worlds of 2 and 4 processes on
# the one card over host-staged gloo, as the context phase does: the 720p
# edit at full width and depth (40 blocks) over pipe = 2 and 4, each rank
# loading only its stage's blocks from the checkpoint directory that
# ``loaded_path`` wrote (about 30.5 / n GiB a rank, so the world holds the
# DiT once); batched CFG (B = 2, two microbatches) over pipe = 2; the
# backward of a CP_BLOCKS-deep DiT over pipe = 2; and the reasoning drop
# over pipe = 2 x context = 2 at CP_BLOCKS blocks (``cp_model``): every
# stage's blocks are held once per context rank, so 40 blocks would need
# 2 x 30.5 GiB of weights beside four ranks' VAEs, contexts and 28,800-token
# activations on the 80 GB card; at CP_BLOCKS = 4 it is 2 x 3.0 GiB.
PP_WORLDS = (2, 4)
PP_TIMEOUT = 900.0
PP_DEVICE = "cuda:0"  # every rank's device: the one card
# the requests the pipeline worlds serve: the edit path's first (request
# seed 10) and the guided edit of ``guidance_cache_path`` (seed 30, its
# negative prompt seed 32), whose one-process outputs are the references
PP_EDIT_SEED = 10
PP_CFG_SEED, PP_NEG_SEED = 30, 32
# the steps of the pipe = 4 world's edit and the pipe = 2 world's guided
# edit (8 steps took 15-20 s more of the command's time limit); the pipe =
# 2 world's edit keeps 8, against the edit path's
PP_SHORT_STEPS = 2
# the card's free GiB each world needs: its ranks' peaks and CUDA contexts
PP_CARD_GIB = {2: 50.0, 4: 67.0}


def stage_bytes(files, num_layers: int, pipe: int, lora: bool = False) -> list[int]:
    """The bytes each stage of ``pipe`` reads from ``files`` (a
    ``SafetensorsFiles``), from the headers: its blocks' tensors, and for
    the DiT's shards the non-block tensors too."""
    from chronoedit_tpu_torch.models.weights import block_index

    per, out = num_layers // pipe, [0] * pipe
    for key in files:
        i = block_index(key.removeprefix("transformer."))
        for stage in range(pipe):
            if (i is None and not lora) or (i is not None and i // per == stage):
                out[stage] += files.nbytes(key)
    return out


def _pp_backward(rank: int, dev, mesh) -> dict:
    """The backward of the CP_BLOCKS-deep DiT (``build_model``'s seeded
    weights) at 7,200 tokens under ``mesh`` (pipe = 2), loss the sum of the
    output's squares: first in this process without a mesh (the reference,
    outside the counted launches), then with the other stage's blocks
    dropped under the mesh. The input's gradient and each parameter's the
    rank holds against the reference, at K6/K7's bounds (``k67_check``),
    and which are bitwise."""
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.parallel.pipeline_parallel import stage_range

    cfg = cp_config()
    dit = build_model(dev, cfg).dit.requires_grad_(True)  # built frozen
    x, ts, text, img = cp_inputs(cfg, dev, EDIT_TOKENS)
    x.requires_grad_()
    layers = stage_range(cfg.dit.num_layers, mesh)

    def keep(name):
        i = name.split(".")[1] if name.startswith("blocks.") else None
        return i is None or int(i) in layers

    def run(m):
        out = dit_lib.dit_forward(dit, x, ts, text, img, mesh=m)
        (out.float() ** 2).sum().backward()
        return out.detach()

    run(None)
    ref = {"x": x.grad}
    ref.update({n: p.grad for n, p in dit.named_parameters() if keep(n)})
    dit.zero_grad(set_to_none=True)
    x.grad = None
    dit.keep_layers(layers)
    free()
    n = len(layers)
    want = expected_tool_launches([(name, kv, n) for name in ("flash_fwd", "flash_bwd_dq",
                                                              "flash_bwd_dkv")
                                   for kv in (EDIT_TOKENS, TEXT_TOKENS, IMAGE_TOKENS)])
    want[0].update(ln_modulate=2 * n + 1, gated_residual=2 * n, rms_norm=5 * n)
    res = _cp_run("backward", functools.partial(run, mesh), want, rank, False)
    params = dict(dit.named_parameters())

    def local(name):  # a kept parameter's name in the stage-local model
        if not name.startswith("blocks."):
            return name
        _, i, rest = name.split(".", 2)
        return f"blocks.{int(i) - layers.start}.{rest}"

    checks, bitwise = {}, []
    for name, want_g in ref.items():
        g = x.grad if name == "x" else params[local(name)].grad
        if torch.equal(g, want_g):
            bitwise.append(name)
            continue
        checks[name] = k67_check(g, want_g)
    res.update(bitwise=len(bitwise), tensors=len(ref), x_bitwise="x" in bitwise,
               blocks_bitwise=all(n in bitwise for n in ref if n.startswith("blocks.")),
               checks=checks, ok=all(c["ok"] for c in checks.values()))
    return res


def pp_request(cfg, dev, kind: str) -> dict:
    """The keyword arguments of the pipeline worlds' edit (``"edit"``: the
    edit path's request PP_EDIT_SEED) or guided edit (``"cfg"``: request
    PP_CFG_SEED with its negative prompt, guidance 5), generator
    included."""
    seed = PP_EDIT_SEED if kind == "edit" else PP_CFG_SEED
    kw = dict(request(cfg, dev, seed, EDIT_H, EDIT_W, TEXT_TOKENS),
              generator=torch.Generator(device=dev).manual_seed(100 + seed))
    if kind == "cfg":
        kw.update(neg_prompt_emb=torch.randn(
            (1, TEXT_TOKENS, cfg.dit.text_dim), device=dev,
            generator=torch.Generator(device=dev).manual_seed(PP_NEG_SEED)), guidance_scale=5.0)
    return kw


def pipeline_whole_refs(pipe, dev) -> dict:
    """The one-process edit and guided edit at PP_SHORT_STEPS steps from
    ``pipe`` (the model loaded whole from ``CHECKPOINT_DIR`` with its LoRA,
    as the stages load theirs): what the pipe = 4 world's edit and the pipe
    = 2 world's guided edit are held to (fp32, on the host)."""
    return {kind: pipe.edit_image(**pp_request(pipe.config, dev, kind),
                                  num_steps=PP_SHORT_STEPS).float().cpu()
            for kind in ("edit", "cfg")}


def pp_worker(rank: int, p: int, plan: dict) -> dict:
    """One rank of a world of ``p`` processes on the one card over gloo
    (NCCL refuses two ranks on one device), its collectives staged through
    pinned host memory. Under a mesh of pipe = ``p`` it loads its stage of
    the distilled model with the distilled LoRA from the checkpoint
    directory (``load_pipeline(..., mesh=)``: only its stage's blocks are
    read) and serves the 720p edit (``plan["edit_steps"]`` steps) and, with
    ``plan["cfg"]``, the guided edit (B = 2, PP_SHORT_STEPS steps); then
    frees it and, with ``plan["backward"]``, runs
    ``_pp_backward``, and with ``plan["drops"]`` the reasoning drop over
    pipe = 2 x context = 2 on ``cp_model``'s CP_BLOCKS blocks, its other
    stage's blocks dropped, in each context mode. Every run with its launch
    counters zeroed just before and held to what the path implies just
    after (``_cp_run``); rank 0 returns the outputs, every rank the digests,
    seconds, bytes read and staged and peak memory."""
    from chronoedit_tpu_torch.kernels import build
    from chronoedit_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from chronoedit_tpu_torch.parallel.pipeline_parallel import stage_range
    from chronoedit_tpu_torch.pipeline.loader import load_pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(plan["device"])
    build.lib()  # the parent's build, loaded: every source hashes the same
    mesh = make_mesh(MeshConfig(data=-1, pipe=p), device=dev)
    cfg = main_config()
    per = cfg.dit.num_layers // p
    res = {}
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        pipe, secs = host_s(lambda: load_pipeline(
            cfg, str(CHECKPOINT_DIR), loras=[(str(CHECKPOINT_DIR / "distill_lora.safetensors"),
                                              1.0)],
            with_text_encoder=False, with_image_encoder=False, device=dev, mesh=mesh))
        res["load"] = {"secs": secs, "bytes": dict(pipe.load_bytes),
                       "layers": (pipe.dit.layers.start, pipe.dit.layers.stop),
                       "blocks": len(pipe.dit.blocks),
                       "gib": torch.cuda.memory_allocated() / 2 ** 30}
        edit_steps = plan["edit_steps"]
        res["edit"] = _cp_run("edit", functools.partial(
            pipe.edit_image, **pp_request(cfg, dev, "edit"), num_steps=edit_steps),
            cp_launches(cfg, [(EDIT_TOKENS, "none", 1)] * edit_steps, per), rank, rank == 0)
        if plan.get("cfg"):
            res["cfg"] = _cp_run("CFG batched", functools.partial(
                pipe.edit_image, **pp_request(cfg, dev, "cfg"), num_steps=PP_SHORT_STEPS),
                cp_launches(cfg, [(EDIT_TOKENS, "none", 1)] * PP_SHORT_STEPS, per,
                            microbatches=2), rank, rank == 0)
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del pipe
    free()
    if plan.get("backward"):
        res["backward"] = _pp_backward(rank, dev, mesh)
        free()
    if plan.get("drops"):
        mesh = make_mesh(MeshConfig(pipe=2, context=2), device=dev)
        cfg = cp_config()
        with torch.inference_mode():
            pipe = cp_model(dev, cfg)
            pipe.dit.keep_layers(stage_range(cfg.dit.num_layers, mesh))
            pipe.mesh = mesh
            free()
            per = len(pipe.dit.layers)
            for mode in ("ring", "ulysses"):
                pipe.dit.cfg = dataclasses.replace(cfg.dit, context_parallel=mode)
                req = request(cfg, dev, 41, EDIT_H, EDIT_W, TEXT_TOKENS)
                gen = torch.Generator(device=dev).manual_seed(141)
                res[f"drop {mode}"] = _cp_run(
                    f"reasoning drop {mode}", functools.partial(
                        pipe, **req, enable_temporal_reasoning=True,
                        num_temporal_reasoning_steps=CP_DROP_K, num_steps=CP_DROP_STEPS,
                        generator=gen),
                    cp_launches(cfg, [(REASONING_TOKENS, mode, 2)] * CP_DROP_K
                                + [(EDIT_TOKENS, mode, 2)] * (CP_DROP_STEPS - CP_DROP_K), per),
                    rank,
                    rank == 0)
        res["peak_gib"] = max(res["peak_gib"], torch.cuda.max_memory_allocated() / 2 ** 30)
        del pipe
        free()
    return res


def pipeline_path(dev, refs: dict, launches: tuple[Counter, Counter]) -> dict:
    """Pipeline parallelism on the one card: worlds of pipe = 2 and 4
    processes on ``cuda:0`` over host-staged gloo (correctness and per-rank
    launches, not a scaling figure), each rank reading only its stage's
    block tensors from ``CHECKPOINT_DIR`` (checked, per rank, against the
    files' headers), against the one-process outputs in ``refs``: the 8-step
    720p edit (``refs[PP_EDIT_SEED]``) at pipe = 2 and its PP_SHORT_STEPS-step
    one (``refs["edit short"]``) at pipe = 4, the guided edit at
    PP_SHORT_STEPS steps (``refs["cfg short"]``) at pipe = 2, and the
    reasoning drop over pipe = 2 x context = 2 in both modes
    (``refs["drop"]``), at the fidelity bar; the
    backward at pipe = 2 against one process at K6/K7's bounds. Adds the
    workers' launches to ``launches``. Needs the card free: the
    one-process runs were freed before."""
    from chronoedit_tpu_torch.models import weights as w
    from chronoedit_tpu_torch.parallel.launch import run_world

    card = card_line()
    cfg = main_config()
    t_phase = time.perf_counter()
    shards = sorted(str(f) for f in (CHECKPOINT_DIR / "transformer").glob("*.safetensors"))
    with w.load_safetensors(shards) as sd, \
            w.load_safetensors(str(CHECKPOINT_DIR / "distill_lora.safetensors")) as lsd:
        total = sum(sd.nbytes(k) for k in sd)
        want_bytes = {p: (stage_bytes(sd, cfg.dit.num_layers, p),
                          stage_bytes(lsd, cfg.dit.num_layers, p, lora=True)) for p in PP_WORLDS}
    summary = {}
    for p in PP_WORLDS:
        plan = {"cfg": p == 2, "backward": p == 2, "drops": p == 4, "device": PP_DEVICE,
                "edit_steps": cfg.num_steps if p == 2 else PP_SHORT_STEPS}
        # the ranks' peaks on an H100 80GB HBM3: pipe 2 23.34 GiB, pipe 4 15.79
        wait_for_card(f"pipeline_path pipe = {p}", PP_CARD_GIB[p])
        with compact_workers():
            results, secs = host_s(lambda: run_world(pp_worker, p, (p, plan), backend="gloo",
                                                     device=plan["device"], timeout=PP_TIMEOUT,
                                                     threads=2))
        print(f"pipeline_path pipe = {p}: {p} processes sharing one card over host-staged gloo "
              f"(not a scaling figure): the world's {secs:.1f} s, peak memory per rank "
              f"{[round(r['peak_gib'], 2) for r in results]} GiB ({card})")
        dit_want, lora_want = want_bytes[p]
        for stage, r in enumerate(results):
            load = r["load"]
            per = cfg.dit.num_layers // p
            ok = (load["layers"] == (stage * per, (stage + 1) * per) and load["blocks"] == per
                  and load["bytes"]["dit"] == dit_want[stage]
                  and load["bytes"]["loras"] == lora_want[stage])
            print(f"   rank {stage}: blocks {load['layers']}, read {load['bytes']['dit'] / 1e9:.3f} "
                  f"GB of the DiT's {total / 1e9:.3f} GB (expected {dit_want[stage] / 1e9:.3f}) "
                  f"and {load['bytes']['loras'] / 1e6:.1f} MB of the LoRA (expected "
                  f"{lora_want[stage] / 1e6:.1f}) in {load['secs']:.2f} s, "
                  f"{load['gib']:.2f} GiB after the load, peak {r['peak_gib']:.2f} GiB")
            if not ok:
                raise AssertionError(f"pipe = {p} rank {stage}: loaded {load}, expected blocks "
                                     f"of stage {stage} and {dit_want[stage]} / "
                                     f"{lora_want[stage]} bytes")
        steps = plan["edit_steps"]
        runs = [("edit", refs[PP_EDIT_SEED] if p == 2 else refs["edit short"], steps,
                 f"720p edit ({steps} steps, {cfg.dit.num_layers} blocks)")]
        if plan["cfg"]:
            runs.append(("cfg", refs["cfg short"], PP_SHORT_STEPS,
                         f"CFG batched, guidance 5 (B = 2, 2 microbatches, {PP_SHORT_STEPS} "
                         f"steps)"))
        if plan["drops"]:
            runs += [(f"drop {mode}", refs["drop"], CP_DROP_STEPS,
                      f"reasoning drop (k = {CP_DROP_K}, {CP_DROP_STEPS} steps, {CP_BLOCKS} "
                      f"blocks) over "
                      f"pipe 2 x context 2, "
                      f"{mode}") for mode in ("ring", "ulysses")]
        for key, want, steps, label in runs:
            per_rank = [r[key] for r in results]
            first = per_rank[0]
            if any(r["digest"] != first["digest"] for r in per_rank) or not first["finite"]:
                raise AssertionError(f"pipe = {p} {label}: the ranks' outputs differ or are "
                                     f"not finite")
            got = torch.from_numpy(first["out"])
            if got.shape != want.shape:
                raise AssertionError(f"pipe = {p} {label}: {tuple(got.shape)} against "
                                     f"{tuple(want.shape)}")
            db = psnr(got, want)
            print(f"   {label}: rank 0 {first['secs']:.3f} s, "
                  f"{first['staged'] / steps / 1e9:.4f} GB staged a forward and rank, every "
                  f"rank bitwise alike, {'bitwise' if db == math.inf else f'{db:.2f} dB'} "
                  f"against one process; rank 0's launches {first['launches'][0]}, flash by KV "
                  f"{first['launches'][1]['flash_fwd']}")
            if not db >= MIN_PSNR_DB:
                raise AssertionError(f"pipe = {p} {label}: {db:.2f} dB against one process "
                                     f"< {MIN_PSNR_DB} dB")
            summary[f"pipe{p} {key}"] = db
            for r in per_rank:
                launches[0].update(r["launches"][0])
                launches[1].update(r["launches"][1]["flash_fwd"])
        if plan["backward"]:
            for stage, r in enumerate(results):
                bw = r["backward"]
                worst = max((c["rel"] for c in bw["checks"].values()), default=0.0)
                print(f"   backward ({CP_BLOCKS} blocks, {EDIT_TOKENS} tokens) rank {stage}: "
                      f"{bw['secs']:.3f} s, {bw['staged'] / 1e9:.3f} GB staged; "
                      f"{bw['bitwise']} of {bw['tensors']} gradients bitwise one process's "
                      f"(input {'bitwise' if bw['x_bitwise'] else 'not bitwise'}, the stage's "
                      f"blocks {'bitwise' if bw['blocks_bitwise'] else 'not all bitwise'}), "
                      f"the rest within K6/K7's bounds: worst normwise {worst:.3e}; "
                      f"launches {bw['launches'][0]}")
                if not bw["ok"]:
                    raise AssertionError(f"pipe = {p} rank {stage} backward: "
                                         f"{ {k: c for k, c in bw['checks'].items() if not c['ok']} }")
                launches[0].update(bw["launches"][0])
                launches[1].update(bw["launches"][1]["flash_fwd"])
    print(f"pipeline_path: {time.perf_counter() - t_phase:.1f} s ({card})")
    return summary


# ------------------------------------- the pipe = 4 world's ranks traced

# ``--trace-pipe-ranks``: why the pipe = 4 world's ranks once returned
# different edits when its workers ran without expandable segments. Each
# rank of that world, started without them, records the digest of its VAE
# encode's output (the condition), of the final latents it decodes and of
# the decoded frames, with the card's free memory at each; then, in a
# fresh process for each, the VAE encode and decode of the 720p edit run
# with the card filled to leave PP_HEADROOM_GIB free (None: nothing
# filled). PyTorch keeps only the cuDNN plans whose workspace fits in the
# card's free memory (or the allocator's largest free block), and keeps
# the plan it picks for a shape for the process's life.
PP_TRACE_WORLDS = 3
PP_HEADROOM_GIB = (None, 24.0, 16.0, 12.0, 10.0, 8.0, 7.0, 6.0, 5.0, 4.0)
TRACE: list = []  # (what, digest, the card's free GiB): this rank's run


def _traced(what: str, fn, arg: int | None = None):
    """``fn`` that appends to TRACE the digest of its output (and of its
    positional argument ``arg``) and the card's free GiB before the call."""
    from chronoedit_tpu_torch.parallel.consistency import tree_digest

    def call(*a, **k):
        free_gib = torch.cuda.mem_get_info()[0] / 2 ** 30
        if arg is not None:
            TRACE.append((f"{what} input", tree_digest(a[arg]), free_gib))
        out = fn(*a, **k)
        TRACE.append((what, tree_digest(out), free_gib))
        return out

    return call


def pp_trace_worker(rank: int, p: int, plan: dict) -> dict:
    """``pp_worker``'s load and 720p edit with this rank's condition, final
    latents and decoded frames digested (TRACE), returned with its
    result."""
    from chronoedit_tpu_torch.models import vae as vae_lib
    from chronoedit_tpu_torch.pipeline import edit_pipeline

    edit_pipeline.prepare_condition = _traced("VAE encode", edit_pipeline.prepare_condition)
    vae_lib.vae_decode = _traced("VAE decode", vae_lib.vae_decode, arg=1)
    res = pp_worker(rank, p, plan)
    res["trace"] = list(TRACE)
    return res


def vae_headroom_worker(rank: int, headroom_gib: float | None) -> dict:
    """The 720p edit's VAE encode (``prepare_condition``) and a decode of
    seeded latents, in this fresh process, with the card filled to leave
    ``headroom_gib`` GiB free just before (None: nothing filled). Their
    digests and the plans' free memory, or the error."""
    from chronoedit_tpu_torch.models import vae as vae_lib
    from chronoedit_tpu_torch.parallel.consistency import tree_digest
    from chronoedit_tpu_torch.pipeline.edit_pipeline import prepare_condition

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(PP_DEVICE)
    cfg = main_config()
    vae = vae_lib.init_vae_params(cfg.vae, torch.Generator(device=dev).manual_seed(0),
                                  device=dev)
    image = request(cfg, dev, PP_EDIT_SEED, EDIT_H, EDIT_W, TEXT_TOKENS)["image"]
    frames = cfg.resolve_num_frames()
    z = torch.randn((1, cfg.latent_channels, cfg.vae.latent_frames(frames),
                     EDIT_H // cfg.vae.spatial_factor, EDIT_W // cfg.vae.spatial_factor),
                    generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    fill = None
    if headroom_gib is not None:
        free_b = torch.cuda.mem_get_info()[0]
        fill = torch.empty(max(free_b - int(headroom_gib * 2 ** 30), 0), dtype=torch.uint8,
                           device=dev)
    res = {"free_gib": torch.cuda.mem_get_info()[0] / 2 ** 30}
    try:
        with torch.inference_mode():
            res["encode"] = tree_digest(prepare_condition(vae, cfg, image, frames,
                                                          cfg.vae_spatial_tiles))
            res["decode"] = tree_digest(vae_lib.vae_decode(vae, z,
                                                           spatial_tiles=cfg.vae_spatial_tiles))
    except torch.OutOfMemoryError as e:
        res["error"] = str(e).split(".")[0]
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del fill
    return res


def trace_pipe_ranks(dev) -> None:
    """``--trace-pipe-ranks``: write the checkpoint directory (the
    encoders' files at a small width: no rank reads them), run the pipe = 4
    world's load and 720p edit PP_TRACE_WORLDS times without expandable
    segments, printing each rank's digests (TRACE) and where the ranks
    first part; then the VAE at each of PP_HEADROOM_GIB, each in a fresh
    process. The directory is removed at the end."""
    from chronoedit_tpu_torch.models import clip, umt5
    from chronoedit_tpu_torch.models import lora as lora_lib
    from chronoedit_tpu_torch.parallel.launch import run_world

    card = card_line()
    cfg = main_config()
    try:
        with torch.inference_mode():
            pipe = build_model(dev, cfg)
            g = torch.Generator(device=dev).manual_seed(40)
            t5 = umt5.init_umt5_params(umt5.UMT5Config(
                vocab_size=256, dim=256, dim_attn=256, dim_ffn=512, num_heads=4, num_layers=1),
                g, dev)
            tower = clip.init_clip_vision_params(clip.CLIPVisionConfig(
                dim=256, num_heads=4, num_layers=1), g, dev)
            lora = lora_lib.init_lora_params(g, pipe.dit, lora_lib.LoRAConfig())
            write_checkpoint(CHECKPOINT_DIR, pipe, t5, tower, lora)
            del pipe, t5, tower, lora
        free()
        plan = {"device": PP_DEVICE}
        for i in range(PP_TRACE_WORLDS):
            wait_for_card(f"trace {i}", PP_CARD_GIB[4])
            t0 = time.perf_counter()
            try:
                results = run_world(pp_trace_worker, 4, (4, plan), backend="gloo",
                                    device=PP_DEVICE, timeout=PP_TIMEOUT, threads=2)
            except RuntimeError as e:  # a rank failed: its error's last line
                print(f"trace {i}: pipe = 4 without expandable segments failed after "
                      f"{time.perf_counter() - t0:.1f} s: {str(e).strip().splitlines()[-1][:300]}"
                      f" ({card})")
                continue
            print(f"trace {i}: pipe = 4 without expandable segments, "
                  f"{time.perf_counter() - t0:.1f} s; the ranks' edits "
                  f"{[r['edit']['digest'][:12] for r in results]} ({card})")
            for step, entries in enumerate(zip(*(r["trace"] for r in results))):
                alike = len({e[1] for e in entries}) == 1
                print(f"   {entries[0][0]}: {'alike' if alike else 'DIFFER'} "
                      f"{[e[1][:12] for e in entries]}, the card's free GiB before "
                      f"{[round(e[2], 2) for e in entries]}")
        for headroom in PP_HEADROOM_GIB:
            (r,), secs = host_s(lambda: run_world(vae_headroom_worker, 1, (headroom,),
                                                  backend="gloo", device=PP_DEVICE,
                                                  timeout=PP_TIMEOUT))
            print(f"VAE at 720p, {'nothing filled' if headroom is None else f'{headroom} GiB left'}"
                  f" ({r['free_gib']:.2f} GiB free before the encode, peak {r['peak_gib']:.2f}"
                  f" GiB): encode {r.get('encode', '-')[:12]}, decode {r.get('decode', '-')[:12]}"
                  f"{'; ' + r['error'] if 'error' in r else ''} ({card})")
    finally:
        shutil.rmtree(CHECKPOINT_DIR, ignore_errors=True)


# ----------------------------------------------------------- FSDP

# FSDP on the one card (``fsdp_path``): worlds of processes on ``cuda:0``
# over host-staged gloo, as the pipeline phase's. The world of 2 loads the
# 40-block model with the distilled LoRA from the directory, each rank its
# slice of every tensor (at 14B every leaf splits), and runs one 720p
# forward of its first FSDP_FORWARD_BLOCKS blocks; then ``cp_model``'s
# weights cut to FSDP_BLOCKS blocks, sharded with ``shard_params``, serve
# the edit, batched CFG and the w4a16 edit, and run the backward. Every
# forward stages each rank's shards through the host, 16.4 GB at 40 blocks:
# the first card run of this phase moved them at 0.40 GB/s a rank (41.1 s a
# forward; H100 80GB HBM3, 700.00 W), so an 8-step path at 40 blocks would
# take about 5.5 minutes and at CP_BLOCKS about 37 s; at FSDP_BLOCKS = 2 a
# forward stages 1.05 GB a rank. The world of 4 runs the edit over fsdp 2 x
# context 2 in both context modes. Every edit takes FSDP_SHORT_STEPS steps
# (8 steps of the world of 2's edit and w4a16 edit took 20-30 s more of the
# command's time limit; 2 were cut to 1 to make room for the sharded VAE's
# check and serving): each step stages the shards again, and the checks
# read the same forward at every step.
FSDP_WORLDS = (2, 4)
FSDP_TIMEOUT = 900.0
FSDP_DEVICE = "cuda:0"  # every rank's device: the one card
FSDP_FORWARD_SEED = 50
# the blocks the fsdp and the tensor world's forwards of the 40-block model
# run (a layer mask skips the rest, which no rank then gathers or reduces):
# all 40 took 20-25 s (fsdp) and 14 s (tensor) of the command's time limit
FSDP_FORWARD_BLOCKS = 5
TP_FORWARD_BLOCKS = 10
TP_FORWARD_SEED = 51
FSDP_BLOCKS = 2
FSDP_SHORT_STEPS = 1
# the card's free GiB each world needs: its ranks' peaks (the first card
# run: 17.97 GiB a rank over the 40-block forward, 9.54 at 4 ranks) and
# CUDA contexts
FSDP_CARD_GIB = {2: 40.0, 4: 42.0}
# batched CFG with B = 2 split over fsdp 2 projects 7,200 rows a rank where
# one process projects 14,400: cuBLAS may pick another algorithm for them
FSDP_CFG_MIN_DB = 50.0


def tensor_checksum(t: torch.Tensor) -> int:
    """An exact, position-weighted integer checksum of ``t``'s bytes, in
    chunks of 2^26 bytes."""
    total = 0
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    for i in range(0, b.numel(), 1 << 26):
        c = b[i:i + (1 << 26)].to(torch.int64)
        w = torch.arange(i, i + c.numel(), device=c.device) % 65521 + 1
        total += int((c * w).sum())
    return total


def fsdp_bytes(files, cfg, shards, blocks: int | None = None) -> int:
    """The bytes an fsdp rank reads from the DiT's shards (``files``, a
    ``SafetensorsFiles``), from the headers: its block of each split tensor
    (every tensor at 14B, each cut along a whole axis of the file), the
    whole of the others; with ``blocks``, only the first ``blocks`` blocks'
    (and every non-block tensor): what a forward that runs those gathers."""
    from chronoedit_tpu_torch.models.weights import block_index, diffusers_dit_names

    names = diffusers_dit_names(cfg.dit)
    total = 0
    for key in files:
        name = names.get(key.removeprefix("transformer."))
        if name is None or (blocks is not None and (block_index(name) or 0) >= blocks):
            continue
        total += files.nbytes(key) // (shards.size if shards.dims[name] is not None else 1)
    return total


def fsdp_forward_blocks(cfg) -> int:
    """The blocks the fsdp world's forward of the loaded model runs."""
    return min(FSDP_FORWARD_BLOCKS, cfg.dit.num_layers)


def fsdp_mask(cfg) -> list[float]:
    """The fsdp world's forward's layer mask: its first
    ``fsdp_forward_blocks`` blocks run."""
    return [1.0 if i < fsdp_forward_blocks(cfg) else 0.0 for i in range(cfg.dit.num_layers)]


def tp_forward_blocks(cfg) -> int:
    """The blocks the tensor world's forward of the loaded model runs."""
    return min(TP_FORWARD_BLOCKS, cfg.dit.num_layers)


def tp_mask(cfg) -> list[float]:
    """The tensor world's forward's layer mask: its first
    ``tp_forward_blocks`` blocks run."""
    return [1.0 if i < tp_forward_blocks(cfg) else 0.0 for i in range(cfg.dit.num_layers)]


def fsdp_config():
    """The edit model at full width, FSDP_BLOCKS deep."""
    cfg = cp_config()
    return dataclasses.replace(cfg, dit=dataclasses.replace(cfg.dit, num_layers=FSDP_BLOCKS))


def fsdp_worker(rank: int, p: int, plan: dict) -> dict:
    """One rank of a world of ``p`` processes on the one card over gloo
    (NCCL refuses two ranks on one device), its collectives staged through
    pinned host memory. At ``p`` = 2, under a mesh of fsdp 2: loads the
    distilled model with the distilled LoRA from the checkpoint directory
    (``load_pipeline(..., mesh=)``: its slice of each tensor; the shards'
    checksums returned) and runs one 720p DiT forward of its first
    ``fsdp_forward_blocks`` blocks; frees it, shards ``cp_model``'s weights
    at FSDP_BLOCKS blocks (``shard_params``) and serves the 720p edit, the
    guided edit with batched CFG (B = 2, a row a rank) and, quantized under
    the mesh, the w4a16 edit; then the training checks (``mesh_train``:
    each process's row gathered into the line's two). At ``p`` = 4, under
    fsdp 2 x context 2: the 720p edit on the same sharded weights in each
    context mode; then the training checks under data 2 x fsdp 2 (a row a
    data line). Every edit takes FSDP_SHORT_STEPS steps. Every run with
    its launch counters zeroed just before and held to what the path
    implies just after (``_cp_run``); rank 0 returns the outputs, every
    rank the digests, seconds, bytes read and staged and peak memory."""
    from chronoedit_tpu_torch.kernels import build
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.ops import quant
    from chronoedit_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from chronoedit_tpu_torch.parallel.sharding import shard_params
    from chronoedit_tpu_torch.pipeline.loader import load_pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(plan["device"])
    build.lib()  # the parent's build, loaded: every source hashes the same
    # the parent's int4 codebook (the same numpy arithmetic from the same
    # seed gives the same bits): a rank skips the 13-16 s search
    quant._lloyd_levels = plan["lloyd"].__getitem__
    fcfg = fsdp_config()
    short = FSDP_SHORT_STEPS
    edit_launches = cp_launches(fcfg, [(EDIT_TOKENS, "none", 1)] * short)
    res = {}

    def sharded_model(mesh):
        pipe = cp_model(dev, fcfg)
        shard_params(pipe.dit, mesh)
        pipe.mesh = mesh
        free()
        return pipe

    def edit(pipe, label, want, **kw):
        """The edited frame, as ``edit_image`` computes it, with the final
        latents kept (the VAE, split over the mesh, does not touch them)."""
        from chronoedit_tpu_torch.parallel.consistency import tree_digest

        req = request(fcfg, dev, kw.pop("seed", 40), EDIT_H, EDIT_W, TEXT_TOKENS)
        gen = torch.Generator(device=dev).manual_seed(kw.pop("gen", 140))
        kept = {}

        def run():
            kept["latents"] = pipe(**req, **kw, generator=gen, output_type="latent")
            return pipe.decode(kept["latents"])[:, :, -1]

        out = _cp_run(label, run, want, rank, rank == 0)
        out["latents_digest"] = tree_digest(kept["latents"])
        if rank == 0:
            out["latents"] = kept["latents"].cpu().numpy()
        return out

    if p == 4:
        mesh = make_mesh(MeshConfig(fsdp=2, context=2), device=dev)
        with torch.inference_mode():
            pipe = sharded_model(mesh)
            for mode in ("ring", "ulysses"):
                pipe.dit.cfg = dataclasses.replace(fcfg.dit, context_parallel=mode)
                res[f"edit {mode}"] = edit(pipe, f"edit {mode}", cp_launches(
                    fcfg, [(EDIT_TOKENS, mode, 2)] * short), num_steps=short)
            res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            del pipe
        free()
        res["train"] = mesh_train(rank, dev, make_mesh(MeshConfig(data=2, fsdp=2), device=dev),
                                  plan, gathered=False)
        return res

    mesh = make_mesh(MeshConfig(fsdp=p), device=dev)
    cfg = main_config()
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        pipe, secs = host_s(lambda: load_pipeline(
            cfg, str(CHECKPOINT_DIR), loras=[(str(CHECKPOINT_DIR / "distill_lora.safetensors"),
                                              1.0)],
            with_text_encoder=False, with_image_encoder=False, device=dev, mesh=mesh))
        res["load"] = {"secs": secs, "bytes": dict(pipe.load_bytes),
                       "gib": torch.cuda.memory_allocated() / 2 ** 30,
                       "sums": {n: tensor_checksum(t) for n, t in pipe.dit.named_parameters()}}
        args = cp_inputs(cfg, dev, EDIT_TOKENS, FSDP_FORWARD_SEED)
        res["forward"] = _cp_run("forward", functools.partial(
            dit_lib.dit_forward, pipe.dit, *args, mesh=mesh, layer_mask=fsdp_mask(cfg)),
            cp_launches(cfg, [(EDIT_TOKENS, "none", 1)], fsdp_forward_blocks(cfg)), rank,
            rank == 0)
        res["peak_gib_40"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del pipe
        free()
        torch.cuda.reset_peak_memory_stats()
        pipe = sharded_model(mesh)
        res["edit"] = edit(pipe, "edit", edit_launches, num_steps=short)
        neg = torch.randn((1, TEXT_TOKENS, fcfg.dit.text_dim), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(PP_NEG_SEED))
        res["cfg"] = edit(pipe, "CFG batched", cp_launches(
            fcfg, [(EDIT_TOKENS, "none", 1)] * short), seed=PP_CFG_SEED, gen=130,
            neg_prompt_emb=neg, guidance_scale=5.0, num_steps=short)
        _, res["quantize_secs"] = host_s(lambda: pipe.quantize(mode="int4"))
        res["w4a16"] = edit(pipe, "w4a16 edit", expected_launches(
            fcfg, [EDIT_TOKENS] * short, int4=True), num_steps=short)
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del pipe
        free()
    res["train"] = mesh_train(rank, dev, mesh, plan, gathered=True)
    free()
    return res


def fsdp_whole_refs(pipe, dev) -> dict:
    """What ``fsdp_path`` holds its world of 2 to, from ``pipe``: the
    distilled model loaded whole from ``CHECKPOINT_DIR`` with its LoRA, as
    each rank loads its shards. Each leaf's fsdp = 2 dimension, the
    checksums of each rank's slices, and the 720p forward of its first
    ``fsdp_forward_blocks`` blocks (``fsdp_mask``; fp32, on the host)."""
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.parallel.sharding import Shards, fsdp_dim

    cfg = pipe.config
    params = dict(pipe.dit.named_parameters())
    dims = {n: fsdp_dim(n, tuple(t.shape), 2) for n, t in params.items()}
    sums = [{n: tensor_checksum(Shards(2, i, dims).local(t, dims[n]))
             for n, t in params.items()} for i in range(2)]
    fwd = dit_lib.dit_forward(pipe.dit, *cp_inputs(cfg, dev, EDIT_TOKENS, FSDP_FORWARD_SEED),
                              layer_mask=fsdp_mask(cfg))
    return {"dims": dims, "sums": sums, "forward": fwd.float().cpu()}


def fsdp_path(dev, whole: dict, launches: tuple[Counter, Counter]) -> dict:
    """FSDP on the one card: worlds of 2 (fsdp 2) and 4 (fsdp 2 x context
    2) processes on ``cuda:0`` over host-staged gloo (correctness, bytes
    and per-rank launches, not a scaling figure). ``whole`` holds the whole
    model's references (``fsdp_whole_refs``: each rank's slices'
    checksums and the 720p forward at 40 blocks); first, in this process,
    ``cp_model``'s weights at FSDP_BLOCKS blocks give the rest at
    FSDP_SHORT_STEPS steps: the edit, batched CFG and, quantized to w4a16,
    the edit again. Each rank's bytes read are held
    to the files' headers, its fused shards to the whole model's slices,
    the forward and the edits' final latents to one process (bitwise; the
    frames, decoded by the VAE split over the rows, at TILED_DECODE_TOL), CFG's
    frame at FSDP_CFG_MIN_DB, the ring's at CP_MIN_DB, the training checks under fsdp
    2 and data 2 x fsdp 2 to ``whole["train"]`` (``mesh_train_refs``) at
    the training bars (fsdp 2's step-1 gradients also leaf by leaf at
    K6/K7's bounds, as the backward it replaces), the bytes staged a
    forward to the shards' bytes. Adds the workers' launches to
    ``launches``. Needs the card free."""
    from chronoedit_tpu_torch.models import weights as w
    from chronoedit_tpu_torch.ops import quant
    from chronoedit_tpu_torch.parallel.launch import run_world
    from chronoedit_tpu_torch.parallel.sharding import Shards

    card = card_line()
    cfg, fcfg = main_config(), fsdp_config()
    dims, sums, short = whole["dims"], whole["sums"], FSDP_SHORT_STEPS
    t_phase = time.perf_counter()
    with torch.inference_mode():
        small = cp_model(dev, fcfg)
        latents = {}

        def edit(seed, gen, key, **kw):
            """The frame, and the final latents under ``key``."""
            req = request(fcfg, dev, seed, EDIT_H, EDIT_W, TEXT_TOKENS)
            lat = small(**req, **kw, generator=torch.Generator(device=dev).manual_seed(gen),
                        output_type="latent")
            latents[key] = lat.cpu()
            return small.decode(lat)[:, :, -1].float().cpu()

        neg = torch.randn((1, TEXT_TOKENS, fcfg.dit.text_dim), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(PP_NEG_SEED))
        ref = {"forward": whole["forward"],
               "cfg": edit(PP_CFG_SEED, 130, "cfg", neg_prompt_emb=neg, guidance_scale=5.0,
                           num_steps=short)}
        ref["edit"] = ref["edit ring"] = ref["edit ulysses"] = edit(40, 140, "edit",
                                                                    num_steps=short)
        latents["edit ring"] = latents["edit ulysses"] = latents["edit"]
        small.quantize(mode="int4")
        ref["w4a16"] = edit(40, 140, "w4a16", num_steps=short)
        del small
        free()
    print(f"fsdp_path: the one-process references at {FSDP_BLOCKS} blocks in "
          f"{time.perf_counter() - t_phase:.1f} s")
    shards = sorted(str(f) for f in (CHECKPOINT_DIR / "transformer").glob("*.safetensors"))
    with w.load_safetensors(shards) as sd, \
            w.load_safetensors(str(CHECKPOINT_DIR / "distill_lora.safetensors")) as lsd:
        total = sum(sd.nbytes(k) for k in sd)
        want_bytes = fsdp_bytes(sd, cfg, Shards(2, 0, dims))
        want_staged = fsdp_bytes(sd, cfg, Shards(2, 0, dims), fsdp_forward_blocks(cfg))
        lora_bytes = sum(lsd.nbytes(k) for k in lsd)
    # (key, the bound in dB: inf for bitwise). The edits' bitwise claims
    # hold the final latents, which the VAE does not touch; their frames,
    # decoded by the VAE split over the mesh's rows (cuDNN may pick another
    # algorithm for a rank's shorter block), are held at the VAE's own
    # tiling tolerance, TILED_DECODE_TOL
    bounds = {"forward": math.inf, "edit": math.inf, "cfg": FSDP_CFG_MIN_DB,
              "w4a16": math.inf, "edit ulysses": math.inf, "edit ring": CP_MIN_DB}
    labels = {"forward": f"720p DiT forward ({cfg.dit.num_layers} blocks, the first "
                         f"{fsdp_forward_blocks(cfg)} run)",
              "edit": f"720p edit ({short} steps, {FSDP_BLOCKS} blocks)",
              "cfg": f"CFG batched, guidance 5 (B = 2, a row a rank; {short} steps, "
                     f"{FSDP_BLOCKS} blocks)",
              "w4a16": f"w4a16 edit, quantized under fsdp ({short} steps, {FSDP_BLOCKS} "
                       f"blocks)",
              "edit ring": f"720p edit over fsdp 2 x context 2, ring ({short} steps, "
                           f"{FSDP_BLOCKS} blocks)",
              "edit ulysses": f"720p edit over fsdp 2 x context 2, Ulysses ({short} steps, "
                              f"{FSDP_BLOCKS} blocks)"}
    summary = {}
    # every in-dimension at full width is at least the group of 128 rows
    lloyd = {quant.INT4_GROUP: quant._lloyd_levels(quant.INT4_GROUP)}
    for p in FSDP_WORLDS:
        plan = {"device": FSDP_DEVICE, "lloyd": lloyd, "train": whole["train"]}
        wait_for_card(f"fsdp_path world of {p}", FSDP_CARD_GIB[p])
        with compact_workers():
            results, secs = host_s(lambda: run_world(fsdp_worker, p, (p, plan), backend="gloo",
                                                     device=plan["device"], timeout=FSDP_TIMEOUT,
                                                     threads=2))
        print(f"fsdp_path world of {p}: {p} processes sharing one card over host-staged gloo "
              f"(not a scaling figure): the world's {secs:.1f} s, peak memory per rank "
              f"{[round(r['peak_gib'], 2) for r in results]} GiB ({card})")
        summary[f"world{p}_s"] = secs
        if p == 2:
            for rank, r in enumerate(results):
                load = r["load"]
                bad = [n for n, s in load["sums"].items() if s != sums[rank][n]]
                print(f"   rank {rank}: read {load['bytes']['dit'] / 1e9:.3f} GB of the DiT's "
                      f"{total / 1e9:.3f} GB (expected {want_bytes / 1e9:.3f}) and "
                      f"{load['bytes']['loras'] / 1e6:.1f} MB of the LoRA (expected "
                      f"{lora_bytes / 1e6:.1f}) in {load['secs']:.2f} s, "
                      f"{load['gib']:.2f} GiB after the load, peak {r['peak_gib_40']:.2f} GiB "
                      f"over the forward; {len(load['sums']) - len(bad)} of "
                      f"{len(load['sums'])} shards bitwise the one-process model's slices")
                if (load["bytes"]["dit"] != want_bytes or load["bytes"]["loras"] != lora_bytes
                        or bad or load["sums"].keys() != sums[rank].keys()):
                    raise AssertionError(f"fsdp rank {rank}: read {load['bytes']}, expected "
                                         f"{want_bytes} / {lora_bytes}; shards differing from "
                                         f"the whole model's slices: {bad[:8]}")
                summary[f"rank{rank}_dit_bytes"] = load["bytes"]["dit"]
        for key in [k for k in bounds if k in results[0]]:
            per_rank = [r[key] for r in results]
            first = per_rank[0]
            if any(r["digest"] != first["digest"] for r in per_rank) or not first["finite"]:
                raise AssertionError(f"fsdp {labels[key]}: the ranks' outputs differ or are "
                                     f"not finite")
            got, want = torch.from_numpy(first["out"]), ref[key]
            if got.shape != want.shape:
                raise AssertionError(f"fsdp {labels[key]}: {tuple(got.shape)} against "
                                     f"{tuple(want.shape)}")
            db = psnr(got, want)
            forwards = 1 if key == "forward" else short
            ok, held, bound = db >= bounds[key], "", bounds[key]
            bound_text = "bitwise" if bound == math.inf else f"{bound} dB"
            if key != "forward":
                if any(r["latents_digest"] != first["latents_digest"] for r in per_rank):
                    raise AssertionError(f"fsdp {labels[key]}: the ranks' latents differ")
                lat_db = psnr(torch.from_numpy(first["latents"]), latents[key])
                held = (f"final latents {'bitwise' if lat_db == math.inf else f'{lat_db:.2f} dB'}"
                        f", frame ")
                if bound == math.inf:  # the latents carry the bitwise claim
                    tol = TILED_DECODE_TOL * max(1.0, float(want.abs().max()))
                    err = max_err(got, want)
                    ok = lat_db == math.inf and err <= tol
                    held += f"max err {err:.3e}, "
                    bound_text = f"latents bitwise, frame within {tol:.3e}"
            print(f"   {labels[key]}: rank 0 {first['secs']:.3f} s (host staging, not a "
                  f"speed), {first['staged'] / forwards / 1e9:.4f} GB staged a forward and rank, "
                  f"every rank bitwise alike, {held}"
                  f"{'bitwise' if db == math.inf else f'{db:.2f} dB'} "
                  f"against one process (bound: {bound_text}); rank 0's "
                  f"launches {first['launches'][0]}, flash by KV "
                  f"{first['launches'][1]['flash_fwd']}")
            if not ok:
                raise AssertionError(f"fsdp {labels[key]}: {held}{db:.2f} dB against one "
                                     f"process, bound {bound_text}")
            # a CPU rehearsal stages nothing: only CUDA tensors go through the host
            if key == "forward" and dev.type == "cuda" and any(
                    r["staged"] != want_staged for r in per_rank):
                raise AssertionError(f"fsdp forward: staged {[r['staged'] for r in per_rank]} "
                                     f"bytes, predicted the run blocks' shards and the rest, "
                                     f"{want_staged}")
            summary[f"fsdp{p} {key}"] = db
            for r in per_rank:
                launches[0].update(r["launches"][0])
                launches[1].update(r["launches"][1]["flash_fwd"])
        if p == 2:
            print(f"   quantized under fsdp (a gathered block at a time) in "
                  f"{results[0]['quantize_secs']:.1f} s")
        train = [r["train"] for r in results]
        summary[f"train fsdp{p}"] = check_mesh_train(
            "fsdp 2" if p == 2 else "data 2 x fsdp 2", train, whole["train"], card)
        add_train_launches(train, launches)
    summary["secs"] = time.perf_counter() - t_phase
    print(f"fsdp_path: {summary['secs']:.1f} s ({card})")
    return summary


# ----------------------------------------------------------- tensor parallelism

# Tensor parallelism on the one card: worlds of 2 and 4 processes on the
# one card over host-staged gloo, each rank holding its columns of the
# blocks' q / k / v / k_img / v_img / fc1 and its rows of o / fc2 and
# running its heads. The world of 2 loads the 40-block model with the
# distilled LoRA from the directory (each rank its slice of every block
# projection, the rest whole) and runs one 720p forward; then ``tp_model``'s
# weights at TP_BLOCKS blocks serve the edit (TP_SHORT_STEPS steps), the
# three planted
# faults' 2-block forwards, the w4a16 edit quantized under tensor and the
# backward. The world of 4 serves the edit and the w4a16 edit at tensor = 4
# (fc2's 3,456 local rows: 27 groups, padded to 28 for K8), batched CFG over
# tensor 2 x data 2, the edit over tensor 2 x context 2 in both modes, a
# forward over tensor 2 x fsdp 2, and serving (``served_world``). Every row
# product is summed over the
# tensor group in bf16: three (1, 7,200, 5,120) reduces a block, 8.85 GB a
# 40-block forward and rank staged through the host.
TP_WORLDS = (2, 4)
TP_TIMEOUT = 900.0
TP_DEVICE = "cuda:0"  # every rank's device: the one card
TP_BLOCKS = 2
# the tensor worlds' edits: 1 step, cut from 2 to make room for serving (a
# step repeats the same forward)
TP_SHORT_STEPS = 1
# the served requests: 2 steps, so that every rank's UniPC carries one
# step's output and history into the next (its corrector) under the mesh
SERVE_STEPS = 2
# the card's free GiB each world needs: its ranks' peaks and CUDA contexts
# (the world of 4 serves a batch of 2 at 720p: 13.7 GiB a rank
# alone on the card, H100 80GB HBM3, 700.00 W)
TP_CARD_GIB = {2: 44.0, 4: 60.0}
# a tensor-parallel reading against one process: partial products and K4's
# statistics are summed across ranks (bf16 partials, each rounded once more
# than one process rounds its product), so not bitwise
TP_MIN_DB = 35.0
TP_FAULTS = ("k4_local_stats", "bias_on_every_rank", "int4_packed_slice")


def tp_model(dev, cfg):
    """``cp_model``'s pipeline with, from a seeded generator, the bias of
    every block projection redrawn N(0, 0.1) (the init zeroes them, so a
    row-parallel bias added on every rank would not show) and the q / k /
    k_img projections' first half of output channels doubled: the heads of
    a first tensor rank then carry twice the magnitude of the rest, as
    heads of a trained model differ, so a rank's own statistics differ from
    the row's (on the init's iid columns they agree to 1 / sqrt(2,560))."""
    pipe = cp_model(dev, cfg)
    g = torch.Generator(device=dev).manual_seed(6)
    half = cfg.dit.dim // 2
    with torch.no_grad():
        for blk in pipe.dit.blocks:
            for mod in (blk.self_attn, blk.cross_attn, blk.ffn):
                for lin in mod.children():
                    if getattr(lin, "bias", None) is not None:
                        lin.bias.normal_(0.0, 0.1, generator=g)
            for lin in (blk.self_attn.q, blk.self_attn.k, blk.cross_attn.q, blk.cross_attn.k,
                        blk.cross_attn.k_img):
                lin.weight[:half].mul_(2.0)
                lin.bias[:half].mul_(2.0)
    return pipe


def tp_config():
    """The edit model at full width, TP_BLOCKS deep."""
    cfg = cp_config()
    return dataclasses.replace(cfg, dit=dataclasses.replace(cfg.dit, num_layers=TP_BLOCKS))


def tp_want(want):
    """A one-process path's launch counters as a tensor rank reads them:
    every K4 call (``rms_norm``) becomes K4's two tensor-parallel passes."""
    by_name, by_kv = want
    by_name = dict(by_name)
    n = by_name.pop("rms_norm")
    by_name.update(rms_norm=0, rms_sumsq=n, rms_norm_ss=n)
    return by_name, by_kv


def tensor_bytes(files, cfg, dims: dict) -> int:
    """The bytes a tensor = 2 rank reads from the DiT's shards (``files``,
    a ``SafetensorsFiles``), from the headers: half of each tensor the
    plan (``dims``) splits, the whole of the others."""
    from chronoedit_tpu_torch.models.weights import diffusers_dit_names

    names = diffusers_dit_names(cfg.dit)
    total = 0
    for key in files:
        name = names.get(key.removeprefix("transformer."))
        if name is not None:
            total += files.nbytes(key) // (2 if dims[name] is not None else 1)
    return total


def tp_staged_bytes(blocks: int, tokens: int, batch: int = 1) -> int:
    """Bytes a tensor rank stages a forward: per block three bf16 row
    reduces of the (B, tokens, 5,120) stream and K4's five fp32 (B, rows)
    statistics (self q and k, cross q, over the tokens; the text and CLIP
    keys)."""
    rows = 3 * tokens + TEXT_TOKENS + IMAGE_TOKENS
    return blocks * batch * (3 * tokens * 40 * 128 * 2 + rows * 4)


@contextlib.contextmanager
def tp_fault(fault: str | None, p: int = 2):
    """Plant ``fault`` for the duration: "k4_local_stats" (each rank's q / k
    norm from its own columns' statistics, no sum over the ranks),
    "bias_on_every_rank" (a row-parallel product's bias added to every
    rank's partial sum before the reduce) or "int4_packed_slice" (a
    row-split int4 leaf taken as JAX's packed-axis slice: the rank's
    block of the packed bytes and of the groups, used as if it held the
    rank's contiguous rows)."""
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.ops import fused_norms as fn
    from chronoedit_tpu_torch.ops import quant
    from chronoedit_tpu_torch.parallel import collectives as C

    saved = (dit_lib.rms_norm_tensor, dit_lib._row, quant.int4_rows)
    if fault == "k4_local_stats":
        def local(p_norm, x, group, index, size, eps):
            d = x.shape[-1]
            w = p_norm.scale.narrow(0, index * d, d).to(x.dtype)
            return fn._Fused.apply(fn.rms_norm_plain, fn._rms_norm_kernel, 2, w, x, eps)
        dit_lib.rms_norm_tensor = local
    elif fault == "bias_on_every_rank":
        def row(p_lin, x, weights, tp):
            if tp is None:
                return saved[1](p_lin, x, weights, tp)
            return C.reduce_from_tensor(dit_lib._lin(p_lin, x, weights, group=tp.group),
                                        tp.group)
        dit_lib._row = row
    elif fault == "int4_packed_slice":
        def packed_slice(leaf, index, size):
            half = leaf.packed.shape[1] // size
            g = leaf.scales.shape[0] // size
            return quant.QuantLinear4(
                leaf.packed[:, index * half:(index + 1) * half].contiguous(),
                leaf.scales[index * g:(index + 1) * g].contiguous(), leaf.table, leaf.bias,
                leaf.scale8, in_features=leaf.in_features // size)
        quant.int4_rows = packed_slice
    try:
        yield
    finally:
        dit_lib.rms_norm_tensor, dit_lib._row, quant.int4_rows = saved


# Serving under a mesh, in the tensor phase's world of 4 (tensor 2 x
# context 2, ``tp_model`` at TP_BLOCKS blocks, SERVE_STEPS steps): rank
# 0's ``EditServer(max_batch=2)`` takes three 720p requests in one window
# (a batch of 2, then 1) and broadcasts each batch; the other ranks run
# ``pipeline/server.follow``. Requests (inputs seed, noise seed), each also
# run by ``pipe(...)`` in the world. Planted: a session whose followers
# draw each request's noise from seed + 1 (the last request).
SERVE_REQUESTS = ((40, 140), (41, 141), (42, 142))


def served_world(rank: int, pipe, mesh, tcfg, dev, want) -> dict:
    """Rank 0 serves SERVE_REQUESTS through ``EditServer`` under ``mesh``
    and the other ranks follow, each batch's launches zeroed just before
    and held to ``want`` just after on every rank (the batcher's thread on
    rank 0); then every rank runs each request through
    ``pipe.edit_image`` in the world; then a planted session. Every
    request takes SERVE_STEPS steps. Rank 0
    returns the frames and the server's stats and health; every rank its
    batches' sizes, seconds and launches."""
    from chronoedit_tpu_torch.kernels import build
    from chronoedit_tpu_torch.pipeline import server as server_mod

    short = SERVE_STEPS
    reqs = {noise: request(tcfg, dev, seed, EDIT_H, EDIT_W, TEXT_TOKENS)
            for seed, noise in SERVE_REQUESTS}
    inner, draw = server_mod._run, server_mod.request_latents
    res = {"batches": []}

    def counted(pipeline, key, tensors, latents):
        build.reset_launches()
        out, secs = host_s(lambda: inner(pipeline, key, tensors, latents))
        got = read_launches()
        if got != want:
            raise AssertionError(f"rank {rank} served batch of {latents.shape[0]}: launches "
                                 f"{got}, the path implies {want}")
        res["batches"].append({"size": latents.shape[0], "secs": secs, "launches": got})
        return out

    def session(noises, shift: int) -> list:
        server_mod.request_latents = (lambda pipeline, key, seed: draw(pipeline, key,
                                                                       seed + shift))
        if rank != 0:
            return server_mod.follow(pipe, mesh)
        srv = server_mod.EditServer(pipe, server_mod.ServerConfig(
            max_batch=2, max_wait_ms=SERVER_WAIT_MS))
        try:
            futs = [srv.submit(**reqs[n], seed=n, num_steps=short) for n in noises]
            srv.start()  # the requests wait in one window
            frames = [f.result(timeout=600).numpy() for f in futs]
            res.setdefault("health", srv.health())
            res.setdefault("stats", dict(srv.stats))
        finally:
            srv.stop()
        return frames

    server_mod._run = counted
    try:
        res["served"] = session([n for _, n in SERVE_REQUESTS], 0)
        server_mod._run = inner
        res["direct"] = {n: _cp_run(f"edit {n} in the world", functools.partial(
            pipe.edit_image, **reqs[n], num_steps=short,
            generator=torch.Generator(device=dev).manual_seed(n)), want, rank, rank == 0)
            for _, n in SERVE_REQUESTS}
        res["planted"] = session([SERVE_REQUESTS[-1][1]], 0 if rank == 0 else 1)
    finally:
        server_mod._run, server_mod.request_latents = inner, draw
    return res


def check_served(results: list[dict], world_refs: dict, one: dict, card: str,
                 launches: tuple[Counter, Counter]) -> dict:
    """The served frames against the same requests run by ``pipe(...)`` in
    the world (SERVE_MIN_DB) and by one process (TP_MIN_DB), the planted
    follower below both; the batches and launches; adds the sound runs'
    launches to ``launches``."""
    r0 = results[0]["serve"]
    sizes = [[b["size"] for b in r["serve"]["batches"]] for r in results]
    followers = [r["serve"]["served"] for r in results[1:]]
    print(f"   served under tensor 2 x context 2: rank 0's batches of {sizes[0]}, stats "
          f"{r0['stats']}, health {r0['health']}; the followers ran {followers} batches then "
          f"{[r['serve']['planted'] for r in results[1:]]} (planted); batch seconds on rank 0 "
          f"{[round(b['secs'], 2) for b in r0['batches']]} ({card})")
    if any(sz != [2, 1] for sz in sizes) or followers != [2] * (len(results) - 1):
        raise AssertionError(f"served under a mesh: batches {sizes}, followers {followers}")
    readings = {}
    planted_frame = torch.from_numpy(r0["planted"][0])
    for i, (_, n) in enumerate(SERVE_REQUESTS):
        got = torch.from_numpy(r0["served"][i])
        world = world_refs[n]
        db_world, db_one = psnr(got, world), psnr(got, one[n])
        readings[n] = (db_world, db_one)
        print(f"   served request {n}: {db_world:.2f} dB against the world's pipe(...) "
              f"(SERVE_MIN_DB {SERVE_MIN_DB}), {db_one:.2f} dB against one process "
              f"(TP_MIN_DB {TP_MIN_DB})")
        if not (db_world >= SERVE_MIN_DB and db_one >= TP_MIN_DB):
            raise AssertionError(f"served request {n}: {db_world:.2f} / {db_one:.2f} dB")
    n = SERVE_REQUESTS[-1][1]
    planted = (psnr(planted_frame, world_refs[n]), psnr(planted_frame, one[n]))
    print(f"   planted: followers drawing seed + 1, request {n}: {planted[0]:.2f} dB against the "
          f"world's pipe(...), {planted[1]:.2f} dB against one process")
    if not (planted[0] < SERVE_MIN_DB and planted[1] < TP_MIN_DB):
        raise AssertionError(f"the planted follower reads {planted} dB, over the bars")
    for r in results:
        runs = [b["launches"] for b in r["serve"]["batches"][:2]]
        runs += [d["launches"] for d in r["serve"]["direct"].values()]
        for by_name, by_kv in runs:
            launches[0].update(by_name)
            launches[1].update(by_kv["flash_fwd"])
    return {"served_db": readings, "planted_db": planted}


def _leaves_bitwise(model, whole) -> tuple[int, int]:
    """(leaves of ``model`` bitwise ``whole``'s after ``whole`` is split
    by ``shard_params``, leaves): a model quantized under tensor against
    the whole model quantized, then split (int4 rows repacked)."""
    got, want = model.state_dict(), whole.state_dict()
    same = sum(k in got and torch.equal(got[k], want[k]) for k in want)
    return same, len(want)


def tp_worker(rank: int, p: int, plan: dict) -> dict:
    """One rank of a world of ``p`` processes on the one card over gloo,
    its collectives staged through pinned host memory. At ``p`` = 2, under
    tensor 2: loads the distilled model with the distilled LoRA from the
    checkpoint directory (``load_pipeline(..., mesh=)``: its slice of each
    block projection; the leaves' checksums returned) and runs one 720p
    DiT forward of its first ``tp_forward_blocks`` blocks; frees it,
    splits ``tp_model``'s weights at TP_BLOCKS blocks (``shard_params``)
    and serves the 720p edit, runs a
    2-block forward sound and under each planted fault of the bf16 model,
    quantizes under the mesh and serves the w4a16 edit (the leaves held
    bitwise against the whole quantized model's split; a forward under the
    packed-slice fault), then the training checks (``mesh_train``: each
    process's row gathered into the line's two; the state after step 1
    saved, sharded, and restored for step 2 again). At ``p`` = 4: the edit
    and the w4a16 edit under tensor 4; batched CFG (B = 2) over tensor 2 x
    data 2; the edit over tensor 2 x context 2 in each mode, then serving
    under that mesh (``served_world``); a 2-block forward over tensor 2 x
    fsdp 2; the training checks under data 2 x
    tensor 2 (a row a data line), then the tensor 2 checkpoint restored
    under RESTORE_MESH for step 2 (``mesh_restore``). Every edit takes
    TP_SHORT_STEPS steps, the served requests SERVE_STEPS. Every sound run
    with its launch counters zeroed just before and
    held to what the path implies just after (``_cp_run``); rank 0 returns
    the outputs, every rank the digests, seconds, bytes read and staged and
    peak memory."""
    from chronoedit_tpu_torch.kernels import build
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.ops import quant
    from chronoedit_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from chronoedit_tpu_torch.parallel.sharding import shard_params
    from chronoedit_tpu_torch.pipeline.loader import load_pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(plan["device"])
    build.lib()  # the parent's build, loaded: every source hashes the same
    quant._lloyd_levels = plan["lloyd"].__getitem__  # the parent's codebook
    tcfg = tp_config()
    short = TP_SHORT_STEPS
    edit_want = tp_want(cp_launches(tcfg, [(EDIT_TOKENS, "none", 1)] * short))
    fwd_want = tp_want(cp_launches(tcfg, [(EDIT_TOKENS, "none", 1)]))
    w4_want = tp_want(expected_launches(tcfg, [EDIT_TOKENS] * short, int4=True))
    res = {}
    with torch.inference_mode():
        base = tp_model(dev, tcfg)  # every split below is a copy of it

    def sharded_model(mesh, quantized: bool = False):
        pipe = copy.deepcopy(base)
        if quantized:
            pipe.quantize(mode="int4")
        shard_params(pipe.dit, mesh)
        pipe.mesh = mesh
        free()
        return pipe

    def edit(pipe, label, want, **kw):
        req = request(tcfg, dev, kw.pop("seed", 40), EDIT_H, EDIT_W, TEXT_TOKENS)
        gen = torch.Generator(device=dev).manual_seed(kw.pop("gen", 140))
        return _cp_run(label, functools.partial(pipe.edit_image, **req, **kw, generator=gen),
                       want, rank, rank == 0)

    def forward(pipe, label, want, mesh):
        args = cp_inputs(tcfg, dev, EDIT_TOKENS, TP_FORWARD_SEED)
        return _cp_run(label, functools.partial(dit_lib.dit_forward, pipe.dit, *args,
                                                mesh=mesh), want, rank, rank == 0)

    def quantized(pipe, mesh, key):
        """Quantize ``pipe`` under ``mesh``; its leaves against the whole
        quantized model's split; then the w4a16 edit."""
        _, secs = host_s(lambda: pipe.quantize(mode="int4"))
        whole = sharded_model(mesh, quantized=True)
        res[f"{key} leaves"] = _leaves_bitwise(pipe.dit, whole.dit) + (secs,)
        del whole
        free()
        res[key] = edit(pipe, key, w4_want, num_steps=short)

    with torch.inference_mode():
        if p == 4:
            torch.cuda.reset_peak_memory_stats()
            mesh = make_mesh(MeshConfig(tensor=4), device=dev)
            pipe = sharded_model(mesh)
            res["edit tp4"] = edit(pipe, "edit tp4", edit_want, num_steps=short)
            quantized(pipe, mesh, "w4a16 tp4")
            del pipe
            free()
            mesh = make_mesh(MeshConfig(data=2, tensor=2), device=dev)
            pipe = sharded_model(mesh)
            neg = torch.randn((1, TEXT_TOKENS, tcfg.dit.text_dim), device=dev,
                              generator=torch.Generator(device=dev).manual_seed(PP_NEG_SEED))
            res["cfg"] = edit(pipe, "CFG batched", tp_want(cp_launches(
                tcfg, [(EDIT_TOKENS, "none", 1)] * short)), seed=PP_CFG_SEED, gen=130,
                neg_prompt_emb=neg, guidance_scale=5.0, num_steps=short)
            del pipe
            free()
            mesh = make_mesh(MeshConfig(tensor=2, context=2), device=dev)
            pipe = sharded_model(mesh)
            for mode in ("ring", "ulysses"):
                pipe.dit.cfg = dataclasses.replace(tcfg.dit, context_parallel=mode)
                res[f"edit {mode}"] = edit(pipe, f"edit {mode}", tp_want(cp_launches(
                    tcfg, [(EDIT_TOKENS, mode, 2)] * short)), num_steps=short)
            pipe.dit.cfg = tcfg.dit  # "auto": Ulysses on the rank's 20 heads
            res["serve"] = served_world(rank, pipe, mesh, tcfg, dev, tp_want(cp_launches(
                tcfg, [(EDIT_TOKENS, "ulysses", 2)] * SERVE_STEPS)))
            del pipe
            free()
            mesh = make_mesh(MeshConfig(fsdp=2, tensor=2), device=dev)
            pipe = sharded_model(mesh)
            del base
            res["forward fsdp"] = forward(pipe, "forward fsdp", fwd_want, mesh)
            res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            del pipe
        else:
            mesh = make_mesh(MeshConfig(tensor=p), device=dev)
            cfg = main_config()
            torch.cuda.reset_peak_memory_stats()
            pipe, secs = host_s(lambda: load_pipeline(
                cfg, str(CHECKPOINT_DIR), loras=[(str(CHECKPOINT_DIR / "distill_lora.safetensors"),
                                                  1.0)],
                with_text_encoder=False, with_image_encoder=False, device=dev, mesh=mesh))
            res["load"] = {"secs": secs, "bytes": dict(pipe.load_bytes),
                           "gib": torch.cuda.memory_allocated() / 2 ** 30,
                           "sums": {n: tensor_checksum(t) for n, t in pipe.dit.named_parameters()}}
            args = cp_inputs(cfg, dev, EDIT_TOKENS, FSDP_FORWARD_SEED)
            res["forward 40"] = _cp_run("forward 40", functools.partial(
                dit_lib.dit_forward, pipe.dit, *args, mesh=mesh, layer_mask=tp_mask(cfg)),
                tp_want(cp_launches(cfg, [(EDIT_TOKENS, "none", 1)], tp_forward_blocks(cfg))),
                rank, rank == 0)
            res["peak_gib_40"] = torch.cuda.max_memory_allocated() / 2 ** 30
            del pipe
            free()
            torch.cuda.reset_peak_memory_stats()
            pipe = sharded_model(mesh)
            res["edit"] = edit(pipe, "edit", edit_want, num_steps=short)
            res["forward"] = forward(pipe, "forward", fwd_want, mesh)
            for fault in TP_FAULTS[:2]:
                with tp_fault(fault):
                    res[fault] = forward(pipe, fault, None, mesh)
            quantized(pipe, mesh, "w4a16")
            del pipe
            free()
            whole = copy.deepcopy(base).quantize(mode="int4")
            del base
            with tp_fault("int4_packed_slice"):
                shard_params(whole.dit, mesh)
            res["int4_packed_slice"] = forward(whole, "int4_packed_slice", None, mesh)
            res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            del whole
            free()
    if p == 4:
        free()
        res["train"] = mesh_train(rank, dev, make_mesh(MeshConfig(data=2, tensor=2), device=dev),
                                  plan, gathered=False)
        res["restore"] = mesh_restore(rank, dev, make_mesh(MeshConfig(**RESTORE_MESH),
                                                           device=dev), plan)
        return res
    res["train"] = mesh_train(rank, dev, mesh, plan, gathered=True, save=True)
    free()
    return res


def tensor_whole_refs(pipe, dev) -> dict:
    """What ``tensor_path`` holds its world of 2 to, from ``pipe``: the
    distilled model loaded whole from ``CHECKPOINT_DIR`` with its LoRA, as
    each rank loads its slice. Each leaf's tensor = 2 dimension, the
    checksums of each rank's slices, and the 720p forward of its first
    ``tp_forward_blocks`` blocks (``tp_mask``; fp32, on the host)."""
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.parallel.sharding import Shards, tensor_dim

    params = dict(pipe.dit.named_parameters())
    dims = {n: tensor_dim(n, tuple(t.shape), 2) for n, t in params.items()}
    sums = [{n: tensor_checksum(Shards(2, i, dims).local(t, dims[n]))
             for n, t in params.items()} for i in range(2)]
    fwd = dit_lib.dit_forward(pipe.dit, *cp_inputs(pipe.config, dev, EDIT_TOKENS,
                                                   FSDP_FORWARD_SEED),
                              layer_mask=tp_mask(pipe.config))
    return {"dims": dims, "sums": sums, "forward": fwd.float().cpu()}


def tensor_path(dev, whole: dict, launches: tuple[Counter, Counter]) -> dict:
    """Tensor parallelism on the one card: worlds of 2 and 4 processes on
    ``cuda:0`` over host-staged gloo (correctness, bytes and per-rank
    launches, not a scaling figure). ``whole`` holds the whole model's
    references (``tensor_whole_refs``); first, in this process,
    ``tp_model``'s weights at TP_BLOCKS blocks give the rest: the edit,
    batched CFG and the context edit at TP_SHORT_STEPS steps, a
    2-block forward and, quantized to w4a16, the edit at TP_SHORT_STEPS
    steps and the forward again. Each rank's bytes read are held to the
    files' headers, its fused slices to the whole model's, every reading to
    one process at TP_MIN_DB and the planted faults below it, the training
    checks under tensor 2 and data 2 x tensor 2 to ``whole["train"]``
    (``mesh_train_refs``) at the training bars, the sharded checkpoint of
    the world of 2 restored in this process after the world of 4
    (``check_checkpoint``) and under data 2 x tensor 2 (``check_restored``,
    then step 2 at the training bars), the bytes staged by the 40-block
    model's forward to ``tp_staged_bytes``. Adds the workers' launches to
    ``launches``. Needs the card free."""
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.models import weights as w
    from chronoedit_tpu_torch.ops import quant
    from chronoedit_tpu_torch.parallel.launch import run_world

    card = card_line()
    cfg, tcfg = main_config(), tp_config()
    dims, sums, short = whole["dims"], whole["sums"], TP_SHORT_STEPS
    t_phase = time.perf_counter()
    with torch.inference_mode():
        small = tp_model(dev, tcfg)

        def edit(seed, gen, **kw):
            req = request(tcfg, dev, seed, EDIT_H, EDIT_W, TEXT_TOKENS)
            return small.edit_image(**req, **kw, generator=torch.Generator(
                device=dev).manual_seed(gen)).float().cpu()

        def forward():
            args = cp_inputs(tcfg, dev, EDIT_TOKENS, TP_FORWARD_SEED)
            return dit_lib.dit_forward(small.dit, *args).float().cpu()

        neg = torch.randn((1, TEXT_TOKENS, tcfg.dit.text_dim), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(PP_NEG_SEED))
        ref = {"forward 40": whole["forward"], "edit": edit(40, 140, num_steps=short),
               **{f"serve {n}": edit(seed, n, num_steps=SERVE_STEPS)
                  for seed, n in SERVE_REQUESTS},
               "forward": forward(),
               "cfg": edit(PP_CFG_SEED, 130, neg_prompt_emb=neg, guidance_scale=5.0,
                           num_steps=short)}
        ref["edit tp4"] = ref["edit"]
        ref["forward fsdp"] = ref["k4_local_stats"] = ref["bias_on_every_rank"] = ref["forward"]
        ref["edit ring"] = ref["edit ulysses"] = ref["edit"]
        small.quantize(mode="int4")
        ref["w4a16"] = ref["w4a16 tp4"] = edit(40, 140, num_steps=short)
        ref["int4_packed_slice"] = forward()
        del small
        free()
    print(f"tensor_path: the one-process references at {TP_BLOCKS} blocks in "
          f"{time.perf_counter() - t_phase:.1f} s")
    shards = sorted(str(f) for f in (CHECKPOINT_DIR / "transformer").glob("*.safetensors"))
    with w.load_safetensors(shards) as sd, \
            w.load_safetensors(str(CHECKPOINT_DIR / "distill_lora.safetensors")) as lsd:
        total = sum(sd.nbytes(k) for k in sd)
        want_bytes = tensor_bytes(sd, cfg, dims)
        lora_bytes = sum(lsd.nbytes(k) for k in lsd)
    want_staged = tp_staged_bytes(tp_forward_blocks(cfg), EDIT_TOKENS)
    peak = {"forward 40": True, "forward": True, "forward fsdp": True,
            **{f: True for f in TP_FAULTS}}
    labels = {"forward 40": f"720p DiT forward ({cfg.dit.num_layers} blocks, the first "
                            f"{tp_forward_blocks(cfg)} run), tensor 2",
              "edit": f"720p edit ({short} steps, {TP_BLOCKS} blocks), tensor 2",
              "forward": f"720p DiT forward ({TP_BLOCKS} blocks), tensor 2",
              "k4_local_stats": "planted: K4 on each rank's local statistics",
              "bias_on_every_rank": "planted: the row products' bias added on every rank",
              "w4a16": f"w4a16 edit, quantized under tensor 2 ({short} steps, {TP_BLOCKS} "
                        f"blocks)",
              "int4_packed_slice": "planted: w4a16 forward, int4 rows as JAX's packed-axis "
                                   "slice",
              "edit tp4": f"720p edit ({short} steps, {TP_BLOCKS} blocks), tensor 4",
              "w4a16 tp4": f"w4a16 edit, quantized under tensor 4 (fc2 padded to 28 groups; "
                           f"{short} steps, {TP_BLOCKS} blocks)",
              "cfg": f"CFG batched, guidance 5, over tensor 2 x data 2 ({short} steps, "
                     f"{TP_BLOCKS} blocks)",
              "edit ring": f"720p edit over tensor 2 x context 2, ring ({short} steps, "
                           f"{TP_BLOCKS} blocks)",
              "edit ulysses": f"720p edit over tensor 2 x context 2, Ulysses ({short} steps, "
                              f"{TP_BLOCKS} blocks)",
              "forward fsdp": f"720p DiT forward over tensor 2 x fsdp 2 ({TP_BLOCKS} blocks)"}
    summary, sound, faults = {}, {}, {}
    # every in-dimension at full width is at least the group of 128 rows
    lloyd = {quant.INT4_GROUP: quant._lloyd_levels(quant.INT4_GROUP)}
    for p in TP_WORLDS:
        plan = {"device": TP_DEVICE, "lloyd": lloyd, "train": whole["train"]}
        wait_for_card(f"tensor_path world of {p}", TP_CARD_GIB[p])
        with compact_workers():
            results, secs = host_s(lambda: run_world(tp_worker, p, (p, plan), backend="gloo",
                                                     device=plan["device"], timeout=TP_TIMEOUT,
                                                     threads=2))
        print(f"tensor_path world of {p}: {p} processes sharing one card over host-staged gloo "
              f"(not a scaling figure): the world's {secs:.1f} s, peak memory per rank "
              f"{[round(r['peak_gib'], 2) for r in results]} GiB ({card})")
        summary[f"world{p}_s"] = secs
        if p == 2:
            for rank, r in enumerate(results):
                load = r["load"]
                bad = [n for n, s in load["sums"].items() if s != sums[rank][n]]
                print(f"   rank {rank}: read {load['bytes']['dit'] / 1e9:.3f} GB of the DiT's "
                      f"{total / 1e9:.3f} GB (expected {want_bytes / 1e9:.3f}) and "
                      f"{load['bytes']['loras'] / 1e6:.1f} MB of the LoRA (expected "
                      f"{lora_bytes / 1e6:.1f}) in {load['secs']:.2f} s, "
                      f"{load['gib']:.2f} GiB after the load, peak {r['peak_gib_40']:.2f} GiB "
                      f"over the forward; {len(load['sums']) - len(bad)} of "
                      f"{len(load['sums'])} leaves bitwise the one-process model's slices")
                if (load["bytes"]["dit"] != want_bytes or load["bytes"]["loras"] != lora_bytes
                        or bad or load["sums"].keys() != sums[rank].keys()):
                    raise AssertionError(f"tensor rank {rank}: read {load['bytes']}, expected "
                                         f"{want_bytes} / {lora_bytes}; leaves differing from "
                                         f"the whole model's slices: {bad[:8]}")
                summary[f"rank{rank}_dit_bytes"] = load["bytes"]["dit"]
        for key in [k for k in labels if k in results[0]]:
            per_rank = [r[key] for r in results]
            first = per_rank[0]
            if any(r["digest"] != first["digest"] for r in per_rank) or not first["finite"]:
                raise AssertionError(f"tensor {labels[key]}: the ranks' outputs differ or are "
                                     f"not finite")
            got, want = torch.from_numpy(first["out"]), ref[key]
            if got.shape != want.shape:
                raise AssertionError(f"tensor {labels[key]}: {tuple(got.shape)} against "
                                     f"{tuple(want.shape)}")
            db = peak_db(got, want) if key in peak else psnr(got, want)
            forwards = 1 if key in peak else short
            print(f"   {labels[key]}: rank 0 {first['secs']:.3f} s (host staging, not a "
                  f"speed), {first['staged'] / forwards / 1e9:.4f} GB staged a forward and rank, "
                  f"every rank bitwise alike, {db:.2f} dB against one process"
                  f"{' over its peak' if key in peak else ''}; rank 0's launches "
                  f"{first['launches'][0]}, flash by KV {first['launches'][1]['flash_fwd']}, "
                  f"int4 by rows {first['launches'][1]['int4_matmul']}")
            (faults if key in TP_FAULTS else sound)[key] = db
            if key == "forward 40" and dev.type == "cuda" and any(
                    r["staged"] != want_staged for r in per_rank):
                raise AssertionError(f"tensor forward: staged {[r['staged'] for r in per_rank]} "
                                     f"bytes, predicted {want_staged}")
            summary[f"tp{p} {key}"] = db
            if key not in TP_FAULTS:
                for r in per_rank:
                    launches[0].update(r["launches"][0])
                    launches[1].update(r["launches"][1]["flash_fwd"])
        if "serve" in results[0]:
            direct = results[0]["serve"]["direct"]
            for n in direct:
                if any(r["serve"]["direct"][n]["digest"] != direct[n]["digest"] for r in results):
                    raise AssertionError(f"request {n} in the world: the ranks' frames differ")
            world_refs = {n: torch.from_numpy(d["out"]) for n, d in direct.items()}
            one = {n: ref[f"serve {n}"] for _, n in SERVE_REQUESTS}
            summary["serve"] = check_served(results, world_refs, one, card, launches)
        for rank, r in enumerate(results):
            for key in ("w4a16 leaves", "w4a16 tp4 leaves"):
                if key in r:
                    same, n, qsecs = r[key]
                    print(f"   rank {rank} {key}: {same} of {n} quantized under tensor bitwise "
                          f"the whole quantized model's split (quantizing {qsecs:.1f} s)")
                    if same != n:
                        raise AssertionError(f"tensor rank {rank} {key}: {n - same} leaves "
                                             f"differ from the whole quantized model's split")
        train = [r["train"] for r in results]
        summary[f"train tp{p}"] = check_mesh_train(
            "tensor 2" if p == 2 else "data 2 x tensor 2", train, whole["train"], card)
        add_train_launches(train, launches)
        if p == 2:
            saved = train
        else:
            # the world of 2's checkpoint in one process, once the world of
            # 4 has left the card (its restore leaves this process holding
            # 8 GiB, which the world of 4's served batch of 2 needs)
            checkpoint = check_checkpoint(dev, saved, card)
            restored = [r["restore"] for r in results]
            label = " x ".join(f"{a} {n}" for a, n in RESTORE_MESH.items())
            check_restored(checkpoint, restored, label)
            update = sum_stats([r["resumed"]["update"] for r in restored])
            moment = sum_stats([r["resumed"]["moment"] for r in restored])
            metrics = restored[0]["resumed"]["metrics"]
            loss_rel = abs(metrics["loss"] - whole["train"]["metrics"][1]["loss"]) / abs(
                whole["train"]["metrics"][1]["loss"])
            print(f"   step 2 under {label} from the tensor 2 checkpoint of step "
                  f"{restored[0]['restored_step']}: loss {loss_rel:.2e} relative, the update "
                  f"{update['rel']:.3e}, Adam's first moment {moment['rel']:.3e} normwise "
                  f"against one process's; restored in {restored[0]['restore_secs']:.2f} s, "
                  f"the step {restored[0]['resumed']['secs']:.2f} s")
            if not (loss_rel <= TRAIN_LOSS_REL and update["rel"] <= TRAIN_UPDATE_REL
                    and moment["rel"] <= TRAIN_MOMENT_REL):
                raise AssertionError(f"step 2 from the tensor 2 checkpoint under {label} misses "
                                     f"the training bars")
            add_train_launches(restored, launches)
    print(f"tensor_path: sound readings {min(sound.values()):.2f}-{max(sound.values()):.2f} dB, "
          f"planted faults {min(faults.values()):.2f}-{max(faults.values()):.2f} dB (TP_MIN_DB "
          f"{TP_MIN_DB}) ({card})")
    if not min(sound.values()) >= TP_MIN_DB > max(faults.values()):
        raise AssertionError(f"tensor: sound {sound}, faults {faults}: TP_MIN_DB {TP_MIN_DB} "
                             f"must lie between them")
    summary["secs"] = time.perf_counter() - t_phase
    print(f"tensor_path: {summary['secs']:.1f} s ({card})")
    return summary


# ----------------------------------------------------------- training under a mesh

# Training under a mesh on the one card, inside the FSDP and tensor worlds:
# one rank-32 LoRA step and two full-parameter ``Trainer`` steps (AdamW, the
# clip at half the first gradient's norm, EMA) of ``tp_model``'s weights at
# TP_BLOCKS blocks on one global batch of MESH_BATCH 720p pairs (7,200
# tokens each) with the Trainer's draws, under fsdp 2, tensor 2 (the worlds
# of 2; each process holds its row and ``host_local_to_global`` gathers the
# line's two) and data 2 x fsdp 2, data 2 x tensor 2 (the worlds of 4: a
# row a data line). Each against one process on the same weights, batch and
# draws (``mesh_train_refs``: its step-1 gradients, its parameters and
# Adam's first moment after step 2 and its adapter gradient, written under
# MESH_DIR, of which a rank reads only its blocks) at the training bars.
# The planted faults are read from the sound run's own tensors: the norm
# over a rank's own shards, the gradients left as each line computed them
# (captured before the mean over data), and the replicated q / k norm
# weights' gradients left unreduced over tensor (captured before their
# sum). Gradients summed over data, not averaged, are planted in the world
# by the CPU test (``tests/test_torch_train_mesh.py``), not here. A sharded
# checkpoint of the tensor 2 state after step 1: restored into the same
# state, step 2 again bitwise; in one process (the parent), bitwise the
# gathered whole; under data 2 x fsdp 2 (RESTORE_MESH, in the tensor world
# of 4), bitwise the whole's blocks, and step 2 at the training bars.
MESH_BATCH = 2
MESH_SEED = 70
MESH_DIR = BUILD_DIR / "smoke_mesh_train"  # on the disk: 14.7 GB
MESH_LORA_RANK = 32
# the layout the tensor 2 checkpoint is restored into, in the tensor world of 4
RESTORE_MESH = {"data": 2, "fsdp": 2}
# the reference's tensors a rank compares with, each a file under MESH_DIR
MESH_REFS = ("grads", "params", "exp_avg", "lora_grads")
# the train CLI as a world of one over NCCL: the 14B model's width at this depth
MESH_CLI_BLOCKS = 2


def mesh_train_config():
    """``tp_config``'s model (TP_BLOCKS blocks of full width), remat "none"."""
    cfg = tp_config()
    return dataclasses.replace(cfg, dit=dataclasses.replace(cfg.dit, remat="none"))


def mesh_train_batch(cfg, dev) -> dict:
    """The global batch: MESH_BATCH 720p edit pairs' latents and conditions
    (2 latent frames, 7,200 tokens) and prompt / CLIP embeddings, seeded on
    the device (the same bits in every process on the card)."""
    g = torch.Generator(device=dev).manual_seed(MESH_SEED)
    d, b, h, w = cfg.dit, MESH_BATCH, EDIT_H // 8, EDIT_W // 8
    return {"latents": torch.randn((b, d.out_channels, 2, h, w), generator=g, device=dev),
            "condition": torch.randn((b, d.in_channels - d.out_channels, 2, h, w), generator=g,
                                     device=dev),
            "text_emb": torch.randn((b, TEXT_TOKENS, d.text_dim), generator=g, device=dev),
            "image_emb": torch.randn((b, d.image_tokens, d.image_dim), generator=g,
                                     device=dev)}


def mesh_lora(dit, dev):
    """Seeded rank-32 adapters of the whole model's shapes over ``dit``
    (whole or sharded), b drawn N(0, 0.02) so that every a has a
    gradient."""
    from chronoedit_tpu_torch.models import lora as lora_lib

    g = torch.Generator(device=dev).manual_seed(MESH_SEED + 1)
    lora = lora_lib.init_lora_params(g, dit, lora_lib.LoRAConfig(rank=MESH_LORA_RANK))
    with torch.no_grad():
        for blk in lora.blocks:
            for _, ad in lora_lib.iter_adapters(blk):
                ad.b.normal_(0.0, 0.02, generator=g)
    return lora


def mesh_tcfg(clip: float):
    from chronoedit_tpu_torch.train.train_step import TrainConfig

    return TrainConfig(lr=TRAIN_LR, warmup_steps=1, grad_clip=clip)


@contextlib.contextmanager
def capture_step(state, owner):
    """For the next micro-step of ``state`` (parameters named as
    ``owner``'s): ``grads``, what its optimizer applies (this rank's
    shards, averaged over data); ``line``, the gradients before the mean
    over data; ``partial``, the rank's own gradient of each leaf that
    ``sum_grad_autograd`` sums over a group, before the sum (over tensor:
    the q / k norm weights, each used in slices)."""
    from chronoedit_tpu_torch.parallel import collectives as C
    from chronoedit_tpu_torch.train import train_step

    got = {"grads": None, "line": None, "partial": {}}
    names = {id(p): n for n, p in owner.named_parameters()}
    update, mean, sum_grad = state.optimizer.update, train_step.data_mean, C.sum_grad_autograd

    def update_(grads):
        if got["grads"] is None:
            got["grads"] = [g.detach().clone() for g in grads]
        return update(grads)

    def mean_(tensors, mesh):
        tensors = list(tensors)
        if (got["line"] is None and len(tensors) == len(names) and mesh is not None
                and mesh.group("data") is not None):
            got["line"] = [t.detach().clone() for t in tensors]
        return mean(tensors, mesh)

    def sum_grad_(x, group):
        y = sum_grad(x, group)
        name = names.get(id(x))
        if name is not None and y.requires_grad:
            y.register_hook(lambda g: got["partial"].setdefault(name, g.detach().clone()))
        return y

    state.optimizer.update = update_
    train_step.data_mean, C.sum_grad_autograd = mean_, sum_grad_
    try:
        yield got
    finally:
        del state.optimizer.update
        train_step.data_mean, C.sum_grad_autograd = mean, sum_grad


def ref_file(kind: str) -> Path:
    return MESH_DIR / "refs" / kind / "params.safetensors"


def block_stats(tensors: dict, owner, kind: str, minus: dict | None = None,
                k67: bool = False) -> dict:
    """Each of this rank's ``tensors`` (by parameter name of ``owner``)
    against its block of the one-process reference ``kind`` (both less
    ``minus``'s tensor, this rank's weights before: an update): {name:
    [block start, got . want,
    |got|^2, |want|^2, |got - want|^2, K6/K7's normwise error and verdict
    (with ``k67``)]}, for the parent to sum over the distinct blocks."""
    from safetensors import safe_open

    from chronoedit_tpu_torch.parallel.sharding import local_box

    out = {}
    with safe_open(str(ref_file(kind)), framework="pt") as f:
        for name, t in tensors.items():
            _, start = local_box(owner, name, tuple(t.shape))
            want = f.get_slice(name)[tuple(slice(s, s + n) for s, n in zip(start, t.shape))]
            got, w = t.detach().float(), want.to(t.device).float()
            if minus is not None:
                got, w = got - minus[name].float(), w - minus[name].float()
            check = (k67_check(t.detach(), want.to(t.device)) if k67
                     else {"rel": 0.0, "ok": True})
            out[name] = [list(start), float((got * w).sum()), float(got.square().sum()),
                         float(w.square().sum()), float((got - w).square().sum()),
                         check["rel"], check["ok"]]
    return out


def sum_stats(per_rank: list[dict]) -> dict:
    """Cosine, normwise error and norm error of the whole vector from the
    ranks' ``block_stats``, each distinct block once (the first rank
    holding it); the leaves within K6/K7's bounds and the worst."""
    seen, dot, sg, sw, sd = set(), 0.0, 0.0, 0.0, 0.0
    within, worst = 0, ("none", 0.0)
    for stats in per_rank:
        for name, (start, d, g, w, diff, rel, ok) in stats.items():
            if (name, tuple(start)) in seen:
                continue
            seen.add((name, tuple(start)))
            dot, sg, sw, sd = dot + d, sg + g, sw + w, sd + diff
            within += bool(ok)
            worst = max(worst, (name, rel), key=lambda kv: kv[1])
    return {"cos": dot / math.sqrt(sg * sw), "norm_rel": abs(math.sqrt(sg) - math.sqrt(sw))
            / math.sqrt(sw), "rel": math.sqrt(max(sd, 0.0) / sw), "blocks": len(seen),
            "within": within, "worst": worst}


def _counted(label: str, fn, want, rank: int):
    """``fn()`` with the launch counters zeroed just before and held to
    ``want`` just after; (its result, seconds, launches, bytes staged)."""
    from chronoedit_tpu_torch.kernels import build
    from chronoedit_tpu_torch.parallel import collectives

    staged = collectives.STAGED_BYTES["bytes"]
    build.reset_launches()
    out, secs = host_s(fn)
    got = read_launches()
    if got != want:
        raise AssertionError(f"rank {rank} {label}: launches {got}, the path implies {want}")
    return out, secs, got, collectives.STAGED_BYTES["bytes"] - staged


def _train_launches(cfg, steps: int, lora: bool, tensor: bool):
    want = expected_train_launches(cfg, remat="none", lora=lora, steps=steps)
    return tp_want(want) if tensor else want


def metrics_callback():
    """A Trainer callback keeping each iteration's loss and grad_norm in
    its ``rows``."""
    from chronoedit_tpu_torch.train.callbacks import Callback

    class Metrics(Callback):
        def __init__(self):
            self.rows = []

        def on_step_end(self, trainer, step, metrics):
            self.rows.append({k: float(metrics[k]) for k in ("loss", "grad_norm")})

    return Metrics()


def mesh_trainer(cfg, mesh, clip: float, max_iter: int, metrics=None):
    from chronoedit_tpu_torch.train.trainer import Trainer, TrainerConfig

    return Trainer(cfg.dit, mesh_tcfg(clip), TrainerConfig(max_iter=max_iter, save_every=10 ** 9),
                   callbacks=[metrics] if metrics is not None else None, mesh=mesh)


def state_sums(state) -> dict:
    """{checkpoint name: [box start, shape, ``tensor_checksum``]} of this
    rank's tensors of a train state."""
    from chronoedit_tpu_torch.train import checkpoint as ck

    boxes = ck.state_boxes(state)
    return {k: [list(boxes[k][1]), list(t.shape), tensor_checksum(t)]
            for k, t in ck.state_tensors(state).items()}


def mesh_train_refs(dev) -> dict:
    """The one-process reference of the mesh training checks, written under
    MESH_DIR: ``mesh_train_config``'s ``tp_model`` weights; one LoRA step
    (its adapter gradients, ``lora_grads``); a Trainer step with no clip to
    read the first gradient's norm, then from the same weights (which a
    warm-up step leaves as they were) two Trainer steps with the clip at
    half of it: the first step's gradients (``grads``), the parameters and
    Adam's first moment after the second (``params``, ``exp_avg``).
    Returns the clip and each step's loss and grad_norm."""
    from chronoedit_tpu_torch.train import checkpoint as ck
    from chronoedit_tpu_torch.train import lora_train

    t0 = time.perf_counter()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    cfg = mesh_train_config()
    dit = tp_model(dev, cfg).dit
    batch = mesh_train_batch(cfg, dev)
    lora = mesh_lora(dit, dev)
    lstate = lora_train.make_lora_train_state(lora, mesh_tcfg(1e9))
    with capture_step(lstate, lora) as cap:
        lm = lora_train.make_lora_train_step(cfg.dit, mesh_tcfg(1e9))(
            lstate, dit, batch, torch.Generator(device=dev).manual_seed(MESH_SEED + 2))
    ck.save_params(str(MESH_DIR / "refs" / "lora_grads"),
                   {n: g for (n, _), g in zip(lora.named_parameters(), cap["grads"])})
    del lora, lstate, cap
    free()
    probe = metrics_callback()
    trainer = mesh_trainer(cfg, None, 1e9, 1, probe)
    trainer.train(trainer.init_state(dit), iter([batch]))
    clip = 0.5 * probe.rows[0]["grad_norm"]
    free()
    metrics = metrics_callback()
    trainer = mesh_trainer(cfg, None, clip, 2, metrics)
    state = trainer.init_state(dit)
    names = [n for n, _ in dit.named_parameters()]
    with capture_step(state, dit) as cap:
        trainer.train(state, iter([batch] * 2))
    adamw = state.optimizer.adamw.state
    for kind, tensors in (("grads", cap["grads"]), ("params", state.params),
                          ("exp_avg", [adamw[p]["exp_avg"] for p in state.params])):
        ck.save_params(str(MESH_DIR / "refs" / kind), dict(zip(names, tensors)))
    nbytes = sum(ref_file(k).stat().st_size for k in MESH_REFS)
    del dit, state, cap, trainer
    free()
    secs = time.perf_counter() - t0
    print(f"mesh training's one-process reference ({TP_BLOCKS} blocks x 5120, B = {MESH_BATCH} "
          f"at {EDIT_TOKENS} tokens): clip {clip:.4e}, losses "
          f"{[round(m['loss'], 6) for m in metrics.rows]}, grad_norms "
          f"{[round(m['grad_norm'], 4) for m in metrics.rows]}, LoRA loss {float(lm['loss']):.6f}; "
          f"{nbytes / 1e9:.3f} GB written in {secs:.1f} s ({card_line()})")
    return {"clip": clip, "metrics": metrics.rows, "lora_loss": float(lm["loss"]),
            "secs": secs}


def _line(batch: dict, mesh, gathered: bool) -> dict:
    """This rank's data line's rows of the global ``batch``: gathered from
    each process's own rows by ``host_local_to_global`` (``gathered``), or
    taken as the line's rows (a world of more processes than rows)."""
    from chronoedit_tpu_torch.parallel.distributed import host_local_to_global, process_index

    if gathered:
        n = MESH_BATCH // mesh.size
        mine = slice(process_index() * n, (process_index() + 1) * n)
        return host_local_to_global({k: v[mine] for k, v in batch.items()}, mesh)
    b = MESH_BATCH // mesh.shape["data"]
    rows = slice(mesh.index("data") * b, (mesh.index("data") + 1) * b)
    return {k: v[rows] for k, v in batch.items()}


def mesh_train(rank: int, dev, mesh, plan: dict, gathered: bool, save: bool = False) -> dict:
    """The training checks of one rank under ``mesh``: ``tp_model``'s
    weights sharded by ``shard_params``; one LoRA step (adapter gradients
    against the reference's); two Trainer steps (step 1's loss, grad_norm,
    gradients: the whole vector's cosine and norm and K6/K7's per-leaf
    bounds, each from its blocks; step 2's loss, grad_norm, update and
    Adam's first moment), each run with its launches held exact; the fault
    readings from the captured tensors. With ``save`` the state after step
    1 is saved under ``checkpoint_dir()`` (sharded, async: step 2 runs
    while it is written) and after step 2 it is restored into the same
    state for step 2 again (checksums against the straight run's)."""
    from chronoedit_tpu_torch.parallel.consistency import check_replica_consistency
    from chronoedit_tpu_torch.parallel.sharding import shard_params
    from chronoedit_tpu_torch.train import checkpoint as ck
    from chronoedit_tpu_torch.train import lora_train

    cfg, clip = mesh_train_config(), plan["train"]["clip"]
    tensor = mesh.shape["tensor"] > 1
    res = {"mesh": dict(mesh.shape)}
    dit = shard_params(tp_model(dev, cfg).dit, mesh)
    line = _line(mesh_train_batch(cfg, dev), mesh, gathered)
    free()
    # one LoRA step over the frozen sharded base
    lora = mesh_lora(dit, dev)
    lstate = lora_train.make_lora_train_state(lora, mesh_tcfg(1e9), mesh)
    step = lora_train.make_lora_train_step(cfg.dit, mesh_tcfg(1e9), mesh)
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED + 2)
    with capture_step(lstate, lora) as cap:
        lm, secs, got, staged = _counted("LoRA step", lambda: step(lstate, dit, line, gen),
                                         _train_launches(cfg, 1, True, tensor), rank)
    names = [n for n, _ in lora.named_parameters()]
    res["lora"] = {"loss": float(lm["loss"]), "secs": secs, "launches": got, "staged": staged,
                   "stats": block_stats(dict(zip(names, cap["grads"])), lora, "lora_grads")}
    del lora, lstate, cap
    free()

    def run(state, max_iter, label, capture=False):
        metrics = metrics_callback()
        trainer = mesh_trainer(cfg, mesh, clip, max_iter, metrics)
        steps = max_iter - state.step
        with capture_step(state, dit) if capture else contextlib.nullcontext() as cap:
            _, secs, got, staged = _counted(
                label, lambda: trainer.train(state, iter([line] * steps)),
                _train_launches(cfg, steps, False, tensor), rank)
        return metrics.rows, {"secs": secs, "launches": got, "staged": staged}, cap

    state = mesh_trainer(cfg, mesh, clip, 2).init_state(dit)
    names = [n for n, _ in dit.named_parameters()]
    before = {n: p.detach().clone() for n, p in zip(names, state.params)}
    torch.cuda.reset_peak_memory_stats()
    rows, res["step1"], cap = run(state, 1, "Trainer step 1", capture=True)
    grads = dict(zip(names, cap["grads"]))
    res["step1"].update(metrics=rows[0], stats=block_stats(grads, dit, "grads", k67=True),
                        local_norm=math.sqrt(sum(float(g.float().square().sum())
                                                 for g in cap["grads"])))
    if cap["line"] is not None:
        res["step1"]["line_stats"] = block_stats(dict(zip(names, cap["line"])), dit, "grads")
    if tensor:
        whole = {n: g for n, g in grads.items() if dit.tensor.dims.get(n) is None}
        res["step1"]["replicas"] = check_replica_consistency(whole, mesh.group("tensor"))
        partial = {n: cap["partial"][n] for n in sorted(cap["partial"])}
        res["step1"]["partial_replicas"] = check_replica_consistency(partial,
                                                                     mesh.group("tensor"))
        res["step1"]["partial_stats"] = block_stats(partial, dit, "grads")
    del cap, grads
    free()
    if save:
        mgr = ck.CheckpointManager(ck.CheckpointConfig(directory=checkpoint_dir()))
        _, res["save_secs"] = host_s(lambda: mgr.save(1, state))  # the host copy, then async
        res["saved"] = state_sums(state)
    rows, res["step2"], _ = run(state, 2, "Trainer step 2")
    if save:
        _, res["wait_secs"] = host_s(mgr.wait_until_finished)
        file = checkpoint_dir() / "1" / ck.RANK_FILE.format(rank)
        res["file_bytes"] = file.stat().st_size if file.exists() else 0
    adamw = state.optimizer.adamw.state
    res["step2"].update(
        metrics=rows[0], peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        update=block_stats(dict(zip(names, state.params)), dit, "params", minus=before),
        moment=block_stats({n: adamw[p]["exp_avg"] for n, p in zip(names, state.params)}, dit,
                           "exp_avg"))
    if save:  # the same layout: step 2 again from the restored step 1
        straight = [s[2] for s in state_sums(state).values()]
        _, res["restore_secs"] = host_s(lambda: ck.CheckpointManager(
            ck.CheckpointConfig(directory=checkpoint_dir())).restore(state))
        res["restored_step"] = state.step
        _, res["resumed"], _ = run(state, 2, "Trainer step 2 after the restore")
        res["resumed"]["bitwise"] = [s[2] for s in state_sums(state).values()] == straight
    del state, dit
    free()
    return res


def checkpoint_dir() -> Path:
    return MESH_DIR / "checkpoint"


def mesh_restore(rank: int, dev, mesh, plan: dict) -> dict:
    """The tensor 2 world's checkpoint of step 1 restored into a fresh
    state of ``tp_model``'s weights sharded for ``mesh`` (another layout:
    each rank reads its blocks from the files' tensor blocks), the
    restored tensors' checksums returned; then step 2 (its launches held
    exact), its update and Adam's first moment against the reference's."""
    from chronoedit_tpu_torch.parallel.sharding import shard_params
    from chronoedit_tpu_torch.train import checkpoint as ck

    cfg, clip = mesh_train_config(), plan["train"]["clip"]
    dit = shard_params(tp_model(dev, cfg).dit, mesh)
    line = _line(mesh_train_batch(cfg, dev), mesh, gathered=False)
    state = mesh_trainer(cfg, mesh, clip, 2).init_state(dit)
    names = [n for n, _ in dit.named_parameters()]
    free()
    res = {"mesh": dict(mesh.shape)}
    _, res["restore_secs"] = host_s(lambda: ck.CheckpointManager(
        ck.CheckpointConfig(directory=str(checkpoint_dir()))).restore(state))
    res["restored"] = state_sums(state)
    res["restored_step"] = state.step
    before = {n: p.detach().clone() for n, p in zip(names, state.params)}
    metrics = metrics_callback()
    trainer = mesh_trainer(cfg, mesh, clip, 2, metrics)
    _, secs, got, staged = _counted(
        "Trainer step 2 after the restore", lambda: trainer.train(state, iter([line])),
        _train_launches(cfg, 1, False, mesh.shape["tensor"] > 1), rank)
    adamw = state.optimizer.adamw.state
    res["resumed"] = {
        "secs": secs, "launches": got, "staged": staged, "metrics": metrics.rows[0],
        "update": block_stats(dict(zip(names, state.params)), dit, "params", minus=before),
        "moment": block_stats({n: adamw[p]["exp_avg"] for n, p in zip(names, state.params)},
                              dit, "exp_avg")}
    del state, dit, before
    free()
    return res


def layout_sums(whole: dict, cfg, config: dict, world: int) -> list[dict]:
    """For each rank of a mesh of ``config`` over ``world`` processes, the
    ``tensor_checksum`` of its block of each of the ``whole`` state's
    tensors (the blocks ``shard_params`` gives that rank, found on a
    ``meta`` model)."""
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.parallel.mesh import Mesh, MeshConfig
    from chronoedit_tpu_torch.parallel.sharding import local_box, shard_params

    shape, out = MeshConfig(**config).resolve(world), []
    for rank in range(world):
        model = shard_params(dit_lib.DiT(cfg.dit, device="meta"),
                             Mesh(shape, rank, torch.device("meta")))
        boxes = {n: (local_box(model, n, tuple(p.shape))[1], tuple(p.shape))
                 for n, p in model.named_parameters()}
        sums = {}
        for k, t in whole.items():
            start, size = boxes[k.rsplit("/", 1)[1]]
            block = t[tuple(slice(a, a + n) for a, n in zip(start, size))]
            sums[k] = tensor_checksum(block.contiguous())
        out.append(sums)
    return out


def check_mesh_train(label: str, results: list[dict], refs: dict, card: str) -> dict:
    """The parent's verdict on one mesh's training checks (``mesh_train``'s
    per-rank results against the reference's readings): every bar, every
    planted fault outside its bar, printed with its reading. Returns the
    readings."""
    ref = refs["metrics"]
    r0 = results[0]
    rd = {}

    def rel(got, want):
        return abs(got - want) / abs(want)

    lora = sum_stats([results[0]["lora"]["stats"]])
    steps = [r0["step1"]["metrics"], r0["step2"]["metrics"]]
    rd["loss_rel"] = max(rel(s["loss"], w["loss"]) for s, w in zip(steps, ref))
    rd["norm_rel"] = max(rel(s["grad_norm"], w["grad_norm"]) for s, w in zip(steps, ref))
    grads = sum_stats([r["step1"]["stats"] for r in results])
    update = sum_stats([r["step2"]["update"] for r in results])
    moment = sum_stats([r["step2"]["moment"] for r in results])
    rd.update(lora_cos=lora["cos"], lora_norm_rel=lora["norm_rel"], grad_cos=grads["cos"],
              grad_norm_rel=grads["norm_rel"], update_rel=update["rel"],
              moment_rel=moment["rel"])
    same = all(r["step1"]["metrics"] == r0["step1"]["metrics"]
               and r["step2"]["metrics"] == r0["step2"]["metrics"] for r in results)
    print(f"   {label}: LoRA step (rank {MESH_LORA_RANK}) loss {r0['lora']['loss']:.6f} vs "
          f"{refs['lora_loss']:.6f}, adapter gradient cosine {lora['cos']:.6f}, norm "
          f"{lora['norm_rel']:.2e}; Trainer steps 1, 2: losses "
          f"{[round(s['loss'], 6) for s in steps]} vs {[round(w['loss'], 6) for w in ref]} "
          f"(worst {rd['loss_rel']:.2e}, bound {TRAIN_LOSS_REL}), grad_norms "
          f"{[round(s['grad_norm'], 4) for s in steps]} (worst {rd['norm_rel']:.2e}, bound "
          f"{TRAIN_NORM_REL}); step 1's gradient over {grads['blocks']} blocks cosine "
          f"{grads['cos']:.6f} (bound {TRAIN_GRAD_COS}), norm {grads['norm_rel']:.2e}, "
          f"{grads['within']} within K6/K7's bounds (worst {grads['worst'][1]:.3e}, "
          f"{grads['worst'][0]}); after step 2 the update {update['rel']:.3e} (bound "
          f"{TRAIN_UPDATE_REL}), Adam's first moment {moment['rel']:.3e} (bound "
          f"{TRAIN_MOMENT_REL}) normwise; every rank's metrics alike: {same}")
    for rank, r in enumerate(results):
        print(f"      rank {rank}: LoRA {r['lora']['secs']:.2f} s, "
              f"{r['lora']['staged'] / 1e9:.3f} GB staged; step 1 {r['step1']['secs']:.2f} s, "
              f"{r['step1']['staged'] / 1e9:.3f} GB; step 2 {r['step2']['secs']:.2f} s, "
              f"{r['step2']['staged'] / 1e9:.3f} GB; peak {r['step2']['peak_gib']:.2f} GiB; "
              f"launches a step {r['step2']['launches'][0]} ({card})")
    ok = (rd["loss_rel"] <= TRAIN_LOSS_REL and rd["norm_rel"] <= TRAIN_NORM_REL
          and lora["cos"] >= TRAIN_GRAD_COS and lora["norm_rel"] <= TRAIN_NORM_REL
          and grads["cos"] >= TRAIN_GRAD_COS and grads["norm_rel"] <= TRAIN_NORM_REL
          and update["rel"] <= TRAIN_UPDATE_REL and moment["rel"] <= TRAIN_MOMENT_REL and same)
    if label == "fsdp 2":  # the folded backward's per-leaf bar
        ok = ok and grads["within"] == grads["blocks"]
    # planted faults, read from the sound run's tensors
    faults = {"local_norm": max(rel(r["step1"]["local_norm"], ref[0]["grad_norm"])
                                for r in results)}
    sound = {"norm": rd["norm_rel"]}
    fault_ok = faults["local_norm"] > TRAIN_NORM_REL
    if "line_stats" in r0["step1"]:
        alone = sum_stats([r["step1"]["line_stats"] for r in results])
        faults.update(data_alone_cos=alone["cos"], data_alone_norm_rel=alone["norm_rel"])
        fault_ok = fault_ok and (alone["cos"] < TRAIN_GRAD_COS
                                 or alone["norm_rel"] > TRAIN_NORM_REL)
    if "replicas" in r0["step1"]:
        faults["tensor_unreduced_leaves"] = len(r0["step1"]["partial_replicas"])
        faults["tensor_unreduced_rel"] = sum_stats([r["step1"]["partial_stats"]
                                                    for r in results])["rel"]
        sound["replicas_differing"] = len(r0["step1"]["replicas"])
        ok = ok and not any(r["step1"]["replicas"] for r in results)
        fault_ok = fault_ok and faults["tensor_unreduced_leaves"] > 0
    print(f"   {label} planted faults (read from this run's tensors): {faults}; sound: {sound} "
          f"(bars: norm {TRAIN_NORM_REL}, cosine {TRAIN_GRAD_COS}, replicas bitwise alike)")
    if not ok:
        raise AssertionError(f"mesh training {label}: {rd}, metrics alike {same}, K6/K7 "
                             f"{grads['within']} of {grads['blocks']}")
    if not fault_ok:
        raise AssertionError(f"mesh training {label}: a planted fault within its bar: {faults}")
    rd["faults"] = faults
    return rd


def check_checkpoint(dev, results: list[dict], card: str) -> list[dict]:
    """The sharded checkpoint that the tensor 2 world saved after step 1
    (``results``: its ranks' ``mesh_train`` readings): each rank's file
    holds the blocks no lower rank holds, its bytes on disk 8 + its header
    + those blocks' bytes; restored in this process into a whole state,
    every tensor bitwise the ranks' saved blocks (checksums). Returns the
    checksums of the whole's blocks under RESTORE_MESH, rank by rank
    (``layout_sums``), for that layout's restore."""
    from chronoedit_tpu_torch.train import checkpoint as ck
    from chronoedit_tpu_torch.train.train_step import make_train_state

    cfg = mesh_train_config()
    state = make_train_state(tp_model(dev, cfg).dit, mesh_tcfg(1.0))
    _, secs = host_s(lambda: ck.CheckpointManager(
        ck.CheckpointConfig(directory=str(checkpoint_dir()))).restore(state))
    whole = ck.state_tensors(state)
    seen, bad, want = set(), [], []
    for rank, r in enumerate(results):
        mine = 0
        for k, (start, shape, checksum) in r["saved"].items():
            block = whole[k][tuple(slice(a, a + n) for a, n in zip(start, shape))]
            if tensor_checksum(block.contiguous()) != checksum:
                bad.append((rank, k))
            if (k, tuple(start)) not in seen:
                seen.add((k, tuple(start)))
                mine += math.prod(shape) * block.element_size()
        want.append(mine)
    files = []
    for rank, r in enumerate(results):
        file = checkpoint_dir() / "1" / ck.RANK_FILE.format(rank)
        header = 0
        if file.exists():
            with open(file, "rb") as f:
                header = int.from_bytes(f.read(8), "little")
        files.append((r["file_bytes"], 8 + header + want[rank] if want[rank] else 0))
    nbytes = sum(n for n, _ in files)
    print(f"   sharded checkpoint of the tensor 2 state after step 1: rank files "
          f"{[n for n, _ in files]} B (predicted {[w for _, w in files]}: each block once, the "
          f"lowest rank holding it writes it), {nbytes / 1e9:.3f} GB; saved in "
          f"{results[0]['save_secs']:.2f} s to the host copy, "
          f"{results[0]['wait_secs']:.2f} s more to the rename; restored in one process in "
          f"{secs:.2f} s, {len(whole) * len(results) - len(bad)} of {len(whole) * len(results)} "
          f"rank blocks bitwise the whole's; the same layout's step 2 after a restore of step "
          f"{results[0]['restored_step']} bitwise the straight step 2 on every rank: "
          f"{all(r['resumed']['bitwise'] for r in results)} ({card})")
    if bad or any(n != w for n, w in files) or not all(r["resumed"]["bitwise"] for r in results):
        raise AssertionError(f"sharded checkpoint: blocks differing {bad[:6]}, bytes {files}, "
                             f"resumed bitwise {[r['resumed']['bitwise'] for r in results]}")
    expected = layout_sums(whole, cfg, RESTORE_MESH, 4)
    del state, whole
    free()
    return expected


def check_restored(expected: list[dict], results: list[dict], label: str) -> None:
    """Each rank's tensors restored under another layout (``results``'
    "restored" checksums) bitwise the whole's blocks for that rank
    (``expected``, from ``layout_sums``)."""
    bad, n = [], 0
    for rank, r in enumerate(results):
        for k, (_, _, checksum) in r["restored"].items():
            n += 1
            if expected[rank][k] != checksum:
                bad.append((rank, k))
    print(f"   {label}: {n - len(bad)} of {n} tensors restored from the tensor 2 checkpoint "
          f"bitwise the whole's blocks")
    if bad:
        raise AssertionError(f"{label}: restored tensors differ from the whole's blocks: "
                             f"{bad[:6]}")


def add_train_launches(results: list[dict], launches: tuple[Counter, Counter]) -> None:
    for r in results:
        for key in ("lora", "step1", "step2", "resumed"):
            if key in r:
                launches[0].update(r[key]["launches"][0])
                launches[1].update(r[key]["launches"][1]["flash_fwd"])


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
    # K4's tensor-parallel form, in two passes: where JAX's shard_map branch
    # of rms_norm_fused computes the local sums of squares, psums them and
    # normalises in XLA instead of the Pallas kernel
    "rms_sumsq": ("chronoedit_tpu_torch/csrc/rms_norm.cu",
                  "chronoedit_tpu/ops/fused_norms.py:251", ("rms_sumsq_ring_kernel",)),
    "rms_norm_ss": ("chronoedit_tpu_torch/csrc/rms_norm.cu",
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
                             "one LoRA and one QLoRA train step and one w4a16 and one mixed2 "
                             "DiT forward")
    parser.add_argument("--trace-pipe-ranks", action="store_true",
                        help="only trace the pipe = 4 world's ranks without expandable "
                             "segments and the VAE's bits against the card's free memory")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
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
    if args.trace_pipe_ranks:
        trace_pipe_ranks(dev)
        return 0

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
    free()
    ulysses_trace(dev)
    free()
    drop_ref = context_path(dev, (by_name, by_kv))["drop_ref"]
    cfg = main_config()
    scratch = scratch_dir()
    print(f"the Trainer's checkpoints under {scratch}; the other large files under {BUILD_DIR}")
    try:
        # loaded outside inference_mode: training saves these weights for backward
        pipe, train_prompts = loaded_path(dev, dataclasses.replace(
            cfg, dit=dataclasses.replace(cfg.dit, remat="full")), (by_name, by_kv))
        with torch.inference_mode():
            refs = edit_path(pipe, dev, (by_name, by_kv), profile_dir)
            refs.update(reasoning_path(pipe, dev, (by_name, by_kv), profile_dir))
            torch.cuda.empty_cache()
            server_path(pipe, dev, (by_name, by_kv))
            torch.cuda.empty_cache()
            refs["cfg"] = guidance_cache_path(pipe, dev, (by_name, by_kv))["cfg"]
            guardrail_path(dev)
        torch.cuda.empty_cache()
        batches = train_batches(pipe)
        training_path(pipe, dev, (by_name, by_kv), batches, profile_dir)
        # quantized: the trained-on bf16 DiT quantized in place (its bf16
        # weights freed as the walk goes), QLoRA over it, then serving; then
        # the bf16 model loaded again from the same files for mixed2, so
        # that no two copies of the DiT share the card
        w4a16_path(pipe, dev, (by_name, by_kv), refs, batches, profile_dir)
        del pipe, batches
        free()
        with torch.inference_mode():
            pipe, secs = host_s(lambda: load_pipeline(
                cfg, str(CHECKPOINT_DIR), loras=[(str(CHECKPOINT_DIR / "distill_lora.safetensors"),
                                                  1.0)],
                with_text_encoder=False, with_image_encoder=False, device=dev))
            print(f"loaded the DiT and VAE again for mixed2 in {secs:.1f} s")
            # the whole model as the fsdp and tensor ranks load it, before
            # mixed2 quantizes it
            fsdp_refs, secs = host_s(lambda: fsdp_whole_refs(pipe, dev))
            tensor_refs, secs_t = host_s(lambda: tensor_whole_refs(pipe, dev))
            pp_refs, secs_p = host_s(lambda: pipeline_whole_refs(pipe, dev))
            refs.update({f"{k} short": v for k, v in pp_refs.items()})
            print(f"fsdp_path's, tensor_path's and pipeline_path's references from the whole "
                  f"model in {secs:.1f} + {secs_t:.1f} + {secs_p:.1f} s")
            mixed2_path(pipe, dev, (by_name, by_kv), refs, profile_dir)
            del pipe
        free()
        # pipeline parallelism from the directory's files, the card free
        pipeline_path(dev, {**refs, "drop": drop_ref}, (by_name, by_kv))
        # training under a mesh: the one-process reference, written for the
        # FSDP and tensor worlds to read
        train_refs = mesh_train_refs(dev)
        # FSDP from the same files, the card free
        fsdp_path(dev, {**fsdp_refs, "train": train_refs}, (by_name, by_kv))
        # tensor parallelism from the same files, the card free
        tensor_path(dev, {**tensor_refs, "train": train_refs}, (by_name, by_kv))
        shutil.rmtree(MESH_DIR, ignore_errors=True)
        # training as a user runs it: the CLI from the directory's files, then
        # the Trainer (the directory is removed first: its checkpoints need
        # the disk)
        prompt_emb = cli_path(dev, cfg, (by_name, by_kv), train_prompts)["prompt_emb"]
        shutil.rmtree(CHECKPOINT_DIR, ignore_errors=True)
        trainer_path(dev, (by_name, by_kv), scratch / "smoke_trainer", prompt_emb)
    finally:
        for d in (CHECKPOINT_DIR, CHECKPOINT_DIR.parent / "smoke_train_data", MESH_DIR,
                  scratch):
            shutil.rmtree(d, ignore_errors=True)

    # K5 is the flash kernel's launches over KV past JAX's resident length
    # (the reasoning self-attention's 28,800 tokens, and the ring's hops at
    # 14,400 under context parallelism); K1 the rest of them; X1 and X2 ran
    # in phase 4 only
    launches = dict(by_name, flash_fwd_streamed=sum(n for kv, n in by_kv.items()
                                                    if kv > STREAMED_KV), **tool_launches)
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
