"""Drive the PyTorch port's 720p edit paths once on one NVIDIA GPU: the
8-step edit and the 29-frame temporal-reasoning edit.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` (sm_90a) and no network; it imports
nothing of JAX. Phases, in order; any failure raises, so the exit code is
non-zero and no result line is printed:

1. require CUDA; print torch/CUDA versions and the card's name and power
   limit (``nvidia-smi``);
2. build the kernels from ``chronoedit_tpu_torch/csrc`` (``kernels/build.py``);
3. hold each kernel against its plain PyTorch twin on the card at the main
   paths' shapes in bf16, with CUDA-event times for both: K1-K4 at the
   edit's 7,200 tokens, and the flash kernel at the reasoning
   self-attention's 28,800 tokens as K5 (against the q-chunked twin). This
   runs before the model exists: the plain attention needs ~35 GB;
4. small references: the whole slice at 2 blocks x 2 heads of 128 on the
   card (bf16, kernels) against the same weights on the CPU (fp32, plain
   twins), as PSNR over the [-1, 1] pixel range: the edit, and reasoning
   mode with the frame drop and without it, W-tiled streaming VAE;
5. the main paths: ``chronoedit_14b_distilled`` at full width and depth
   (40 blocks x 5120, bf16, random weights from a seeded generator) and the
   full-width VAE serve two 720p edits, then two 29-frame reasoning edits
   (the whole trajectory, k = 8; the drop, k = 2) through ``__call__``.
   The launch counters are zeroed just before each edit and must then show
   exactly the launches the path implies, by kernel and by attention KV
   length; stage times, peak memory and a tiled-against-untiled streaming
   decode of an 8-frame latent trajectory (fp32) follow;
6. print the kernel table as one JSON line, the card line again, and last
   ``{"ok": true, "device": {...}}``.

``--profile`` adds one warm ``torch.profiler`` pass over each stage (DiT
forward, VAE encode, VAE decode) of both paths at their shapes, printing
each one's device idle share and writing its per-kernel table to
``chiprun_out/profile_<stage>.txt`` under the repository root.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
from collections import Counter
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

# Tolerances, each with its reason. K2-K4 compute in fp32 and round once to
# bf16, as their twins do, so they may differ by one bf16 rounding step at
# the output's largest magnitude (2**-7 relative). K1 also rounds P to bf16
# before P.V (<= 2**-9 per weight, fp32 accumulation), so its output may
# differ by two bf16 steps at the case's largest output, and never by more
# than 1e-2 (outputs reach ~1.3 against KV 512 and 257, ~0.13 in
# self-attention). Its LSE is fp32 throughout.
ULP_BF16 = 2.0 ** -7
K1_OUT_STEPS = 2.0
K1_OUT_MAX_TOL = 1e-2
K1_LSE_TOL = 1e-3
# bf16 on the card against fp32 on the CPU; the repo's fidelity bar
MIN_PSNR_DB = 35.0
# The W-tiled streaming decode against the untiled one, both fp32 on the
# card with TF32 off: the tiles' halo covers the receptive field, so the
# two compute the same sums, and differ only where cuDNN picks another
# algorithm (another summation order) for the narrower tile. A misplaced
# tile or a short halo errs by the output's own scale, 1,000x this bound.
TILED_DECODE_TOL = 1e-3

EDIT_H, EDIT_W = 720, 1280
TEXT_TOKENS = 512
IMAGE_TOKENS = 257
REASONING_FRAMES = 29
# reasoning self-attention: 8 latent frames x 45 x 80 patches
REASONING_TOKENS = 8 * (EDIT_H // 16) * (EDIT_W // 16)
# q rows per chunk of the plain twin at 28,800 tokens: ~8 GB of fp32 scores
Q_CHUNK = 1800


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


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


def host_s(fn):
    """(result, seconds) of ``fn`` on the host clock, ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def psnr(got: torch.Tensor, want: torch.Tensor) -> float:
    mse = float((got.double() - want.double()).square().mean())
    return math.inf if mse == 0 else 10.0 * math.log10(2.0 ** 2 / mse)


# ----------------------------------------------------------- phase 3

def compare_kernels(dev: torch.device) -> dict[str, dict]:
    """Each kernel against its plain twin at main-path shapes; returns
    {name: {max_abs_err, ms, plain_ms}}."""
    from chronoedit_tpu_torch.ops import fused_norms as fn
    from chronoedit_tpu_torch.ops import layers as L

    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    results = {}
    s, h, d = (EDIT_H // 16) * (EDIT_W // 16) * 2, 40, 128  # 7,200 tokens
    q = randn(1, s, h, d)
    k1 = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for skv, what in ((s, "self"), (TEXT_TOKENS, "text"), (IMAGE_TOKENS, "image")):
        k, v = randn(1, skv, h, d), randn(1, skv, h, d)
        row = compare_flash("K1", what, q, k, v)
        for key in ("ms", "plain_ms"):
            k1[key] += row[key]
        k1["max_abs_err"] = max(k1["max_abs_err"], row["max_abs_err"])
    results["flash_fwd"] = k1
    del q, k, v
    torch.cuda.empty_cache()

    hw, t, dim = s // 2, 2, h * d
    x = randn(1, s, dim) * 2.0 + 0.5
    mod_scale, mod_shift, gate = (0.1 * randn(1, t, dim, dtype=torch.float32)
                                  for _ in range(3))
    delta = randn(1, s, dim)
    norm = L.RMSNorm(dim, device=dev, dtype=bf16)
    with torch.no_grad():
        norm.scale.copy_(1.0 + 0.1 * randn(dim))
    cases = {
        "ln_modulate": (lambda: fn.layer_norm_modulate(x, mod_scale, mod_shift, hw),
                        lambda: fn.ln_modulate_plain(x, mod_scale, mod_shift, hw)),
        "gated_residual": (lambda: fn.gated_residual(x, delta, gate, hw),
                           lambda: fn.gated_residual_plain(x, delta, gate, hw)),
        "rms_norm": (lambda: fn.rms_norm_fused(norm, x),
                     lambda: fn.rms_norm_plain(norm.scale, x)),
    }
    for name, (kernel, plain) in cases.items():
        got, ref = kernel(), plain()
        err, tol = max_err(got, ref), ULP_BF16 * float(ref.float().abs().max())
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        print(f"{name} x {tuple(x.shape)}: max|out-ref| {err:.3e} (tol {tol:.3e}); "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        if not err <= tol:
            raise AssertionError(f"{name} disagrees with its twin")
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    # K5: the same kernel over the reasoning self-attention's 28,800 tokens
    q, k, v = (randn(1, REASONING_TOKENS, h, d) for _ in range(3))
    results["flash_fwd_streamed"] = compare_flash("K5", "self", q, k, v, q_chunk=Q_CHUNK)
    del q, k, v
    torch.cuda.empty_cache()
    return results


def compare_flash(kid: str, what: str, q, k, v, q_chunk: int | None = None) -> dict:
    """The flash kernel against its plain twin on (q, k, v): output within
    two bf16 steps of max|ref| (at most 1e-2), LSE within 1e-3; CUDA-event
    times of both. Returns {max_abs_err, ms, plain_ms}."""
    from chronoedit_tpu_torch.ops import flash_attention as fa

    scale = q.shape[-1] ** -0.5
    skv = k.shape[1]
    out, lse = fa.flash_attention_with_lse(q, k, v, scale)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, scale, q_chunk=q_chunk)
    e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
    ref_max = float(ref.float().abs().max())
    out_tol = min(K1_OUT_MAX_TOL, K1_OUT_STEPS * ULP_BF16 * ref_max)
    print(f"{kid} flash_fwd {what:5s} q {tuple(q.shape)} kv {skv}: max|out-ref| "
          f"{e_out:.3e} (tol {out_tol:.3e}, max|ref| {ref_max:.3f})"
          f", max|lse-ref| {e_lse:.3e} (tol {K1_LSE_TOL})")
    if not (e_out <= out_tol and e_lse <= K1_LSE_TOL):
        raise AssertionError(f"{kid} disagrees with its twin at kv={skv}")
    del out, lse, ref, ref_lse
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: fa.flash_attention_with_lse(q, k, v, scale))
    plain = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, scale, q_chunk=q_chunk),
                    reps=3, warmup=1)
    tflops = 4 * q.shape[0] * q.shape[2] * q.shape[1] * skv * q.shape[3] / ms / 1e9
    print(f"   kernel {ms:.3f} ms ({tflops:.1f} TFLOP/s), plain {plain:.3f} ms")
    torch.cuda.empty_cache()
    return {"max_abs_err": e_out, "ms": ms, "plain_ms": plain}


# ----------------------------------------------------------- phases 4, 5

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
    with the drop (k = 2) and without it (k = 8). Returns PSNRs in dB."""
    from chronoedit_tpu_torch.configs import chronoedit_14b_distilled
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.models import vae as vae_lib
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

    def compare(label, entry, tiles, h, w, noise, shape, **kw):
        ref_pipe = ChronoEditPipeline(dataclasses.replace(ref_cfg, vae_spatial_tiles=tiles),
                                      dit, vae)
        dev_pipe = ChronoEditPipeline(dataclasses.replace(dev_cfg, vae_spatial_tiles=tiles),
                                      dev_dit, dev_vae)
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

    results = {"edit": compare("edit", "edit_image", None, 64, 64,
                               torch.randn((1, 16, 2, 8, 8), generator=g), (1, 3, 64, 64))}
    noise = torch.randn((1, 16, 8, 8, 32), generator=g)
    for k, frames in ((2, 5), (ref_cfg.num_steps, REASONING_FRAMES)):
        results[f"reasoning k={k}"] = compare(
            f"reasoning k={k}, 4 VAE tiles", "__call__", 4, 64, 256, noise,
            (1, 3, frames, 64, 256), enable_temporal_reasoning=True,
            num_temporal_reasoning_steps=k)
    return results


def expected_launches(cfg, tokens: list[int]) -> tuple[dict[str, int], dict[int, int]]:
    """Kernel launches of one edit whose step i self-attends over tokens[i]:
    per block and step 3 attentions (self, text, image), 2 LN-modulates, 2
    gated residuals and 5 RMSNorms (self q, k; cross q; text k; image k),
    plus the head's LN-modulate; and the attentions by KV length."""
    n, steps = cfg.dit.num_layers, len(tokens)
    by_name = {"flash_fwd": 3 * n * steps, "ln_modulate": (2 * n + 1) * steps,
               "gated_residual": 2 * n * steps, "rms_norm": 5 * n * steps}
    by_kv = {TEXT_TOKENS: n * steps, IMAGE_TOKENS: n * steps}
    for s in tokens:
        by_kv[s] = by_kv.get(s, 0) + n
    return by_name, by_kv


def build_model(dev: torch.device, cfg):
    """The full-size pipeline with seeded random weights on the card."""
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.models import vae as vae_lib
    from chronoedit_tpu_torch.pipeline.edit_pipeline import ChronoEditPipeline

    d = cfg.dit
    print(f"main path: {d.num_layers} blocks x {d.dim} wide, ffn {d.ffn_dim}, "
          f"{cfg.num_steps} steps, guidance {cfg.guidance_scale}, shift {cfg.flow_shift}")
    g = torch.Generator(device=dev).manual_seed(0)
    (dit, vae), secs = host_s(lambda: (dit_lib.init_dit_params(d, g, device=dev),
                                       vae_lib.init_vae_params(cfg.vae, g, device=dev)))
    redraw_zero_projections(dit, vae, g)
    n_params = sum(p.numel() for p in dit.parameters())
    print(f"random init {secs:.1f} s: DiT {n_params / 1e9:.2f} B parameters "
          f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card)")
    return ChronoEditPipeline(cfg, dit, vae)


def serve(entry, cfg, dev, label: str, seed: int, shape: tuple, tokens: list[int],
          launches: tuple[Counter, Counter], **kw) -> None:
    """One 720p edit through ``entry`` (the pipeline or its ``edit_image``),
    with the launch counters zeroed just before it and read just after:
    they must equal what the path implies, and are added to ``launches``
    (by name, by KV length)."""
    from chronoedit_tpu_torch.kernels import build

    req = request(cfg, dev, seed, EDIT_H, EDIT_W, TEXT_TOKENS)
    gen = torch.Generator(device=dev).manual_seed(100 + seed)
    want = expected_launches(cfg, tokens)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    out, secs = host_s(lambda: entry(**req, generator=gen, **kw))
    got = dict(build.LAUNCHES), dict(build.FLASH_KV_LAUNCHES)
    print(f"{label}: {secs:.2f} s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB, launches {got[0]}, attention launches by KV length {got[1]}")
    if got != want:
        raise AssertionError(f"{label}: launches {got}, the path implies {want}")
    if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}: output {tuple(out.shape)} is not finite {shape}")
    print(f"   output {tuple(out.shape)} finite, mean {float(out.float().mean()):.4f}, "
          f"std {float(out.float().std()):.4f}")
    for total, counts in zip(launches, got):
        total.update(counts)


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


def edit_path(pipe, dev, launches: tuple[Counter, Counter], profile_dir: Path | None) -> None:
    """Two 720p edits through ``edit_image``, then warm per-stage times (and
    profiles when ``profile_dir`` is set); adds their launches to ``launches``."""
    cfg = pipe.config
    tokens = [2 * (EDIT_H // 16) * (EDIT_W // 16)] * cfg.num_steps
    for i, seed in enumerate((10, 11)):
        serve(pipe.edit_image, cfg, dev, f"edit {i} ({'cold' if i == 0 else 'warm'})", seed,
              (1, 3, EDIT_H, EDIT_W), tokens, launches)

    fns, x, enc_s = stages(pipe, dev, cfg.num_frames, 12)
    _, dit_s = host_s(fns["dit_forward"])
    _, dec_s = host_s(fns["vae_decode"])
    print(f"VAE encode {enc_s:.3f} s, DiT forward (one step, {x.shape[2]}x"
          f"{x.shape[3]}x{x.shape[4]} latents) {dit_s:.3f} s, VAE decode {dec_s:.3f} s")
    if profile_dir is not None:
        profile_stages(fns, profile_dir)


def reasoning_path(pipe, dev, launches: tuple[Counter, Counter],
                   profile_dir: Path | None) -> None:
    """Two 29-frame reasoning edits through ``__call__``: the whole
    trajectory (k = num_steps, 8 forwards at 28,800 tokens) and the drop
    (k = 2: two forwards at 28,800 tokens, the rest at 7,200); then warm
    stage times (the dual decode of each submode among them), the
    tiled-against-untiled decode check and, with
    ``profile_dir``, profiles. Adds the edits' launches to ``launches``."""
    cfg = pipe.config
    steps, edit_tokens = cfg.num_steps, 2 * (EDIT_H // 16) * (EDIT_W // 16)
    for label, seed, k, frames in (("whole trajectory", 20, steps, REASONING_FRAMES),
                                   ("drop", 21, 2, 5)):
        tokens = [REASONING_TOKENS] * k + [edit_tokens] * (steps - k)
        serve(pipe, cfg, dev, f"reasoning edit ({label}, k = {k})", seed,
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

SOURCES = {
    "flash_fwd": ("chronoedit_tpu_torch/csrc/flash_fwd.cu",
                  "chronoedit_tpu/ops/flash_attention.py:188"),
    "ln_modulate": ("chronoedit_tpu_torch/csrc/ln_modulate.cu",
                    "chronoedit_tpu/ops/fused_norms.py:87"),
    "gated_residual": ("chronoedit_tpu_torch/csrc/gated_residual.cu",
                       "chronoedit_tpu/ops/fused_norms.py:177"),
    "rms_norm": ("chronoedit_tpu_torch/csrc/rms_norm.cu",
                 "chronoedit_tpu/ops/fused_norms.py:251"),
    "flash_fwd_streamed": ("chronoedit_tpu_torch/csrc/flash_fwd.cu",
                           "chronoedit_tpu/ops/flash_attention.py:227"),
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile one DiT forward and the VAE of each path after its edits")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    from chronoedit_tpu_torch.configs import chronoedit_14b_distilled
    from chronoedit_tpu_torch.kernels import build
    from chronoedit_tpu_torch.utils.platform import cuda_device

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

    profile_dir = Path(__file__).resolve().parent / "chiprun_out" if args.profile else None
    by_name, by_kv = Counter(), Counter()
    with torch.inference_mode():
        results = compare_kernels(dev)
        torch.cuda.empty_cache()
        small_references(dev)
        pipe = build_model(dev, chronoedit_14b_distilled())
        edit_path(pipe, dev, (by_name, by_kv), profile_dir)
        reasoning_path(pipe, dev, (by_name, by_kv), profile_dir)

    # K5 is the flash kernel's launches over the 28,800-token reasoning
    # self-attention; K1 the rest of them
    launches = dict(by_name, flash_fwd_streamed=by_kv[REASONING_TOKENS])
    launches["flash_fwd"] -= launches["flash_fwd_streamed"]
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **results[name])
               for name, (src, rep) in SOURCES.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
