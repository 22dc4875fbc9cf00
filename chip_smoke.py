"""Drive the PyTorch port's 8-step 720p edit path once on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` (sm_90a) and no network; it imports
nothing of JAX. Phases, in order; any failure raises, so the exit code is
non-zero and no result line is printed:

1. require CUDA; print torch/CUDA versions and the card's name and power
   limit (``nvidia-smi``);
2. build K1-K4 from ``chronoedit_tpu_torch/csrc`` (``kernels/build.py``);
3. hold each kernel against its plain PyTorch twin on the card at the main
   path's shapes in bf16, with CUDA-event times for both. This runs before
   the model exists: the plain attention at 7,200 tokens needs ~35 GB;
4. a small reference: the whole slice at 2 blocks x 2 heads of 128 on the
   card (bf16, kernels) against the same weights on the CPU (fp32, plain
   twins), as PSNR over the [-1, 1] pixel range;
5. the main path: ``chronoedit_14b_distilled`` at full width and depth
   (40 blocks x 5120, bf16, random weights from a seeded generator) and the
   full-width VAE serve two 720p edits through ``edit_image``. The launch
   counters are zeroed just before each edit and must then show exactly
   the K1-K4 launches the path implies; DiT-forward and VAE times follow;
6. print the kernel table as one JSON line, the card line again, and last
   ``{"ok": true, "device": {...}}``.

``--profile`` adds one warm ``torch.profiler`` pass over a DiT forward, the
VAE encode and the VAE decode at the main path's shapes, printing each
one's device idle share and writing its per-kernel table to
``chiprun_out/profile_<stage>.txt`` under the repository root.
"""

from __future__ import annotations

import argparse
import dataclasses
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

EDIT_H, EDIT_W = 720, 1280
TEXT_TOKENS = 512


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
    from chronoedit_tpu_torch.ops import flash_attention as fa
    from chronoedit_tpu_torch.ops import fused_norms as fn
    from chronoedit_tpu_torch.ops import layers as L

    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    results = {}
    s, h, d = (EDIT_H // 16) * (EDIT_W // 16) * 2, 40, 128  # 7,200 tokens
    scale = d ** -0.5
    q = randn(1, s, h, d)
    k1 = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for skv, what in ((s, "self"), (TEXT_TOKENS, "text"), (257, "image")):
        k, v = randn(1, skv, h, d), randn(1, skv, h, d)
        out, lse = fa.flash_attention_with_lse(q, k, v, scale)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, scale)
        e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
        ref_max = float(ref.float().abs().max())
        out_tol = min(K1_OUT_MAX_TOL, K1_OUT_STEPS * ULP_BF16 * ref_max)
        print(f"K1 flash_fwd {what:5s} q {tuple(q.shape)} kv {skv}: max|out-ref| "
              f"{e_out:.3e} (tol {out_tol:.3e}, max|ref| {ref_max:.3f})"
              f", max|lse-ref| {e_lse:.3e} (tol {K1_LSE_TOL})")
        if not (e_out <= out_tol and e_lse <= K1_LSE_TOL):
            raise AssertionError(f"K1 disagrees with its twin at kv={skv}")
        del ref, ref_lse
        ms = cuda_ms(lambda: fa.flash_attention_with_lse(q, k, v, scale))
        plain = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, scale), reps=3, warmup=1)
        print(f"   kernel {ms:.3f} ms, plain {plain:.3f} ms")
        k1["max_abs_err"] = max(k1["max_abs_err"], e_out)
        k1["ms"] += ms
        k1["plain_ms"] += plain
        torch.cuda.empty_cache()
    results["flash_fwd"] = k1
    del q, k, v

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
    return results


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


def small_reference(dev: torch.device) -> float:
    """The slice at 2 blocks x 2 heads of 128 on ``dev`` in bf16 against the
    same weights in fp32 on the CPU; returns the PSNR in dB."""
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
    ref_pipe = ChronoEditPipeline(ref_cfg, dit, vae)
    dev_pipe = ChronoEditPipeline(
        dev_cfg, dit_lib.DiT(dev_cfg.dit, device=dev), vae_lib.VAE(dev_cfg.vae, device=dev))
    dev_pipe.dit.load_state_dict(dit.state_dict())
    dev_pipe.vae.load_state_dict(vae.state_dict())

    req = request(ref_cfg, cpu, 2, 64, 64, 16)
    noise = torch.randn((1, 16, 2, 8, 8), generator=g)
    want = ref_pipe.edit_image(**req, latents=noise)
    got = dev_pipe.edit_image(**{k: v.to(dev) for k, v in req.items()},
                              latents=noise.to(dev))
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"small reference: bad output {tuple(got.shape)}")
    return psnr(got.float().cpu(), want)


def expected_launches(cfg) -> dict[str, int]:
    """Kernel launches one edit implies: per block 3 attentions (self, text,
    image), 2 LN-modulates, 2 gated residuals and 5 RMSNorms (self q, k;
    cross q; text k; image k), plus the head's LN-modulate, per step."""
    n, steps = cfg.dit.num_layers, cfg.num_steps
    return {"flash_fwd": 3 * n * steps, "ln_modulate": (2 * n + 1) * steps,
            "gated_residual": 2 * n * steps, "rms_norm": 5 * n * steps}


def main_path(dev: torch.device, cfg, h: int = EDIT_H, w: int = EDIT_W,
              text_tokens: int = TEXT_TOKENS,
              profile_dir: Path | None = None) -> dict[str, int]:
    """Two edits of an h x w image, then warm per-stage times (and profiles
    when ``profile_dir`` is set); returns the launches counted over the edits."""
    from chronoedit_tpu_torch.kernels import build
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.models import vae as vae_lib
    from chronoedit_tpu_torch.pipeline.edit_pipeline import (
        ChronoEditPipeline, prepare_condition)

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
    pipe = ChronoEditPipeline(cfg, dit, vae)

    want = expected_launches(cfg)
    total = dict.fromkeys(want, 0)
    torch.cuda.reset_peak_memory_stats()
    for i, seed in enumerate((10, 11)):
        req = request(cfg, dev, seed, h, w, text_tokens)
        gen = torch.Generator(device=dev).manual_seed(100 + seed)
        build.reset_launches()
        frame, secs = host_s(lambda: pipe.edit_image(**req, generator=gen))
        got = dict(build.LAUNCHES)
        print(f"edit {i} ({'cold' if i == 0 else 'warm'}): {secs:.2f} s, "
              f"launches {got}")
        if got != want:
            raise AssertionError(f"edit {i}: launches {got}, the path implies {want}")
        if tuple(frame.shape) != (1, 3, h, w) or not bool(torch.isfinite(frame).all()):
            raise AssertionError(f"edit {i}: output {tuple(frame.shape)} is not a finite frame")
        print(f"   frame {tuple(frame.shape)} finite, mean {float(frame.float().mean()):.4f}, "
              f"std {float(frame.float().std()):.4f}")
        for name in total:
            total[name] += got[name]
    print(f"peak memory over the edits: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # per-stage times at the same shapes (warm)
    req = request(cfg, dev, 12, h, w, text_tokens)
    with torch.inference_mode():
        cond, enc_s = host_s(lambda: prepare_condition(vae, cfg, req["image"], cfg.num_frames))
        x = torch.randn((1, cfg.vae.z_dim) + tuple(cond.shape[2:]), generator=g, device=dev)
        xin = torch.cat([x, cond], dim=1).to(d.dtype)
        ts = torch.full((1,), 999.0, device=dev)
        stages = {
            "dit_forward": lambda: dit_lib.dit_forward(
                dit, xin, ts, req["prompt_emb"], req["image_emb"]),
            "vae_encode": lambda: prepare_condition(vae, cfg, req["image"], cfg.num_frames),
            "vae_decode": lambda: vae_lib.vae_decode(vae, x),
        }
        stages["dit_forward"]()
        _, dit_s = host_s(stages["dit_forward"])
        _, dec_s = host_s(stages["vae_decode"])
        print(f"VAE encode {enc_s:.3f} s, DiT forward (one step, {xin.shape[2]}x"
              f"{xin.shape[3]}x{xin.shape[4]} latents) {dit_s:.3f} s, VAE decode {dec_s:.3f} s")
        if profile_dir is not None:
            profile_stages(stages, profile_dir)
    return total


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
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile one DiT forward and the VAE after the edits")
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

    with torch.inference_mode():
        results = compare_kernels(dev)
        torch.cuda.empty_cache()
        db = small_reference(dev)
        print(f"small reference (2 blocks x 2 heads, 64x64, 8 steps): card bf16 vs "
              f"CPU fp32 {db:.2f} dB (bar {MIN_PSNR_DB} dB)")
        if not db >= MIN_PSNR_DB:
            raise AssertionError(f"small reference PSNR {db:.2f} dB < {MIN_PSNR_DB} dB")
    profile_dir = Path(__file__).resolve().parent / "chiprun_out" if args.profile else None
    launches = main_path(dev, chronoedit_14b_distilled(), profile_dir=profile_dir)

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
