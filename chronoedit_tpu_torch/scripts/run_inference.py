"""ChronoEdit inference CLI on PyTorch (reference:
scripts/run_inference_diffusers.py; the JAX package's
``scripts/run_inference.py``).

Examples:
  # one edit from a checkpoint directory, the prompt as UMT5 token ids
  python -m chronoedit_tpu_torch.scripts.run_inference --input image.png \\
      --prompt-ids prompt_ids.npy --checkpoint-dir ./checkpoints/ChronoEdit-14B \\
      --lora distill.safetensors --output edit.png

  # the whole pipeline on tiny random weights, on the CPU
  python -m chronoedit_tpu_torch.scripts.run_inference --smoke --device cpu

Text prompts (``--prompt``) need the UMT5 tokenizer's vocabulary, which is a
download; ``--prompt-ids`` takes the token ids as a ``.npy`` instead.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch


def add_pipeline_args(p: argparse.ArgumentParser) -> None:
    """The pipeline construction flags that ``serve`` shares."""
    p.add_argument("--experiment", type=str, default=None,
                   help="preset name (configs.EXPERIMENTS); default "
                        "chronoedit_14b_distilled, or tiny with --smoke")
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="dir with diffusers DiT shards + Wan2.1_VAE.pth + "
                        "models_t5_umt5-xxl-enc-bf16.pth + CLIP pth")
    p.add_argument("--lora", type=str, action="append", default=[],
                   help="LoRA safetensors path[:scale], repeatable")
    p.add_argument("--mesh", type=str, default=None,
                   help="multi-GPU parallelism spec (not ported yet: raises)")
    p.add_argument("--quantize", nargs="?", const="int8", default=None,
                   choices=("int8", "int4", "int4_a8"),
                   help="quantize the DiT's projections: 'int8' (w8a8; the bare "
                        "flag), 'int4' (w4a16) or 'int4_a8' (int4 storage, int8 compute)")
    p.add_argument("--cache-blocks", type=str, default=None,
                   help="A:B[:period]: the block cache over blocks [A,B), refreshed "
                        "every `period` solver steps (default 2)")
    p.add_argument("--cache-thresh", type=float, default=None,
                   help="adaptive block-cache refresh: refresh blocks [A,B) when the "
                        "latents' accumulated relative change since the last refresh "
                        "reaches this value (overrides the period; needs --cache-blocks)")
    p.add_argument("--smoke", action="store_true",
                   help="random tiny weights, no checkpoint: an end-to-end smoke run")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the first CUDA card")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", type=str, help="input image path")
    p.add_argument("--prompt", type=str, default="")
    p.add_argument("--prompt-ids", type=str, default=None,
                   help=".npy of UMT5 token ids, (S,) or (1, S), in place of --prompt")
    p.add_argument("--negative-prompt", type=str, default="")
    p.add_argument("--negative-prompt-ids", type=str, default=None)
    p.add_argument("--output", type=str, default="output.png")
    p.add_argument("--num-steps", type=int, default=None)
    p.add_argument("--guidance-scale", type=float, default=None)
    p.add_argument("--flow-shift", type=float, default=None)
    p.add_argument("--enable-temporal-reasoning", action="store_true")
    p.add_argument("--num-temporal-reasoning-steps", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    add_pipeline_args(p)
    return p.parse_args(argv)


def build_pipeline(args):
    """The pipeline the flags describe, on ``--device`` (default the card)."""
    from chronoedit_tpu_torch.configs import get_experiment
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.models import vae as vae_lib
    from chronoedit_tpu_torch.pipeline.edit_pipeline import ChronoEditPipeline
    from chronoedit_tpu_torch.pipeline.loader import load_pipeline
    from chronoedit_tpu_torch.utils.platform import cuda_device

    if args.mesh:
        raise SystemExit("--mesh: multi-GPU meshes are not ported yet")
    device = cuda_device() if args.device is None else torch.device(args.device)
    cfg = get_experiment(args.experiment or ("tiny" if args.smoke else
                                             "chronoedit_14b_distilled"))
    loras = [(path, float(scale or 1.0))
             for path, _, scale in (spec.partition(":") for spec in args.lora)]
    if args.checkpoint_dir:
        pipe = load_pipeline(cfg, args.checkpoint_dir, loras=loras, device=device)
    else:
        if not args.smoke:
            raise SystemExit("--checkpoint-dir required unless --smoke")
        if loras:
            raise SystemExit("--lora needs --checkpoint-dir")
        g = torch.Generator(device=device).manual_seed(0)
        pipe = ChronoEditPipeline(cfg, dit_lib.init_dit_params(cfg.dit, g, device),
                                  vae_lib.init_vae_params(cfg.vae, g, device))
    if args.cache_blocks:
        parts = [int(x) for x in args.cache_blocks.split(":")]
        pipe.config = dataclasses.replace(
            pipe.config, cache_blocks=(parts[0], parts[1]),
            cache_period=parts[2] if len(parts) > 2 else 2, cache_thresh=args.cache_thresh)
    elif args.cache_thresh is not None:
        raise SystemExit("--cache-thresh needs --cache-blocks")
    if args.quantize:
        pipe.quantize(mode=args.quantize)
    return pipe


def prompt_embeddings(pipe, args):
    """(prompt, negative prompt) UMT5 embeddings. With a text encoder and a
    prompt, each is encoded from its token ids (``--*-ids``) or its text
    (the negative's may be empty, as in JAX; text needs the tokenizer's
    vocabulary); otherwise both are seeded random embeddings of 8 tokens."""
    device = pipe.device

    def encode(text, ids_path):
        if ids_path:
            ids = torch.from_numpy(np.load(ids_path).astype(np.int64)).reshape(1, -1)
            return pipe.encode_prompt(ids.to(device))
        return pipe.encode_prompt(text)

    if pipe.text_encoder is not None and (args.prompt or args.prompt_ids):
        return (encode(args.prompt, args.prompt_ids),
                encode(args.negative_prompt, args.negative_prompt_ids))
    return tuple(torch.randn((1, 8, pipe.config.dit.text_dim), device=device,
                             generator=torch.Generator(device=device).manual_seed(seed))
                 for seed in (1, 2))


def main(argv=None) -> None:
    args = parse_args(argv)
    from chronoedit_tpu_torch.utils.visualize import save_image, save_video

    pipe = build_pipeline(args)
    cfg, device = pipe.config, pipe.device
    if args.input:
        from PIL import Image

        from chronoedit_tpu_torch.data.edit_dataset import ImageCropAndResize, ToArray

        img = Image.open(args.input).convert("RGB")
        crop = ImageCropAndResize(args.height, args.width, max_pixels=1280 * 720)
        image = torch.from_numpy(ToArray()(crop(img)))[None].to(device)
    else:
        if not args.smoke:
            raise SystemExit("--input required unless --smoke")
        g = torch.Generator(device=device).manual_seed(7)
        image = torch.rand((1, 3, 32, 32), generator=g, device=device) * 2 - 1

    prompt_emb, neg_emb = prompt_embeddings(pipe, args)
    if pipe.image_encoder is not None:
        image_emb = pipe.encode_image(image)
    elif cfg.dit.image_dim:
        g = torch.Generator(device=device).manual_seed(3)
        image_emb = torch.randn((1, cfg.dit.image_tokens, cfg.dit.image_dim), generator=g,
                                device=device)
    else:
        image_emb = None

    video = pipe(image, prompt_emb, neg_prompt_emb=neg_emb, image_emb=image_emb,
                 num_steps=args.num_steps, guidance_scale=args.guidance_scale,
                 flow_shift=args.flow_shift, prompt=args.prompt,
                 enable_temporal_reasoning=args.enable_temporal_reasoning,
                 num_temporal_reasoning_steps=args.num_temporal_reasoning_steps,
                 generator=torch.Generator(device=device).manual_seed(args.seed))
    # the edit is the last frame; reasoning mode also writes the trajectory
    video = video.float().cpu().numpy()
    save_image(args.output, video[0, :, -1])
    print(f"saved edit -> {args.output} ({video.shape[-1]}x{video.shape[-2]})")
    if args.enable_temporal_reasoning:
        path = save_video(os.path.splitext(args.output)[0] + ".mp4", video[0], fps=8)
        print(f"saved reasoning video -> {path} ({video.shape[2]} frames)")


if __name__ == "__main__":
    main()
