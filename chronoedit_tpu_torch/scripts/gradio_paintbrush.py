"""Interactive paint-brush editing demo (reference: scripts/gradio_paintbrush.py;
the JAX package's ``scripts/gradio_paintbrush.py``).

A Gradio Blocks app: upload an image, paint a mask/scribble with the brush,
give an instruction; the composited brush strokes + prompt drive the
paintbrush-LoRA edit. Requires ``gradio`` (not part of the core deps).

  python -m chronoedit_tpu_torch.scripts.gradio_paintbrush \\
      --checkpoint-dir ./checkpoints/ChronoEdit-14B \\
      --lora ./checkpoints/paintbrush_lora.safetensors

The edit itself is :func:`run_edit`, a function of the pipeline and the
editor's value that needs no gradio (JAX's is nested inside its app).
Text instructions go through the UMT5 tokenizer, whose vocabulary is a
download; :func:`run_edit` also takes token ids. The pipeline runs on
``--device`` (default the card).
"""

from __future__ import annotations

import argparse

import torch

GRADIO_MISSING = "gradio is not installed; `pip install gradio` to run the demo"


def composite_image(editor_value, device: torch.device) -> torch.Tensor:
    """The editor's composite (the brush layers over the input: the
    paintbrush conditioning) cropped as the inference CLI crops
    (``ImageCropAndResize(max_pixels=1280*720)``), as (1, 3, H, W) in
    [-1, 1] on ``device``."""
    from chronoedit_tpu_torch.data.edit_dataset import ImageCropAndResize, ToArray

    composite = editor_value["composite"].convert("RGB")
    crop = ImageCropAndResize(None, None, max_pixels=1280 * 720)
    return torch.from_numpy(ToArray()(crop(composite)))[None].to(device)


def run_edit(pipe, editor_value, prompt: str | torch.Tensor, steps: int, guidance: float,
             seed: int = 0, negative_prompt: str | torch.Tensor = "",
             **edit_kw) -> torch.Tensor:
    """One paint-brush edit: the cropped composite, the prompt and negative
    prompt through ``pipe.encode_prompt`` (text, or (1, S) token ids), the
    image through ``pipe.encode_image``, then ``pipe.edit_image`` with
    noise from a generator on the pipeline's device seeded with ``seed``
    (``edit_kw`` reach ``edit_image``: ``latents=`` gives the noise).
    Returns the edited frame (1, 3, H, W) in [-1, 1]."""
    image = composite_image(editor_value, pipe.device)
    return pipe.edit_image(
        image, pipe.encode_prompt(prompt), neg_prompt_emb=pipe.encode_prompt(negative_prompt),
        image_emb=pipe.encode_image(image), num_steps=int(steps),
        guidance_scale=float(guidance), prompt=prompt if isinstance(prompt, str) else "",
        generator=torch.Generator(device=pipe.device).manual_seed(seed), **edit_kw)


def build_app(pipe, seed: int = 0):
    try:
        import gradio as gr
    except ImportError:
        raise SystemExit(GRADIO_MISSING) from None

    from chronoedit_tpu_torch.utils.visualize import to_uint8

    def edit(editor_value, prompt, steps, guidance):
        frame = run_edit(pipe, editor_value, prompt, steps, guidance, seed)
        return to_uint8(frame[0].float().cpu().numpy())  # (H, W, 3), as JAX's app shows it

    with gr.Blocks(title="ChronoEdit Paintbrush") as demo:
        gr.Markdown("# ChronoEdit — paint-brush editing")
        with gr.Row():
            editor = gr.ImageEditor(type="pil", label="paint on the image")
            output = gr.Image(label="edit result")
        prompt = gr.Textbox(label="instruction",
                            placeholder="turn the scribbled region into ...")
        with gr.Row():
            steps = gr.Slider(1, 50, value=8, step=1, label="steps")
            guidance = gr.Slider(1.0, 10.0, value=1.0, label="guidance")
        gr.Button("Edit").click(edit, [editor, prompt, steps, guidance], [output])
    return demo


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--lora", action="append", default=[], help="path[:scale], repeatable")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", default=None, help="torch device; default the first CUDA card")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    try:
        import gradio  # noqa: F401
    except ImportError:
        raise SystemExit(GRADIO_MISSING) from None

    from chronoedit_tpu_torch.configs import chronoedit_14b_distilled
    from chronoedit_tpu_torch.pipeline.loader import load_pipeline

    loras = [(path, float(scale or 1.0))
             for path, _, scale in (spec.partition(":") for spec in args.lora)]
    pipe = load_pipeline(chronoedit_14b_distilled(), args.checkpoint_dir, loras=loras,
                         device=None if args.device is None else torch.device(args.device))
    build_app(pipe).launch(server_port=args.port)


if __name__ == "__main__":
    main()
