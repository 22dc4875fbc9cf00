"""Prompt-enhancer CLI (reference: scripts/prompt_enhancer.py; the JAX
package's ``scripts/prompt_enhancer.py``): a Qwen-VL class model expands a
terse edit instruction, given the input image, into a rich edit prompt.

  python -m chronoedit_tpu_torch.scripts.prompt_enhancer --image input.png \\
      --prompt "make the car red" --model ./Qwen2.5-VL-7B-Instruct

The model runs through transformers on ``--device`` (default the card);
its weights are a download, so ``--model`` names a local directory in a
setup without a network.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--prompt", required=True)
    p.add_argument("--image", default=None)
    p.add_argument("--model", default="Qwen/Qwen2.5-VL-7B-Instruct",
                   help="local HF path (zero-egress setups pre-stage weights)")
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--device", default=None, help="torch device; default the first CUDA card")
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Prints the expanded prompt and returns it."""
    args = parse_args(argv)
    from chronoedit_tpu_torch.aux.prompt_enhancer import PromptEnhancer, PromptEnhancerConfig

    image = None
    if args.image:
        from PIL import Image

        image = Image.open(args.image).convert("RGB")

    enhancer = PromptEnhancer(PromptEnhancerConfig(
        model_path=args.model, max_new_tokens=args.max_new_tokens, device=args.device))
    text = enhancer(args.prompt, image=image)
    print(text)
    return text


if __name__ == "__main__":
    main()
