"""Two-stage VLM labeling of edit pairs (reference: scripts/data_captioning.py;
the JAX package's ``scripts/data_captioning.py``): caption the pair, then
expand the caption into a chain-of-thought edit prompt, written into the
metadata's ``--out-column``.

  python -m chronoedit_tpu_torch.scripts.data_captioning \\
      --metadata data/metadata.csv --model ./Qwen2.5-VL-7B-Instruct

The CSV contract is JAX's: the same instructions, the same column, the
file rewritten in place. The model runs on ``--device`` (default the card).
"""

from __future__ import annotations

import argparse
import csv
import os

CAPTION_INSTRUCTION = (
    "These are the before and after images of an edit. In one sentence, "
    "state what changed between them."
)
EXPAND_INSTRUCTION = (
    "Rewrite that change as a detailed 80-100 word edit prompt describing "
    "the transformation as a physically plausible continuous process from "
    "the first image to the second, preserving everything else."
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--metadata", required=True)
    p.add_argument("--model", default="Qwen/Qwen2.5-VL-7B-Instruct")
    p.add_argument("--image-column", default="image")
    p.add_argument("--edit-column", default="edit_image")
    p.add_argument("--out-column", default="prompt")
    p.add_argument("--device", default=None, help="torch device; default the first CUDA card")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from PIL import Image

    from chronoedit_tpu_torch.aux.prompt_enhancer import PromptEnhancer, PromptEnhancerConfig

    vlm = PromptEnhancer(PromptEnhancerConfig(model_path=args.model, device=args.device))

    with open(args.metadata, newline="") as f:
        rows = list(csv.DictReader(f))
    base = os.path.dirname(os.path.abspath(args.metadata))

    for i, row in enumerate(rows):
        first = Image.open(os.path.join(base, row[args.image_column]))
        # stage 1: terse caption of the change; stage 2: CoT expansion
        caption = vlm(CAPTION_INSTRUCTION, image=first)
        expanded = vlm(f"{EXPAND_INSTRUCTION}\nChange: {caption}", image=first)
        row[args.out_column] = expanded
        print(f"[{i + 1}/{len(rows)}] {expanded[:80]}...")

    with open(args.metadata, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"updated {args.metadata}")


if __name__ == "__main__":
    main()
