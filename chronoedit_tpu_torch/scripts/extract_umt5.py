"""Precompute UMT5 prompt embeddings for a training dataset (reference:
scripts/extract_umt5.py; the JAX package's ``scripts/extract_umt5.py``):
one pickle per metadata row, and the rows' ``umt5_emb`` column pointing at
them, which the training CLI (``scripts/train.py``) reads.

Examples:
  # from a column of token-id files (.npy, paths relative to the metadata)
  python -m chronoedit_tpu_torch.scripts.extract_umt5 --metadata data/metadata.csv \\
      --checkpoint-dir ./checkpoints/ChronoEdit-14B --ids-column prompt_ids \\
      --output-dir data/umt5

  # from the prompt text, with a local copy of the google/umt5-xxl tokenizer
  python -m chronoedit_tpu_torch.scripts.extract_umt5 --metadata data/metadata.csv \\
      --t5-checkpoint models_t5_umt5-xxl-enc-bf16.pth --tokenizer ./umt5-xxl \\
      --output-dir data/umt5

Each row's prompt becomes ``{output_dir}/{i:08d}.pkl``: the (text_len,
dim) float32 embedding, zero past the prompt's length. JAX's script
tokenizes the prompt text with the ``google/umt5-xxl`` vocabulary, a
download; here the text needs a local tokenizer directory
(``--tokenizer``), or the row gives its token ids (``--ids-column``: a
``.npy`` of the prompt's ids, (S,) or (1, S), padded with id 0 to the
encoder's text length under a mask of S ones, as the tokenizer pads). The
encoder runs on ``--device`` (default the card), its shapes read from the
checkpoint and its dtype the file's (bf16 for the released file).
"""

from __future__ import annotations

import argparse
import csv
import os
import pickle
import re

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--metadata", required=True, help="metadata.csv, rewritten in place")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint-dir", help="directory holding "
                     "models_t5_umt5-xxl-enc-bf16.pth (pipeline/loader.py's T5_FILE)")
    src.add_argument("--t5-checkpoint", help="the UMT5 encoder's .pth file")
    text = p.add_mutually_exclusive_group(required=True)
    text.add_argument("--tokenizer", help="local UMT5 tokenizer directory (encodes "
                      "--prompt-column's text)")
    text.add_argument("--ids-column", help="column of .npy token-id files, in place of text")
    p.add_argument("--output-dir", default="umt5")
    p.add_argument("--prompt-column", default="prompt")
    p.add_argument("--device", default=None, help="torch device; default the first CUDA card")
    return p.parse_args(argv)


def umt5_config(sd: dict[str, torch.Tensor]):
    """The encoder's shapes and dtype from its checkpoint (reference
    names): vocabulary and width from the token embedding, heads and
    buckets from a layer's relative embedding, the layer count from the
    norms; the file's dtype is both parameter and compute dtype."""
    from chronoedit_tpu_torch.models.umt5 import UMT5Config

    emb = sd["token_embedding.weight"]
    layers = {k.split(".")[1] for k in sd if re.fullmatch(r"blocks\.\d+\.norm1\.weight", k)}
    buckets, heads = sd["blocks.0.pos_embedding.embedding.weight"].shape
    return UMT5Config(vocab_size=emb.shape[0], dim=emb.shape[1],
                      dim_attn=sd["blocks.0.attn.q.weight"].shape[0],
                      dim_ffn=sd["blocks.0.ffn.fc1.weight"].shape[0], num_heads=heads,
                      num_layers=len(layers), num_buckets=buckets, dtype=emb.dtype,
                      param_dtype=emb.dtype)


def load_encoder(path: str, device: torch.device, tokenizer: str | None = None):
    """A ``UMT5TextEncoder`` from the reference file at ``path`` (its
    tokenizer read from the ``tokenizer`` directory when it is asked to
    encode text)."""
    from chronoedit_tpu_torch.models import weights as w
    from chronoedit_tpu_torch.models.umt5 import UMT5TextEncoder, convert_umt5_checkpoint

    sd = w.load_torch(path)
    model = convert_umt5_checkpoint(sd, umt5_config(sd), device=device)
    return UMT5TextEncoder(model, tokenizer_path=tokenizer or "google/umt5-xxl")


def padded_ids(ids: np.ndarray, text_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(1, text_len) ids and 0/1 mask of a prompt's ids: truncated to
    ``text_len``, padded with id 0, the mask one over the prompt."""
    ids = np.asarray(ids).reshape(-1)[:text_len].astype(np.int64)
    out = torch.zeros((1, text_len), dtype=torch.long)
    mask = torch.zeros((1, text_len), dtype=torch.long)
    out[0, :len(ids)] = torch.from_numpy(ids)
    mask[0, :len(ids)] = 1
    return out, mask


def main(argv=None) -> list[str]:
    """Writes the pickles and the updated metadata; returns the pickles'
    paths in row order."""
    args = parse_args(argv)
    from chronoedit_tpu_torch.pipeline.loader import T5_FILE
    from chronoedit_tpu_torch.utils.platform import cuda_device

    device = cuda_device() if args.device is None else torch.device(args.device)
    path = args.t5_checkpoint or os.path.join(args.checkpoint_dir, T5_FILE)
    encoder = load_encoder(path, device, args.tokenizer)

    with open(args.metadata, newline="") as f:
        rows = list(csv.DictReader(f))
    base = os.path.dirname(os.path.abspath(args.metadata))
    os.makedirs(args.output_dir, exist_ok=True)
    outs = []
    for i, row in enumerate(rows):
        if args.ids_column:
            ids, mask = padded_ids(np.load(os.path.join(base, row[args.ids_column])),
                                   encoder.cfg.text_len)
            emb = encoder.encode_ids(ids.to(device), mask.to(device))
        else:
            emb = encoder([row[args.prompt_column]])
        out = os.path.join(args.output_dir, f"{i:08d}.pkl")
        with open(out, "wb") as f:
            pickle.dump(emb[0].float().cpu().numpy(), f)
        row["umt5_emb"] = out
        outs.append(out)
        print(f"[{i + 1}/{len(rows)}] {out}")

    with open(args.metadata, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    print(f"updated {args.metadata} with umt5_emb column")
    return outs


if __name__ == "__main__":
    main()
