"""Checkpoint conversion (reference: scripts/convert_distcp_to_pt.py; the
JAX package's ``scripts/convert_weights.py``).

Two directions, each mode named after what it reads:

- ``checkpoint-to-diffusers SRC DST``: a trainer checkpoint (a
  ``CheckpointManager`` directory, its latest step, or one step directory)
  or a ``save_params`` directory -> diffusers-style DiT safetensors (the
  raw parameters, or the EMA with ``--ema``);
- ``diffusers-to-checkpoint "SHARDS_GLOB" DST``: diffusers DiT shards -> a
  parameters-only checkpoint directory (``train/checkpoint.save_params``).

Examples:
  python -m chronoedit_tpu_torch.scripts.convert_weights checkpoint-to-diffusers \\
      ckpts/ out.safetensors --ema
  python -m chronoedit_tpu_torch.scripts.convert_weights diffusers-to-checkpoint \\
      "ChronoEdit-14B/transformer/*.safetensors" params/

The DiT's layout comes from ``--experiment`` (default ``chronoedit_14b``) at
``--num-layers`` blocks (default 40), in its parameter dtype; tensors keep
their dtype and bits both ways. Runs on the host (CPU): no card needed.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=["checkpoint-to-diffusers", "diffusers-to-checkpoint"])
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--ema", action="store_true",
                   help="export the EMA weights instead of the raw params")
    p.add_argument("--experiment", type=str, default="chronoedit_14b")
    p.add_argument("--num-layers", type=int, default=40)
    return p.parse_args(argv)


def _step_dir(src: str) -> str:
    """``src`` itself when it holds a checkpoint's files, else its latest
    (largest) step directory."""
    from chronoedit_tpu_torch.train.checkpoint import PARAMS_FILE, STATE_FILE

    if any(os.path.exists(os.path.join(src, f)) for f in (PARAMS_FILE, STATE_FILE)):
        return src
    steps = sorted(int(d) for d in os.listdir(src) if d.isdigit())
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {src}")
    return os.path.join(src, str(steps[-1]))


def main(argv=None):
    args = parse_args(argv)

    from safetensors.torch import save_file

    from chronoedit_tpu_torch.configs import get_experiment
    from chronoedit_tpu_torch.models import weights as w
    from chronoedit_tpu_torch.train.checkpoint import load_params, save_params

    cfg = dataclasses.replace(get_experiment(args.experiment).dit, num_layers=args.num_layers)
    if args.mode == "diffusers-to-checkpoint":
        shards = sorted(glob.glob(args.src))
        if not shards:
            raise FileNotFoundError(f"no safetensors match {args.src!r}")
        with w.load_safetensors(shards) as sd:
            model = w.convert_diffusers_dit(sd, cfg, device="cpu")
        save_params(args.dst, model)
        print(f"wrote parameters -> {args.dst}")
    else:
        src = _step_dir(args.src)
        params = load_params(src, field="ema_params" if args.ema else "params")
        sd = {k: v.contiguous() for k, v in w.diffusers_dit_state(params, cfg).items()}
        os.makedirs(os.path.dirname(os.path.abspath(args.dst)), exist_ok=True)
        save_file(sd, args.dst)
        print(f"wrote diffusers safetensors -> {args.dst} ({len(sd)} tensors)")


if __name__ == "__main__":
    main()
