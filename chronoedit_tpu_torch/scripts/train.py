"""ChronoEdit training CLI on PyTorch (reference: scripts/train.py; the JAX
package's ``scripts/train.py``).

Examples:
  # smoke-train the tiny model on mock data, on the CPU
  python -m chronoedit_tpu_torch.scripts.train --experiment tiny --data mock --smoke \\
      --device cpu

  # rank-32 LoRA over the 14B checkpoint's DiT, on the card, exported to
  # ckpts/lora.safetensors
  python -m chronoedit_tpu_torch.scripts.train --experiment chronoedit_14b \\
      --data /path/to/metadata.csv --lora-rank 32 --remat full \\
      --base-checkpoint "ChronoEdit-14B/transformer/*.safetensors" --checkpoint-dir ckpts/

  # full-parameter training through the Trainer, checkpoints every 500 iterations
  python -m chronoedit_tpu_torch.scripts.train --experiment tiny --data mock \\
      --max-iter 5000 --checkpoint-dir ckpts/

As in JAX: the training clips are encoded by a VAE with random weights
(seed 1; there is no flag to load one), the full-parameter path starts
from a random DiT (seed 0), and the LoRA loop calls the step ``--max-iter``
times, each call one micro-step of ``--grad-accum``. The DiT is built once:
with ``--base-checkpoint`` (LoRA mode) its weights come straight from the
shards, no random model beside it. ``--mesh`` (data-parallel and FSDP
training, item 6b of the roadmap) is not ported yet and raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import itertools
import os

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--experiment", type=str, default="tiny")
    p.add_argument("--data", type=str, default="mock",
                   help="'mock' or a metadata.csv path")
    p.add_argument("--base-path", type=str, default="",
                   help="dataset root for relative paths in metadata")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--max-iter", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--save-every", type=int, default=500)
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--log-file", type=str, default=None)
    p.add_argument("--mesh", type=str, default=None,
                   help="multi-GPU parallelism spec (not ported yet, item 6b of the "
                        "roadmap: raises)")
    p.add_argument("--remat", type=str, default="none",
                   choices=["none", "full", "matmul_only"])
    p.add_argument("--lora-rank", type=int, default=0,
                   help=">0: LoRA fine-tune (frozen base, rank-R adapters on "
                        "q,k,v,o,ffn: the DiffSynth train_diffsynth.py path)")
    p.add_argument("--base-checkpoint", type=str, default=None,
                   help="diffusers safetensors glob for the frozen base "
                        "weights (LoRA mode; random base if omitted)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   help="config override key=value (repeatable), e.g. "
                        "--set dit.num_layers=8")
    p.add_argument("--smoke", action="store_true",
                   help="max_iter=2, no checkpoints (reference train.py --smoke)")
    p.add_argument("--dryrun", action="store_true",
                   help="print resolved configs and exit (reference --dryrun)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the first CUDA card")
    return p.parse_args(argv)


def main(argv=None):
    """Train as the flags say; returns the final train state."""
    args = parse_args(argv)
    if args.smoke:
        args.max_iter = 2
        args.checkpoint_dir = None
    if args.mesh:
        raise NotImplementedError("--mesh: multi-GPU training is not ported yet "
                                  "(item 6b of the roadmap)")

    from chronoedit_tpu_torch.configs import get_experiment
    from chronoedit_tpu_torch.parallel import init_distributed, is_primary
    from chronoedit_tpu_torch.train.callbacks import (
        HeartbeatCallback, IterSpeedCallback, LossLoggerCallback)
    from chronoedit_tpu_torch.train.checkpoint import CheckpointConfig
    from chronoedit_tpu_torch.train.train_step import TrainConfig
    from chronoedit_tpu_torch.train.trainer import Trainer, TrainerConfig
    from chronoedit_tpu_torch.utils.config import apply_overrides
    from chronoedit_tpu_torch.utils.platform import cuda_device

    init_distributed(device=None if args.device is None else torch.device(args.device))
    pipe_cfg = apply_overrides(get_experiment(args.experiment), args.overrides)
    dit_cfg = dataclasses.replace(pipe_cfg.dit, remat=args.remat)
    train_cfg = TrainConfig(lr=args.lr, grad_accum=args.grad_accum,
                            warmup_steps=min(1000, max(1, args.max_iter // 10)))
    trainer_cfg = TrainerConfig(max_iter=args.max_iter, save_every=args.save_every)

    if args.dryrun:
        print(pipe_cfg)
        print(train_cfg)
        print(trainer_cfg)
        return None

    device = cuda_device() if args.device is None else torch.device(args.device)
    model = _build_dit(args, dit_cfg, device)
    vae = _build_vae(pipe_cfg, device)
    if args.data == "mock":
        from chronoedit_tpu_torch.data.mock import mock_batch_iterator

        data = mock_batch_iterator(vae, pipe_cfg, height=32, width=32)
    else:
        from chronoedit_tpu_torch.data.edit_dataset import EditDataset
        from chronoedit_tpu_torch.data.loaders import PrefetchLoader

        ds = EditDataset(args.base_path, args.data)
        data = iter(PrefetchLoader(_edit_batches(ds, vae, pipe_cfg, args.batch_size, device)))

    if args.lora_rank > 0:
        return _train_lora(args, dit_cfg, train_cfg, model, data)

    # host-side observability is rank-0-only (the reference's rank0 filter)
    callbacks = []
    if is_primary():
        callbacks = [IterSpeedCallback(log_every=10 if args.smoke else 50),
                     HeartbeatCallback(path=os.path.join(
                         args.checkpoint_dir or ".", "heartbeat.txt"))]
        if args.log_file:
            callbacks.append(LossLoggerCallback(args.log_file))
    ckpt_cfg = (CheckpointConfig(directory=args.checkpoint_dir, save_interval=args.save_every)
                if args.checkpoint_dir else None)
    trainer = Trainer(dit_cfg, train_cfg, trainer_cfg, ckpt_cfg, callbacks)
    state = trainer.train(trainer.init_state(model), data)
    print(f"done at step {state.step}")
    return state


def _build_dit(args, dit_cfg, device: torch.device):
    """The DiT, once: from the ``--base-checkpoint`` shards in LoRA mode,
    else random weights from seed 0."""
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.models import weights as w

    if args.lora_rank > 0 and args.base_checkpoint:
        shards = sorted(glob.glob(args.base_checkpoint))
        if not shards:
            raise FileNotFoundError(f"no safetensors match {args.base_checkpoint!r}")
        with w.load_safetensors(shards) as sd:
            return w.convert_diffusers_dit(sd, dit_cfg, device)
    return dit_lib.init_dit_params(dit_cfg, torch.Generator(device=device).manual_seed(0),
                                   device=device)


def _build_vae(pipe_cfg, device: torch.device):
    """The VAE that encodes the training clips: random weights from seed 1,
    as JAX's CLI (which has no flag to load one)."""
    from chronoedit_tpu_torch.models import vae as vae_lib

    return vae_lib.init_vae_params(pipe_cfg.vae, torch.Generator(device=device).manual_seed(1),
                                   device=device)


def _train_lora(args, dit_cfg, train_cfg, base, data):
    """LoRA fine-tune (the train_diffsynth.py recipe: rank-R adapters on the
    attention/ffn projections of every block, frozen base), exported to
    ``<checkpoint-dir>/lora.safetensors``; returns the train state."""
    from safetensors.torch import save_file

    from chronoedit_tpu_torch.models import lora as lora_lib
    from chronoedit_tpu_torch.models import weights as w
    from chronoedit_tpu_torch.train.lora_train import (
        make_lora_train_state, make_lora_train_step)

    device = next(base.parameters()).device
    lcfg = lora_lib.LoRAConfig(rank=args.lora_rank, alpha=float(args.lora_rank))
    lora = lora_lib.init_lora_params(torch.Generator(device=device).manual_seed(1), base, lcfg)
    state = make_lora_train_state(lora, train_cfg)
    step = make_lora_train_step(dit_cfg, train_cfg)

    gen = torch.Generator(device=device).manual_seed(0)
    for it in range(args.max_iter):  # micro-steps, as JAX's loop counts them
        metrics = step(state, base, next(data), gen)
        if it % 10 == 0:
            print(f"[lora iter {it}] loss={float(metrics['loss']):.4f}")

    out = os.path.join(args.checkpoint_dir or ".", "lora.safetensors")
    sd_out = {k: v.cpu() for k, v in w.export_diffusers_lora(state.lora, alpha=lcfg.alpha).items()}
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    save_file(sd_out, out)
    print(f"saved LoRA -> {out} ({len(sd_out)} tensors)")
    return state


def _edit_batches(ds, vae, pipe_cfg, batch_size: int, device: torch.device):
    """Endless train-step batches from the metadata dataset: edit pairs
    encoded by ``vae`` and their precomputed UMT5 embeddings, on
    ``device``."""
    from chronoedit_tpu_torch.train.train_step import edit_training_batch

    idx = itertools.cycle(range(len(ds)))
    while True:
        items = [ds[next(idx)] for _ in range(batch_size)]
        video = torch.from_numpy(np.stack([it["video"] for it in items])).to(device)
        with torch.no_grad():
            latents, condition = edit_training_batch(vae, pipe_cfg, video)
        batch = {"latents": latents, "condition": condition}
        if "text_emb" not in items[0]:
            raise SystemExit(
                "metadata rows need precomputed 'umt5_emb' pickles: on-the-fly text "
                "encoding needs the UMT5 tokenizer")
        batch["text_emb"] = torch.from_numpy(
            np.stack([it["text_emb"] for it in items])).to(device)
        yield batch


if __name__ == "__main__":
    main()
