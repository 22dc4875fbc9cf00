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

  # the 14B model over 8 cards, its parameters sharded 8 ways (one rank a card, NCCL)
  torchrun --nproc-per-node 8 -m chronoedit_tpu_torch.scripts.train \\
      --experiment chronoedit_14b --data /path/to/metadata.csv --mesh fsdp=8 \\
      --max-iter 5000 --checkpoint-dir ckpts/

  # data parallelism on the CPU, two processes over gloo
  python -m torch.distributed.run --standalone --nproc-per-node 2 \\
      -m chronoedit_tpu_torch.scripts.train --experiment tiny --data mock --smoke \\
      --device cpu --mesh data=2

  # context or pipeline parallelism on the CPU (pipe=2,context=2 over 4)
  python -m torch.distributed.run --standalone --nproc-per-node 2 \\
      -m chronoedit_tpu_torch.scripts.train --experiment tiny --data mock --smoke \\
      --device cpu --mesh pipe=2

  # pipeline stages whose blocks are sharded over fsdp, on the CPU
  python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      -m chronoedit_tpu_torch.scripts.train --experiment tiny --data mock --smoke \\
      --device cpu --mesh pipe=2,fsdp=2

As in JAX: the training clips are encoded by a VAE with random weights
(seed 1; there is no flag to load one), the full-parameter path starts
from a random DiT (seed 0), and the LoRA loop calls the step ``--max-iter``
times, each call one micro-step of ``--grad-accum``. The DiT is built once:
with ``--base-checkpoint`` (LoRA mode) its weights come straight from the
shards, no random model beside it.

``--mesh`` trains over the ``data``, ``fsdp`` and ``tensor`` axes and their
compositions in both modes, and in full-parameter mode also over
``context`` and ``pipe`` and their compositions with the others, one
process a device (``torchrun``; a world of several
processes needs ``--mesh``): the DiT is sharded by JAX's placement
(``parallel.shard_params``; with ``--base-checkpoint`` each rank reads only
its slices); under ``pipe`` each rank keeps only its stage's blocks of the
seeded model (``DiT.keep_layers``: bitwise the whole model's), and beside
``fsdp`` its fsdp slice of each of them; the VAE and
the LoRA adapters are whole on every rank; each process encodes its own
rows (the metadata rows strided by process, a mock stream seeded by
process) and ``host_local_to_global`` gives every rank its data line's
rows; callbacks, logs and the exported LoRA are rank 0's; checkpoints are
sharded (a stage's blocks under their global names). ``--batch-size`` is
per process. LoRA mode under ``context`` or ``pipe`` and a quantized base
under a mesh raise ``ValueError`` (``ROADMAP.md`` queue 1, item 3.3).
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
                   help="parallelism over the processes' devices, e.g. 'fsdp=8', "
                        "'data=2,fsdp=2,tensor=2', 'context=2', 'data=2,pipe=2,context=2' or "
                        "'pipe=2,fsdp=2': data, fsdp, tensor, context and pipe train in "
                        "full-parameter mode, data, fsdp and tensor in LoRA mode")
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

    from chronoedit_tpu_torch.configs import get_experiment
    from chronoedit_tpu_torch.parallel import (host_local_to_global, init_distributed,
                                               is_primary, process_count, process_index)
    from chronoedit_tpu_torch.parallel.distributed import leave_world
    from chronoedit_tpu_torch.parallel.mesh import make_mesh, parse_mesh, single_device_mesh
    from chronoedit_tpu_torch.train.callbacks import (
        HeartbeatCallback, IterSpeedCallback, LossLoggerCallback)
    from chronoedit_tpu_torch.train.checkpoint import CheckpointConfig
    from chronoedit_tpu_torch.train.train_step import TrainConfig, check_lora_mesh
    from chronoedit_tpu_torch.train.trainer import Trainer, TrainerConfig
    from chronoedit_tpu_torch.utils.config import apply_overrides
    from chronoedit_tpu_torch.utils.platform import cuda_device, multi_device_world

    mesh_cfg = parse_mesh(args.mesh) if args.mesh else None
    if args.lora_rank > 0:
        check_lora_mesh(mesh_cfg)
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
    if mesh_cfg is not None:
        mesh = make_mesh(mesh_cfg, device)
    elif multi_device_world():
        raise ValueError(f"{process_count()} processes: say how they split the training with "
                         f"--mesh (e.g. --mesh data={process_count()})")
    else:
        mesh = single_device_mesh(device)
    if mesh_cfg is not None and is_primary():
        import torch.distributed as dist

        backend = dist.get_backend() if dist.is_initialized() else "no process group"
        print(f"mesh {mesh.shape} over {backend}, {mesh.size} ranks", flush=True)
    model = _build_dit(args, dit_cfg, device, mesh)
    vae = _build_vae(pipe_cfg, device)
    if args.data == "mock":
        from chronoedit_tpu_torch.data.mock import mock_batch_iterator

        # a stream of its own a process: the data lines train on other rows
        data = mock_batch_iterator(vae, pipe_cfg, height=32, width=32, seed=process_index())
    else:
        from chronoedit_tpu_torch.data.edit_dataset import EditDataset
        from chronoedit_tpu_torch.data.loaders import PrefetchLoader

        ds = EditDataset(args.base_path, args.data)
        data = iter(PrefetchLoader(_edit_batches(ds, vae, pipe_cfg, args.batch_size, device,
                                                 process_index(), process_count())))
    data = (host_local_to_global(batch, mesh) for batch in data)

    if args.lora_rank > 0:
        state = _train_lora(args, dit_cfg, train_cfg, model, data, mesh)
        leave_world()
        return state

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
    trainer = Trainer(dit_cfg, train_cfg, trainer_cfg, ckpt_cfg, callbacks, mesh=mesh)
    state = trainer.train(trainer.init_state(model), data)
    if is_primary():
        print(f"done at step {state.step}")
    leave_world()
    return state


def _build_dit(args, dit_cfg, device: torch.device, mesh):
    """The DiT, once, holding this rank's shards under ``mesh``: from the
    ``--base-checkpoint`` shards in LoRA mode (each rank reading only its
    slices), else random weights from seed 0, sharded; under a pipe axis
    only this rank's stage's blocks of the seeded model are kept."""
    from chronoedit_tpu_torch.models import dit as dit_lib
    from chronoedit_tpu_torch.models import weights as w
    from chronoedit_tpu_torch.parallel.pipeline_parallel import stage_range
    from chronoedit_tpu_torch.parallel.sharding import shard_params

    if args.lora_rank > 0 and args.base_checkpoint:
        shards = sorted(glob.glob(args.base_checkpoint))
        if not shards:
            raise FileNotFoundError(f"no safetensors match {args.base_checkpoint!r}")
        with w.load_safetensors(shards) as sd:
            return w.convert_diffusers_dit(sd, dit_cfg, device, mesh=mesh)
    model = dit_lib.init_dit_params(dit_cfg, torch.Generator(device=device).manual_seed(0),
                                    device=device)
    model.keep_layers(stage_range(dit_cfg.num_layers, mesh))
    return shard_params(model, mesh)


def _build_vae(pipe_cfg, device: torch.device):
    """The VAE that encodes the training clips: random weights from seed 1,
    as JAX's CLI (which has no flag to load one)."""
    from chronoedit_tpu_torch.models import vae as vae_lib

    return vae_lib.init_vae_params(pipe_cfg.vae, torch.Generator(device=device).manual_seed(1),
                                   device=device)


def _train_lora(args, dit_cfg, train_cfg, base, data, mesh):
    """LoRA fine-tune (the train_diffsynth.py recipe: rank-R adapters on the
    attention/ffn projections of every block, frozen base), exported to
    ``<checkpoint-dir>/lora.safetensors`` by rank 0; returns the train
    state. Under ``mesh`` the adapters are the whole model's on every rank,
    over this rank's shards of the base."""
    from safetensors.torch import save_file

    from chronoedit_tpu_torch.models import lora as lora_lib
    from chronoedit_tpu_torch.models import weights as w
    from chronoedit_tpu_torch.parallel import is_primary
    from chronoedit_tpu_torch.train.lora_train import (
        make_lora_train_state, make_lora_train_step)

    device = next(base.parameters()).device
    lcfg = lora_lib.LoRAConfig(rank=args.lora_rank, alpha=float(args.lora_rank))
    lora = lora_lib.init_lora_params(torch.Generator(device=device).manual_seed(1), base, lcfg)
    state = make_lora_train_state(lora, train_cfg, mesh)
    step = make_lora_train_step(dit_cfg, train_cfg, mesh)

    gen = torch.Generator(device=device).manual_seed(0)
    for it in range(args.max_iter):  # micro-steps, as JAX's loop counts them
        metrics = step(state, base, next(data), gen)
        if it % 10 == 0 and is_primary():
            print(f"[lora iter {it}] loss={float(metrics['loss']):.4f}")
    if not is_primary():
        return state

    out = os.path.join(args.checkpoint_dir or ".", "lora.safetensors")
    sd_out = {k: v.cpu() for k, v in w.export_diffusers_lora(state.lora, alpha=lcfg.alpha).items()}
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    save_file(sd_out, out)
    print(f"saved LoRA -> {out} ({len(sd_out)} tensors)")
    return state


def _edit_batches(ds, vae, pipe_cfg, batch_size: int, device: torch.device, rank: int = 0,
                  world: int = 1):
    """Endless train-step batches from the metadata dataset: edit pairs
    encoded by ``vae`` and their precomputed UMT5 embeddings, on
    ``device``; process ``rank`` of ``world`` takes every ``world``-th row
    from its own (JAX's strided split, webdataset's distributor)."""
    from chronoedit_tpu_torch.train.train_step import edit_training_batch

    idx = itertools.cycle(range(rank % max(len(ds), 1), len(ds), world))
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
