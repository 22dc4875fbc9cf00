"""The port's training and conversion CLIs (``chronoedit_tpu_torch/scripts/
train.py``, ``convert_weights.py``) on the CPU, tiny preset, fp32, against
the JAX package's scripts where the two compute the same thing:

- ``--dryrun`` resolves the same training and trainer configs as JAX's
  (the printed lines equal); ``--smoke`` trains; ``--mesh`` trains over
  data, fsdp and tensor and raises for context and pipe;
- ``--lora-rank`` over ``--base-checkpoint`` (a tiny diffusers checkpoint
  the test writes) counts micro-steps as JAX's loop does, exports
  ``lora.safetensors`` that JAX's converter reads back as the trained
  adapters bitwise, and ``load_pipeline`` merges it as JAX's loader does
  (bitwise) before one edit;
- the metadata path: PNG pairs and UMT5-embedding pickles through the
  dataset and ``_edit_batches``, against JAX's on the same VAE weights
  (1e-4 of scale, the VAE's bound);
- ``convert_weights`` in both directions, bitwise, and the exported file
  read by JAX's converter bitwise.

JAX's ``scripts/train.py`` is not a package: it is loaded from its path.
"""

import csv
import importlib.util
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chronoedit_tpu.configs import chronoedit_tiny as tiny_j
from chronoedit_tpu.data.edit_dataset import EditDataset as EditDatasetJ
from chronoedit_tpu.models import dit as dit_j
from chronoedit_tpu.models import vae as vae_j
from chronoedit_tpu.models import weights as weights_j
from chronoedit_tpu.pipeline.loader import load_pipeline as load_pipeline_j
from chronoedit_tpu_torch.configs import chronoedit_tiny as tiny_t
from chronoedit_tpu_torch.data.edit_dataset import EditDataset
from chronoedit_tpu_torch.models import dit as dit_t
from chronoedit_tpu_torch.models import lora as lora_t
from chronoedit_tpu_torch.models import vae as vae_t
from chronoedit_tpu_torch.models.from_jax import load_dit, load_lora, load_vae
from chronoedit_tpu_torch.pipeline.loader import load_pipeline
from chronoedit_tpu_torch.scripts import convert_weights
from chronoedit_tpu_torch.scripts import train as train_t
from chronoedit_tpu_torch.train import checkpoint as ck_t
from chronoedit_tpu_torch.train import train_step as ts_t
from chronoedit_tpu_torch.train.trainer import Trainer, TrainerConfig
from test_torch_dit import randomize
from test_torch_encoders import state_equal
from test_torch_weights import write_checkpoint

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CFG_J, CFG_T = tiny_j(), tiny_t()


def _jax_train_script():
    spec = importlib.util.spec_from_file_location("jax_scripts_train", REPO / "scripts" /
                                                  "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trees():
    dit_p = randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), CFG_J.dit), 41)
    vae_p = randomize(lambda: vae_j.init_vae_params(jax.random.PRNGKey(1), CFG_J.vae), 42,
                      fan_in=lambda s: int(np.prod(s[:-1])))
    return dit_p, vae_p


def test_dryrun_resolves_jax_configs_smoke_trains_and_mesh_raises(capsys, monkeypatch):
    """``--dryrun`` prints the pipeline, training and trainer configs and
    builds nothing: the training and trainer lines equal JAX's (the
    warm-up rule ``min(1000, max(1, max_iter // 10))`` among them), and the
    ``--set`` override reaches the pipeline's. ``--smoke`` trains 2
    iterations on the CPU, also under ``--mesh data=1`` (a world of one);
    a mesh that is not ported raises ``ValueError`` naming the roadmap item
    that ports it: LoRA mode with a context or pipe axis (item 3.3); pipe x
    fsdp trains in full-parameter mode, so in one process it fails only
    for want of the 4 ranks its mesh needs."""
    flags = ["--dryrun", "--max-iter", "30", "--grad-accum", "2", "--lr", "3e-4",
             "--set", "dit.num_layers=3", "--remat", "matmul_only"]
    assert train_t.main(flags) is None
    port = capsys.readouterr().out.splitlines()
    monkeypatch.setattr("sys.argv", ["train.py"] + flags)
    _jax_train_script().main()
    jax_out = capsys.readouterr().out.splitlines()
    assert len(port) == len(jax_out) == 3
    assert port[1:] == jax_out[1:]
    assert "warmup_steps=3" in port[1] and "grad_accum=2" in port[1]
    assert "num_layers=3" in port[0]

    state = train_t.main(["--smoke", "--device", "cpu"])
    assert state.step == 2 and "done at step 2" in capsys.readouterr().out
    state = train_t.main(["--smoke", "--device", "cpu", "--mesh", "data=1"])
    assert state.step == 2 and "done at step 2" in capsys.readouterr().out
    for axis in ("context", "pipe"):
        with pytest.raises(ValueError, match=f"{axis}=2 .*item 3.3"):
            train_t.main(["--smoke", "--device", "cpu", "--lora-rank", "2", "--mesh", f"{axis}=2"])
    with pytest.raises(ValueError, match=r"1 devices not divisible by pipe\*fsdp\*tensor\*"
                                         r"context=4"):
        train_t.main(["--smoke", "--device", "cpu", "--mesh", "pipe=2,fsdp=2"])


def test_lora_cli_from_a_diffusers_base_exports_and_loads(trees, tmp_path, capsys):
    """``--lora-rank 2 --grad-accum 2 --max-iter 4`` over the tiny checkpoint's
    shards: 4 step calls (micro-steps, JAX's count) and 2 applied updates,
    the second at a non-zero learning rate, so every b moves. The exported
    ``lora.safetensors`` reads back through JAX's converter as the trained
    adapters, bitwise (fp32), with alpha = rank. ``load_pipeline`` with it
    merges into the file's DiT as ``merge_lora`` does and as JAX's loader
    does (bitwise both), and serves an edit."""
    dit_p, vae_p = trees
    write_checkpoint(tmp_path, dit_p, vae_p)
    out = tmp_path / "out"
    state = train_t.main(["--experiment", "tiny", "--data", "mock", "--lora-rank", "2",
                          "--base-checkpoint", str(tmp_path / "transformer" / "*.safetensors"),
                          "--checkpoint-dir", str(out), "--max-iter", "4", "--grad-accum",
                          "2", "--remat", "full", "--device", "cpu"])
    assert state.step == 4 and state.optimizer.gradient_step == 2
    assert all(bool(ad.b.detach().any()) for blk in state.lora.blocks
               for _, ad in lora_t.iter_adapters(blk))
    assert "saved LoRA" in capsys.readouterr().out

    from safetensors.numpy import load_file

    sd = load_file(str(out / "lora.safetensors"))
    tree_j, scaling_j = weights_j.convert_diffusers_lora(sd, num_layers=CFG_J.dit.num_layers)
    assert scaling_j == 1.0  # alpha = rank
    exported = load_lora(lora_t.LoRA(dit_t.DiT(CFG_T.dit), lora_t.LoRAConfig(rank=2)),
                         jax.tree.map(np.asarray, tree_j))
    for p, q in zip(exported.parameters(), state.lora.parameters()):
        assert torch.equal(p, q.detach())

    lora_path = str(out / "lora.safetensors")
    pipe = load_pipeline(CFG_T, str(tmp_path), loras=[(lora_path, 1.0)], device=CPU)
    base = load_dit(dit_t.DiT(CFG_T.dit), dit_p)
    state_equal(pipe.dit, lora_t.merge_lora(base, state.lora, 1.0))
    pipe_j = load_pipeline_j(CFG_J, str(tmp_path), loras=[(lora_path, 1.0)])
    state_equal(pipe.dit, load_dit(dit_t.DiT(CFG_T.dit),
                                   jax.tree.map(np.asarray, pipe_j.dit_params)))
    rng = np.random.default_rng(3)
    d = CFG_T.dit
    with torch.no_grad():
        frame = pipe.edit_image(
            torch.from_numpy(rng.uniform(-1, 1, (1, 3, 16, 16)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((1, 6, d.text_dim)).astype(np.float32)),
            image_emb=torch.from_numpy(rng.standard_normal(
                (1, d.image_tokens, d.image_dim)).astype(np.float32)),
            generator=torch.Generator().manual_seed(0))
    assert tuple(frame.shape) == (1, 3, 16, 16) and bool(torch.isfinite(frame).all())


def _metadata(root: Path) -> Path:
    """Two PNG edit pairs (24x40, cropped to 16x32 by the dataset) and their
    UMT5-embedding pickles, listed in metadata.csv."""
    rng = np.random.default_rng(7)
    rows = []
    for i in range(2):
        for name in ("image", "edit_image"):
            Image.fromarray(rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)).save(
                root / f"{name}{i}.png")
        with open(root / f"emb{i}.pkl", "wb") as f:
            pickle.dump(rng.standard_normal((6, CFG_T.dit.text_dim)).astype(np.float32), f)
        rows.append({"image": f"image{i}.png", "edit_image": f"edit_image{i}.png",
                     "prompt": f"edit {i}", "umt5_emb": f"emb{i}.pkl"})
    path = root / "metadata.csv"
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return path


def test_metadata_path_matches_jax(trees, tmp_path):
    """``EditDataset`` (the port's copy) reads the same pairs and pickles as
    JAX's; ``_edit_batches`` encodes them through the port's VAE as JAX's
    through its own, on the same weights: latents and condition within
    1e-4 of scale, the text embeddings equal, for two rows (cycled). The CLI
    then trains a rank-2 LoRA on the file and exports it."""
    _, vae_p = trees
    meta = _metadata(tmp_path)
    ds_t, ds_j = EditDataset(str(tmp_path), str(meta)), EditDatasetJ(str(tmp_path), str(meta))
    assert len(ds_t) == 2
    item = ds_t[1]
    assert item["video"].shape == (3, 2, 16, 32) and item["prompt"] == "edit 1"
    np.testing.assert_array_equal(item["video"], ds_j[1]["video"])
    vae = load_vae(vae_t.VAE(CFG_T.vae), vae_p)
    got = train_t._edit_batches(ds_t, vae, CFG_T, 1, CPU)
    want = _jax_train_script()._edit_batches(ds_j, jax.tree.map(jnp.asarray, vae_p), CFG_J, 1)
    for _ in range(3):
        g, w = next(got), next(want)
        assert tuple(g["latents"].shape) == (1, 4, 2, 8, 16)
        for k in ("latents", "condition"):
            ref = np.asarray(w[k])
            np.testing.assert_allclose(g[k].numpy(), ref,
                                       atol=1e-4 * max(1.0, float(np.abs(ref).max())))
        np.testing.assert_array_equal(g["text_emb"].numpy(), np.asarray(w["text_emb"]))

    out = tmp_path / "out"
    state = train_t.main(["--experiment", "tiny", "--data", str(meta), "--base-path",
                          str(tmp_path), "--lora-rank", "2", "--max-iter", "2",
                          "--checkpoint-dir", str(out), "--device", "cpu"])
    assert state.step == 2 and (out / "lora.safetensors").exists()


def test_convert_weights_both_directions_bitwise(trees, tmp_path):
    """A Trainer checkpoint (2 iterations) -> diffusers safetensors, raw and
    ``--ema``: JAX's converter reads each file back to the checkpoint's
    parameters bitwise; diffusers -> a parameters checkpoint -> the same
    bits again (``load_params``)."""
    dit_p, _ = trees
    model = load_dit(dit_t.DiT(CFG_T.dit), dit_p)
    trainer = Trainer(CFG_T.dit, ts_t.TrainConfig(lr=1e-2, warmup_steps=1),
                      TrainerConfig(max_iter=2, save_every=2),
                      ck_t.CheckpointConfig(directory=str(tmp_path / "ck"), async_save=False))
    from test_torch_trainer import _data_t

    state = trainer.train(trainer.init_state(model), _data_t())
    flags = ["--experiment", "tiny", "--num-layers", str(CFG_T.dit.num_layers)]
    for field, extra in (("params", []), ("ema_params", ["--ema"])):
        want = dict(zip([n for n, _ in model.named_parameters()],
                        state.params if field == "params" else state.ema_params))
        dst = tmp_path / f"{field}.safetensors"
        convert_weights.main(["checkpoint-to-diffusers", str(tmp_path / "ck"), str(dst)] +
                             flags + extra)
        from safetensors.numpy import load_file

        back_j = load_dit(dit_t.DiT(CFG_T.dit), jax.tree.map(
            np.asarray, weights_j.convert_diffusers_dit(load_file(str(dst)),
                                                        num_layers=CFG_J.dit.num_layers)))
        for name, p in back_j.named_parameters():
            assert torch.equal(p, want[name].detach()), name
        convert_weights.main(["diffusers-to-checkpoint", str(dst), str(tmp_path / f"p_{field}")]
                             + flags)
        back = ck_t.load_params(str(tmp_path / f"p_{field}"))
        assert back.keys() == want.keys()
        for name, t in back.items():
            assert torch.equal(t, want[name].detach()), name
    assert not torch.equal(state.params[0], state.ema_params[0])
    with pytest.raises(FileNotFoundError):
        convert_weights.main(["checkpoint-to-diffusers", str(tmp_path / "p_params" / "x"),
                              str(tmp_path / "x.safetensors")] + flags)


def test_cli_takes_every_jax_flag():
    """The flags the JAX CLI takes, with its defaults, plus ``--device``."""
    port = vars(train_t.parse_args([]))
    assert set(port) == {"experiment", "data", "base_path", "batch_size", "max_iter", "lr",
                         "grad_accum", "save_every", "checkpoint_dir", "log_file", "mesh",
                         "remat", "lora_rank", "base_checkpoint", "overrides", "smoke",
                         "dryrun", "device"}
    jax_script = _jax_train_script()
    import sys

    argv, sys.argv = sys.argv, ["train.py"]
    try:
        jax_defaults = vars(jax_script.parse_args())
    finally:
        sys.argv = argv
    assert {k: v for k, v in port.items() if k != "device"} == jax_defaults
