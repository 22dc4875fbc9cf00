"""The port's command-line entry points on the CPU (``--device cpu``) and
its presets against the JAX package's.

``run_inference --smoke`` runs the tiny preset end to end on random weights
(also with the block cache, guidance and reasoning),
``serve --smoke`` answers over HTTP from a subprocess, and
``check_environment --device cpu`` passes. ``EXPERIMENTS`` holds JAX's
names and numbers.
"""

import dataclasses
import io
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from chronoedit_tpu.configs import presets as presets_j
from chronoedit_tpu_torch.configs import presets as presets_t
from chronoedit_tpu_torch.scripts import check_environment, run_inference

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("extra", [
    [],
    ["--cache-blocks", "0:1", "--guidance-scale", "2.0"],
    ["--cache-blocks", "0:1", "--cache-thresh", "0.3", "--quantize", "int8"],
    ["--enable-temporal-reasoning", "--num-temporal-reasoning-steps", "2"],
])
def test_run_inference_smoke(tmp_path, extra):
    out = tmp_path / "edit.png"
    run_inference.main(["--smoke", "--device", "cpu", "--output", str(out), *extra])
    from PIL import Image

    assert Image.open(out).size == (32, 32)
    if "--enable-temporal-reasoning" in extra:
        assert list(tmp_path.glob("edit.*")) != [out]  # the trajectory video too


def test_run_inference_refusals(tmp_path):
    base = ["--smoke", "--device", "cpu", "--output", str(tmp_path / "x.png")]
    with pytest.raises(SystemExit, match="mesh"):
        run_inference.main([*base, "--mesh", "tensor=2"])
    with pytest.raises(SystemExit, match="cache-blocks"):
        run_inference.main([*base, "--cache-thresh", "0.1"])
    with pytest.raises(SystemExit, match="checkpoint-dir"):
        run_inference.main(["--device", "cpu"])


def test_build_pipeline_flags():
    args = run_inference.parse_args(["--smoke", "--device", "cpu", "--cache-blocks", "0:2:3",
                                     "--cache-thresh", "0.5"])
    pipe = run_inference.build_pipeline(args)
    cfg = pipe.config
    assert (cfg.cache_blocks, cfg.cache_period, cfg.cache_thresh) == ((0, 2), 3, 0.5)
    assert pipe.device == torch.device("cpu") and pipe.guardrails is None
    assert cfg.dit.num_layers == presets_t.chronoedit_tiny().dit.num_layers


@pytest.mark.parametrize("size,target", [((70, 50), (None, None)), ((1400, 900), (None, None)),
                                         ((64, 48), (32, 48))])
def test_image_preprocessing_is_jax(size, target):
    """``ImageCropAndResize`` + ``ToArray`` (the CLI's ``--input``) give
    JAX's array bit for bit: both are the same PIL and numpy steps."""
    from PIL import Image

    from chronoedit_tpu.data import edit_dataset as data_j
    from chronoedit_tpu_torch.data import edit_dataset as data_t

    rgb = np.random.default_rng(0).integers(0, 256, (*size[::-1], 3), dtype=np.uint8)
    img = Image.fromarray(rgb)
    got = data_t.ToArray()(data_t.ImageCropAndResize(*target, max_pixels=1280 * 720)(img))
    want = data_j.ToArray()(data_j.ImageCropAndResize(*target, max_pixels=1280 * 720)(img))
    assert got.dtype == np.float32 and got.shape[0] == 3 and got.shape[1] % 16 == 0
    np.testing.assert_array_equal(got, want)


def test_run_inference_from_an_image_file(tmp_path):
    """``--input``: the image is read, cropped to a multiple of 16 and
    edited at that size."""
    from PIL import Image

    src = tmp_path / "in.png"
    Image.fromarray(np.random.default_rng(1).integers(0, 256, (40, 56, 3), dtype=np.uint8)
                    ).save(src)
    out = tmp_path / "edit.png"
    run_inference.main(["--smoke", "--device", "cpu", "--input", str(src), "--output", str(out)])
    assert Image.open(out).size == (48, 32)


def test_check_environment_on_the_cpu(capsys):
    assert check_environment.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[FAIL]" not in out and "tiny DiT forward" in out


def test_serve_smoke_answers_over_http():
    """``python -m chronoedit_tpu_torch.scripts.serve --smoke --device cpu``
    on a free port: /healthz and one /edit answer, then it is stopped."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "chronoedit_tpu_torch.scripts.serve", "--smoke", "--device",
         "cpu", "--port", "0", "--warmup", "16x16", "--max-wait-ms", "5"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = ""
        while "listening on" not in line:
            line = proc.stdout.readline()
            assert line, "the server exited before listening"
        port = int(line.split(":")[1].split()[0])
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert b'"device": "cpu"' in r.read()
        buf = io.BytesIO()
        np.savez(buf, image=np.zeros((3, 16, 16), np.float32),
                 prompt_emb=np.zeros((6, presets_t.chronoedit_tiny().dit.text_dim), np.float32))
        req = urllib.request.Request(f"http://127.0.0.1:{port}/edit?seed=3",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            with np.load(io.BytesIO(r.read())) as z:
                assert z["edit"].shape == (3, 16, 16) and np.isfinite(z["edit"]).all()
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def _numbers(cfg):
    """The config's fields without dtypes (jnp against torch)."""
    def plain(obj):
        if dataclasses.is_dataclass(obj):
            return {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)
                    if "dtype" not in f.name}
        return obj
    return plain(cfg)


@pytest.mark.parametrize("name", sorted(presets_j.EXPERIMENTS))
def test_experiments_are_jax(name):
    assert sorted(presets_t.EXPERIMENTS) == sorted(presets_j.EXPERIMENTS)
    got, want = _numbers(presets_t.get_experiment(name)), _numbers(presets_j.get_experiment(name))
    got["dit"].pop("rope"), want["dit"].pop("rope")
    # the port's fields are a subset of JAX's (the mesh options are not ported)
    assert set(got) == set(want) and set(got["dit"]) <= set(want["dit"])
    want["dit"] = {k: want["dit"][k] for k in got["dit"]}
    want["vae"] = {k: want["vae"][k] for k in got["vae"]}
    assert got == want


def test_get_experiment_errors_and_remat():
    with pytest.raises(KeyError, match="unknown experiment"):
        presets_t.get_experiment("nope")
    assert presets_t.get_experiment("chronoedit_14b", remat="full").dit.remat == "full"
    assert presets_t.chronoedit_14b_distilled(remat="full").dit.remat == "full"
    assert presets_t.chronoedit_14b().dit.remat == presets_j.chronoedit_14b().dit.remat


def test_prompt_embeddings_from_ids_or_text(tmp_path):
    """With a text encoder, the prompt comes from its token ids and the
    negative from its text (JAX encodes even an empty one); without a
    prompt, both are seeded random embeddings."""
    ids = np.array([5, 7, 9], np.int32)
    np.save(tmp_path / "ids.npy", ids)

    class Encoding:
        text_encoder, device, config, calls = object(), torch.device("cpu"), \
            presets_t.chronoedit_tiny(), []

        def encode_prompt(self, prompt):
            self.calls.append(prompt)
            return torch.zeros(1)

    pipe = Encoding()
    args = run_inference.parse_args(["--prompt-ids", str(tmp_path / "ids.npy"),
                                     "--negative-prompt", "blurry"])
    run_inference.prompt_embeddings(pipe, args)
    assert torch.equal(pipe.calls[0], torch.tensor([[5, 7, 9]])) and pipe.calls[1] == "blurry"
    a, b = run_inference.prompt_embeddings(pipe, run_inference.parse_args([]))
    assert len(pipe.calls) == 2 and a.shape == b.shape == (1, 8, 16) and not torch.equal(a, b)
    torch.testing.assert_close(a, run_inference.prompt_embeddings(
        pipe, run_inference.parse_args([]))[0], rtol=0, atol=0)
