"""The port's last CLIs and the prompt enhancer against the JAX package's.

- ``scripts/extract_umt5.py`` on a tiny random UMT5 checkpoint: from a
  column of token ids, and from text through a (stub) local tokenizer, its
  pickles against JAX's script's (its encoder given the same tokenizer) at
  the encoder bound of ``test_torch_encoders.py`` (60 dB over the
  reference's peak, fp32), and ``metadata.csv`` rewritten byte for byte as
  JAX's script rewrites it.
- ``aux/prompt_enhancer.py`` and ``scripts/{prompt_enhancer,data_captioning}.py``
  with a stub processor and model in place of Qwen-VL (a download), as
  ``tests/test_aux_utils.py`` stubs Qwen3Guard: the same text and the same
  CSV as JAX's scripts given the same stub; the enhancer's default device
  is the card.
- ``scripts/gradio_paintbrush.py``'s ``run_edit`` at the tiny preset
  against JAX's ``edit_image`` on JAX's ``ImageCropAndResize`` /
  ``ToArray`` crop of the same composite, embeddings and noise: the
  pipeline tests' bound (PSNR over the [-1, 1] range at least 60 dB).
  Without gradio, ``main`` exits with JAX's message.
"""

import csv
import importlib.util
import pickle
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.data import edit_dataset as data_j
from chronoedit_tpu.models import umt5 as umt5_j
from chronoedit_tpu_torch.scripts import data_captioning as captioning_t
from chronoedit_tpu_torch.scripts import extract_umt5 as extract_t
from chronoedit_tpu_torch.scripts import gradio_paintbrush as paintbrush_t
from chronoedit_tpu_torch.scripts import prompt_enhancer as enhancer_t
from test_torch_dit import randomize
from test_torch_encoders import T5_KW, encoder_pipelines, peak_db, umt5_reference_sd  # noqa: F401

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
MIN_DB = 60.0
TEXT_LEN = 512  # the port's UMT5 text length, read by both sides here


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_scripts_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class StubTokenizer:
    """A tokenizer whose "text" is the token ids written out ("5 17 3"):
    truncated and padded with 0 to ``max_length`` under a mask of ones,
    as the UMT5 tokenizer pads; numpy or torch as asked."""

    def __call__(self, texts, padding=None, truncation=None, max_length=None,
                 return_tensors=None, add_special_tokens=None):
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            row = [int(t) for t in text.split()][:max_length]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        if return_tensors == "pt":
            return {"input_ids": torch.from_numpy(ids), "attention_mask": torch.from_numpy(mask)}
        return {"input_ids": ids, "attention_mask": mask}


# ------------------------------------------------------------- extract_umt5

@pytest.fixture(scope="module")
def umt5_data(tmp_path_factory):
    """A tiny UMT5 in the reference file's layout (fp32 .pth), and a
    metadata directory of three rows whose prompts are token ids, as text
    and as ``.npy`` files (one longer than the text length)."""
    cfg_j = umt5_j.UMT5Config(**{**T5_KW, "text_len": TEXT_LEN}, dtype=jnp.float32)
    params = randomize(lambda: umt5_j.init_umt5_params(jax.random.PRNGKey(0), cfg_j), 21)
    root = tmp_path_factory.mktemp("torch_umt5")
    ckpt = root / "models_t5_umt5-xxl-enc-bf16.pth"
    torch.save({k: torch.from_numpy(v) for k, v in umt5_reference_sd(params, cfg_j).items()},
               ckpt)
    rng = np.random.default_rng(22)
    meta = root / "data"
    meta.mkdir()
    rows = []
    for i, n in enumerate((7, 300, 600)):
        ids = rng.integers(1, cfg_j.vocab_size, (n,))
        np.save(meta / f"ids{i}.npy", ids)
        rows.append({"image": f"img{i}.png", "prompt": " ".join(map(str, ids)),
                     "prompt_ids": f"ids{i}.npy"})
    with open(meta / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["image", "prompt", "prompt_ids"])
        w.writeheader()
        w.writerows(rows)
    return cfg_j, params, ckpt, meta


def _run_jax_extract(monkeypatch, cfg_j, ckpt, meta_dir):
    """JAX's script as a user runs it, its encoder built at the tiny
    config with the stub tokenizer (JAX's reads only the XXL layout and
    tokenizes with a download)."""
    import chronoedit_tpu.models.umt5 as mod

    script = _jax_script("extract_umt5")
    convert, encoder = mod.convert_umt5_checkpoint, mod.UMT5TextEncoder
    with monkeypatch.context() as m:
        m.setattr(mod, "convert_umt5_checkpoint",
                  lambda sd: convert(sd, num_layers=cfg_j.num_layers))
        m.setattr(mod, "UMT5TextEncoder",
                  lambda params: encoder(params, cfg_j, StubTokenizer()))
        m.chdir(meta_dir)
        m.setattr(sys, "argv", ["extract_umt5.py", "--metadata", "metadata.csv",
                                "--t5-checkpoint", str(ckpt), "--output-dir", "umt5"])
        script.main()


@pytest.mark.parametrize("source", ["ids", "tokenizer"])
def test_extract_umt5_matches_jax(umt5_data, tmp_path, monkeypatch, source):
    cfg_j, params, ckpt, meta = umt5_data
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(meta, jdir)
    shutil.copytree(meta, tdir)
    _run_jax_extract(monkeypatch, cfg_j, ckpt, jdir)

    flags = (["--ids-column", "prompt_ids"] if source == "ids"
             else ["--tokenizer", str(tmp_path / "tokenizer")])
    with monkeypatch.context() as m:
        import transformers

        m.setattr(transformers.AutoTokenizer, "from_pretrained",
                  lambda path: StubTokenizer() if path == str(tmp_path / "tokenizer") else None)
        m.chdir(tdir)
        outs = extract_t.main(["--metadata", "metadata.csv", "--t5-checkpoint", str(ckpt),
                               "--output-dir", "umt5", "--device", "cpu"] + flags)
    assert outs == [f"umt5/{i:08d}.pkl" for i in range(3)]
    assert (tdir / "metadata.csv").read_bytes() == (jdir / "metadata.csv").read_bytes()
    encoder = umt5_j.UMT5TextEncoder(params, cfg_j)
    for i, out in enumerate(outs):
        got = pickle.load(open(tdir / out, "rb"))
        want = pickle.load(open(jdir / out, "rb"))
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (TEXT_LEN, cfg_j.dim)
        assert peak_db(got, want) >= MIN_DB
        ids = np.load(meta / f"ids{i}.npy")[:TEXT_LEN]
        np.testing.assert_array_equal(got[len(ids):], 0.0)
        # the padded ids straight through JAX's encode_ids
        pid, mask = extract_t.padded_ids(ids, TEXT_LEN)
        direct = np.asarray(encoder.encode_ids(jnp.asarray(pid.numpy()),
                                               jnp.asarray(mask.numpy())))[0]
        assert peak_db(got, direct) >= MIN_DB


def test_extract_umt5_reads_the_checkpoint_shapes(umt5_data, tmp_path):
    """The config comes from the file: the tiny shapes and its fp32, or the
    XXL defaults' shapes for a bf16 file of those shapes (the loader's
    encoder config); the checkpoint directory form finds ``T5_FILE``."""
    from chronoedit_tpu_torch.models.umt5 import UMT5Config

    cfg_j, _, ckpt, meta = umt5_data
    sd = torch.load(ckpt)
    cfg = extract_t.umt5_config(sd)
    want = UMT5Config(**{**T5_KW, "text_len": TEXT_LEN}, dtype=torch.float32,
                      param_dtype=torch.float32)
    assert cfg == want
    xxl = {k: torch.empty(s, dtype=torch.bfloat16, device="meta") for k, s in (
        ("token_embedding.weight", (256_384, 4096)), ("blocks.0.attn.q.weight", (4096, 4096)),
        ("blocks.0.ffn.fc1.weight", (10_240, 4096)),
        ("blocks.0.pos_embedding.embedding.weight", (32, 64)))}
    xxl.update({f"blocks.{i}.norm1.weight": torch.empty(4096, device="meta") for i in range(24)})
    assert extract_t.umt5_config(xxl) == UMT5Config()
    shutil.copytree(meta, tmp_path / "d")
    outs = extract_t.main(["--metadata", str(tmp_path / "d" / "metadata.csv"),
                           "--checkpoint-dir", str(ckpt.parent), "--ids-column", "prompt_ids",
                           "--output-dir", str(tmp_path / "out"), "--device", "cpu"])
    assert len(outs) == 3 and all(Path(o).exists() for o in outs)
    with pytest.raises(SystemExit):  # a text source is required
        extract_t.main(["--metadata", "m.csv", "--t5-checkpoint", str(ckpt)])


# ------------------------------------------------------------- Qwen-VL stubs

class StubInputs(dict):
    def to(self, device):
        assert torch.device(device) == torch.device("cpu")
        return self


class StubProcessor:
    """Chat template -> one token naming the call; decode -> a reply that
    spells out the instruction and the image it was given."""

    def __init__(self):
        self.calls = []

    def apply_chat_template(self, messages, add_generation_prompt, tokenize, return_dict,
                            return_tensors):
        assert messages[0]["role"] == "system" and add_generation_prompt and tokenize
        content = messages[1]["content"]
        image = next((c["image"] for c in content if c["type"] == "image"), None)
        self.calls.append((content[-1]["text"], None if image is None else image.size))
        return StubInputs(input_ids=torch.tensor([[len(self.calls) - 1, 0, 0]]))

    def batch_decode(self, ids, skip_special_tokens):
        text, size = self.calls[int(ids[0, 0]) - 1000]
        return [f"  expanded<{text[-40:]}|{size}>  "]


class StubModel:
    def to(self, device):
        return self

    def generate(self, input_ids, max_new_tokens):
        return torch.cat([input_ids, input_ids[:, :1] + 1000], dim=1)


@pytest.fixture
def qwen_stub(monkeypatch):
    import transformers

    monkeypatch.setattr(transformers.AutoProcessor, "from_pretrained",
                        lambda path: StubProcessor())
    monkeypatch.setattr(transformers.AutoModelForImageTextToText, "from_pretrained",
                        lambda path: StubModel())


def test_prompt_enhancer_cli_matches_jax(qwen_stub, tmp_path, monkeypatch, capsys):
    from PIL import Image

    Image.fromarray(np.full((24, 40, 3), 90, np.uint8)).save(tmp_path / "in.png")
    for image in ([], ["--image", str(tmp_path / "in.png")]):
        argv = ["--prompt", "make the car red", "--model", "local-qwen"] + image
        monkeypatch.setattr(sys, "argv", ["prompt_enhancer.py"] + argv)
        _jax_script("prompt_enhancer").main()
        want = capsys.readouterr().out
        got = enhancer_t.main(argv + ["--device", "cpu"])
        assert capsys.readouterr().out == want == got + "\n"
        assert got == f"expanded<make the car red|{(40, 24) if image else None}>"


def test_prompt_enhancer_default_device_is_the_card(monkeypatch):
    """JAX's enhancer defaults to the CPU, the port's to the card: with no
    card, asking for nothing raises, asking for the CPU works."""
    from chronoedit_tpu_torch.aux.prompt_enhancer import PromptEnhancer, PromptEnhancerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PromptEnhancer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        enhancer_t.main(["--prompt", "x"])
    assert PromptEnhancer(PromptEnhancerConfig(device="cpu")).device == torch.device("cpu")


def test_data_captioning_matches_jax(qwen_stub, tmp_path, monkeypatch):
    """The two-stage caption, then expand, written into ``--out-column``:
    the port's metadata file byte for byte JAX's."""
    from PIL import Image

    rng = np.random.default_rng(5)
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        rows = []
        for i in range(3):
            for name in ("image", "edit_image"):
                Image.fromarray(rng.integers(0, 256, (16 + 8 * i, 24, 3), dtype=np.uint8)).save(
                    d / f"{name}{i}.png")
            rows.append(f"image{i}.png,edit_image{i}.png,old {i}")
        (d / "metadata.csv").write_text("image,edit_image,prompt\n" + "\n".join(rows) + "\n")
    monkeypatch.setattr(sys, "argv", ["data_captioning.py", "--metadata",
                                      str(tmp_path / "jax" / "metadata.csv"), "--out-column",
                                      "cot"])
    _jax_script("data_captioning").main()
    captioning_t.main(["--metadata", str(tmp_path / "port" / "metadata.csv"), "--out-column",
                       "cot", "--device", "cpu"])
    got = (tmp_path / "port" / "metadata.csv").read_bytes()
    assert got == (tmp_path / "jax" / "metadata.csv").read_bytes()
    rows = list(csv.DictReader(open(tmp_path / "port" / "metadata.csv")))
    assert [r["prompt"] for r in rows] == ["old 0", "old 1", "old 2"]
    # stage 2's reply ends with stage 1's, each on the row's source image
    assert rows[2]["cot"].startswith("expanded<") and rows[2]["cot"].endswith(
        "|(24, 32)>|(24, 32)>")


# ------------------------------------------------------------- paintbrush

def _editor_value(seed: int):
    """A seeded 40x24 background and a composite with a painted square."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    background = rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)
    composite = background.copy()
    composite[4:14, 10:22] = (250, 20, 20)
    return {"background": Image.fromarray(background), "composite": Image.fromarray(composite),
            "layers": []}


@pytest.mark.parametrize("guidance", [1.0, 2.5])
def test_paintbrush_edit_matches_jax(encoder_pipelines, guidance):  # noqa: F811
    pipe_j, pipe_t = encoder_pipelines
    pipe_j.text_encoder._tokenizer = pipe_t.text_encoder._tokenizer = StubTokenizer()
    value = _editor_value(6)
    prompt = "3 14 15 92 65"
    image_j = jnp.asarray(data_j.ToArray()(data_j.ImageCropAndResize(
        None, None, max_pixels=1280 * 720)(value["composite"].convert("RGB"))))[None]
    assert image_j.shape == (1, 3, 16, 32)
    cfg = pipe_t.config
    sf = cfg.vae.spatial_factor
    latents = np.random.default_rng(8).standard_normal(
        (1, cfg.vae.z_dim, cfg.vae.latent_frames(cfg.num_frames), 16 // sf, 32 // sf)
    ).astype(np.float32)
    want = np.asarray(pipe_j.edit_image(
        image_j, pipe_j.encode_prompt(prompt), neg_prompt_emb=pipe_j.encode_prompt(""),
        image_emb=pipe_j.encode_image(image_j), num_steps=2, guidance_scale=guidance,
        prompt=prompt, latents=jnp.asarray(latents)))
    got = paintbrush_t.run_edit(pipe_t, value, prompt, 2, guidance,
                                latents=torch.from_numpy(latents))
    assert got.shape == want.shape == (1, 3, 16, 32)
    mse = float(np.mean((got.numpy().astype(np.float64) - want) ** 2))
    assert 10.0 * np.log10(2.0 ** 2 / mse) >= MIN_DB


def test_paintbrush_token_ids_and_seed(encoder_pipelines):  # noqa: F811
    """Token ids in place of text, and the seed's generator in place of
    ``latents``: bitwise ``edit_image`` on the crop, those embeddings and a
    generator of that seed."""
    _, pipe = encoder_pipelines
    value = _editor_value(9)
    ids = torch.from_numpy(np.random.default_rng(10).integers(1, T5_KW["vocab_size"], (1, 9)))
    neg = torch.zeros((1, 1), dtype=torch.long)
    got = paintbrush_t.run_edit(pipe, value, ids, 1, 1.0, seed=4, negative_prompt=neg)
    image = paintbrush_t.composite_image(value, torch.device("cpu"))
    want = pipe.edit_image(image, pipe.encode_prompt(ids), neg_prompt_emb=pipe.encode_prompt(neg),
                           image_emb=pipe.encode_image(image), num_steps=1,
                           guidance_scale=1.0, generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_paintbrush_without_gradio(monkeypatch):
    """gradio is not installed here: the port's ``main`` and ``build_app``
    exit with JAX's message before loading anything."""
    monkeypatch.setitem(sys.modules, "gradio", None)  # absent, wherever it is installed
    monkeypatch.setattr(sys, "argv", ["gradio_paintbrush.py", "--checkpoint-dir", "nowhere"])
    with pytest.raises(SystemExit) as want:
        _jax_script("gradio_paintbrush").main()
    with pytest.raises(SystemExit) as got:
        paintbrush_t.main(["--checkpoint-dir", "nowhere"])
    assert str(got.value) == str(want.value) == paintbrush_t.GRADIO_MISSING
    with pytest.raises(SystemExit, match="gradio is not installed"):
        paintbrush_t.build_app(None)
