"""The port's item dataset and training-time render against the JAX
package's ``data/item_dataset.py``.

``write_item_dataset`` / ``PromptItemDataset`` are copies: the same items
read back bitwise. ``make_sample_fn`` renders the item at the tiny preset
through the edit pipeline under given (EMA) DiT parameters: against JAX's
on the same weights (``models/from_jax.py``), item, negative prompt and
``latents=`` noise, fp32, at the pipeline tests' bound (PSNR over the
[-1, 1] range at least 60 dB, far above the 35 dB bar). The trained
parameters must come back bitwise after each render, also when it raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.configs import chronoedit_tiny as tiny_j
from chronoedit_tpu.data import item_dataset as item_j
from chronoedit_tpu.models import dit as dit_j
from chronoedit_tpu.models import vae as vae_j
from chronoedit_tpu.pipeline.edit_pipeline import ChronoEditPipeline as PipeJ
from chronoedit_tpu_torch.configs import chronoedit_tiny as tiny_t
from chronoedit_tpu_torch.data import item_dataset as item_t
from chronoedit_tpu_torch.models import dit as dit_t
from chronoedit_tpu_torch.models import vae as vae_t
from chronoedit_tpu_torch.models.from_jax import load_dit, load_vae
from chronoedit_tpu_torch.pipeline.edit_pipeline import ChronoEditPipeline as PipeT
from test_torch_dit import randomize

torch.set_num_threads(2)

MIN_PSNR_DB = 60.0
H = W = 16
T5_LEN = 8


def psnr(got: np.ndarray, want: np.ndarray) -> float:
    mse = float(np.mean((got.astype(np.float64) - want) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(2.0 ** 2 / mse)


def _items(n: int, d: int, seed: int = 0, with_image: bool = True) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        item = {"prompt": f"edit instruction {i}",
                "t5_text_embeddings": rng.standard_normal((5 + i, d)).astype(np.float32),
                "extra": {"tag": i}}
        if with_image:
            item["image"] = rng.uniform(-1, 1, (3, H, W)).astype(np.float32)
        out.append(item)
    return out


def test_item_dataset_matches_jax(tmp_path):
    """Each side reads the other's files: padding, mask, ``__idx__``, extra
    keys and the range checks agree bitwise."""
    items = _items(4, 16)
    item_t.write_item_dataset(str(tmp_path / "t"), items)
    item_j.write_item_dataset(str(tmp_path / "j"), items)
    for root in ("t", "j"):
        for start, end, max_len in ((0, None, 12), (1, 3, 6)):
            dj = item_j.PromptItemDataset(str(tmp_path / root), start, end, max_len)
            dt = item_t.PromptItemDataset(str(tmp_path / root), start, end, max_len)
            assert len(dt) == len(dj)
            for i in range(len(dt)):
                a, b = dt[i], dj[i]
                assert a.keys() == b.keys()
                for k in a:
                    if isinstance(a[k], np.ndarray):
                        assert a[k].dtype == b[k].dtype
                        np.testing.assert_array_equal(a[k], b[k])
                    else:
                        assert a[k] == b[k]
        with pytest.raises(ValueError):
            item_t.PromptItemDataset(str(tmp_path / root), end_index=99)
    it = item_t.PromptItemDataset(str(tmp_path / "t"), max_t5_length=12)[1]
    assert it["t5_text_embeddings"].shape == (12, 16) and it["t5_text_mask"].sum() == 6


@pytest.fixture(scope="module")
def render(tmp_path_factory):
    """Both tiny pipelines on the same weights, a second (EMA) weight set,
    a one-item dataset and the item's noise and negative prompt."""
    cfg_j, cfg_t = tiny_j(), tiny_t()
    dit_p = randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg_j.dit), 5)
    ema_p = randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg_j.dit), 9)
    vae_p = randomize(lambda: vae_j.init_vae_params(jax.random.PRNGKey(1), cfg_j.vae), 6,
                      fan_in=lambda s: int(np.prod(s[:-1])))
    pipe_j = PipeJ(cfg_j, dit_p, vae_p)
    pipe_t = PipeT(cfg_t, load_dit(dit_t.DiT(cfg_t.dit), dit_p),
                   load_vae(vae_t.VAE(cfg_t.vae), vae_p))
    ema_t = [p.detach().clone() for p in load_dit(dit_t.DiT(cfg_t.dit), ema_p).parameters()]
    root = tmp_path_factory.mktemp("torch_items")
    item_t.write_item_dataset(str(root), _items(2, cfg_t.dit.text_dim, seed=3))
    rng = np.random.default_rng(7)
    tl = cfg_t.vae.latent_frames(cfg_t.num_frames)
    sf = cfg_t.vae.spatial_factor
    latents = rng.standard_normal((1, cfg_t.vae.z_dim, tl, H // sf, W // sf)).astype(np.float32)
    neg = rng.standard_normal((1, T5_LEN, cfg_t.dit.text_dim)).astype(np.float32)
    return dict(pipe_j=pipe_j, pipe_t=pipe_t, dit_p=dit_p, ema_p=ema_p, ema_t=ema_t,
                root=str(root), latents=latents, neg=neg)


@pytest.mark.parametrize("item_index,guidance,ema", [(0, 1.0, True), (1, 3.0, True),
                                                     (1, 3.0, False)])
def test_sample_fn_matches_jax(render, item_index, guidance, ema):
    """The render under the EMA weights (or the pipeline's own, params
    None), with classifier-free guidance at 3.0: JAX's frame at the bound;
    the pipeline's parameters bitwise and in their own storage after."""
    r = render
    ds_j = item_j.PromptItemDataset(r["root"], max_t5_length=T5_LEN)
    ds_t = item_t.PromptItemDataset(r["root"], max_t5_length=T5_LEN)
    fn_j = item_j.make_sample_fn(r["pipe_j"], ds_j, item_index, num_steps=2,
                                 latents=jnp.asarray(r["latents"]),
                                 neg_prompt_emb=jnp.asarray(r["neg"]))
    fn_t = item_t.make_sample_fn(r["pipe_t"], ds_t, item_index, num_steps=2,
                                 latents=torch.from_numpy(r["latents"]),
                                 neg_prompt_emb=torch.from_numpy(r["neg"]))
    own = list(r["pipe_t"].dit.parameters())
    before = [(p.data_ptr(), p.detach().clone()) for p in own]
    want = fn_j(r["ema_p"] if ema else None, guidance)
    got = fn_t(r["ema_t"] if ema else None, guidance)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == np.asarray(want).shape == (3, 5, H, W)
    assert psnr(got, np.asarray(want)) >= MIN_PSNR_DB
    for p, (ptr, value) in zip(own, before):
        assert p.data_ptr() == ptr
        torch.testing.assert_close(p.detach(), value, rtol=0, atol=0)
    if ema:  # the EMA render is not the trained weights' render
        other = fn_t(None, guidance)
        assert psnr(got, other) < MIN_PSNR_DB


def test_sample_fn_restores_after_a_raise(render, monkeypatch):
    """A render that raises after the DiT ran under the EMA weights (a
    failing decode) leaves the trained parameters in place, bitwise."""
    r = render
    pipe = r["pipe_t"]
    ds = item_t.PromptItemDataset(r["root"], max_t5_length=T5_LEN)
    fn = item_t.make_sample_fn(pipe, ds, 0, num_steps=1)
    own = list(pipe.dit.parameters())
    before = [(p.data_ptr(), p.detach().clone()) for p in own]
    seen = []

    def failing_decode(*a, **k):
        seen.append(all(torch.equal(p, e) for p, e in zip(pipe.dit.parameters(), r["ema_t"])))
        raise RuntimeError("decode failed")

    monkeypatch.setattr(pipe, "decode", failing_decode)
    with pytest.raises(RuntimeError, match="decode failed"):
        fn(r["ema_t"], 1.0)
    assert seen == [True]  # the DiT held the EMA weights during the render
    for p, (ptr, value) in zip(own, before):
        assert p.data_ptr() == ptr
        torch.testing.assert_close(p.detach(), value, rtol=0, atol=0)
    with pytest.raises(ValueError, match="tensors for"):
        fn(r["ema_t"][:-1], 1.0)


def test_sample_fn_noise_rule_and_callback(render, tmp_path):
    """Without ``latents`` the noise comes from a generator on the
    pipeline's device seeded with the item's ``__idx__``: two renders of
    one item are bitwise alike, and the same as the pipeline called with
    that generator. ``EveryNDrawSample`` draws it under a train state's
    EMA and writes each guidance's image; an item without an image
    raises."""
    from chronoedit_tpu_torch.train.callbacks import EveryNDrawSample

    r = render
    pipe = r["pipe_t"]
    ds = item_t.PromptItemDataset(r["root"], start_index=1, max_t5_length=T5_LEN)
    fn = item_t.make_sample_fn(pipe, ds, 0, num_steps=2)
    a, b = fn(None, 1.0), fn(None, 1.0)
    np.testing.assert_array_equal(a, b)
    item = ds[0]
    want = pipe(torch.from_numpy(item["image"])[None],
                torch.from_numpy(item["t5_text_embeddings"])[None], num_steps=2,
                guidance_scale=1.0, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(a, want[0].numpy())

    class State:
        params = list(pipe.dit.parameters())
        ema_params = r["ema_t"]

    class Trainer:
        _last_state = State()

    cb = EveryNDrawSample(every_n=2, sample_fn=fn, out_dir=str(tmp_path),
                          guidance_sweep=(1.0, 2.0))
    cb.on_step_end(Trainer(), 1, {})
    assert not list(tmp_path.iterdir())
    cb.on_step_end(Trainer(), 2, {})
    assert len(list(tmp_path.iterdir())) == 2

    no_image = tmp_path / "no_image"
    item_t.write_item_dataset(str(no_image), _items(1, 16, with_image=False))
    with pytest.raises(ValueError, match="no 'image'"):
        item_t.make_sample_fn(pipe, item_t.PromptItemDataset(str(no_image)))
