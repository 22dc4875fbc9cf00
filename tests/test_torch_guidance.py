"""Guidance forms of the edit pipeline against the JAX pipeline: batched
CFG (cond and uncond in one forward of 2B), sequential CFG (two forwards)
and skip-layer guidance (the unconditional forward skips the listed
blocks, which forces the sequential form).

The tiny preset, the same weights through ``models/from_jax.py``, the same
image, embeddings and initial latents, fp32 on both sides, guidance 2.0
with a negative prompt. The bar is the edit test's: PSNR over the [-1, 1]
pixel range of at least 60 dB (fp32 op-order differences through 4 solver
steps leave ~1e-6 errors).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.pipeline.edit_pipeline import ChronoEditPipeline as PipeJ
from chronoedit_tpu_torch.models import dit as dit_t
from chronoedit_tpu_torch.pipeline.edit_pipeline import ChronoEditPipeline as PipeT
from test_torch_pipeline import _inputs, pipelines, psnr  # noqa: F401 (fixture)

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MIN_PSNR_DB = 60.0
# batched against sequential CFG inside the port: the same fp32 arithmetic
# per sample, only the batch's GEMM shapes differ (the JAX test's bound)
BATCHED_TOL = 1e-4

FORMS = {"batched": (True, ()), "sequential": (False, ()), "slg": (False, (1,))}


def _pair(pipes, batched):
    """(JAX, port) pipelines on the shared weights with ``cfg_batched``."""
    pipe_j, pipe_t = pipes
    return (PipeJ(dataclasses.replace(pipe_j.config, cfg_batched=batched),
                  pipe_j.dit_params, pipe_j.vae_params),
            PipeT(dataclasses.replace(pipe_t.config, cfg_batched=batched),
                  pipe_t.dit, pipe_t.vae))


@pytest.mark.parametrize("form", list(FORMS))
def test_guidance_form_matches_jax(pipelines, form):
    batched, slg = FORMS[form]
    pipe_j, pipe_t = _pair(pipelines, batched)
    inp = _inputs(pipe_t.config)
    want = np.asarray(pipe_j(**{k: jnp.asarray(v) for k, v in inp.items()},
                             guidance_scale=2.0, slg_layers=slg))
    got = pipe_t(**{k: torch.from_numpy(v) for k, v in inp.items()},
                 guidance_scale=2.0, slg_layers=slg).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert psnr(got, want) >= MIN_PSNR_DB


def test_batched_equals_sequential(pipelines):
    """One 2B forward and two B forwards give the same latents (JAX's
    ``tests/test_pipeline.py`` check, on the port)."""
    inp = {k: torch.from_numpy(v) for k, v in _inputs(pipelines[1].config).items()}
    lat = [_pair(pipelines, batched)[1](**inp, guidance_scale=2.0, output_type="latent")
           for batched in (True, False)]
    torch.testing.assert_close(lat[0], lat[1], rtol=BATCHED_TOL, atol=BATCHED_TOL)


def test_slg_changes_only_the_uncond(pipelines, monkeypatch):
    """The layer mask reaches only the forward with the negative prompt, as a
    host sequence; it changes the result; with guidance 1.0 there is no
    unconditional forward and ``slg_layers`` changes nothing (bitwise)."""
    pipe_t = _pair(pipelines, False)[1]
    inp = {k: torch.from_numpy(v) for k, v in _inputs(pipe_t.config).items()}
    calls, neg = [], inp["neg_prompt_emb"]
    forward = dit_t.dit_forward

    def recording(model, x, ts, text, img, layer_mask=None, **kw):
        calls.append((text is neg, layer_mask))
        return forward(model, x, ts, text, img, layer_mask=layer_mask, **kw)

    monkeypatch.setattr(dit_t, "dit_forward", recording)
    base = pipe_t(**inp, guidance_scale=2.0, output_type="latent")
    calls.clear()
    slg = pipe_t(**inp, guidance_scale=2.0, slg_layers=(1,), output_type="latent")
    steps = pipe_t.config.num_steps
    assert calls == [(False, None), (True, [1.0, 0.0])] * steps
    assert float((base - slg).abs().max()) > 1e-6

    del inp["neg_prompt_emb"]
    a = pipe_t(**inp, guidance_scale=1.0, output_type="latent")
    b = pipe_t(**inp, neg_prompt_emb=neg, guidance_scale=1.0, slg_layers=(1,),
               output_type="latent")
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_dit_reads_a_tensor_mask_once(pipelines):
    """A mask given as a tensor is read to the host once: the same output as
    the host list."""
    pipe_t = pipelines[1]
    cfg = pipe_t.config.dit
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, cfg.in_channels, 2, 4, 4)).astype(np.float32))
    ts = torch.tensor([500.0])
    text = torch.from_numpy(rng.standard_normal((1, 6, cfg.text_dim)).astype(np.float32))
    with torch.inference_mode():
        a = dit_t.dit_forward(pipe_t.dit, x, ts, text, layer_mask=[1.0, 0.0])
        b = dit_t.dit_forward(pipe_t.dit, x, ts, text, layer_mask=torch.tensor([1.0, 0.0]))
        c = dit_t.dit_forward(pipe_t.dit, x, ts, text)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float((a - c).abs().max()) > 1e-6
