"""The rank bodies of the pipeline-parallel tests
(``test_torch_pipeline_parallel.py``).

``parallel.launch.run_world`` starts each world with the ``spawn`` method,
so every rank imports this module afresh: it imports torch, numpy and the
port only, never jax or the JAX package. Each function runs on one rank of
a gloo world on the CPU and returns numpy arrays or plain values; the JAX
side of each comparison runs in the test's own process.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from chronoedit_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from chronoedit_tpu_torch.parallel.pipeline_parallel import gpipe_scan, stage_range
from test_torch_cp_workers import count_context_attention

CPU = torch.device("cpu")


def _mesh(config: dict):
    return make_mesh(MeshConfig(**config), device=CPU)


def run_jobs(rank: int, jobs: list[tuple[str, tuple]]) -> list:
    """Each job, (the name of a function here, its arguments after the
    rank), in turn on this rank; their results in order."""
    return [globals()[name](rank, *args) for name, args in jobs]


def mesh_layouts(rank: int, configs: list[dict]) -> list[dict]:
    """This rank's coordinates and the ranks of its groups in a mesh of
    each config, made one after another in the same world."""
    import torch.distributed as dist

    out = []
    for config in configs:
        mesh = _mesh(config)
        out.append({"coords": mesh.coords, "groups": {
            a: dist.get_process_group_ranks(g) for a, g in mesh.groups.items()}})
    return out


def _toy_block(lp, x_cur, ctx):
    return torch.tanh(x_cur @ lp + ctx)


def gpipe_toy(rank: int, w, x, bctx, pipe: int) -> dict:
    """``gpipe_scan`` over ``pipe`` stages on toy affine blocks: the output
    and the gradients of ``sum(out ** 2)`` with respect to the whole stack
    ``w`` (each rank's only in its stage's rows), ``x`` and ``bctx``; the
    same forward from this stage's layers alone; and the errors of layers
    the stages do not divide and of microbatches the batch does not."""
    mesh = _mesh(dict(data=-1, pipe=pipe))
    wt, xt, ct = (torch.from_numpy(a).requires_grad_() for a in (w, x, bctx))
    out = gpipe_scan(_toy_block, wt, xt, ct, mesh)
    (out ** 2).sum().backward()
    layers = stage_range(w.shape[0], mesh)
    with torch.no_grad():
        local = gpipe_scan(_toy_block, wt[layers.start:layers.stop], xt, ct, mesh,
                           num_layers=w.shape[0])
    errors = {}
    for name, stack, kw in (("layers", wt[:-1], {}), ("microbatches", wt, {"microbatches": 3})):
        try:
            gpipe_scan(_toy_block, stack, xt, ct, mesh, **kw)
        except ValueError as e:
            errors[name] = str(e)
    return {"out": out.detach().numpy(), "local": local.numpy(), "dw": wt.grad.numpy(),
            "dx": xt.grad.numpy(), "dctx": ct.grad.numpy(),
            "layers": (layers.start, layers.stop), "errors": errors}


def dit_pipe(rank: int, cfg, params, inputs: tuple, config: dict, mask=None,
             quantize: str | None = None) -> dict:
    """``dit_forward`` under a mesh of ``config`` (a pipe axis among its
    axes) on a stage-local DiT holding this rank's blocks of the given
    weights (numpy, JAX layout), quantized in ``quantize``'s mode if given
    (``ops.quant.quantize_dit``): the output, the rank's ring / Ulysses
    calls, the blocks it holds and the warnings raised."""
    from chronoedit_tpu_torch.models import dit as dit_t
    from chronoedit_tpu_torch.models.from_jax import load_dit
    from chronoedit_tpu_torch.ops.quant import quantize_dit

    mesh = _mesh(config)
    layers = stage_range(cfg.num_layers, mesh)
    model = load_dit(dit_t.DiT(cfg, layers=layers), params)
    if quantize:
        quantize_dit(model, mode=quantize)
    args = [None if a is None else torch.from_numpy(a) for a in inputs]
    calls = count_context_attention()
    with warnings.catch_warnings(record=True) as caught, torch.inference_mode():
        warnings.simplefilter("always")
        out = dit_t.dit_forward(model, *args, layer_mask=mask, mesh=mesh)
    return {"out": out.numpy(), "calls": dict(calls), "layers": (layers.start, layers.stop),
            "blocks": len(model.blocks), "warnings": [str(w.message) for w in caught]}


def load_stage(rank: int, cfg, ckpt: str, lora: str, pipe: int) -> dict:
    """``load_pipeline`` under ``pipe=pipe`` from a checkpoint directory with
    a LoRA file: the blocks the rank's DiT holds, its parameters by name,
    the bytes read, and a 2-step edit through the loaded pipeline."""
    from chronoedit_tpu_torch.pipeline.loader import load_pipeline

    mesh = _mesh(dict(data=-1, pipe=pipe))
    pipe_ = load_pipeline(cfg, ckpt, loras=[(lora, 0.8)], device=CPU, mesh=mesh)
    dit = pipe_.dit
    video = pipe_(**{k: torch.from_numpy(v) for k, v in loader_edit_inputs(cfg).items()},
                  num_steps=2)
    return {"layers": (dit.layers.start, dit.layers.stop), "blocks": len(dit.blocks),
            "params": {k: v.detach().numpy() for k, v in dit.named_parameters()},
            "bytes": dict(pipe_.load_bytes), "video": video.numpy()}


def loader_edit_inputs(cfg) -> dict:
    """The seeded inputs of ``load_stage``'s edit (fp32, numpy)."""
    rng = np.random.default_rng(51)
    d = cfg.dit
    inp = dict(image=rng.uniform(-1, 1, (1, 3, 16, 16)),
               prompt_emb=rng.standard_normal((1, 6, d.text_dim)),
               image_emb=rng.standard_normal((1, d.image_tokens, d.image_dim)),
               latents=rng.standard_normal((1, 4, 3, 8, 8)))
    return {k: v.astype(np.float32) for k, v in inp.items()}


def pipeline(rank: int, cfg, dit_params, vae_params, inputs: dict, call: dict,
             config: dict) -> dict:
    """The port's pipeline under a mesh of ``config`` with a stage-local
    DiT: the rank's output."""
    from chronoedit_tpu_torch.models import dit as dit_t
    from chronoedit_tpu_torch.models import vae as vae_t
    from chronoedit_tpu_torch.models.from_jax import load_dit, load_vae
    from chronoedit_tpu_torch.pipeline.edit_pipeline import ChronoEditPipeline

    mesh = _mesh(config)
    dit = load_dit(dit_t.DiT(cfg.dit, layers=stage_range(cfg.dit.num_layers, mesh)),
                   dit_params)
    pipe_ = ChronoEditPipeline(cfg, dit, load_vae(vae_t.VAE(cfg.vae), vae_params), mesh=mesh)
    args = {k: torch.from_numpy(v) for k, v in inputs.items()}
    return {"out": pipe_(**args, **call).numpy()}
