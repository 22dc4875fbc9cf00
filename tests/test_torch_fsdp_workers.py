"""The rank bodies of the FSDP tests (``test_torch_fsdp.py``).

``parallel.launch.run_world`` starts each world with the ``spawn`` method,
so every rank imports this module afresh: it imports torch, numpy and the
port only, never jax or the JAX package. Each function runs on one rank of
a gloo world on the CPU and returns numpy arrays or plain values; the JAX
side of each comparison runs in the test's own process. A rank's
one-process reference (the whole model, no mesh) runs in the rank's own
process, so that a bitwise comparison sees the same threads and the same
calls.
"""

from __future__ import annotations

import numpy as np
import torch

from chronoedit_tpu_torch.parallel.mesh import MeshConfig, make_mesh

CPU = torch.device("cpu")


def _mesh(config: dict):
    return make_mesh(MeshConfig(**config), device=CPU)


def run_jobs(rank: int, jobs: list[tuple[str, tuple]]) -> list:
    """Each job, (the name of a function here, its arguments after the
    rank), in turn on this rank; their results in order."""
    return [globals()[name](rank, *args) for name, args in jobs]


def _whole(cfg, params):
    from chronoedit_tpu_torch.models import dit as dit_t
    from chronoedit_tpu_torch.models.from_jax import load_dit

    return load_dit(dit_t.DiT(cfg), params)


def _numpy(tensors: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tensors.items()}


def _lora(model, rank: int = 2):
    """Seeded rank-``rank`` adapters over ``model`` with b drawn non-zero."""
    from chronoedit_tpu_torch.models import lora as lora_t

    g = torch.Generator().manual_seed(7)
    lora = lora_t.init_lora_params(g, model, lora_t.LoRAConfig(rank=rank))
    with torch.no_grad():
        for blk in lora.blocks:
            for _, ad in lora_t.iter_adapters(blk):
                ad.b.normal_(0.0, 0.1, generator=g)
    return lora


def dit_fsdp(rank: int, cfg, params, inputs: tuple, config: dict, grads: bool = False,
             kw: dict | None = None, lora: str | None = None) -> dict:
    """``dit_forward`` on the given weights (numpy, JAX layout) sharded with
    ``shard_params`` under a mesh of ``config``, against the same forward on
    the whole model in this process; ``kw`` goes to both calls (a layer
    mask, the block cache), and ``lora`` ("merged" or "attached") gives
    both seeded adapters. Returns both outputs, the plan, each leaf's shard
    shape, the ring and Ulysses calls, the number of leaves gathered (a
    recompute gathers again), and with ``grads`` each shard's
    gradient of ``sum(out ** 2)`` (full-parameter training) and the whole
    model's."""
    from chronoedit_tpu_torch.models import dit as dit_t
    from chronoedit_tpu_torch.parallel import collectives
    from chronoedit_tpu_torch.parallel.sharding import shard_params
    from test_torch_cp_workers import count_context_attention

    mesh = _mesh(config)
    args = [torch.from_numpy(a) for a in inputs]
    model = _whole(cfg, params).requires_grad_(grads)
    kw = dict(kw or {})
    if lora:
        kw.update(lora=_lora(model), lora_attach=lora == "attached")

    def run(m):
        with torch.set_grad_enabled(grads):
            out = dit_t.dit_forward(model, *args, mesh=m, **kw)
            if grads:
                (out ** 2).sum().backward()
        return (out[0] if isinstance(out, tuple) else out).detach().numpy()

    res = {"one": run(None)}
    if grads:
        res["one_grads"] = _numpy({n: p.grad for n, p in model.named_parameters()})
        model.zero_grad(set_to_none=True)
    shard_params(model, mesh)
    calls = count_context_attention()
    gathered = []
    inner = collectives.gather_shard_autograd

    def counted(x, *a):
        gathered.append(x.shape)
        return inner(x, *a)

    collectives.gather_shard_autograd = counted
    try:
        out = run(mesh)
    finally:
        collectives.gather_shard_autograd = inner
    res.update(out=out, dims=dict(model.fsdp.dims), calls=dict(calls), gathers=len(gathered),
               shapes={n: tuple(p.shape) for n, p in model.named_parameters()})
    if grads:
        res["grads"] = _numpy({n: p.grad for n, p in model.named_parameters()})
    return res


def quantized(rank: int, cfg, params, inputs: tuple, config: dict, mode: str) -> dict:
    """``quantize_dit`` under a mesh of ``config`` on the sharded model
    (each block gathered, quantized whole, re-sharded) against quantizing
    the whole model and then sharding it: whether every leaf is bitwise
    the same, and the plan of each. Then the quantized forward under the
    mesh and the whole quantized model's in this process. int4 modes
    take the uniform grid here: the Lloyd codebook would cost 13-16 s a
    process and the sharding does not depend on the grid."""
    from chronoedit_tpu_torch.models import dit as dit_t
    from chronoedit_tpu_torch.ops import quant
    from chronoedit_tpu_torch.parallel.sharding import shard_params

    quant.INT4_GRID = "uniform"
    mesh = _mesh(config)
    args = [torch.from_numpy(a) for a in inputs]
    whole = quant.quantize_dit(_whole(cfg, params), mode=mode)
    with torch.no_grad():
        one = dit_t.dit_forward(whole, *args).numpy()
    shard_params(whole, mesh)  # quantize, then shard: JAX's order
    model = quant.quantize_dit(shard_params(_whole(cfg, params), mesh), mode=mode, mesh=mesh)
    want = whole.state_dict()
    got = model.state_dict()
    with torch.no_grad():
        out = dit_t.dit_forward(model, *args, mesh=mesh).numpy()
    return {"names": sorted(got) == sorted(want),
            "bitwise": sorted(k for k in want if k in got and torch.equal(got[k], want[k])),
            "leaves": len(want), "dims": dict(model.fsdp.dims),
            "plan_equal": model.fsdp.dims == whole.fsdp.dims, "one": one, "out": out}


def load_fsdp(rank: int, cfg, ckpt: str, lora: str, config: dict, edit_inputs: dict) -> dict:
    """``load_pipeline`` under a mesh of ``config`` from a checkpoint
    directory with a LoRA file (scale 0.8), against the whole load in this
    process: which shards are bitwise this rank's slice of the whole
    model's, the bytes read, and a 2-step edit from each."""
    from chronoedit_tpu_torch.pipeline.loader import load_pipeline

    mesh = _mesh(config)
    whole = load_pipeline(cfg, ckpt, loras=[(lora, 0.8)], device=CPU)
    sharded = load_pipeline(cfg, ckpt, loras=[(lora, 0.8)], device=CPU, mesh=mesh)
    shards = sharded.dit.fsdp
    want = dict(whole.dit.named_parameters())
    got = dict(sharded.dit.named_parameters())
    bitwise = sorted(n for n, p in got.items()
                     if torch.equal(p, shards.local(want[n], shards.dims[n])))
    args = {k: torch.from_numpy(v) for k, v in edit_inputs.items()}
    with torch.no_grad():
        one = whole(**args, num_steps=2).numpy()
        out = sharded(**args, num_steps=2).numpy()
    return {"bitwise": bitwise, "params": len(want), "dims": dict(shards.dims),
            "bytes": dict(sharded.load_bytes), "whole_bytes": dict(whole.load_bytes),
            "one": one, "out": out}


def mesh_errors(rank: int, configs: list[dict]) -> list[str]:
    """The error each config's mesh raises (type and message), or "" when
    it makes one."""
    out = []
    for config in configs:
        try:
            _mesh(config)
            out.append("")
        except (NotImplementedError, ValueError) as e:
            out.append(f"{type(e).__name__}: {e}")
    return out


def edit_inputs(cfg) -> dict:
    """Seeded inputs of ``load_fsdp``'s edit (fp32, numpy)."""
    rng = np.random.default_rng(61)
    d = cfg.dit
    inp = dict(image=rng.uniform(-1, 1, (1, 3, 16, 16)),
               prompt_emb=rng.standard_normal((1, 6, d.text_dim)),
               image_emb=rng.standard_normal((1, d.image_tokens, d.image_dim)),
               latents=rng.standard_normal((1, 4, 3, 8, 8)))
    return {k: v.astype(np.float32) for k, v in inp.items()}
