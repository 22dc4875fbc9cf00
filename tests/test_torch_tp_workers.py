"""The rank bodies of the tensor-parallel tests
(``test_torch_tensor_parallel.py``).

``parallel.launch.run_world`` starts each world with the ``spawn`` method,
so every rank imports this module afresh: it imports torch, numpy and the
port only, never jax or the JAX package. Each function runs on one rank of
a gloo world on the CPU and returns numpy arrays or plain values; the JAX
side of each comparison runs in the test's own process. A rank's
one-process reference (the whole model, no mesh) runs in the rank's own
process, so that a comparison sees the same threads and the same calls.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.distributed as dist

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


def _plans(model) -> dict:
    return {axis: None if getattr(model, axis) is None else dict(getattr(model, axis).dims)
            for axis in ("tensor", "fsdp")}


def _count(module, name: str, calls: dict, key: str):
    """Count this rank's calls of ``module.name`` under ``calls[key]``."""
    inner = getattr(module, name)

    def counted(*a, **k):
        calls[key] += 1
        return inner(*a, **k)

    setattr(module, name, counted)


def dit_tp(rank: int, cfg, params, inputs: tuple, config: dict, grads: bool = False,
           kw: dict | None = None, lora: str | None = None) -> dict:
    """``dit_forward`` on the given weights (numpy, JAX layout) split with
    ``shard_params`` under a mesh of ``config``, against the same forward on
    the whole model in this process; ``kw`` goes to both calls (a layer
    mask, the block cache) and ``lora`` ("merged" or "attached") gives both
    the same seeded adapters of the whole model. Returns both outputs, the
    plans, each leaf's shard shape, the calls of the ring, Ulysses, K4's
    tensor form and the row reduces, and with ``grads`` each leaf's
    gradient of ``sum(out ** 2)`` (full-parameter training) and the whole
    model's."""
    from chronoedit_tpu_torch.models import dit as dit_t
    from chronoedit_tpu_torch.parallel import collectives
    from chronoedit_tpu_torch.parallel.sharding import shard_params
    from test_torch_cp_workers import count_context_attention
    from test_torch_fsdp_workers import _lora

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
    calls.update(k4=0, reduce=0)
    _count(dit_t, "rms_norm_tensor", calls, "k4")
    _count(collectives, "reduce_from_tensor", calls, "reduce")
    out = run(mesh)
    res.update(out=out, plans=_plans(model), calls=dict(calls),
               shapes={n: tuple(p.shape) for n, p in model.named_parameters()})
    if grads:
        res["grads"] = _numpy({n: p.grad for n, p in model.named_parameters()})
    return res


def quantized_tp(rank: int, cfg, params, inputs: tuple, config: dict, mode: str,
                 levels: tuple) -> dict:
    """``quantize_dit`` under a mesh of ``config`` on the split model (each
    rank its local layers; the row layers' scales over the tensor group)
    against quantizing the whole model and then splitting it with
    ``shard_params`` (the int4 rows repacked): whether every leaf is
    bitwise the same, and the plans. Then the quantized forward under the
    mesh, the same with each rank's own per-token int8 scale (the fault
    the global scale prevents), and the whole quantized model's in this
    process. ``levels`` replaces the Lloyd codebook, as the test's JAX side
    does, so that both quantize alike without the search."""
    from chronoedit_tpu_torch.models import dit as dit_t
    from chronoedit_tpu_torch.ops import quant
    from chronoedit_tpu_torch.parallel.sharding import shard_params

    quant._lloyd_levels = lambda eff_group: levels
    mesh = _mesh(config)
    args = [torch.from_numpy(a) for a in inputs]
    whole = quant.quantize_dit(_whole(cfg, params), mode=mode)
    with torch.no_grad():
        one = dit_t.dit_forward(whole, *args).numpy()
    shard_params(whole, mesh)  # quantize, then split: JAX's order
    model = quant.quantize_dit(shard_params(_whole(cfg, params), mesh), mode=mode, mesh=mesh)
    want, got = whole.state_dict(), model.state_dict()
    with torch.no_grad():
        out = dit_t.dit_forward(model, *args, mesh=mesh).numpy()
        token_scale = quant._token_scale
        quant._token_scale = lambda xf, group=None: token_scale(xf)
        try:
            local_scale = dit_t.dit_forward(model, *args, mesh=mesh).numpy()
        finally:
            quant._token_scale = token_scale
    return {"names": sorted(got) == sorted(want),
            "bitwise": sorted(k for k in want if k in got and torch.equal(got[k], want[k])),
            "leaves": len(want), "plans": _plans(model),
            "plans_equal": _plans(model) == _plans(whole),
            "fc2": tuple(model.blocks[0].ffn.fc2.packed.shape) if mode != "int8" else None,
            "one": one, "out": out, "local_scale": local_scale}


def load_tp(rank: int, cfg, ckpt: str, lora: str, config: dict, edit_inputs: dict) -> dict:
    """``load_pipeline`` under a mesh of ``config`` from a checkpoint
    directory with a LoRA file (scale 0.8), against the whole load in this
    process: which leaves are bitwise this rank's slice of the whole
    model's, the bytes read, and a 2-step edit from each."""
    from chronoedit_tpu_torch.parallel.sharding import local_of
    from chronoedit_tpu_torch.pipeline.loader import load_pipeline

    mesh = _mesh(config)
    whole = load_pipeline(cfg, ckpt, loras=[(lora, 0.8)], device=CPU)
    split = load_pipeline(cfg, ckpt, loras=[(lora, 0.8)], device=CPU, mesh=mesh)
    want = dict(whole.dit.named_parameters())
    got = dict(split.dit.named_parameters())
    bitwise = sorted(n for n, p in got.items()
                     if torch.equal(p, local_of(split.dit, n, want[n])))
    args = {k: torch.from_numpy(v) for k, v in edit_inputs.items()}
    with torch.no_grad():
        one = whole(**args, num_steps=2).numpy()
        out = split(**args, num_steps=2).numpy()
    return {"bitwise": bitwise, "params": len(want), "plans": _plans(split.dit),
            "bytes": dict(split.load_bytes), "whole_bytes": dict(whole.load_bytes),
            "one": one, "out": out}


def rms_tp(rank: int, x, w, config: dict) -> dict:
    """K4's tensor form (``rms_norm_tensor``) on this rank's block of the
    columns of the whole (B, S, D) ``x``, the (D,) weight whole on every
    rank; the output gathered over the tensor group and, through
    ``sum(out ** 2)`` of the gathered output, the gradients of x (gathered)
    and of the weight."""
    from chronoedit_tpu_torch.ops import fused_norms as fn
    from chronoedit_tpu_torch.ops import layers as L
    from chronoedit_tpu_torch.parallel import collectives as C

    mesh = _mesh(config)
    group, index, size = mesh.group("tensor"), mesh.index("tensor"), mesh.shape["tensor"]
    norm = L.RMSNorm(w.shape[0])
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(w))
    norm.scale.requires_grad_(True)
    d = x.shape[-1] // size
    local = torch.from_numpy(x[..., index * d:(index + 1) * d].copy()).requires_grad_(True)
    out = C.gather_sequence_autograd(fn.rms_norm_tensor(norm, local, group, index, size), group,
                                     -1)
    (out ** 2).sum().backward()
    return {"out": out.detach().numpy(), "dx": C.all_gather(local.grad, group, -1).numpy(),
            "dw": norm.scale.grad.numpy()}


def mesh_checks(rank: int, configs: list[dict], cfg) -> list[dict]:
    """For each config: the mesh's groups of ranks by axis, or the error
    that making it raised; the warnings ``gpipe_scan`` gives under it; and
    the error ``shard_params`` raises for ``cfg``'s DiT under it, if any."""
    from chronoedit_tpu_torch.models import dit as dit_t
    from chronoedit_tpu_torch.parallel.pipeline_parallel import gpipe_scan
    from chronoedit_tpu_torch.parallel.sharding import shard_params

    out = []
    for config in configs:
        try:
            mesh = _mesh(config)
        except ValueError as e:
            out.append({"error": f"{type(e).__name__}: {e}"})
            continue
        res = {"groups": {a: dist.get_process_group_ranks(g) for a, g in mesh.groups.items()},
               "coords": mesh.coords}
        if mesh.shape["pipe"] > 1:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                gpipe_scan(lambda lp, x, ctx: x, [0, 1], torch.zeros(1, 2), (), mesh)
            res["warnings"] = [str(w.message) for w in caught]
        try:
            model = shard_params(dit_t.DiT(cfg, device="meta"), mesh)
            res["tensor"] = None if model.tensor is None else model.tensor.size
        except ValueError as e:
            res["shard_error"] = f"{type(e).__name__}: {e}"
        out.append(res)
    return out
