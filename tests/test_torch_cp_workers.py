"""The rank bodies of the multi-process tests (``test_torch_parallel.py``,
``test_torch_ring_in_dit.py``, ``test_torch_consistency.py``).

``parallel.launch.run_world`` starts each world with the ``spawn`` method,
so every rank imports this module afresh: it imports torch, numpy and the
port only, never jax or the JAX package. Each function runs on one rank of
a gloo world on the CPU and returns numpy arrays or plain values. It holds
no test; the JAX side of each comparison runs in the test's own process.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from chronoedit_tpu_torch.parallel import context
from chronoedit_tpu_torch.parallel.mesh import MeshConfig, make_mesh

CPU = torch.device("cpu")


def _mesh(**config):
    return make_mesh(MeshConfig(**config), device=CPU)


def mesh_layout(rank: int, config: dict) -> dict:
    """This rank's mesh coordinates and the ranks of its groups, or the
    error that making the mesh raised."""
    try:
        mesh = _mesh(**config)
    except (NotImplementedError, ValueError) as e:
        return {"error": f"{type(e).__name__}: {e}"}
    return {"shape": mesh.shape, "coords": mesh.coords,
            "groups": {a: dist.get_process_group_ranks(g) for a, g in mesh.groups.items()}}


def attention(rank: int, q, k, v, mode: str, cp: int, grads: bool) -> dict:
    """Ring or Ulysses attention over a context group of ``cp`` ranks on
    this rank's block of the whole (B, S, H, D) q, k, v; the output and,
    with ``grads``, the gradients of ``sum(out ** 2)``, gathered."""
    mesh = _mesh(data=-1, context=cp)
    local = [context.split_sequence(torch.from_numpy(a), mesh, seq_dim=1).clone()
             .requires_grad_(grads) for a in (q, k, v)]
    if mode == "ring":
        out = context.ring_attention(*local, mesh)
    elif mode == "ring_dense":
        out = context.ring_attention_dense_inner(*local, mesh.group("context"))
    else:
        out = context.ulysses_attention(*local, mesh)
    full = context.gather_sequence(out, mesh, seq_dim=1)
    res = {"out": full.detach().numpy()}
    if grads:
        (full ** 2).sum().backward()
        res["grads"] = [context.gather_sequence(t.grad, mesh, seq_dim=1).numpy()
                        for t in local]
    return res


def split_gather(rank: int, x, cp: int) -> dict:
    mesh = _mesh(data=-1, context=cp)
    block = context.split_sequence(torch.from_numpy(x), mesh, seq_dim=2)
    return {"block": block.numpy(), "whole": context.gather_sequence(block, mesh).numpy()}


def ulysses_qk8(rank: int, q, k, v, cp: int) -> dict:
    """Ulysses with int8 scores (the resident rule lowered so that they
    apply at this length), and the same without."""
    from chronoedit_tpu_torch.ops import flash_attention as fa

    fa.QK8_RESIDENT_KV_BYTES = 0
    mesh = _mesh(data=-1, context=cp)
    local = [context.split_sequence(torch.from_numpy(a), mesh, seq_dim=1) for a in (q, k, v)]
    group = mesh.group("context")
    with torch.no_grad():
        int8 = context.ulysses_attention_inner(*local, group, qk_int8=True)
        bf = context.ulysses_attention_inner(*local, group)
    return {name: context.gather_sequence(t, mesh, seq_dim=1).numpy()
            for name, t in (("int8", int8), ("plain", bf))}


def count_context_attention() -> dict:
    """Count this rank's ring and Ulysses attention calls from here on."""
    calls = {"ring": 0, "ulysses": 0}
    for name in calls:
        inner = getattr(context, f"{name}_attention_inner")

        def counted(*a, _name=name, _inner=inner, **k):
            calls[_name] += 1
            return _inner(*a, **k)
        setattr(context, f"{name}_attention_inner", counted)
    return calls


def _dit(cfg, params):
    from chronoedit_tpu_torch.models import dit as dit_t
    from chronoedit_tpu_torch.models.from_jax import load_dit

    return load_dit(dit_t.DiT(cfg), params)


def dit_forward(rank: int, cfg, params, inputs: tuple, cp: int, data: int = -1
                ) -> tuple[np.ndarray, dict]:
    """``dit_forward`` under a mesh of ``data`` x ``cp`` ranks on the given
    weights (numpy, JAX layout) and inputs; the output and this rank's
    ring / Ulysses calls."""
    from chronoedit_tpu_torch.models import dit as dit_t

    mesh = _mesh(data=data, context=cp)
    model = _dit(cfg, params)
    args = [None if a is None else torch.from_numpy(a) for a in inputs]
    calls = count_context_attention()
    with torch.inference_mode():
        out = dit_t.dit_forward(model, *args, mesh=mesh)
    return out.numpy(), calls


def dit_cached(rank: int, cfg, params, inputs: tuple, cp: int, blocks: tuple,
               mask) -> dict:
    """Under context parallelism: the block cache's refresh and reuse steps
    (each rank's cache its own block of the tokens) and a forward with a
    skip-layer mask, with the cache's shape."""
    from chronoedit_tpu_torch.models import dit as dit_t

    mesh = _mesh(data=-1, context=cp)
    model = _dit(cfg, params)
    args = [torch.from_numpy(a) for a in inputs]
    with torch.inference_mode():
        fresh, cache = dit_t.dit_forward(model, *args, cache_blocks=blocks, mesh=mesh)
        reused, same = dit_t.dit_forward(model, *args, cache_blocks=blocks, cache=cache,
                                         cache_refresh=False, mesh=mesh)
        masked = dit_t.dit_forward(model, *args, layer_mask=mask, mesh=mesh)
    assert same is cache
    return {"fresh": fresh.numpy(), "reused": reused.numpy(), "masked": masked.numpy(),
            "cache_shape": tuple(cache.shape)}


def pipeline(rank: int, cfg, dit_params, vae_params, inputs: dict, call: dict,
             cp: int) -> tuple[np.ndarray, dict]:
    """The port's pipeline under a ``context=cp`` mesh: the rank's output
    and its ring / Ulysses calls."""
    from chronoedit_tpu_torch.models import vae as vae_t
    from chronoedit_tpu_torch.models.from_jax import load_vae
    from chronoedit_tpu_torch.pipeline.edit_pipeline import ChronoEditPipeline

    mesh = _mesh(data=-1, context=cp)
    pipe = ChronoEditPipeline(cfg, _dit(cfg.dit, dit_params),
                              load_vae(vae_t.VAE(cfg.vae), vae_params), mesh=mesh)
    args = {k: torch.from_numpy(v) for k, v in inputs.items()}
    calls = count_context_attention()
    return pipe(**args, **call).numpy(), calls


def consistency(rank: int, diverge: int | None) -> dict:
    """A tree that is the same on every rank except, when ``diverge`` names
    a rank, in ``w`` there; what ``check_replica_consistency`` and the
    callback make of it on this rank."""
    from chronoedit_tpu_torch.parallel.consistency import check_replica_consistency, tree_digest
    from chronoedit_tpu_torch.train.callbacks import ReplicaConsistencyCallback

    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(4, 3, generator=g), "ok": [torch.ones(2), torch.arange(5)],
            "module": torch.nn.Linear(3, 2)}
    with torch.no_grad():
        tree["module"].weight.copy_(torch.randn(2, 3, generator=g))
        tree["module"].bias.zero_()
        if rank == diverge:
            tree["w"][1, 2] += 1e-6

    class Trainer:
        _last_state = tree

    raised = None
    try:
        ReplicaConsistencyCallback(every_n=1).on_step_end(Trainer(), 0, {})
    except RuntimeError as e:
        raised = str(e)
    return {"bad": check_replica_consistency(tree), "digest": tree_digest(tree),
            "raised": raised}


def collate(rank: int) -> dict:
    from chronoedit_tpu_torch.parallel.distributed import (
        collate_metrics, is_primary, local_batch_size, process_count, process_index)

    try:
        local_batch_size(8)
        indivisible = None
    except ValueError as e:
        indivisible = str(e)
    return {"metrics": collate_metrics({"loss": float(rank + 1), "acc": torch.tensor(rank * 0.5)}),
            "count": process_count(), "index": process_index(), "primary": is_primary(),
            "local_batch": local_batch_size(6), "indivisible": indivisible}
