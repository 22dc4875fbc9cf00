"""The rank bodies of ``test_torch_serve_mesh.py``: the port's
``EditServer`` on rank 0 of a gloo world on the CPU and ``follow`` on the
other ranks.

``parallel.launch.run_world`` starts each world with the ``spawn`` method,
so every rank imports this module afresh: it imports torch, numpy and the
port only, never jax or the JAX package. JAX's side of each comparison runs
in the test's own process.
"""

from __future__ import annotations

import time
import types

import torch

from chronoedit_tpu_torch.parallel.mesh import MeshConfig, make_mesh

CPU = torch.device("cpu")
# how long rank 0 waits for a request's future: a hang fails the test
FUTURE_S = 90.0


def _pipeline(cfg, dit_params, vae_params, mesh):
    from chronoedit_tpu_torch.models import dit as dit_t
    from chronoedit_tpu_torch.models import vae as vae_t
    from chronoedit_tpu_torch.models.from_jax import load_dit, load_vae
    from chronoedit_tpu_torch.parallel.sharding import shard_params
    from chronoedit_tpu_torch.pipeline.edit_pipeline import ChronoEditPipeline

    dit = load_dit(dit_t.DiT(cfg.dit), dit_params)
    shard_params(dit, mesh)
    return ChronoEditPipeline(cfg, dit, load_vae(vae_t.VAE(cfg.vae), vae_params), mesh=mesh)


def _session(rank: int, pipe, mesh, noise: dict, requests: list, plant: str | None) -> dict:
    """One server session: rank 0 serves ``requests`` (all at once, then
    the second alone again) and stops; the other ranks follow. Every rank
    draws the noise of a seed from ``noise`` (JAX's draws) and checks its
    initial latents against the other ranks' before each batch. Planted:
    ``"seed+1"``, the followers draw the noise of seed + 1; ``"raise"``,
    rank 1 raises before its first batch runs (rank 0 then submits one
    request, and one more after the world ended)."""
    from chronoedit_tpu_torch.parallel.consistency import check_replica_consistency
    from chronoedit_tpu_torch.pipeline import server as server_mod

    shift = 1 if plant == "seed+1" and rank != 0 else 0
    server_mod.request_latents = lambda pipeline, key, seed: torch.from_numpy(
        noise[seed + shift].copy())
    inner, diverged = server_mod._run, []

    def run(pipeline, key, tensors, latents):
        diverged.append(check_replica_consistency(latents))
        if plant == "raise" and rank == 1:
            raise RuntimeError("planted follower failure")
        return inner(pipeline, key, tensors, latents)

    server_mod._run = run
    try:
        if rank != 0:
            try:
                return {"batches": server_mod.follow(pipe, mesh), "diverged": diverged}
            except Exception as e:  # noqa: BLE001 - returned to the test
                return {"error": f"{type(e).__name__}: {e}", "diverged": diverged}
        srv = server_mod.EditServer(pipe, server_mod.ServerConfig(max_batch=4,
                                                                 max_wait_ms=300)).start()
        health = srv.health()
        try:
            if plant == "raise":
                t0 = time.monotonic()
                fut = srv.submit(**requests[0])
                try:
                    fut.result(timeout=FUTURE_S)
                    error = None
                except Exception as e:  # noqa: BLE001 - the expected failure
                    error = f"{type(e).__name__}: {e}"
                waited = time.monotonic() - t0
                late = srv.submit(**requests[1])
                return {"error": error, "waited": waited, "late_done": late.done(),
                        "late": repr(late.exception(timeout=0)) if late.done() else None,
                        "health": srv.health(), "diverged": diverged}
            futs = [srv.submit(**r) for r in requests]
            frames = [f.result(timeout=FUTURE_S).numpy() for f in futs]
            frames.append(srv.submit(**requests[1]).result(timeout=FUTURE_S).numpy())
            return {"frames": frames, "stats": dict(srv.stats), "health": health,
                    "diverged": diverged}
        finally:
            srv.stop()
    finally:
        server_mod._run = inner


def serve_world(rank: int, cfg, dit_params, vae_params, mesh_config: dict, noise: dict,
                requests: list, plants: list) -> list:
    """The port's server under a mesh of ``mesh_config`` on the given
    weights (numpy, JAX layout): one session per entry of ``plants``
    (None for the sound one), in turn on the same world."""
    mesh = make_mesh(MeshConfig(**mesh_config), device=CPU)
    pipe = _pipeline(cfg, dit_params, vae_params, mesh)
    return [_session(rank, pipe, mesh, noise, requests, plant) for plant in plants]


class _EchoPipeline:
    """A stand-in pipeline for the protocol alone: its edit is the input
    image as one frame, plus the mean of the initial latents."""

    def __init__(self, cfg, rank: int, world: int):
        self.config, self.device, self.guardrails = cfg, CPU, None
        self.mesh = types.SimpleNamespace(rank=rank, shape={"context": world})

    def __call__(self, image, prompt_emb, latents=None, **kw):
        return image[:, :, None] + latents.mean()


def idle_world(rank: int, cfg, request: dict, keepalive_s: float, idle_s: float) -> dict:
    """Rank 0 serves with ``KEEPALIVE_S`` set to ``keepalive_s`` (this
    spawned rank's own copy of the module), leaves the world idle for
    ``idle_s`` (past the process group's timeout, which the test sets
    shorter), then submits ``request``; the other ranks follow. Rank 0
    returns the frame or the request's error and the keep-alive headers it
    sent; the others their batch count or their error."""
    from chronoedit_tpu_torch.pipeline import server as server_mod

    pipe = _EchoPipeline(cfg, rank, torch.distributed.get_world_size())
    if rank != 0:
        try:
            return {"batches": server_mod.follow(pipe, pipe.mesh)}
        except Exception as e:  # noqa: BLE001 - returned to the test
            return {"error": f"{type(e).__name__}: {e}"}
    sent, inner = [], server_mod._broadcast_batch
    server_mod.KEEPALIVE_S = keepalive_s

    def counted(header, tensors, device):
        sent.append(header == server_mod._KEEPALIVE)
        return inner(header, tensors, device)

    server_mod._broadcast_batch = counted
    srv = server_mod.EditServer(pipe, server_mod.ServerConfig(max_batch=1,
                                                             max_wait_ms=5)).start()
    try:
        time.sleep(idle_s)
        t0 = time.monotonic()
        fut = srv.submit(**request)
        try:
            out = {"frame": fut.result(timeout=FUTURE_S).numpy()}
        except Exception as e:  # noqa: BLE001 - the planted world's failure
            out = {"error": f"{type(e).__name__}: {e}"}
        out["waited"] = time.monotonic() - t0
        out["keepalives"] = sum(sent)
        out["health"] = srv.health()
        return out
    finally:
        srv.stop()
        server_mod._broadcast_batch = inner
