"""The rank bodies of ``test_torch_vae_sharded.py``: the port's VAE under a
mesh, one rank of a gloo world on the CPU each.

``parallel.launch.run_world`` starts each world with the ``spawn`` method,
so every rank imports this module afresh: it imports torch, numpy and the
port only, never jax or the JAX package. JAX's side of each comparison runs
in the test's own process.
"""

from __future__ import annotations

import numpy as np
import torch

from chronoedit_tpu_torch.parallel.mesh import MeshConfig, make_mesh

CPU = torch.device("cpu")


def sharded_vae(rank: int, cfg, params, mesh_config: dict, cases: dict,
                halos: tuple[int, int] | None = None) -> dict:
    """Each case, name: (``"encode"`` or ``"decode"``, input, keywords),
    through ``vae_encode`` / ``vae_decode`` (``normalize=False``) under a
    mesh of ``mesh_config``, and through the same call without the mesh in
    this rank; the split's size (ranks of the VAE group). With ``halos`` (encoder, decoder) the module's halos are
    replaced by those values for the duration (a planted fault)."""
    from chronoedit_tpu_torch.models import vae as vae_t
    from chronoedit_tpu_torch.models.from_jax import load_vae
    from chronoedit_tpu_torch.parallel.consistency import tree_digest

    mesh = make_mesh(MeshConfig(**mesh_config), device=CPU)
    vae = load_vae(vae_t.VAE(cfg), params)
    saved = vae_t._encoder_halo, vae_t._decoder_halo
    if halos is not None:
        vae_t._encoder_halo = lambda c: halos[0]
        vae_t._decoder_halo = lambda c: halos[1]
    out = {}
    try:
        for name, (kind, x, kw) in cases.items():
            fn = vae_t.vae_encode if kind == "encode" else vae_t.vae_decode
            inp = torch.from_numpy(x)
            rows = x.shape[-2] // (cfg.spatial_factor if kind == "encode" else 1)
            with torch.inference_mode():
                got = fn(vae, inp, normalize=False, mesh=mesh, **kw)
                alone = fn(vae, inp, normalize=False, **kw)
            out[name] = {"out": got.numpy(), "alone": alone.numpy(), "digest": tree_digest(got),
                         "ranks": vae_t._row_split(mesh, rows)[1]}
    finally:
        vae_t._encoder_halo, vae_t._decoder_halo = saved
    return out


def run_jobs(rank: int, jobs: list[tuple[str, tuple]]) -> list:
    """Each job, (the name of a function here, its arguments after the
    rank), in turn on this rank; their results in order."""
    return [globals()[name](rank, *args) for name, args in jobs]


def clip(seed: int, shape: tuple) -> np.ndarray:
    """Seeded pixels in [-1, 1] or latents N(0, 1) (4 channels)."""
    rng = np.random.default_rng(seed)
    if shape[1] == 3:
        return rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)
