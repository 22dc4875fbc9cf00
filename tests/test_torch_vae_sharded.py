"""The port's spatially sharded VAE against JAX's VAE (``tests/test_vae_sharded.py``).

Under a mesh the port splits the VAE's rows over the context, tensor and
fsdp ranks that divide them (``parallel/mesh.vae_axes``, JAX's
``_spatial_shard`` rule) in whole latent rows with a halo on each side,
and all-gathers the result (``models/vae.py``). Its side runs in one world
of context 2 x tensor 2 and one of JAX's context 4 x tensor 2, gloo
processes on the CPU started together for the file
(``test_torch_vae_workers.py`` through ``parallel.launch.run_world``:
spawned workers, a ``file://`` rendezvous under the test's temporary
directory, each world ended within its own timeout, a barrier after
joining), while this process computes JAX's unsharded encode and decode
(its sharded ones equal them within the same bound, which is what JAX's
test holds). Same weights (``models/from_jax.py``), fp32, JAX's TINY
config and shapes ((1, 3, 5, 32, 32), streamed (1, 3, 7, 32, 32), the
fallback at H = 20) and its bound, 2e-5; there every rank's halo covers
the whole image, so taller clips (128 rows: 32 latent rows, 4 or 8 a
rank) take halos that end inside it, one of them W-tiled inside each
rank's rows. A planted short halo must miss the bound.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from chronoedit_tpu.models import vae as vae_j
from chronoedit_tpu.parallel import MeshConfig as MeshConfigJ
from chronoedit_tpu.parallel import make_mesh as make_mesh_j
from chronoedit_tpu_torch.models import vae as vae_t
from chronoedit_tpu_torch.parallel import mesh as mesh_t
from chronoedit_tpu_torch.parallel.launch import run_world
from test_torch_dit import randomize
import test_torch_vae_workers as W

torch.set_num_threads(2)

TOL = 2e-5
TIMEOUT = 120.0
WORLDS = {4: dict(context=2, tensor=2), 8: dict(context=4, tensor=2)}
# JAX's TINY (tests/test_vae.py): spatial factor 4, temporal factor 2
TINY = dict(dim=8, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1,
            temporal_downsample=(False, True))
# name: (kind, input shape, seed, keywords)
CASES = {
    "encode": ("encode", (1, 3, 5, 32, 32), 1, {}),
    "decode": ("decode", (1, 4, 3, 8, 8), 2, {}),
    "encode_streamed": ("encode", (1, 3, 7, 32, 32), 3, dict(streaming=True)),
    "decode_streamed": ("decode", (1, 4, 4, 8, 8), 4, dict(streaming=True)),
    "encode_tall": ("encode", (1, 3, 5, 128, 32), 5, {}),
    "decode_tall": ("decode", (1, 4, 3, 32, 8), 6, {}),
    "encode_tall_tiled": ("encode", (1, 3, 7, 128, 64), 7, dict(streaming=True,
                                                                 spatial_tiles=2)),
    "decode_tall_tiled": ("decode", (1, 4, 4, 32, 16), 8, dict(streaming=True,
                                                                spatial_tiles=2)),
    "fallback": ("encode", (1, 3, 3, 20, 16), 9, {}),
}
# the planted fault: halos of one latent row instead of 24 pixel / 9 latent rows
SHORT = (4, 1)
TALL = ("encode_tall", "decode_tall")


def inputs() -> dict:
    return {name: (kind, W.clip(seed, shape), kw)
            for name, (kind, shape, seed, kw) in CASES.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's unsharded outputs by case, {world: {"sound": ..., "short":
    ...}} with each case's results a list by rank)."""
    params = randomize(lambda: vae_j.init_vae_params(jax.random.PRNGKey(0),
                                                     vae_j.VAEConfig(**TINY)), 4,
                       fan_in=lambda s: int(np.prod(s[:-1])))
    cfg = vae_t.VAEConfig(**TINY)
    cases = inputs()
    short = {k: cases[k] for k in TALL}

    dirs = {n: str(tmp_path_factory.mktemp(f"vae_world{n}")) for n in WORLDS}

    def world(n):
        jobs = [("sharded_vae", (cfg, params, WORLDS[n], cases)),
                ("sharded_vae", (cfg, params, WORLDS[n], short, SHORT))]
        got = run_world(W.run_jobs, n, (jobs,), timeout=TIMEOUT, tmp_dir=dirs[n])
        return {kind: {case: [rank[i][case] for rank in got] for case in got[0][i]}
                for i, kind in enumerate(("sound", "short"))}

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        worlds = {n: pool.submit(world, n) for n in WORLDS}
        cfg_j = vae_j.VAEConfig(**TINY)
        want = {}
        for name, (kind, x, kw) in cases.items():
            fn = vae_j.vae_encode if kind == "encode" else vae_j.vae_decode
            want[name] = np.asarray(fn(params, cfg_j, jnp.asarray(x), normalize=False,
                                       streaming=kw.get("streaming")))
        return want, {n: f.result() for n, f in worlds.items()}


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("case", [c for c in CASES if c != "fallback"])
def test_sharded_vae_matches_jax(runs, world, case):
    """Every rank's gathered output within JAX's bound of JAX's unsharded
    VAE and bitwise the other ranks'; the rows split over every rank."""
    want, got = runs
    per_rank = got[world]["sound"][case]
    for r in per_rank:
        assert r["ranks"] == world
        assert r["out"].shape == want[case].shape
        np.testing.assert_array_equal(r["out"], per_rank[0]["out"])
        assert r["digest"] == per_rank[0]["digest"]
    np.testing.assert_allclose(per_rank[0]["out"], want[case], atol=TOL, rtol=0)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_sharded_vae_indivisible_h_falls_back(runs, world):
    """H = 20 (5 latent rows) divides over no axis: the unsharded path, bitwise
    the call without a mesh, within the bound of JAX's."""
    want, got = runs
    for r in got[world]["sound"]["fallback"]:
        assert r["ranks"] == 1
        np.testing.assert_array_equal(r["out"], r["alone"])
        np.testing.assert_allclose(r["out"], want["fallback"], atol=TOL, rtol=0)


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("case", TALL)
def test_short_halo_fails(runs, world, case):
    """A halo short of the receptive field: the ranks' blocks disagree with
    JAX's far outside the bound."""
    want, got = runs
    r = got[world]["short"][case][0]
    assert r["ranks"] == world
    assert np.abs(r["out"] - want[case]).max() > 100 * TOL


@pytest.mark.parametrize("rows", [1, 2, 4, 5, 8, 12, 32, 90])
@pytest.mark.parametrize("mesh", [dict(context=4, tensor=2), dict(context=2, tensor=2, fsdp=2),
                                  dict(tensor=2, fsdp=4), dict(context=8), dict(fsdp=2),
                                  dict(data=2, context=2, tensor=2), dict(pipe=2, context=4)])
def test_axis_rule_is_jax(mesh, rows):
    """``vae_axes`` takes the axes JAX's ``_spatial_shard`` shards an array
    of ``rows`` rows over, on the same mesh (8 CPU devices)."""
    cfg = dict(mesh)
    cfg.setdefault("data", -1)
    mesh_j = make_mesh_j(MeshConfigJ(**cfg))
    x = vae_j._spatial_shard(jnp.zeros((1, 1, rows, 2, 1)), mesh_j)
    spec = x.sharding.spec if isinstance(x.sharding, NamedSharding) else P()
    axes = spec[2] if len(spec) > 2 and spec[2] is not None else ()
    assert mesh_t.vae_axes(mesh, rows) == ((axes,) if isinstance(axes, str) else tuple(axes))
