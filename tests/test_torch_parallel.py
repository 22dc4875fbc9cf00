"""The port's mesh, collectives and context-parallel attention against JAX.

The port's side runs in worlds of 2 and 4 gloo processes on the CPU
(``parallel.launch.run_world``: spawned workers from
``test_torch_cp_workers.py``, a ``file://`` rendezvous under ``tmp_path``,
each world ended within its own timeout); JAX's runs in this process on its
8 virtual CPU devices through its own mesh functions, as its
``tests/test_parallel.py`` runs them. fp32, seeded numpy inputs.

Bounds: attention outputs within 2e-5 (JAX's own bound for its rings and
Ulysses against dense attention); gradients within 1e-4 of the largest
gradient magnitude (JAX's flash-ring gradient bound); the frame slices
bitwise; the sharded norms within 1e-5 (JAX's sharded-norm bound).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.ops import fused_norms as norms_j
from chronoedit_tpu.ops.attention import dot_product_attention as attention_j
from chronoedit_tpu.parallel import MeshConfig as MeshConfigJ
from chronoedit_tpu.parallel import make_mesh as make_mesh_j
from chronoedit_tpu.parallel import ring_attention as ring_j
from chronoedit_tpu.parallel import ulysses_attention as ulysses_j
from chronoedit_tpu_torch.models import dit as dit_t
from chronoedit_tpu_torch.ops import fused_norms as norms_t
from chronoedit_tpu_torch.parallel import mesh as mesh_t
from chronoedit_tpu_torch.parallel.launch import run_world
import test_torch_cp_workers as W

ATTN_TOL = 2e-5
GRAD_REL = 1e-4
NORM_TOL = 1e-5
TIMEOUT = 120.0


def world(tmp_path, fn, n, *args):
    return run_world(fn, n, args, timeout=TIMEOUT, tmp_dir=str(tmp_path))


def qkv(b=2, s=32, h=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3)]


def jax_mesh(cp):
    return make_mesh_j(MeshConfigJ(data=8 // cp, context=cp))


# ------------------------------------------------------------ the mesh

@pytest.mark.parametrize("config,n", [
    (dict(data=-1, context=4), 8), (dict(data=2, context=4), 8), (dict(context=1), 3),
    (dict(data=-1, fsdp=2, tensor=2), 8), (dict(data=3, context=3), 8),
    (dict(data=-1, context=3), 8), (dict(data=1, context=2, pipe=2), 4)])
def test_mesh_config_resolve_matches_jax(config, n):
    """``MeshConfig.resolve`` gives JAX's degrees, or raises as JAX's does."""
    try:
        want = MeshConfigJ(**config).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" ")[0]):
            mesh_t.MeshConfig(**config).resolve(n)
        return
    assert mesh_t.MeshConfig(**config).resolve(n) == want


@pytest.mark.parametrize("config", [dict(data=2, context=2), dict(context=4)])
def test_mesh_layout_matches_jax(tmp_path, config):
    """In a world of 4: every rank's coordinates are those of the JAX
    device at the same place of JAX's 4-device mesh, and its context group
    holds the ranks of its JAX mesh row; the axes of size 1 get no group."""
    got = world(tmp_path, W.mesh_layout, 4, config)
    mesh = make_mesh_j(MeshConfigJ(**config), devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(mesh.devices)  # device i of the list is rank i
    axis = mesh.axis_names.index("context")
    for rank, layout in enumerate(got):
        where = np.argwhere(ids == rank)[0].tolist()
        assert layout["shape"] == dict(mesh.shape)
        assert layout["coords"] == dict(zip(mesh.axis_names, where))
        row = list(where)
        row[axis] = slice(None)
        if mesh.shape["context"] > 1:
            assert layout["groups"]["context"] == ids[tuple(row)].tolist()
        assert set(layout["groups"]) == {a for a, n in mesh.shape.items() if n > 1}


def test_make_mesh_refuses_later_axes_and_bad_degrees(tmp_path):
    """A tensor axis above 1 now makes its groups (the ranks of a tensor
    line, in order); degrees that do not fill the world raise ValueError."""
    tensor, wrong = (world(tmp_path, W.mesh_layout, 2, c)
                     for c in (dict(tensor=2), dict(data=3)))
    assert [r["groups"] for r in tensor] == [{"tensor": [0, 1]}] * 2
    assert [r["coords"]["tensor"] for r in tensor] == [0, 1]
    assert wrong[0]["error"].startswith("ValueError")


@pytest.mark.parametrize("make", ["make_mesh", "single_device_mesh", "init_distributed"])
def test_no_card_and_no_device_raises(tmp_path, monkeypatch, make):
    """Given no device, the mesh and the world take the rank's CUDA device
    and raise without one: the CPU is only ever asked for explicitly."""
    from chronoedit_tpu_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"make_mesh": mesh_t.make_mesh, "single_device_mesh": mesh_t.single_device_mesh,
            "init_distributed": functools.partial(
                distributed.init_distributed, init_method=f"file://{tmp_path}/init",
                world_size=1, rank=0)}[make]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert not torch.distributed.is_initialized()


def test_parse_mesh():
    assert mesh_t.parse_mesh("data=2,context=4") == mesh_t.MeshConfig(data=2, context=4)
    with pytest.raises(ValueError, match="unknown mesh axes"):
        mesh_t.parse_mesh("seq=2")


# ------------------------------------------------------------ attention

def _jax_grads(fn, q, k, v):
    return jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in (q, k, v)))


# (mode, head dim, context size): the ring at D = 16 is the dense merge, at
# D = 128 the flash ring (the twins of K1/K5 and K6/K7 with the global LSE)
CASES = [("ring", 16, 2), ("ring", 16, 4), ("ring", 128, 2), ("ring", 128, 4),
         ("ulysses", 16, 2), ("ulysses", 16, 4)]


@pytest.mark.parametrize("mode,d,cp", CASES)
def test_context_attention_matches_jax(tmp_path, mode, d, cp):
    """The gathered output on every rank against JAX's ring / Ulysses on its
    mesh and JAX's dense attention; the gradients of sum(out**2) against
    ``jax.grad`` of JAX's dense ring (D = 16: the same dense per-hop
    merge), of JAX's Ulysses, or of JAX's dense attention (D = 128, where
    JAX's ring runs its Pallas hops in interpret mode: its own test of that
    is marked slow)."""
    q, k, v = qkv(s=32 if d == 16 else 16, d=d, seed=cp + d)
    got = world(tmp_path, W.attention, cp, q, k, v, mode, cp, True)
    dense = np.asarray(attention_j(*map(jnp.asarray, (q, k, v))))
    mesh = jax_mesh(cp)
    if d == 16:
        fn = functools.partial(ring_j if mode == "ring" else ulysses_j, mesh=mesh)
        want = np.asarray(jax.jit(fn)(*map(jnp.asarray, (q, k, v))))
        np.testing.assert_allclose(want, dense, atol=ATTN_TOL)
    else:
        fn = attention_j
        want = dense
    for rank in got:  # every rank gathered the same output
        np.testing.assert_allclose(rank["out"], want, atol=ATTN_TOL)
        np.testing.assert_array_equal(rank["out"], got[0]["out"])
    for name, g, gw in zip("qkv", got[0]["grads"], _jax_grads(fn, q, k, v)):
        gw = np.asarray(gw)
        np.testing.assert_allclose(g, gw, atol=GRAD_REL * max(float(np.abs(gw).max()), 1.0),
                                   err_msg=f"d{name}")


def test_dense_ring_at_d128_matches_the_flash_ring(tmp_path):
    """``ring_attention_dense_inner`` at a head dim the flash ring takes:
    both merges give dense attention's output and gradients."""
    q, k, v = qkv(s=16, d=128, seed=5)
    got = world(tmp_path, W.attention, 2, q, k, v, "ring_dense", 2, True)[0]
    np.testing.assert_allclose(got["out"], np.asarray(attention_j(*map(jnp.asarray, (q, k, v)))),
                               atol=ATTN_TOL)
    for g, gw in zip(got["grads"], _jax_grads(attention_j, q, k, v)):
        gw = np.asarray(gw)
        np.testing.assert_allclose(g, gw, atol=GRAD_REL * max(float(np.abs(gw).max()), 1.0))


def test_ulysses_with_int8_scores_runs_the_int8_twin(tmp_path):
    """Under Ulysses each rank attends over the whole sequence, so
    ``qk_int8`` gives exactly the single-process int8-score attention (the
    twin of K9, quantized per token and head); it differs from the bf16
    path's result. The twin itself is held against JAX's int8-score kernel
    in ``test_torch_qk8.py``."""
    from chronoedit_tpu_torch.ops import flash_attention as fa

    q, k, v = qkv(b=1, s=32, h=4, d=128, seed=9)
    got = world(tmp_path, W.ulysses_qk8, 2, q, k, v, 2)[0]
    old = fa.QK8_RESIDENT_KV_BYTES
    fa.QK8_RESIDENT_KV_BYTES = 0
    try:
        with torch.no_grad():
            want = fa.flash_attention_qk_int8(*map(torch.from_numpy, (q, k, v)), 128 ** -0.5)
    finally:
        fa.QK8_RESIDENT_KV_BYTES = old
    np.testing.assert_allclose(got["int8"], want.numpy(), atol=1e-6)
    assert np.abs(got["int8"] - got["plain"]).max() > 1e-4


def test_ulysses_refuses_heads_that_do_not_divide(tmp_path):
    q, k, v = qkv(b=1, s=8, h=2, d=16)
    with pytest.raises(RuntimeError, match="heads 2 not divisible by axis size 4"):
        world(tmp_path, W.attention, 4, q, k, v, "ulysses", 4, False)


def test_ring_refuses_int8_scores():
    """The ring merges hops by their LSE, which K9 does not write: the DiT
    raises for ``context_parallel="ring"`` with ``attn_qk_int8`` (JAX
    ignores the flag on both branches); "auto" with heads that do not
    divide picks the ring and raises too; Ulysses takes it."""
    mesh = mesh_t.Mesh((1, 1, 1, 1, 2), 0, torch.device("cpu"), {"context": None})
    cfg = dit_t.DiTConfig(num_heads=3, attn_qk_int8=True)
    for mode in ("ring", "auto"):
        with pytest.raises(ValueError, match="log-sum-exp"):
            dit_t.context_split(dit_t.DiTConfig(num_heads=3, attn_qk_int8=True,
                                                context_parallel=mode), mesh, 7200, 3600)
    split = dit_t.context_split(dit_t.DiTConfig(num_heads=4, attn_qk_int8=True), mesh,
                                7200, 3600)
    assert split.mode == "ulysses" and split.size == 2
    assert dit_t.context_split(cfg, mesh, 7201, 3600) is None  # unsharded: no ring to refuse


def test_split_gather_sequence_roundtrip(tmp_path):
    """Each rank's block is its contiguous slice; the gather puts the whole
    back on every rank, bitwise (JAX's ``split_sequence`` / ``gather_sequence``
    round trip)."""
    x = np.random.default_rng(0).standard_normal((1, 4, 8, 2, 2)).astype(np.float32)
    got = world(tmp_path, W.split_gather, 4, x, 4)
    for rank, res in enumerate(got):
        np.testing.assert_array_equal(res["block"], x[:, :, 2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(res["whole"], x)


# ------------------------------------------------------------ frame slices

def _norm_data(t, hw, key=0, d=128, b=2):
    ks = jax.random.split(jax.random.PRNGKey(key), 4)
    x = jax.random.normal(ks[0], (b, t * hw, d), jnp.float32)
    sc = jax.random.normal(ks[1], (b, t, d), jnp.float32)
    sh = jax.random.normal(ks[2], (b, t, d), jnp.float32)
    delta = jax.random.normal(ks[3], (b, t * hw, d), jnp.float32)
    return [np.asarray(a) for a in (x, sc, sh, delta)]


@pytest.mark.parametrize("t,hw", [(8, 64), (2, 64)])
def test_local_frame_slice_matches_jax(t, hw):
    """cp = 4 with T = 8: two whole frames per shard; T = 2: shards within a
    frame. Each shard's modulation slice and ``hw_local`` are JAX's
    ``local_frame_slice``'s inside its shard_map, bitwise."""
    from jax.sharding import Mesh, PartitionSpec as P

    _, sc, sh, _ = (a.copy() for a in _norm_data(t, hw))
    cp, s_local = 4, t * hw // 4
    mesh = Mesh(np.array(jax.devices()[:cp]), ("context",))
    hw_seen = []

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(P(), P()),
                       out_specs=(P(None, "context"), P(None, "context")), check_vma=False)
    def run(a, b):
        mods, hw_l = norms_j.local_frame_slice((a, b), hw, s_local, "context")
        hw_seen.append(hw_l)
        return mods

    want = [np.asarray(m) for m in run(jnp.asarray(sc), jnp.asarray(sh))]
    got = [norms_t.local_frame_slice((torch.from_numpy(sc), torch.from_numpy(sh)), hw,
                                     s_local, i) for i in range(cp)]
    assert {hw_l for _, hw_l in got} == set(hw_seen)
    for j in range(2):
        np.testing.assert_array_equal(torch.cat([m[j] for m, _ in got], dim=1).numpy(), want[j])


@pytest.mark.parametrize("t,hw", [(8, 64), (2, 64)])
def test_sharded_modulation_matches_jax(t, hw):
    """K2's and K3's twins on each shard's tokens with its frame slice and
    ``hw_local``, concatenated, against JAX's sharded ``layer_norm_modulate``
    / ``gated_residual`` on a (tensor 2, context 4) mesh."""
    from jax.sharding import Mesh

    x, sc, sh, delta = (a.copy() for a in _norm_data(t, hw, key=1))
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("tensor", "context"))
    want_ln = np.asarray(jax.jit(lambda *a: norms_j.layer_norm_modulate(
        *a, hw, 1e-6, mesh=mesh))(x, sc, sh))
    want_gate = np.asarray(jax.jit(lambda *a: norms_j.gated_residual(
        *a, hw, mesh=mesh))(x, delta, sc))
    cp, s_local = 4, t * hw // 4
    ln, gate = [], []
    for i in range(cp):
        rows = slice(i * s_local, (i + 1) * s_local)
        xt, dt = torch.from_numpy(x[:, rows]), torch.from_numpy(delta[:, rows])
        (scl, shl), hw_l = norms_t.local_frame_slice(
            (torch.from_numpy(sc), torch.from_numpy(sh)), hw, s_local, i)
        ln.append(norms_t.layer_norm_modulate(xt, scl, shl, hw_l, 1e-6))
        gate.append(norms_t.gated_residual(xt, dt, scl, hw_l))
    np.testing.assert_allclose(torch.cat(ln, dim=1).numpy(), want_ln, atol=NORM_TOL)
    np.testing.assert_allclose(torch.cat(gate, dim=1).numpy(), want_gate, atol=NORM_TOL)


@pytest.mark.parametrize("s,hw,cp", [(7200, 3600, 4), (28800, 3600, 4), (28800, 3600, 8),
                                     (66, 33, 4), (7200, 2400, 4), (7200, 3600, 2),
                                     (960, 64, 2), (128, 64, 2)])
def test_frames_map_locally_matches_jax(s, hw, cp):
    assert norms_t.frames_map_locally(s, hw, cp) == norms_j.frames_map_locally(s, hw, cp)
