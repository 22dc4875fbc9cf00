"""Tensor parallelism against JAX: the placement of every DiT leaf over the
tensor axis (alone and with fsdp), K4's tensor form, the Megatron column /
row forward and its gradients (alone and composed with fsdp, context and
data), the quantized leaves split over tensor, tensor-local loading, the
mesh, and ``run_inference --mesh tensor=``.

The port's side runs in one world of 2 and one of 4 gloo processes on the
CPU, each started once for the file (``test_torch_tp_workers.py`` through
``parallel.launch.run_world``: spawned workers, a ``file://`` rendezvous
under the test's temporary directory, each world ended within its own
timeout, a barrier after joining); JAX's runs in this process on its 8
virtual CPU devices, with the parameters sharded by its own
``shard_params(..., dit_param_sharding(mesh))``, as its
``tests/test_parallel.py`` runs it. The same seeded numpy weights and inputs
go to both (``models/from_jax.py``); fp32.

Bounds: the forward within 2e-4 (rtol and atol) of JAX's sharded forward,
JAX's own bound for it (``tests/test_parallel.py``), and of the port's one
process in the rank's own process (the row products and K4's statistics
are sums over the ranks, so not bitwise); the gradients within 1e-4 of
the largest gradient of ``jax.grad``; K4's tensor form within 1e-5 of
JAX's ``rms_norm_fused`` on a tensor mesh (its own bound in
``tests/test_fused_norms_sharded.py``), gradients within 1e-5 of the
largest; the quantized leaves bitwise the whole model's quantized leaves'
split, their forward within 2e-4 of one process and of JAX's (JAX's own
bound for its sharded int4 / w4a8 forwards, ``tests/test_quant.py``);
loaded slices bitwise.
"""

import concurrent.futures
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as MeshJ

from chronoedit_tpu.configs import chronoedit_14b as big_j
from chronoedit_tpu.core.rope import Rope3DSpec as RopeJ
from chronoedit_tpu.models import dit as dit_j
from chronoedit_tpu.ops import fused_norms as fn_j
from chronoedit_tpu.ops import quant as quant_j
from chronoedit_tpu.parallel import MeshConfig as MeshConfigJ
from chronoedit_tpu.parallel import make_mesh as make_mesh_j
from chronoedit_tpu.parallel.sharding import dit_param_sharding as sharding_j
from chronoedit_tpu.parallel.sharding import shard_params as shard_params_j
from chronoedit_tpu_torch.configs import chronoedit_14b as big_t
from chronoedit_tpu_torch.configs import chronoedit_tiny as tiny_t
from chronoedit_tpu_torch.core.rope import Rope3DSpec as RopeT
from chronoedit_tpu_torch.models import dit as dit_t
from chronoedit_tpu_torch.models import weights as w_t
from chronoedit_tpu_torch.ops import quant as quant_t
from chronoedit_tpu_torch.parallel import mesh as mesh_t
from chronoedit_tpu_torch.parallel import sharding as sharding_t
from chronoedit_tpu_torch.parallel.launch import run_world
from test_torch_dit import randomize
from test_torch_fsdp import QUANT_MODES, _TRANSPOSED, _layer, _port_name, dit_inputs, tiny
import test_torch_fsdp_workers as FW
import test_torch_tp_workers as W

torch.set_num_threads(2)

DIT_TOL = 2e-4
GRAD_REL = 1e-4
RMS_TOL = 1e-5
TIMEOUT = 120.0
REPO = Path(__file__).resolve().parents[1]
# evenly spaced int4 levels for both packages in place of the Lloyd search
LEVELS = tuple(float(v) for v in np.linspace(-1.0, 1.0, 15))


def wide(mod, heads: int, ffn: int):
    """The tiny DiT with ``heads`` heads of 128 and ``ffn_dim`` ``ffn``: every
    tensor rank's rows of o and fc2 are whole 128-row int4 groups."""
    rope = (RopeJ if mod is dit_j else RopeT)(head_dim=128, temporal_skip_len=8)
    return tiny(mod, num_heads=heads, head_dim=128, ffn_dim=ffn, rope=rope)


# ------------------------------------------------------------ placement

def jax_plan(tree, t: int, f: int) -> dict:
    """{port name: (tensor dim, fsdp dim)}: JAX's ``dit_param_sharding`` on
    a mesh of tensor ``t`` x fsdp ``f`` (its data axis filling the 8
    devices), mapped through the stacked axis and the transposition."""
    spec_fn = sharding_j(make_mesh_j(MeshConfigJ(data=8 // (t * f), fsdp=f, tensor=t)))
    plan = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name, stacked, jax_leaf = _port_name(path)
        spec = spec_fn(path, leaf).spec
        dims = []
        for axis in ("tensor", "fsdp"):
            found = [a for a, s in enumerate(spec) if s == axis]
            dim = found[0] if found else None
            if dim is not None and stacked:
                assert dim > 0, name
                dim -= 1
            if dim is not None and jax_leaf in _TRANSPOSED:
                dim = 1 - dim
            dims.append(dim)
        for layer in (range(leaf.shape[0]) if stacked else [None]):
            plan[_layer(name, layer)] = tuple(dims)
    return plan


def port_plan(model, t: int, f: int) -> dict:
    mesh = mesh_t.Mesh((1, 8 // (t * f), f, t, 1), 0, torch.device("cpu"))
    return {n: tuple(s) for n, s in sharding_t.param_spec_tree(model, mesh).items()}


@pytest.fixture
def flat_codebook(monkeypatch):
    """Both packages' Lloyd codebook replaced by evenly spaced levels."""
    monkeypatch.setattr(quant_j, "_lloyd_levels", lambda eff_group: LEVELS)
    monkeypatch.setattr(quant_t, "_lloyd_levels", lambda eff_group: LEVELS)


@pytest.mark.parametrize("t,f", [(2, 1), (4, 1), (8, 1), (2, 2), (2, 4), (4, 2)])
def test_placement_matches_jax_14b(t, f):
    """The 14B DiT (the port's on ``meta``, JAX's by ``jax.eval_shape``):
    for every leaf the port's (tensor, fsdp) dimensions are JAX's; q / k /
    v / k_img / v_img / fc1 split their out-dimension (the port's dim 0),
    o / fc2 their in-dimension (dim 1), and fsdp never takes the tensor
    dimension."""
    tree = jax.eval_shape(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), big_j().dit))
    model = dit_t.DiT(big_t().dit, device="meta")
    got = port_plan(model, t, f)
    assert got == jax_plan(tree, t, f)
    assert got["blocks.3.self_attn.q.weight"][0] == 0 == got["blocks.3.ffn.fc1.bias"][0]
    assert got["blocks.3.self_attn.o.weight"][0] == 1 == got["blocks.3.ffn.fc2.weight"][0]
    assert got["blocks.3.ffn.fc2.bias"][0] is None and got["patch_embed.weight"][0] is None
    assert sum(s[0] is not None for s in got.values()) == 40 * (2 * 9 + 3)
    assert all(s[0] != s[1] for s in got.values() if s[0] is not None)


@pytest.mark.parametrize("t,f", [(2, 1), (4, 1), (2, 2)])
@pytest.mark.parametrize("mode", (None,) + QUANT_MODES)
def test_placement_matches_jax_tiny(flat_codebook, mode, t, f):
    """The tiny preset, unquantized and in each quantized mode (the port's
    ``quantize_dit``, JAX's ``quantize_dit_params`` traced by
    ``jax.eval_shape``): the same (tensor, fsdp) dimensions for every leaf,
    JAX's guard included (a row-split int4 leaf's packed and group axes
    split only where the degree divides them: at tensor 4 the one group
    stays whole)."""
    cfg_j = tiny(dit_j)

    def init():
        params = dit_j.init_dit_params(jax.random.PRNGKey(0), cfg_j)
        return params if mode is None else quant_j.quantize_dit_params(params, mode=mode)

    model = dit_t.init_dit_params(tiny(dit_t), torch.Generator().manual_seed(0))
    if mode is not None:
        quant_t.quantize_dit(model, mode=mode)
    got = port_plan(model, t, f)
    assert got == jax_plan(jax.eval_shape(init), t, f)
    if mode in ("int4", "int4_a8"):
        assert (got["blocks.0.ffn.fc2.scales"][0] is None) == (t == 4)


# ------------------------------------------------------------ int4 rows

@pytest.mark.parametrize("din,tp", [(512, 2), (1536, 4), (256, 2)])
@pytest.mark.parametrize("grid", ["uniform", "lloyd"])
def test_int4_rows_are_local_quantization(flat_codebook, din, tp, grid):
    """``int4_rows`` of a whole int4 leaf (its contiguous rows repacked,
    an odd group count padded with a zero group) is bitwise what
    quantizing each rank's rows alone gives; its product on the rank's
    columns sums over the ranks to the whole leaf's; rows that are not
    whole 128-row groups raise."""
    from chronoedit_tpu_torch.ops import layers as L

    g = torch.Generator().manual_seed(din)
    lin = L.Linear(din, 64, generator=g)
    with torch.no_grad():
        lin.bias.normal_(generator=g)
    whole = quant_t.quantize_linear_params_int4(lin, grid=grid)
    x = torch.randn(3, din, generator=g)
    total = 0
    n = din // tp
    for i in range(tp):
        part = quant_t.int4_rows(whole, i, tp)
        local = L.Linear(n, 64)
        with torch.no_grad():
            local.weight.copy_(lin.weight[:, i * n:(i + 1) * n])
            local.bias.copy_(lin.bias)
        want = quant_t.quantize_linear_params_int4(local, grid=grid)
        for key, t in want.state_dict().items():
            assert torch.equal(part.state_dict()[key], t), key
        assert part.scales.shape[0] % 2 == 0 and part.in_features == n
        total = total + quant_t.quantized_linear_int4(part, x[:, i * n:(i + 1) * n], bias=False)
    np.testing.assert_allclose((total + whole.bias).numpy(),
                               quant_t.quantized_linear_int4(whole, x).numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="128-row groups"):
        quant_t.int4_rows(whole, 0, din // 64)


# ------------------------------------------------------------ the worlds

@pytest.fixture(scope="module")
def weights():
    """Seeded numpy DiT trees (JAX layout): the tiny preset, its 4-head
    variant, and the wide variants for the int4 cases."""
    def draw(cfg, seed):
        return randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg), seed)

    return {"tiny": draw(tiny(dit_j), 5), "heads4": draw(tiny(dit_j, num_heads=4), 6),
            "wide2": draw(wide(dit_j, 2, 512), 7), "wide4": draw(wide(dit_j, 4, 1536), 8)}


CONFIGS = {"tiny": {}, "heads4": dict(num_heads=4)}


def config(name: str, mod, **kw):
    if name.startswith("wide"):
        cfg = wide(mod, *((2, 512) if name == "wide2" else (4, 1536)))
        return dataclasses.replace(cfg, **kw)
    return tiny(mod, **CONFIGS[name], **kw)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny checkpoint directory and a diffusers LoRA file."""
    from safetensors.numpy import save_file

    from chronoedit_tpu.configs import chronoedit_tiny as tiny_j
    from chronoedit_tpu.models import vae as vae_j
    from test_torch_weights import lora_file, write_checkpoint

    cfg = tiny_j()
    dit_p = randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg.dit), 21)
    vae_p = randomize(lambda: vae_j.init_vae_params(jax.random.PRNGKey(1), cfg.vae), 22,
                      fan_in=lambda s: int(np.prod(s[:-1])))
    root = tmp_path_factory.mktemp("tp_ckpt")
    write_checkpoint(root / "ck", dit_p, vae_p)
    lora = str(root / "edit_lora.safetensors")
    save_file({k: np.asarray(v) for k, v in lora_file("diffusers").items()}, lora)
    return str(root / "ck"), lora


MASK = np.array([1.0, 0.0], np.float32)
# (case, weights, config of the DiT, batch, mesh, kwargs of dit_tp)
TWO = [
    ("tensor", "tiny", {}, 1, dict(tensor=2), {}),
    ("batch", "tiny", {}, 2, dict(tensor=2), {}),
    ("grads", "tiny", {}, 1, dict(tensor=2), dict(grads=True)),
    ("grads_full", "tiny", dict(remat="full"), 1, dict(tensor=2), dict(grads=True)),
    ("mask", "tiny", {}, 2, dict(tensor=2), dict(kw=dict(layer_mask=MASK))),
    ("lora_merged", "tiny", {}, 1, dict(tensor=2), dict(lora="merged")),
    ("lora_attached", "tiny", {}, 1, dict(tensor=2), dict(lora="attached")),
]
FOUR = [
    ("tensor4", "heads4", {}, 1, dict(tensor=4), {}),
    ("grads4", "heads4", {}, 1, dict(tensor=4), dict(grads=True)),
    ("fsdp", "tiny", {}, 1, dict(tensor=2, fsdp=2), {}),
    ("fsdp_grads_split", "tiny", {}, 2, dict(tensor=2, fsdp=2), dict(grads=True)),
    ("ring", "tiny", dict(context_parallel="ring"), 1, dict(tensor=2, context=2), {}),
    ("ulysses", "heads4", dict(context_parallel="ulysses"), 1, dict(tensor=2, context=2), {}),
    ("auto_ring", "tiny", {}, 1, dict(tensor=2, context=2), {}),
    ("auto_ulysses", "heads4", {}, 1, dict(tensor=2, context=2), {}),
    ("cache", "tiny", {}, 2, dict(data=2, tensor=2),
     dict(kw=dict(cache_blocks=(0, 1), cache_refresh=False))),
]
# (case, weights, mode, mesh)
QUANT_TWO = [(f"q_{m}", "wide2", m, dict(tensor=2)) for m in QUANT_MODES]
QUANT_FOUR = [(f"q_{m}_fsdp", "wide2", m, dict(tensor=2, fsdp=2)) for m in QUANT_MODES] + [
    ("q_int4_tensor4", "wide4", "int4", dict(tensor=4))]
MESHES = [dict(tensor=4), dict(tensor=2, context=2), dict(data=2, tensor=2),
          dict(fsdp=2, tensor=2), dict(pipe=2, tensor=2), dict(pipe=2, fsdp=2), dict(data=3)]


def _jobs(cases, weights):
    jobs = {}
    for name, wname, cfg, b, mesh, kw in cases:
        cfg_t = config(wname, dit_t, **cfg)
        jobs[name] = ("dit_tp", (cfg_t, weights[wname], dit_inputs(cfg_t, b), mesh,
                                 bool(kw.get("grads")), kw.get("kw"), kw.get("lora")))
    return jobs


def _quant_jobs(cases, weights):
    return {name: ("quantized_tp", (config(wname, dit_t), weights[wname],
                                    dit_inputs(config(wname, dit_t)), mesh, mode, LEVELS))
            for name, wname, mode, mesh in cases}


RMS_X = np.random.default_rng(3).standard_normal((2, 6, 64)).astype(np.float32)
RMS_W = (1.0 + 0.1 * np.random.default_rng(4).standard_normal(64)).astype(np.float32)


def run_jobs(tmp_dir: str, n: int, jobs: dict) -> dict:
    got = run_world(W.run_jobs, n, (list(jobs.values()),), timeout=TIMEOUT, tmp_dir=tmp_dir)
    return {key: [rank[i] for rank in got] for i, key in enumerate(jobs)}


def jax_mesh(mesh_config: dict):
    c = dict(mesh_config)
    c["data"] = 8 // (c.get("fsdp", 1) * c.get("tensor", 1) * c.get("context", 1))
    return make_mesh_j(MeshConfigJ(**c))


def jax_forward(params, cfg, inputs, mesh_config: dict, **kw):
    """JAX's forward with its parameters sharded by its own
    ``dit_param_sharding`` on a mesh of ``mesh_config`` (its data axis
    filling the 8 devices), the mesh given to the forward when it has a
    context axis."""
    mesh = jax_mesh(mesh_config)
    args = [jnp.asarray(a) for a in inputs]
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    if "context" in mesh_config:
        kw["mesh"] = mesh
    with mesh:
        sharded = shard_params_j(params, mesh, sharding_j(mesh))
        out = jax.jit(lambda p, *a: dit_j.dit_forward(p, cfg, *a, **kw))(sharded, *args)
    return np.asarray(out[0] if isinstance(out, tuple) else out)


def jax_grads(params, cfg, inputs) -> dict:
    """{port name: JAX's gradient of ``sum(out ** 2)``} in the port's
    layout (one process; the split forward computes the same function)."""
    args = [jnp.asarray(a) for a in inputs]
    grads = jax.jit(jax.grad(lambda p: jnp.sum(dit_j.dit_forward(p, cfg, *args) ** 2)))(
        jax.tree.map(jnp.asarray, params))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, grads))[0]:
        name, stacked, jax_leaf = _port_name(path)
        for layer in (range(leaf.shape[0]) if stacked else [None]):
            g = leaf[layer] if layer is not None else leaf
            want[_layer(name, layer)] = np.array(g.T if jax_leaf in _TRANSPOSED else g)
    return want


def jax_rms(world: int) -> tuple:
    """JAX's ``rms_norm_fused`` on a mesh with a tensor axis of ``world``
    (the rest context), its output and the gradients of x and the weight
    through ``sum(out ** 2)``."""
    mesh = MeshJ(np.array(jax.devices()).reshape(world, 8 // world), ("tensor", "context"))
    x, w = jnp.asarray(RMS_X), {"scale": jnp.asarray(RMS_W)}

    def fwd(w, x):
        return fn_j.rms_norm_fused(w, x, 1e-6, mesh=mesh)

    out = jax.jit(fwd)(w, x)
    dw, dx = jax.jit(jax.grad(lambda w, x: jnp.sum(fwd(w, x) ** 2), argnums=(0, 1)))(w, x)
    return np.asarray(out), np.asarray(dx), np.asarray(dw["scale"])


def jax_references(weights) -> dict:
    """Every JAX reading the tests compare with, by case."""
    refs = {}
    for name, wname, cfg, b, mesh, kw in TWO + FOUR:
        cfg_j = config(wname, dit_j, **cfg)
        if not kw.get("lora"):
            refs[name] = jax_forward(weights[wname], cfg_j, dit_inputs(cfg_j, b), mesh,
                                     **dict(kw.get("kw") or {}))
        if kw.get("grads"):
            refs[f"{name} grads"] = jax_grads(weights[wname], config(wname, dit_j),
                                              dit_inputs(cfg_j, b))
    quant_j._lloyd_levels = lambda eff_group: LEVELS
    for name, wname, mode, mesh in QUANT_TWO + QUANT_FOUR:
        if "fsdp" in mesh:
            continue  # fsdp splits nothing the quantized math sees: held to one process
        cfg_j = config(wname, dit_j)
        params = quant_j.quantize_dit_params(jax.tree.map(jnp.asarray, weights[wname]),
                                             mode=mode)
        refs[name] = jax_forward(params, cfg_j, dit_inputs(cfg_j), mesh)
    for world in (2, 4):
        refs[f"rms{world}"] = jax_rms(world)
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory, weights, checkpoint):
    """The worlds of 2 and 4 (every case of each: results by case, each a
    list by rank), started together in the background while this process
    computes JAX's references; (world of 2, world of 4, JAX)."""
    two = {**_jobs(TWO, weights), **_quant_jobs(QUANT_TWO, weights)}
    two["loader"] = ("load_tp", (tiny_t(), *checkpoint, dict(tensor=2),
                                 FW.edit_inputs(tiny_t())))
    two["rms"] = ("rms_tp", (RMS_X, RMS_W, dict(tensor=2)))
    four = {**_jobs(FOUR, weights), **_quant_jobs(QUANT_FOUR, weights)}
    four["loader"] = ("load_tp", (tiny_t(), *checkpoint, dict(tensor=2, fsdp=2),
                                  FW.edit_inputs(tiny_t())))
    four["rms"] = ("rms_tp", (RMS_X, RMS_W, dict(tensor=4)))
    four["meshes"] = ("mesh_checks", (MESHES, tiny(dit_t)))
    levels = quant_j._lloyd_levels
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        worlds = [pool.submit(run_jobs, str(tmp_path_factory.mktemp(f"tp_world{n}")), n, jobs)
                  for n, jobs in ((2, two), (4, four))]
        try:
            refs = jax_references(weights)
        finally:
            quant_j._lloyd_levels = levels
        return worlds[0].result(), worlds[1].result(), refs


def results(runs, world: int, case: str):
    return runs[0 if world == 2 else 1][case]


def rank_shards(r: dict, mesh: dict, rank: int) -> list:
    """The rank's (tensor, fsdp) ``Shards`` from its plans."""
    shape = tuple(mesh.get(a, 1) for a in mesh_t.MESH_AXES)
    coords = mesh_t.mesh_coords(shape, rank)
    return [sharding_t.Shards(mesh[a], coords[a], r["plans"][a])
            for a in ("tensor", "fsdp") if r["plans"][a] is not None]


def local(shards: list, name: str, t: np.ndarray) -> np.ndarray:
    out = torch.from_numpy(t)
    for s in shards:
        out = s.local(out, s.dims.get(name))
    return out.numpy()


ALL = [(2, c[0]) for c in TWO] + [(4, c[0]) for c in FOUR]
CASES = {c[0]: c[1:] for c in TWO + FOUR}
# the block the mask skips, and the cached block a step without refresh skips
SKIPPED = {"mask": 1, "cache": 1}


@pytest.mark.parametrize("world,case", ALL)
def test_tp_forward_matches_jax(runs, world, case):
    """The tiny DiT split with ``shard_params`` under each mesh: every
    rank's velocity against JAX's forward on its sharded parameters and
    against the port's one process, within 2e-4; every rank bitwise alike;
    each leaf this rank's block of its plans' dimensions; K4's tensor form
    five times and the row reduce three times a block run (again in remat's
    recompute), none in a block that the layer mask or the block cache
    skips; the ring or Ulysses once a block under context, as the mode
    asks ("auto": Ulysses when the rank's heads divide the context
    degree)."""
    wname, cfg, b, mesh, kw = CASES[case]
    cfg_t = config(wname, dit_t, **cfg)
    got = results(runs, world, case)
    whole = {n: tuple(p.shape) for n, p in dit_t.DiT(cfg_t, device="meta").named_parameters()}
    blocks = cfg_t.num_layers - (case in SKIPPED)
    blocks *= 2 if cfg.get("remat", "none") != "none" else 1
    mode = cfg.get("context_parallel")
    if case.startswith("auto"):
        mode = "ulysses" if (cfg_t.num_heads // mesh["tensor"]) % mesh["context"] == 0 else "ring"
    for rank, r in enumerate(got):
        np.testing.assert_array_equal(r["out"], got[0]["out"])
        np.testing.assert_allclose(r["out"], r["one"], rtol=DIT_TOL, atol=DIT_TOL)
        for name, shape in r["shapes"].items():
            want = list(whole[name])
            for s in rank_shards(r, mesh, rank):
                if s.dims[name] is not None:
                    want[s.dims[name]] //= s.size
            assert shape == tuple(want), name
        assert r["calls"] == {"ring": 0, "ulysses": 0, **({mode: blocks} if mode else {}),
                              "k4": 5 * blocks, "reduce": 3 * blocks}
    if kw.get("lora"):
        return  # the adapters are the port's own draw: held against one process
    np.testing.assert_allclose(got[0]["out"], runs[2][case], rtol=DIT_TOL, atol=DIT_TOL)


GRAD_CASES = [(w, c) for w, c in ALL if "grads" in c]


@pytest.mark.parametrize("world,case", GRAD_CASES)
def test_tp_gradients_match_jax(runs, world, case):
    """Full-parameter gradients of ``sum(out ** 2)`` through the split
    forward: each rank's gradient of each leaf against its block of
    ``jax.grad`` within 1e-4 of the largest gradient (the replicated q / k
    norm scales, which each rank uses a slice of, summed over the tensor
    group), under remat "none" and "full", at tensor 2 and 4 and over
    tensor 2 x fsdp 2 with the batch split; against the port's one process
    too."""
    wname, cfg, b, mesh, _ = CASES[case]
    got = results(runs, world, case)
    want = runs[2][f"{case} grads"]
    atol = GRAD_REL * max(float(np.abs(g).max()) for g in want.values())
    for rank, r in enumerate(got):
        shards = rank_shards(r, mesh, rank)
        assert r["grads"].keys() == want.keys()
        for name, g in r["grads"].items():
            np.testing.assert_allclose(g, local(shards, name, want[name]), atol=atol,
                                       err_msg=name)
            np.testing.assert_allclose(g, local(shards, name, r["one_grads"][name]), atol=atol,
                                       err_msg=name)


QUANT = {c[0]: c[1:] for c in QUANT_TWO + QUANT_FOUR}


@pytest.mark.parametrize("world,case", [(2, c[0]) for c in QUANT_TWO] +
                         [(4, c[0]) for c in QUANT_FOUR])
def test_tp_quantized_matches_jax(runs, world, case):
    """``quantize_dit`` under each mesh on the split model against
    quantizing the whole model and splitting it (JAX's order): every leaf
    bitwise (int4 row leaves repacked from their contiguous rows; fc2 at
    tensor 4 holds 3 groups of rows padded to 4), the same plans; the
    quantized forward within 2e-4 of the whole quantized model's in one
    process and (but over fsdp, which splits nothing that the quantized
    math sees) of JAX's quantized forward on its sharded parameters. With
    int8 activations (w8a8, w4a8) a rank's own per-token scale misses that
    bound: the row layers' scale is the whole row's."""
    _, mode, _ = QUANT[case]
    got = results(runs, world, case)
    for r in got:
        assert r["names"] and r["plans_equal"]
        assert len(r["bitwise"]) == r["leaves"]
        np.testing.assert_allclose(r["out"], r["one"], rtol=DIT_TOL, atol=DIT_TOL)
        if mode != "int4":
            assert not np.allclose(r["local_scale"], r["one"], rtol=DIT_TOL, atol=DIT_TOL)
    if case == "q_int4_tensor4":
        assert got[0]["fc2"] == (512, 256)  # 384 local rows: 3 groups padded to 4
    if case in runs[2]:
        np.testing.assert_allclose(got[0]["out"], runs[2][case], rtol=DIT_TOL, atol=DIT_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_rms_tensor_matches_jax(runs, world):
    """K4's tensor form on each rank's columns (its twins on the CPU: the
    local sums of squares, one all-reduce, the normalisation by the whole
    row's statistics, the rank's slice of the weight) against JAX's
    ``rms_norm_fused`` on a mesh with a tensor axis of the same degree,
    within 1e-5; the gradients of x and of the replicated weight (summed
    over the ranks) against ``jax.grad`` within 1e-5 of the largest."""
    out, dx, dw = runs[2][f"rms{world}"]
    for r in results(runs, world, "rms"):
        np.testing.assert_allclose(r["out"], out, atol=RMS_TOL)
        for got, want in ((r["dx"], dx), (r["dw"], dw)):
            np.testing.assert_allclose(got, want, atol=RMS_TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("world", [2, 4])
def test_loader_reads_only_its_slices(runs, checkpoint, world):
    """``load_pipeline`` under tensor 2 (and tensor 2 x fsdp 2) from a tiny
    checkpoint directory with a diffusers LoRA (scale 0.8): every parameter
    bitwise this rank's slice of the one-process load (the LoRA-fused ones
    included); the bytes read from the DiT shards exactly this rank's
    slices, from the files' headers; a 2-step edit within 2e-4 of the
    one-process pipeline's."""
    ckpt, _ = checkpoint
    shards = [str(p) for p in sorted(Path(ckpt, "transformer").glob("*.safetensors"))]
    names = w_t.diffusers_dit_names(tiny_t().dit)
    with w_t.load_safetensors(shards) as sd:
        files = {k.removeprefix("transformer."): sd.nbytes(k) for k in sd}
    for r in results(runs, world, "loader"):
        assert len(r["bitwise"]) == r["params"]
        want = 0
        for key, n in files.items():
            if key in names:
                for axis in ("tensor", "fsdp"):
                    plan = r["plans"][axis]
                    n //= 2 if plan is not None and plan[names[key]] is not None else 1
                want += n
        assert r["bytes"]["dit"] == want < r["whole_bytes"]["dit"]
        assert sum(d is not None for d in r["plans"]["tensor"].values()) == 2 * (2 * 9 + 3)
        np.testing.assert_allclose(r["out"], r["one"], rtol=DIT_TOL, atol=DIT_TOL)


def test_mesh_tensor_axis(runs):
    """``make_mesh`` builds the tensor groups alone and beside data,
    context and fsdp (consecutive ranks when tensor is innermost but for
    context); under a pipe axis ``gpipe_scan`` warns that it replicates
    tensor inside the stages, whose DiT stays whole; a DiT whose heads the
    tensor degree does not divide raises ValueError; pipe x fsdp makes a
    mesh (pipe lines across the fsdp pairs, no warning, the DiT whole over
    tensor); degrees that do not fill the world still raise ValueError."""
    tensor4, tc, dt, ft, pt, pf, bad = zip(*runs[1]["meshes"])
    assert [r["groups"]["tensor"] for r in tensor4] == [[0, 1, 2, 3]] * 4
    assert all("shard_error" in r and "heads" in r["shard_error"] for r in tensor4)
    assert [r["groups"]["tensor"] for r in tc] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    assert [r["groups"]["context"] for r in tc] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    for rows in (dt, ft):
        assert [r["groups"]["tensor"] for r in rows] == [[0, 1], [0, 1], [2, 3], [2, 3]]
        assert all(r["tensor"] == 2 for r in rows)
    assert [r["groups"]["fsdp"] for r in ft] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    for r in pt:
        assert r["tensor"] is None
        assert any("'tensor' axis inside stages" in w for w in r["warnings"])
    assert [r["groups"]["pipe"] for r in pf] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    assert [r["groups"]["fsdp"] for r in pf] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    assert all(r["tensor"] is None and not r["warnings"] for r in pf)
    assert all(r["error"].startswith("ValueError") for r in bad)


def test_whole_model_under_tensor_mesh_raises():
    """A whole DiT given a tensor mesh raises before any collective."""
    mesh = mesh_t.Mesh((1, 1, 1, 2, 1), 0, torch.device("cpu"), {"tensor": None})
    args = [torch.from_numpy(a) for a in dit_inputs(tiny(dit_j))]
    with pytest.raises(ValueError, match="shard_params"):
        dit_t.dit_forward(dit_t.DiT(tiny(dit_t)), *args, mesh=mesh)


def test_run_inference_tensor_under_torchrun(tmp_path):
    """``run_inference --mesh tensor=2 --smoke --device cpu`` under
    ``torch.distributed.run --nproc-per-node 2``: each rank splits the
    seeded tiny model, rank 0 writes the edit, within one 8-bit level of
    the single process's PNG (the row sums and K4's statistics are summed
    over the ranks in another order)."""
    from PIL import Image

    args = ["-m", "chronoedit_tpu_torch.scripts.run_inference", "--smoke", "--device", "cpu"]
    runs = {"single": [sys.executable, *args],
            "mesh": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc-per-node", "2", *args, "--mesh", "tensor=2"]}
    for name, cmd in runs.items():
        proc = subprocess.run([*cmd, "--output", str(tmp_path / f"{name}.png")], cwd=REPO,
                              capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "mesh {'pipe': 1, 'data': 1, 'fsdp': 1, 'tensor': 2" in proc.stdout
    single = np.asarray(Image.open(tmp_path / "single.png")).astype(np.int16)
    assert single.std() > 0
    mesh = np.asarray(Image.open(tmp_path / "mesh.png")).astype(np.int16)
    assert np.abs(mesh - single).max() <= 1
