"""FSDP against JAX: the placement of every DiT leaf, the sharded forward
and its gradients, quantizing and loading under an fsdp mesh, and
``run_inference --mesh fsdp=``.

The port's side runs in one world of 2 and one of 4 gloo processes on the
CPU, each started once for the file (``test_torch_fsdp_workers.py`` through
``parallel.launch.run_world``: spawned workers, a ``file://`` rendezvous
under the test's temporary directory, each world ended within its own
timeout, a barrier after joining); JAX's runs in this process on its 8
virtual CPU devices, with the parameters sharded by its own
``shard_params(..., dit_param_sharding(mesh))``, as its
``tests/test_parallel.py`` runs it. The same seeded numpy weights and inputs
go to both (``models/from_jax.py``); fp32.

Bounds: the forward within 2e-4 (rtol and atol) of JAX's sharded forward,
JAX's own bound for it (``tests/test_parallel.py``); the shard gradients
within 1e-4 of the largest gradient of ``jax.grad`` (the port's CP
gradient bound); against the port's one process in the rank's own
process, bitwise where every rank runs the whole batch on all the tokens
(the gathered weights are the whole model's bits), within the forward's
bound where the batch or the tokens split; quantized leaves, loaded shards and the CLI's PNG bitwise.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.configs import chronoedit_14b as big_j
from chronoedit_tpu.configs import chronoedit_tiny as tiny_j
from chronoedit_tpu.models import dit as dit_j
from chronoedit_tpu.models import vae as vae_j
from chronoedit_tpu.ops import quant as quant_j
from chronoedit_tpu.parallel import MeshConfig as MeshConfigJ
from chronoedit_tpu.parallel import make_mesh as make_mesh_j
from chronoedit_tpu.parallel.sharding import dit_param_sharding as sharding_j
from chronoedit_tpu.parallel.sharding import shard_params as shard_params_j
from chronoedit_tpu_torch.configs import chronoedit_14b as big_t
from chronoedit_tpu_torch.configs import chronoedit_tiny as tiny_t
from chronoedit_tpu_torch.models import dit as dit_t
from chronoedit_tpu_torch.models import weights as w_t
from chronoedit_tpu_torch.ops import quant as quant_t
from chronoedit_tpu_torch.parallel import mesh as mesh_t
from chronoedit_tpu_torch.parallel import sharding as sharding_t
from chronoedit_tpu_torch.parallel.launch import run_world
from test_torch_dit import randomize
import test_torch_fsdp_workers as W

torch.set_num_threads(2)

DIT_TOL = 2e-4
GRAD_REL = 1e-4
TIMEOUT = 120.0
REPO = Path(__file__).resolve().parents[1]
DEGREES = (2, 4, 8)
QUANT_MODES = ("int8", "int4", "int4_a8")

# JAX leaf name -> the port's, for the quantized leaves and the kernel
_LEAVES = {"kernel": "weight", "kernel_q": "weight_q", "kernel_q4": "packed",
           "kernel_scale": "weight_scale", "kernel_scale4": "scales",
           "kernel_lut4": "table", "kernel_scale8": "scale8"}
_TRANSPOSED = ("kernel", "kernel_q", "kernel_q4")


def tiny(mod, **kw):
    return dataclasses.replace((tiny_j if mod is dit_j else tiny_t)().dit, **kw)


def dit_inputs(cfg, b=1, t=2, h=4, w=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cfg.in_channels, t, h, w)).astype(np.float32)
    ts = rng.uniform(0, 1000, (b,)).astype(np.float32)
    text = rng.standard_normal((b, 7, cfg.text_dim)).astype(np.float32)
    img = rng.standard_normal((b, cfg.image_tokens, cfg.image_dim)).astype(np.float32)
    return x, ts, text, img


def _port_name(path) -> tuple[str, bool, str]:
    """(the port's name, stacked over blocks, the JAX leaf name) of a JAX
    DiT leaf; a block leaf's name without its layer index."""
    keys = [str(getattr(k, "key", k)) for k in path]
    return ".".join(keys[:-1] + [_LEAVES.get(keys[-1], keys[-1])]), keys[0] == "blocks", keys[-1]


def _layer(name: str, layer: int | None) -> str:
    return name if layer is None else name.replace("blocks.", f"blocks.{layer}.", 1)


def jax_leaves(tree):
    """(port name, layer or None, JAX leaf name, array) of every leaf of a
    JAX DiT tree, a block leaf once per layer."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name, stacked, jax_leaf = _port_name(path)
        for layer in (range(leaf.shape[0]) if stacked else [None]):
            yield _layer(name, layer), layer, jax_leaf, leaf


def jax_plan(tree, f: int) -> dict:
    """{port name: the port's dimension of JAX's fsdp axis, or None}: JAX's
    ``dit_param_sharding`` on a mesh of data 8 / f x fsdp f, mapped
    through the stacked axis and the transposition."""
    spec_fn = sharding_j(make_mesh_j(MeshConfigJ(data=8 // f, fsdp=f)))
    plan = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name, stacked, jax_leaf = _port_name(path)
        axes = [a for a, s in enumerate(spec_fn(path, leaf).spec) if s == "fsdp"]
        dim = axes[0] if axes else None
        if dim is not None and stacked:
            assert dim > 0, name  # never the stacked layer axis
            dim -= 1
        if dim is not None and jax_leaf in _TRANSPOSED:
            dim = 1 - dim
        for layer in (range(leaf.shape[0]) if stacked else [None]):
            plan[_layer(name, layer)] = dim
    return plan


def port_plan(model, f: int) -> dict:
    mesh = mesh_t.Mesh((1, 8 // f, f, 1, 1), 0, torch.device("cpu"))
    return {n: spec.fsdp for n, spec in sharding_t.param_spec_tree(model, mesh).items()}


@pytest.fixture
def flat_codebook(monkeypatch):
    """Both packages' Lloyd codebook replaced by evenly spaced levels: the
    placement needs the leaves' shapes, not the 13-16 s search."""
    levels = tuple(float(v) for v in np.linspace(-1.0, 1.0, 15))
    monkeypatch.setattr(quant_j, "_lloyd_levels", lambda eff_group: levels)
    monkeypatch.setattr(quant_t, "_lloyd_levels", lambda eff_group: levels)


# ------------------------------------------------------------ placement

@pytest.mark.parametrize("f", DEGREES)
def test_placement_matches_jax_14b(f):
    """The 14B DiT (the port's on ``meta``, JAX's by ``jax.eval_shape``):
    for every leaf the port's plan names JAX's dimension; no leaf stays
    whole, and every square projection splits its in-dimension (the port's
    dim 1), which the rule run on the port's own (out, in) shapes would
    miss."""
    tree = jax.eval_shape(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), big_j().dit))
    model = dit_t.DiT(big_t().dit, device="meta")
    got, want = port_plan(model, f), jax_plan(tree, f)
    assert got == want
    assert None not in got.values()
    square = {n: d for n, d in got.items() if n.endswith(".weight")
              and len(set(dict(model.named_parameters())[n].shape)) == 1}
    assert len(square) == 40 * 10 + 3 and set(square.values()) == {1}
    naive = {n: sharding_t.fsdp_dim("x", tuple(dict(model.named_parameters())[n].shape), f)
             for n in square}
    assert set(naive.values()) == {0}


@pytest.mark.parametrize("f", DEGREES)
@pytest.mark.parametrize("mode", (None,) + QUANT_MODES)
def test_placement_matches_jax_tiny(flat_codebook, mode, f):
    """The tiny preset, unquantized and in each quantized mode (the port's
    ``quantize_dit``, JAX's ``quantize_dit_params`` traced by
    ``jax.eval_shape``): the same dimension for every leaf; the image
    embedder's 10-wide leaves stay whole at 4 and 8."""
    cfg_j = tiny(dit_j)

    def init():
        params = dit_j.init_dit_params(jax.random.PRNGKey(0), cfg_j)
        return params if mode is None else quant_j.quantize_dit_params(params, mode=mode)

    model = dit_t.init_dit_params(tiny(dit_t), torch.Generator().manual_seed(0))
    if mode is not None:
        quant_t.quantize_dit(model, mode=mode)
    got = port_plan(model, f)
    assert got == jax_plan(jax.eval_shape(init), f)
    assert (got["img_embed.fc1.weight"] is None) == (f > 2)


# ------------------------------------------------------------ the worlds

@pytest.fixture(scope="module")
def params():
    return randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), tiny(dit_j)), 5)


@pytest.fixture(scope="module")
def trees():
    """Numpy DiT and VAE trees of the tiny preset (JAX layout)."""
    cfg = tiny_j()
    dit_p = randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg.dit), 21)
    vae_p = randomize(lambda: vae_j.init_vae_params(jax.random.PRNGKey(1), cfg.vae), 22,
                      fan_in=lambda s: int(np.prod(s[:-1])))
    return dit_p, vae_p


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, trees):
    """A tiny checkpoint directory and a diffusers LoRA file."""
    from safetensors.numpy import save_file

    from test_torch_weights import lora_file, write_checkpoint

    root = tmp_path_factory.mktemp("fsdp_ckpt")
    write_checkpoint(root / "ck", *trees)
    lora = str(root / "edit_lora.safetensors")
    save_file({k: np.asarray(v) for k, v in lora_file("diffusers").items()}, lora)
    return str(root / "ck"), lora


MASK = np.array([1.0, 0.0], np.float32)
# (case, config of the tiny DiT, batch, mesh, kwargs of dit_fsdp)
TWO = [
    ("unsplit", {}, 1, dict(fsdp=2), {}),
    ("split", {}, 2, dict(fsdp=2), {}),
    ("grads_unsplit", {}, 1, dict(fsdp=2), dict(grads=True)),
    ("grads_split", {}, 2, dict(fsdp=2), dict(grads=True)),
    ("grads_full", dict(remat="full"), 2, dict(fsdp=2), dict(grads=True)),
    ("grads_matmul_only", dict(remat="matmul_only"), 2, dict(fsdp=2), dict(grads=True)),
    ("mask", {}, 2, dict(fsdp=2), dict(kw=dict(layer_mask=MASK))),
    ("cache", {}, 2, dict(fsdp=2), dict(kw=dict(cache_blocks=(0, 1), cache_refresh=False))),
    ("lora_merged", {}, 1, dict(fsdp=2), dict(lora="merged")),
    ("lora_attached", {}, 1, dict(fsdp=2), dict(lora="attached")),
]
FOUR = [
    ("unsplit", {}, 1, dict(fsdp=4), {}),
    ("split", {}, 4, dict(fsdp=4), {}),
    ("grads_split", {}, 4, dict(fsdp=4), dict(grads=True)),
    ("data", {}, 2, dict(data=2, fsdp=2), {}),
    ("ring", dict(context_parallel="ring"), 1, dict(fsdp=2, context=2), {}),
    ("ulysses", dict(context_parallel="ulysses"), 1, dict(fsdp=2, context=2), {}),
    ("ulysses_split", dict(context_parallel="ulysses"), 2, dict(fsdp=2, context=2), {}),
]
ERRORS = [dict(pipe=2, fsdp=2), dict(fsdp=2, tensor=2), dict(fsdp=3)]


def _jobs(cases, params):
    return {name: ("dit_fsdp", (tiny(dit_t, **cfg), params, dit_inputs(tiny(dit_j), b),
                                mesh, bool(kw.get("grads")), kw.get("kw"), kw.get("lora")))
            for name, cfg, b, mesh, kw in cases}


def run_jobs(tmp_path_factory, n: int, jobs: dict) -> dict:
    got = run_world(W.run_jobs, n, (list(jobs.values()),), timeout=TIMEOUT,
                    tmp_dir=str(tmp_path_factory.mktemp(f"fsdp_world{n}")))
    return {key: [rank[i] for rank in got] for i, key in enumerate(jobs)}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, params, checkpoint):
    """Every case of the world of 2: results by case, each a list by rank."""
    jobs = _jobs(TWO, params)
    for mode in QUANT_MODES:
        jobs[mode] = ("quantized", (tiny(dit_t), params, dit_inputs(tiny(dit_j)),
                                    dict(fsdp=2), mode))
    jobs["loader"] = ("load_fsdp", (tiny_t(), *checkpoint, dict(fsdp=2),
                                    W.edit_inputs(tiny_t())))
    return run_jobs(tmp_path_factory, 2, jobs)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, params):
    """Every case of the world of 4: results by case, each a list by rank."""
    jobs = _jobs(FOUR, params)
    jobs["errors"] = ("mesh_errors", (ERRORS,))
    return run_jobs(tmp_path_factory, 4, jobs)


def results(two_ranks, four_ranks, world: int, case: str):
    return (two_ranks if world == 2 else four_ranks)[case]


def jax_forward(params, cfg, inputs, mesh_config: dict, **kw):
    """JAX's forward with its parameters sharded by its own
    ``dit_param_sharding`` on a mesh of ``mesh_config`` (its data axis
    filling the 8 devices), the mesh given to the forward when it has a
    context axis."""
    config = dict(mesh_config)
    config["data"] = 8 // (config.get("fsdp", 1) * config.get("context", 1))
    mesh = make_mesh_j(MeshConfigJ(**config))
    args = [jnp.asarray(a) for a in inputs]
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    if "context" in mesh_config:
        kw["mesh"] = mesh
    with mesh:
        sharded = shard_params_j(params, mesh, sharding_j(mesh))
        out = jax.jit(lambda p, *a: dit_j.dit_forward(p, cfg, *a, **kw))(sharded, *args)
    return np.asarray(out[0] if isinstance(out, tuple) else out)


def check_shapes(r, f: int):
    """Each leaf is this rank's block of the plan's dimension."""
    whole = {n: tuple(p.shape) for n, p in dit_t.DiT(tiny(dit_t), device="meta")
             .named_parameters()}
    for name, shape in r["shapes"].items():
        dim = r["dims"][name]
        want = list(whole[name])
        if dim is not None:
            want[dim] //= f
        assert shape == tuple(want), name


ALL = [(2, c) for c, *_ in TWO] + [(4, c) for c, *_ in FOUR]
# the block the mask skips, and the cached block a step without refresh
# skips: no rank gathers it
skipped = {"mask": 1, "cache": 0}


def gathers(dims: dict, skip: int | None) -> int:
    """The leaves one forward gathers: every split one, but those of a
    skipped block."""
    return sum(d is not None for n, d in dims.items()
               if skip is None or not n.startswith(f"blocks.{skip}."))


@pytest.mark.parametrize("world,case", ALL)
def test_fsdp_forward_matches_jax(two_ranks, four_ranks, params, world, case):
    """The tiny DiT sharded with ``shard_params`` under each mesh: every
    rank's velocity against JAX's forward on its sharded parameters within
    2e-4, and against the port's one process bitwise when neither the
    batch splits over fsdp nor the tokens over context (within 2e-4 when
    one does); every rank bitwise
    alike; each leaf this rank's block of its plan's dimension; every split
    leaf gathered once, but none of a block that the layer mask or the
    block cache skips (a recompute gathers a block again); ring or Ulysses
    called once a block under context, never otherwise."""
    cases = {c: (cfg, b, mesh, kw) for c, cfg, b, mesh, kw in (TWO if world == 2 else FOUR)}
    cfg, b, mesh, kw = cases[case]
    got = results(two_ranks, four_ranks, world, case)
    f = mesh["fsdp"]
    extra = dict(kw.get("kw") or {})
    lora = kw.get("lora")
    for r in got:
        np.testing.assert_array_equal(r["out"], got[0]["out"])
        check_shapes(r, f)
        if b % f and "context" not in mesh:
            np.testing.assert_array_equal(r["out"], r["one"])
        else:
            np.testing.assert_allclose(r["out"], r["one"], rtol=DIT_TOL, atol=DIT_TOL)
        mode = cfg.get("context_parallel")
        assert r["calls"] == {"ring": 0, "ulysses": 0, **({mode: 2} if mode else {})}
        want = gathers(r["dims"], skipped.get(case))
        if cfg.get("remat", "none") != "none":  # the backward's recompute
            want += sum(d is not None for n, d in r["dims"].items() if n.startswith("blocks."))
        assert r["gathers"] == want
    if lora:
        return  # the adapters are the port's own draw: held against one process
    want = jax_forward(params, tiny(dit_j, **cfg), dit_inputs(tiny(dit_j), b), mesh, **extra)
    np.testing.assert_allclose(got[0]["out"], want, rtol=DIT_TOL, atol=DIT_TOL)


GRAD_CASES = [(w, c) for w, c in ALL if c.startswith("grads")]


@pytest.mark.parametrize("world,case", GRAD_CASES)
def test_fsdp_gradients_match_jax(two_ranks, four_ranks, params, world, case):
    """Full-parameter gradients of ``sum(out ** 2)`` through the sharded
    forward: each rank's shard gradients against its block of ``jax.grad``
    within 1e-4 of the largest gradient, for a batch split over fsdp
    (reduce-scatter; the leaves kept whole at 4 summed by an all-reduce)
    and not (each rank's slice), under remat "none", "full" and
    "matmul_only"; unsplit, bitwise the port's one-process gradient's
    slices."""
    cases = {c: (cfg, b, mesh) for c, cfg, b, mesh, _ in (TWO if world == 2 else FOUR)}
    cfg, b, mesh = cases[case]
    f = mesh["fsdp"]
    got = results(two_ranks, four_ranks, world, case)
    cfg_j = tiny(dit_j)
    inputs = [jnp.asarray(a) for a in dit_inputs(cfg_j, b)]
    grads = jax.grad(lambda p: jnp.sum(dit_j.dit_forward(p, cfg_j, *inputs) ** 2))(
        jax.tree.map(jnp.asarray, params))
    want = {}
    for name, layer, leaf, g in jax_leaves(jax.tree.map(np.asarray, grads)):
        g = g[layer] if layer is not None else g
        want[name] = np.array(g.T if leaf in _TRANSPOSED else g)
    atol = GRAD_REL * max(float(np.abs(g).max()) for g in want.values())
    for rank, r in enumerate(got):
        shards = sharding_t.Shards(f, rank, r["dims"])
        assert r["grads"].keys() == want.keys()
        for name, g in r["grads"].items():
            block = shards.local(torch.from_numpy(want[name]), r["dims"][name]).numpy()
            np.testing.assert_allclose(g, block, atol=atol, err_msg=name)
            if b % f:
                one = shards.local(torch.from_numpy(r["one_grads"][name]), r["dims"][name])
                np.testing.assert_array_equal(g, one.numpy(), err_msg=name)


@pytest.mark.parametrize("mode", QUANT_MODES)
def test_quantize_under_fsdp(two_ranks, mode):
    """``quantize_dit`` on the sharded model (a gathered block at a time)
    against quantizing the whole model and sharding it after (JAX's
    order): every leaf bitwise, the same plan; the quantized forward under
    fsdp bitwise the whole quantized model's in one process."""
    for r in two_ranks[mode]:
        assert r["names"] and r["plan_equal"]
        assert len(r["bitwise"]) == r["leaves"]
        np.testing.assert_array_equal(r["out"], r["one"])


def test_loader_reads_only_its_shards(two_ranks, checkpoint):
    """``load_pipeline`` under fsdp 2 from a tiny checkpoint directory with
    a diffusers LoRA (scale 0.8): every parameter bitwise this rank's
    slice of the one-process load (the LoRA-fused ones included); the bytes
    read from the DiT shards exactly this rank's slices, from the files'
    headers (the whole load reads them all); a 2-step edit bitwise the
    one-process pipeline's."""
    ckpt, _ = checkpoint
    shards = [str(p) for p in sorted(Path(ckpt, "transformer").glob("*.safetensors"))]
    names = w_t.diffusers_dit_names(tiny_t().dit)
    with w_t.load_safetensors(shards) as sd:
        files = {k.removeprefix("transformer."): sd.nbytes(k) for k in sd}
    total = sum(files.values())
    for rank, r in enumerate(two_ranks["loader"]):
        assert len(r["bitwise"]) == r["params"] == len(r["dims"])
        assert r["whole_bytes"]["dit"] == total - sum(
            n for k, n in files.items() if k not in names)
        want = sum(n // 2 if r["dims"][names[k]] is not None else n
                   for k, n in files.items() if k in names)
        assert r["bytes"]["dit"] == want < total
        assert sum(d is not None for d in r["dims"].values()) == len(r["dims"])
        np.testing.assert_array_equal(r["out"], r["one"])


def test_mesh_errors(four_ranks):
    """``pipe`` x ``fsdp`` makes a mesh (each stage's blocks split over
    fsdp, ``test_torch_pipe_fsdp.py``), and so does ``fsdp`` x ``tensor``
    (tensor parallelism composes with fsdp); an fsdp degree that does not
    divide the world raises ValueError."""
    for r in four_ranks["errors"]:
        pipe, tensor, bad = r
        assert pipe == "" and tensor == ""
        assert bad.startswith("ValueError") and "not divisible" in bad


def test_whole_model_under_fsdp_mesh_raises():
    """A whole DiT given an fsdp mesh raises before any collective."""
    mesh = mesh_t.Mesh((1, 1, 2, 1, 1), 0, torch.device("cpu"), {"fsdp": None})
    args = [torch.from_numpy(a) for a in dit_inputs(tiny(dit_j))]
    with pytest.raises(ValueError, match="shard_params"):
        dit_t.dit_forward(dit_t.DiT(tiny(dit_t)), *args, mesh=mesh)


def test_run_inference_fsdp_under_torchrun(tmp_path):
    """``run_inference --mesh fsdp=2 --smoke --device cpu`` under
    ``torch.distributed.run --nproc-per-node 2``: each rank shards the
    seeded tiny model, rank 0 writes the edit, bitwise the single
    process's PNG."""
    from PIL import Image

    args = ["-m", "chronoedit_tpu_torch.scripts.run_inference", "--smoke", "--device", "cpu"]
    runs = {"single": [sys.executable, *args],
            "mesh": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc-per-node", "2", *args, "--mesh", "fsdp=2"]}
    for name, cmd in runs.items():
        proc = subprocess.run([*cmd, "--output", str(tmp_path / f"{name}.png")], cwd=REPO,
                              capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "mesh {'pipe': 1, 'data': 1, 'fsdp': 2" in proc.stdout
    single = np.asarray(Image.open(tmp_path / "single.png"))
    assert single.std() > 0
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "mesh.png")), single)
