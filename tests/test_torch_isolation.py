"""The port imports without jax and without the JAX package.

A fresh interpreter blocks ``jax`` and ``chronoedit_tpu`` (a ``None``
entry in ``sys.modules`` makes any import of them raise) and then imports
every module of ``chronoedit_tpu_torch``.
"""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
for blocked in ("jax", "jaxlib", "chronoedit_tpu"):
    sys.modules[blocked] = None
import chronoedit_tpu_torch
names = ["chronoedit_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(chronoedit_tpu_torch.__path__,
                                          "chronoedit_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib")
                and sys.modules[n] is not None)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20  # every module was walked


# the modules of checkpoint loading and the encoders, and of serving (the
# server, the guardrails and their models, the CLIs and the host copies they
# import), which the walk must reach
LOADER_MODULES = ("models.weights", "models.umt5", "models.clip", "models.xlm_roberta",
                  "models.conditioner", "models.from_jax", "pipeline.loader")
SERVING_MODULES = ("pipeline.server", "aux", "aux.guardrails", "aux.safety_classifier",
                   "aux.face_detector", "scripts", "scripts.run_inference", "scripts.serve",
                   "scripts.check_environment", "data.edit_dataset", "utils.visualize")

# the modules of training (the trainer, its checkpoints, callbacks and
# guards, the training and conversion CLIs and the host copies they import)
TRAINING_MODULES = ("train.trainer", "train.checkpoint", "train.callbacks", "utils.config",
                    "utils.easy_io", "utils.sanitize", "parallel", "parallel.distributed",
                    "parallel.consistency", "data.loaders", "scripts.train",
                    "scripts.convert_weights")

# the modules of context, pipeline and tensor parallelism and FSDP (the
# process world, the mesh, the collectives, ring and Ulysses attention, the
# GPipe schedule, the parameter sharding, the launcher, the cross-rank
# replica check) and what runs them (the DiT, K4's tensor form and the
# tensor-split quantized leaves, the pipeline, the loader, the CLI)
PARALLEL_MODULES = ("parallel.mesh", "parallel.collectives", "parallel.context",
                    "parallel.pipeline_parallel", "parallel.sharding", "pipeline.loader",
                    "parallel.distributed", "parallel.consistency", "parallel.launch",
                    "models.dit", "ops.fused_norms", "ops.quant", "pipeline.edit_pipeline",
                    "scripts.run_inference", "utils.platform")

_WALK = """
import pkgutil, sys
for blocked in ("jax", "jaxlib", "chronoedit_tpu"):
    sys.modules[blocked] = None
import chronoedit_tpu_torch
for m in pkgutil.walk_packages(chronoedit_tpu_torch.__path__, "chronoedit_tpu_torch."):
    print(m.name)
"""


def _walked() -> set[str]:
    proc = subprocess.run([sys.executable, "-c", _WALK], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return set(proc.stdout.split())


def test_walk_reaches_the_loader_and_encoders():
    """The probe above imports every module the walk yields; the loader's and
    the encoders' are among them."""
    assert {f"chronoedit_tpu_torch.{m}" for m in LOADER_MODULES} <= _walked()


def test_walk_reaches_serving():
    """... and serving's: the server, the guardrails, the CLIs."""
    assert {f"chronoedit_tpu_torch.{m}" for m in SERVING_MODULES} <= _walked()


def test_walk_reaches_training():
    """... and training's."""
    assert {f"chronoedit_tpu_torch.{m}" for m in TRAINING_MODULES} <= _walked()


def test_walk_reaches_parallelism():
    """... and context parallelism's."""
    assert {f"chronoedit_tpu_torch.{m}" for m in PARALLEL_MODULES} <= _walked()


def test_importing_the_scripts_starts_nothing():
    """Importing a CLI module parses no arguments and starts no thread."""
    proc = subprocess.run([sys.executable, "-c", _SCRIPTS, "--not-an-option"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["1"]


_SCRIPTS = """
import threading
from chronoedit_tpu_torch.scripts import (check_environment, convert_weights, run_inference,
                                          serve, train)
print(threading.active_count())
"""


def test_attention_routes_by_head_dim(monkeypatch):
    """JAX's rule, by head dim alone: on CPU tensors every head dim takes the
    differentiable Function, whose CPU forward is the plain twin; on CUDA
    tensors a head dim that is not a multiple of 128 (CLIP's 80) goes to
    SDPA, and a multiple of 128 to the Function (K1's own check raises on
    any but 128)."""
    import torch

    from chronoedit_tpu_torch.ops import attention
    from chronoedit_tpu_torch.ops import flash_attention as fa

    calls = []
    apply, plain = fa.FlashAttention.apply, fa.flash_attention_plain
    monkeypatch.setattr(fa.FlashAttention, "apply",
                        lambda *a: calls.append("function") or apply(*a))
    monkeypatch.setattr(fa, "flash_attention_plain",
                        lambda *a, **k: calls.append("twin") or plain(*a, **k))
    g = torch.Generator().manual_seed(0)
    for d in (80, 128):
        calls.clear()
        q, k = (torch.randn((1, 9, 2, d), generator=g) for _ in range(2))
        out = attention.dot_product_attention(q, k, k)
        assert calls == ["function", "twin"], d  # the Function's CPU forward is the twin
        torch.testing.assert_close(out, plain(q, k, k, d ** -0.5)[0], rtol=0, atol=0)

    class OnCard(torch.Tensor):  # a CPU tensor that reports CUDA, to read the route
        is_cuda = property(lambda self: True)

    monkeypatch.setattr(attention.F, "scaled_dot_product_attention",
                        lambda *a, **k: calls.append("sdpa") or a[0])
    monkeypatch.setattr(fa, "flash_attention", lambda *a: calls.append("function") or a[0])
    for d, route in ((80, "sdpa"), (128, "function"), (256, "function")):
        calls.clear()
        q = torch.randn((1, 9, 2, d), generator=g).as_subclass(OnCard)
        attention.dot_product_attention(q, q, q)
        assert calls == [route], d
