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
