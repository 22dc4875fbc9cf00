"""Builds the CUDA kernels in ``csrc/`` and loads them with ctypes.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` call for ``sm_90a``,
all in parallel, and the objects link into one shared library with a plain
C interface (no PyTorch headers, so the
build takes seconds). The library lands in ``build/kernels/`` at the
repository root, named by a hash of the sources and the flags, so an edited
source rebuilds and an unchanged one loads the library already there.
nvcc's output (``-Xptxas=-v``: each kernel's registers, shared memory and
spills) is kept beside it, in :func:`build_log_path`.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers call :func:`check` on it. A missing ``nvcc`` or a failed build
raises. Nothing here runs at import time.

``LAUNCHES`` counts kernel launches by kernel name (the grouped attention
kernels apart: ``flash_fwd_grouped``, ``flash_bwd_dq_grouped``,
``flash_bwd_dkv_grouped``); ``SHAPE_LAUNCHES`` counts them again by kernel
name and shape: each attention kernel's by its KV length, the int4
matmul's by its flattened row count M. Each wrapper
adds one right after a launch that returned success, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v")

LAUNCHES: dict[str, int] = {
    "flash_fwd": 0, "ln_modulate": 0, "gated_residual": 0, "rms_norm": 0,
    "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "int4_matmul": 0, "flash_fwd_qk8": 0,
    "flash_fwd_grouped": 0, "flash_bwd_dq_grouped": 0, "flash_bwd_dkv_grouped": 0}
SHAPE_LAUNCHES: dict[str, dict[int, int]] = {
    name: {} for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "int4_matmul",
                          "flash_fwd_qk8", "flash_fwd_grouped", "flash_bwd_dq_grouped",
                          "flash_bwd_dkv_grouped")}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: pointers and the stream as void*, sizes as int
_SIGNATURES = {
    # q, k, v, o, lse, B, Sq, Skv, H, D, scale, stream
    "flash_fwd_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # q, k, v, o, lse, B, Sq, Skv, H, D, scale, group, stream
    "flash_fwd_grouped_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    # q, k, v, dout, lse, dsum, dq, B, Sq, Skv, H, D, scale, stream
    "flash_bwd_dq_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # q, k, v, dout, lse, dsum, dk, dv, B, Sq, Skv, H, D, scale, stream
    "flash_bwd_dkv_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # q, k, v, dout, lse, dsum, dq, B, Sq, Skv, H, D, scale, group, stream
    "flash_bwd_dq_grouped_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    # q, k, v, dout, lse, dsum, dk, dv, B, Sq, Skv, H, D, scale, group, stream
    "flash_bwd_dkv_grouped_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                   _I, _P],
    # x, scale, shift, out, rows, T, hw, D, eps, stream
    "ln_modulate_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # x, delta, gate, out, rows, T, hw, D, stream
    "gated_residual_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, weight, out, rows, D, eps, stream
    "rms_norm_bf16": [_P, _P, _P, _I, _I, _F, _P],
    # x, packed, scales, table, y, M, N, K, stream
    "int4_matmul_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # q8, k8, v, qs, ks, o, B, Sq, Skv, H, D, scale, stream
    "flash_fwd_qk8_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
}

_LIB: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for counts in SHAPE_LAUNCHES.values():
        counts.clear()


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libchronoedit_kernels_{h.hexdigest()[:16]}.so"


def build_log_path() -> Path:
    return library_path().with_suffix(".log")


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists:
    one ``nvcc -c`` per source, all started together, then one link.
    Returns its path; raises with nvcc's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-I", str(CSRC), "-o", obj, str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
            objs.append(obj)
        so = os.path.join(tmp, out.name)
        link = [_nvcc(), "-shared", "-o", so, *objs]
        log = []
        for cmd, proc in procs + [(link, None)]:
            if proc is None:  # every compile has finished: link
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
            text = proc.communicate()[0]
            log.append(text)
            if proc.returncode != 0:
                for _, other in procs:
                    other.kill()
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{text}")
        build_log_path().write_text("".join(log))
        os.replace(so, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        so = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        so.kernel_error_string.argtypes = [ctypes.c_int]
        so.kernel_error_string.restype = ctypes.c_char_p
        _LIB = so
    return _LIB


def check(err: int, name: str, key: int | None = None) -> None:
    """Raise if a C entry point reported a CUDA error; count the launch,
    and with ``key`` (an attention's KV length, an int4 matmul's rows) also
    in ``SHAPE_LAUNCHES[name]``."""
    if err != 0:
        msg = lib().kernel_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
    LAUNCHES[name] += 1
    if key is not None:
        counts = SHAPE_LAUNCHES[name]
        counts[key] = counts.get(key, 0) + 1
