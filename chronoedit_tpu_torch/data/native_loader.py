"""ctypes bindings for the native C++ batch image decoder.

``native/image_loader.cpp`` decodes JPEG batches on a C++ thread pool
(GIL-free) straight into a numpy buffer — the host-side decode hot path of
the input pipeline. Falls back to PIL when the shared library hasn't been
built or for non-JPEG inputs.

A copy of ``chronoedit_tpu/data/native_loader.py`` (the port imports
nothing of the JAX package), at the same depth, so it finds the same
``native/`` directory. :func:`build_native` compiles the source with the
flags of ``native/Makefile`` into the git-ignored ``build/native/``, where
the port builds its CUDA kernels too, and never writes into ``native/``;
the library is loaded from there, else from ``native/libce_loader.so``
(``make -C native``). Decoding with PIL stays the behaviour where neither
library exists: it is host decoding, not a device path.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SOURCE = os.path.join(_REPO, "native", "image_loader.cpp")
_BUILD_PATH = os.path.join(_REPO, "build", "native", "libce_loader.so")
# the port's own build first, then ``make -C native``'s
_LIB_PATHS = (_BUILD_PATH, os.path.join(_REPO, "native", "libce_loader.so"))
# native/Makefile's CXXFLAGS and LIBS
_CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")
_LIBS = ("-ljpeg", "-lpthread")


@functools.cache
def _load_lib():
    path = next((p for p in _LIB_PATHS if os.path.exists(p)), None)
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.ce_decode_jpeg_batch.restype = ctypes.c_int
    lib.ce_decode_jpeg_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.ce_loader_abi_version.restype = ctypes.c_int
    abi = lib.ce_loader_abi_version()
    if abi not in (1, 2):
        raise RuntimeError(f"unknown native loader ABI {abi} in {path}")
    if abi >= 2:
        lib.ce_decode_jpeg_buffers.restype = ctypes.c_int
        lib.ce_decode_jpeg_buffers.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
    lib._abi = abi
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def build_native(quiet: bool = True) -> bool:
    """Best-effort compile of ``native/image_loader.cpp`` into
    ``build/native/libce_loader.so`` (``$CXX``, default g++, with
    ``native/Makefile``'s flags; written under a temporary name and renamed,
    so a concurrent build or load never sees half a file); returns
    availability."""
    os.makedirs(os.path.dirname(_BUILD_PATH), exist_ok=True)
    tmp = f"{_BUILD_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", tmp, _SOURCE,
                        *_LIBS], capture_output=quiet, check=True)
        os.replace(tmp, _BUILD_PATH)
    except (OSError, subprocess.CalledProcessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    _load_lib.cache_clear()
    return native_available()


def _decode_batch_pil(paths, target_h, target_w):
    from PIL import Image

    out = np.zeros((len(paths), 3, target_h, target_w), np.float32)
    failures = 0
    for i, p in enumerate(paths):
        try:
            img = Image.open(p).convert("RGB")
        except Exception:
            failures += 1
            continue
        w, h = img.size
        scale = max(target_w / w, target_h / h)
        img = img.resize((round(w * scale), round(h * scale)), Image.BILINEAR)
        w2, h2 = img.size
        left, top = (w2 - target_w) // 2, (h2 - target_h) // 2
        img = img.crop((left, top, left + target_w, top + target_h))
        out[i] = np.asarray(img, np.float32).transpose(2, 0, 1) / 127.5 - 1.0
    return out, failures


def decode_image_batch(paths: list[str], target_h: int, target_w: int,
                       num_threads: int = 0,
                       force_backend: str | None = None) -> np.ndarray:
    """Decode + resize-to-cover + center-crop a batch of images.

    Returns (N, 3, target_h, target_w) float32 in [-1, 1]; undecodable
    images yield zero frames (matching the native ABI).
    """
    lib = _load_lib()
    all_jpeg = all(p.lower().endswith((".jpg", ".jpeg")) for p in paths)
    use_native = (force_backend == "native"
                  or (force_backend is None and lib is not None and all_jpeg))
    if use_native:
        if lib is None:
            raise RuntimeError("native loader not built (build_native())")
        out = np.empty((len(paths), 3, target_h, target_w), np.float32)
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        lib.ce_decode_jpeg_batch(
            arr, len(paths), target_h, target_w,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads)
        return out
    out, _ = _decode_batch_pil(paths, target_h, target_w)
    return out


def _decode_buffers_pil(buffers, target_h, target_w):
    import io

    from PIL import Image

    out = np.zeros((len(buffers), 3, target_h, target_w), np.float32)
    for i, data in enumerate(buffers):
        try:
            img = Image.open(io.BytesIO(data)).convert("RGB")
        except Exception:
            continue
        w, h = img.size
        scale = max(target_w / w, target_h / h)
        img = img.resize((round(w * scale), round(h * scale)), Image.BILINEAR)
        w2, h2 = img.size
        left, top = (w2 - target_w) // 2, (h2 - target_h) // 2
        img = img.crop((left, top, left + target_w, top + target_h))
        out[i] = np.asarray(img, np.float32).transpose(2, 0, 1) / 127.5 - 1.0
    return out


def decode_jpeg_buffers(buffers: list[bytes], target_h: int, target_w: int,
                        num_threads: int = 0,
                        force_backend: str | None = None) -> np.ndarray:
    """In-memory variant of :func:`decode_image_batch` for tar-shard members
    (webdataset) and other non-file sources: decode + resize-to-cover +
    center-crop a batch of JPEG byte strings on the C++ thread pool.

    Returns (N, 3, target_h, target_w) float32 in [-1, 1]; undecodable
    buffers yield zero frames.
    """
    lib = _load_lib()
    use_native = (force_backend == "native"
                  or (force_backend is None and lib is not None
                      and getattr(lib, "_abi", 1) >= 2))
    if use_native:
        if lib is None or getattr(lib, "_abi", 1) < 2:
            raise RuntimeError("native loader with ABI>=2 not built "
                               "(build_native())")
        out = np.empty((len(buffers), 3, target_h, target_w), np.float32)
        bufs = (ctypes.c_char_p * len(buffers))(*buffers)
        sizes = (ctypes.c_long * len(buffers))(*[len(b) for b in buffers])
        lib.ce_decode_jpeg_buffers(
            bufs, sizes, len(buffers), target_h, target_w,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads)
        return out
    return _decode_buffers_pil(buffers, target_h, target_w)
