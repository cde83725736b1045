"""ctypes binding of the port's native SAH BVH builder (``csrc/sah_bvh.cpp``).

The source is compiled with g++ at first use into
``dxrexperiments_torch/build/`` (listed in .gitignore), keyed by a hash of the
source and the flags, and loaded with ctypes. Where g++ is missing the
builder is unavailable and ``accel.bvh.build_nodes`` takes the Morton build,
as the JAX package does: this is host-side BVH construction, not a device
fallback. The flags are the JAX package's (``dxrexperiments_tpu/utils/
native.py``), so both packages build the same tree from the same triangles.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from .cuda_build import BUILD_DIR, CSRC_DIR

SOURCE = os.path.join(CSRC_DIR, "sah_bvh.cpp")
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> str | None:
    """Path of the built library, or None without g++ or on a failed build."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    path = os.path.join(BUILD_DIR, f"libsah_bvh-{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, timeout=300)
    except subprocess.SubprocessError:
        return None
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return path


def get_lib():
    """The loaded builder library, or None where it cannot be built."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        f32 = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
        i32 = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
        lib.sah_build.restype = ctypes.c_void_p
        lib.sah_build.argtypes = [f32, f32, f32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
        for fn in ("sah_num_nodes", "sah_num_refs"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.sah_copy.argtypes = [ctypes.c_void_p, f32, f32, i32, i32]
        lib.sah_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def build_sah_native(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, leaf_size: int = 8):
    """Binned-SAH BVH with object splits. Returns (nodes_lo [M,3],
    nodes_hi [M,3], child [M,2], order [T]) or None where the builder is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    v0 = np.ascontiguousarray(v0, np.float32)
    e1 = np.ascontiguousarray(e1, np.float32)
    e2 = np.ascontiguousarray(e2, np.float32)
    h = lib.sah_build(v0, e1, e2, len(v0), leaf_size, 0)
    try:
        m = lib.sah_num_nodes(h)
        r = lib.sah_num_refs(h)
        nodes_lo = np.empty((m, 3), np.float32)
        nodes_hi = np.empty((m, 3), np.float32)
        child = np.empty((m, 2), np.int32)
        order = np.empty((r,), np.int32)
        lib.sah_copy(h, nodes_lo, nodes_hi, child, order)
        return nodes_lo, nodes_hi, child, order
    finally:
        lib.sah_free(h)
