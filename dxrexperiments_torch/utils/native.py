"""ctypes bindings of the port's native host code: the SAH BVH builder
(``csrc/sah_bvh.cpp``) and the OBJ parser (``csrc/mesh_io.cpp``).

Each source is compiled with g++ at first use into its own library under
``dxrexperiments_torch/build/`` (listed in .gitignore), keyed by a hash of
the source and the flags, and loaded with ctypes. Where g++ is missing a
library is unavailable: ``accel.bvh.build_nodes`` then takes the Morton
build and ``scene.mesh.load_obj`` the Python parser, as the JAX package
does (host-side work, not a device fallback; ``Mesh.loader`` and
``scene["bvh"]["builder"]`` say which ran). The flags are the JAX
package's (``dxrexperiments_tpu/utils/native.py``), so both packages build
the same tree from the same triangles.
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
from .profiling import annotate

SOURCE = os.path.join(CSRC_DIR, "sah_bvh.cpp")
MESH_SOURCE = os.path.join(CSRC_DIR, "mesh_io.cpp")
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL | None] = {}  # source path -> library, None after a failed build


def _library_path(source: str) -> str | None:
    """Where the library of ``source`` is or will be built, or None without
    g++."""
    if shutil.which("g++") is None:
        return None
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(source, "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def _build(source: str, path: str) -> str | None:
    """``path``, the library built from ``source`` there if it is not yet,
    or None on a failed build."""
    if os.path.exists(path):
        return path
    gxx = shutil.which("g++")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, source], check=True,
                       capture_output=True, timeout=300)
    except subprocess.SubprocessError:
        return None
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return path


def _load(source: str, bind):
    """The library of ``source`` with ``bind`` applied, built once per
    process; None where it cannot be built."""
    with _lock:
        if source not in _libs:
            path = _library_path(source)
            with annotate("kernel_load", int(path is not None and not os.path.exists(path))):
                if path is not None:
                    path = _build(source, path)
                _libs[source] = None if path is None else bind(ctypes.CDLL(path))
        return _libs[source]


def _bind_sah(lib):
    f32 = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    lib.sah_build.restype = ctypes.c_void_p
    lib.sah_build.argtypes = [f32, f32, f32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
    for fn in ("sah_num_nodes", "sah_num_refs"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.sah_copy.argtypes = [ctypes.c_void_p, f32, f32, i32, i32]
    lib.sah_free.argtypes = [ctypes.c_void_p]
    return lib


def _bind_mesh(lib):
    f32 = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    lib.obj_parse.restype = ctypes.c_void_p
    lib.obj_parse.argtypes = [ctypes.c_char_p]
    lib.obj_error.restype = ctypes.c_char_p
    lib.obj_error.argtypes = [ctypes.c_void_p]
    for fn in ("obj_num_vertices", "obj_num_normals", "obj_num_triangles"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.obj_copy.argtypes = [ctypes.c_void_p, f32, f32, i32, i32, i32]
    lib.obj_free.argtypes = [ctypes.c_void_p]
    return lib


def get_lib():
    """The loaded SAH builder library, or None where it cannot be built."""
    return _load(SOURCE, _bind_sah)


def get_mesh_lib():
    """The loaded OBJ parser library, or None where it cannot be built."""
    return _load(MESH_SOURCE, _bind_mesh)


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


def parse_obj_native(path: str):
    """Fast OBJ parse (``dxrexperiments_tpu.utils.native.parse_obj_native``).
    Returns (positions [V,3], normals [N,3], face_pos [F,3], face_nrm [F,3]
    (-1 where a corner has no normal), face_mat [F] (usemtl order)) or None
    where the parser is unavailable; raises IOError for a file it cannot
    read."""
    lib = get_mesh_lib()
    if lib is None:
        return None
    h = lib.obj_parse(os.fsencode(path))
    try:
        err = lib.obj_error(h)
        if err:
            raise IOError(f"obj_parse({path}): {err.decode()}")
        nv = lib.obj_num_vertices(h)
        nn = lib.obj_num_normals(h)
        nf = lib.obj_num_triangles(h)
        positions = np.empty((nv, 3), np.float32)
        normals = np.empty((nn, 3), np.float32)
        face_pos = np.empty((nf, 3), np.int32)
        face_nrm = np.empty((nf, 3), np.int32)
        face_mat = np.empty((nf,), np.int32)
        lib.obj_copy(h, positions, normals, face_pos, face_nrm, face_mat)
        return positions, normals, face_pos, face_nrm, face_mat
    finally:
        lib.obj_free(h)
