"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each library is compiled at first use from the sources in ``csrc/`` into
``dxrexperiments_torch/build/`` (listed in .gitignore), keyed by a hash of
the sources and the flags, so an edited source rebuilds and an unchanged one
loads the cached library. The sources expose a plain C interface: no PyTorch
headers, which keeps a build to seconds.

Flags: ``sm_90a`` (Hopper), ``-O3``, and no ``--use_fast_math``: parity with
the float32 reference needs IEEE-rounded ``sqrtf``, division, ``sinf``,
``cosf``, ``expf`` and ``powf``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build seconds (0.0 when cached), "log": nvcc output}
BUILD_INFO: dict[str, dict] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return nvcc


def load_library(name: str, sources: list[str]) -> ctypes.CDLL:
    """Compile ``csrc/<sources>`` into ``build/lib<name>-<hash>.so`` if it is
    not built yet, then load it. Raises with nvcc's output on failure."""
    if name in _LOADED:
        return _LOADED[name]
    paths = [os.path.join(CSRC_DIR, s) for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    so_path = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    info = {"seconds": 0.0, "log": "", "path": so_path}
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        info["seconds"] = time.perf_counter() - t0
        info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{info['log']}")
        os.replace(tmp, so_path)  # atomic: a concurrent loader never sees half a file
    lib = ctypes.CDLL(so_path)
    _LOADED[name] = lib
    BUILD_INFO[name] = info
    return lib
