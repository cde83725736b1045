"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each library is compiled at first use from the sources in ``csrc/`` into
``dxrexperiments_torch/build/`` (listed in .gitignore), keyed by a hash of
the sources, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds and an unchanged one loads the cached library
(and nvcc's output, kept beside it, for ``BUILD_INFO``). The sources
expose a plain C interface: no PyTorch headers, which keeps a build to
seconds.

Flags: ``sm_90a`` (Hopper), ``-O3``, and no ``--use_fast_math``: parity with
the float32 reference needs IEEE-rounded ``sqrtf``, division, ``sinf``,
``cosf``, ``expf`` and ``powf``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

from .profiling import annotate

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


def load_library(name: str, sources: list[str], csrc_dir: str = CSRC_DIR,
                 flags: tuple = ()) -> ctypes.CDLL:
    """Compile ``csrc/<sources>`` into ``build/lib<name>-<hash>.so`` if it is
    not built yet, then load it. Raises with nvcc's output on failure.
    ``csrc_dir`` names another source tree (another commit's ``csrc``),
    built beside the package's under its own hash and loaded under the key
    ``name@csrc_dir`` of ``BUILD_INFO``. ``flags``: nvcc options after
    NVCC_FLAGS (a ``-D`` for an opt-in instantiation such as B5's counting
    build, ``-fmad=false`` for kernel_ab.py's builds without contraction),
    hashed with them; give such a build a name of its own."""
    key = name if csrc_dir == CSRC_DIR else f"{name}@{csrc_dir}"
    if key in _LOADED:
        return _LOADED[key]
    paths = [os.path.join(csrc_dir, s) for s in sources]
    headers = sorted(os.path.join(csrc_dir, f) for f in os.listdir(csrc_dir) if f.endswith(".cuh"))
    flags = (*NVCC_FLAGS, *flags)
    h = hashlib.sha256(" ".join(flags).encode())
    for p in paths + headers:
        with open(p, "rb") as f:
            h.update(f.read())
    so_path = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    log_path = so_path + ".log"  # nvcc's output (ptxas' counts), kept beside the library
    info = {"seconds": 0.0, "log": "", "path": so_path}
    cached = os.path.exists(so_path) and os.path.exists(log_path)
    with annotate("kernel_load", int(not cached)):
        if cached:
            with open(log_path) as f:
                info["log"] = f.read()
        else:
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so_path}.{os.getpid()}.{threading.get_ident()}.tmp"  # one per building thread
            cmd = [find_nvcc(), *flags, "-o", tmp, *paths]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
            info["seconds"] = time.perf_counter() - t0
            info["log"] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{info['log']}")
            with open(f"{tmp}.log", "w") as f:
                f.write(info["log"])
            os.replace(f"{tmp}.log", log_path)
            os.replace(tmp, so_path)  # atomic: a concurrent loader never sees half a file
        lib = ctypes.CDLL(so_path)
    _LOADED[key] = lib
    BUILD_INFO[key] = info
    return lib


def ptxas_counts(log: str) -> list[dict]:
    """Per kernel of a build's ``-Xptxas -v`` log: name, registers, spill
    stores and loads (bytes), stack frame (bytes)."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out
