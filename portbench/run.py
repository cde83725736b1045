"""Entry point of the port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It keeps every build and kernel cache the
run can make inside the checkout (the port builds its CUDA libraries into
``dxrexperiments_torch/build/``; Triton's, torch's extension and the CUDA
JIT caches go under ``.bench_cache/``), then hands over to
``portbench/harness.py``.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from portbench import harness

    sys.exit(harness.run(sys.argv[1:], t_start=T_START))
