"""PyTorch/CUDA port of the ray tracing framework for NVIDIA Hopper.

Mirrors the layout of ``dxrexperiments_tpu`` module for module. The plain
PyTorch code is the reference for every kernel; on a CUDA device the
pipelines run the hand-written kernels in ``csrc/`` (built at first use, see
``utils/cuda_build.py``). This package imports torch and numpy only.
"""
