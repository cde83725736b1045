"""Acceleration structures (``dxrexperiments_tpu.accel``): the BVH builds."""
from . import bvh  # noqa: F401
from .bvh import build_bvh, build_bvh_device, choose_layout  # noqa: F401
