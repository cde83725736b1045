"""Acceleration structures (``dxrexperiments_tpu.accel``): the BVH builds."""
