from . import camera, device, rng, vecmath  # noqa: F401
from .camera import Camera, camera_params, primary_ray_grid  # noqa: F401
from .device import setup_device  # noqa: F401
