from . import base, denoise, progressive  # noqa: F401
from .progressive import ProgressiveRaytracingPipeline, make_progressive_step  # noqa: F401
