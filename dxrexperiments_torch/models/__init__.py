from . import base, denoise, progressive, realtime  # noqa: F401
from .denoise import DenoiseCompositor, denoise_composite  # noqa: F401
from .progressive import ProgressiveRaytracingPipeline, make_progressive_step  # noqa: F401
from .realtime import RealtimeRaytracingPipeline  # noqa: F401
