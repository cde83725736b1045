"""Multi-GPU rendering over ``torch.distributed`` (``dxrexperiments_tpu.parallel``)."""

from . import render  # noqa: F401
from .render import (  # noqa: F401
    RenderMesh,
    gather_rows,
    make_render_mesh,
    make_sharded_progressive_step,
    make_sharded_realtime_step,
    progressive_step_sharded,
    render_samples_sharded,
    replicate_scene,
    stack_cameras,
)
