from . import integrator, sampling  # noqa: F401
from .integrator import default_options, render_sample, trace_rays  # noqa: F401
