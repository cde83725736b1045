from . import convert, envmap, lights, materials, mesh, procedural, scene  # noqa: F401
from .materials import Material  # noqa: F401
from .mesh import Mesh  # noqa: F401
from .procedural import cornell_box  # noqa: F401
from .scene import Scene  # noqa: F401
