"""Reference-shaped entry points of the port."""
from .compat import ImageProcess, Projection, equalization, transfer  # noqa: F401
