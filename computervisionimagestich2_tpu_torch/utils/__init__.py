"""Host utilities: image I/O (``io.py``, on the native codec of
``native/`` or the numpy BMP codec of ``bmp.py``),
logging and stage timing (``obs.py``) and the dump / resume artifacts
(``artifacts.py``). The port's own copies of the JAX package's
``utils`` modules; nothing here imports that package."""
from . import bmp  # noqa: F401
from .io import load_image, save_image  # noqa: F401
