"""Host utilities, reused from the JAX package's modules that import no JAX:
image I/O (``utils/io.py``, ``utils/bmp.py``) and the logging helpers of
``utils/obs.py`` (``log``, ``warn``, ``log_sift_overflow``, ``StageTimer``;
not ``obs.trace``, which imports jax)."""
from computervisionimagestich2_tpu.utils import bmp  # noqa: F401
from computervisionimagestich2_tpu.utils.io import (  # noqa: F401
    load_image,
    save_image,
)
