"""computervisionimagestich2_tpu_torch — the panorama stitcher in PyTorch.

A port of ``computervisionimagestich2_tpu`` (JAX/XLA/Pallas) to PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (H100, ``sm_90a``). The JAX
package stays the reference; every function here has a counterpart of the
same name at the same place in its layout (``core/``, ``ops/``,
``models/``, ``utils/``).

This package covers the JAX package's main path, ``DEFAULT_CONFIG``
(graph ordering, the fused detect, exact L1 matching — what the JAX
package runs off a TPU), and the chain-ordered ``config.SLICE_CONFIG``,
with the incremental stitch, bucketed canvases, the per-edge color
transfer, mixed image shapes and dump / resume; ``StreamingStitcher``
(``models/streaming.py``), the reference-shaped API (``api/compat.py``)
and the ``panorama-torch`` command line (``cli.py``).
``check_supported`` names what lies outside them. The package imports
``torch`` and never ``jax``. Kernels are compiled with ``nvcc`` at first
use on a CUDA tensor (``ops/_native.py``); nothing is built or loaded at
import.
"""
from .config import (  # noqa: F401
    DEFAULT_CONFIG,
    SLICE_CONFIG,
    BlendConfig,
    EnhanceConfig,
    MatchConfig,
    ProjectionConfig,
    RansacConfig,
    SiftConfig,
    StitchConfig,
    check_supported,
)
from .device import resolve_device  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name):
    # keep `import computervisionimagestich2_tpu_torch` light
    if name in ("Stitcher", "stitch", "stitch_files"):
        from .models import stitcher as _stitcher

        return getattr(_stitcher, name)
    if name == "StreamingStitcher":
        from .models.streaming import StreamingStitcher

        return StreamingStitcher
    if name in ("ImageProcess", "Projection"):
        from .api import compat

        return getattr(compat, name)
    raise AttributeError(name)
