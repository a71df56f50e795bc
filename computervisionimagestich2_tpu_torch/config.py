"""Configuration: the JAX package's dataclasses, plus the chain slice.

``computervisionimagestich2_tpu.config`` imports no JAX, so the port reuses
it rather than copying it; a ``StitchConfig`` built for either package is
valid for both.

The port runs ``DEFAULT_CONFIG`` (graph ordering, the fused detect, exact
L1 matching) and ``SLICE_CONFIG``, the chain-ordered path with the dense
(non-fused) detect that was ported first, each with the incremental stitch
(``planned=False``), bucketed canvases (``exact_canvas=False``) and the
per-edge color transfer (``color_transfer=True``). ``check_supported``
raises ``NotImplementedError`` for any switch outside them, naming the
ROADMAP item that ports it.

``match.method="auto"`` resolves to exact L1 here. That is what the JAX
package itself picks on any backend other than a TPU
(``computervisionimagestich2_tpu/ops/distance.py::_l2pre_enabled``); on a
TPU its default would be the MXU-prefiltered ``"l2pre"``, which the port
does not implement (A14). So the port's default follows the JAX package's
CPU and GPU decisions, not its TPU ones.
"""
from __future__ import annotations

import dataclasses

from computervisionimagestich2_tpu.config import (  # noqa: F401
    DEFAULT_CONFIG,
    BlendConfig,
    EnhanceConfig,
    MatchConfig,
    ProjectionConfig,
    RansacConfig,
    SiftConfig,
    StitchConfig,
)

SLICE_CONFIG = dataclasses.replace(
    DEFAULT_CONFIG,
    ordering="chain",
    sift=dataclasses.replace(DEFAULT_CONFIG.sift, detect_impl="xla"),
    match=dataclasses.replace(DEFAULT_CONFIG.match, method="exact"),
)


def check_supported(cfg: StitchConfig) -> None:
    """Raise NotImplementedError if ``cfg`` leaves the ported
    configurations."""
    unsupported = [
        (cfg.match.method == "l2pre", "match.method='l2pre'", "A14"),
        (cfg.match.distance != "l1", "match.distance='l2'", "A14"),
        (cfg.warp_model != "bilinear", "warp_model='projective'", "A13"),
        (cfg.blend.blur_impl != "fir", f"blend.blur_impl="
         f"{cfg.blend.blur_impl!r}", "A13 (vanvliet); fir_fused is TPU-only"),
        (cfg.sift.o_min < 0, "sift.o_min<0", "A13"),
        (cfg.blend.gain_compensation and cfg.blend.gain_mode == "luma",
         "blend.gain_mode='luma' with gain_compensation", "A13"),
        (cfg.sift.walk_dtype != "f32", "sift.walk_dtype='bf16'",
         "§A 'Do not port' (a TPU-only experiment)"),
    ]
    for bad, what, item in unsupported:
        if bad:
            raise NotImplementedError(
                f"{what} is outside the ported configurations; see "
                f"ROADMAP.md {item}")
