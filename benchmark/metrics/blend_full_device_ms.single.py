"""Device milliseconds per panorama of the edges blended over the full
canvas, in float32 or in bfloat16: as ``blend_band_device_ms.single``
(whose arithmetic it takes), for the ``blend:f32`` and ``blend:bf16``
spans. None where the trace holds neither."""
from harness import registry

LAYER = "blend (models/blender.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "panorama_ms"
SPANS = ("blend:f32", "blend:bf16")


def read(run: dict):
    band = registry.reader("metrics", "blend_band_device_ms.single")
    return band.launched_ms(run["view"], SPANS)
