"""Device milliseconds per panorama inside the stitcher's ``stitching``
stage: as ``device_busy_ms.features`` (whose arithmetic it takes), for
the ``stage:stitching`` spans. ``host_ms.stitching`` minus this is the
stage's idle time."""
from harness import registry

LAYER = "device (H100) inside the stitcher's stitching stage"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "panorama_ms"
SPAN = "stage:stitching"


def read(run: dict):
    features = registry.reader("metrics", "device_busy_ms.features")
    return features.busy_ms(run["view"], SPAN)
