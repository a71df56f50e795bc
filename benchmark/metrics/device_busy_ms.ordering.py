"""Device milliseconds per panorama inside the stitcher's ``ordering``
stage: as ``device_busy_ms.features`` (whose arithmetic it takes), for
the ``stage:ordering`` spans: B5 over every pair of the frames and the
counts' copy back. ``host_ms.ordering`` minus this is the stage's idle
time."""
from harness import registry

LAYER = "device (H100) inside the stitcher's ordering stage"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "panorama_ms"
SPAN = "stage:ordering"


def read(run: dict):
    features = registry.reader("metrics", "device_busy_ms.features")
    return features.busy_ms(run["view"], SPAN)
