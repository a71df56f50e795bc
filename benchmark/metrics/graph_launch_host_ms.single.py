"""Host milliseconds inside CUDA graph launches (``cudaGraphLaunch``
in the trace) per panorama of the traced calls, for one panorama (``Stitcher.stitch``: the features graph of each frame, the ordering's, the plan's, one an edge and the tail's)."""

LAYER = "programs (core/programs.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "panorama_ms"
EVENT = "GraphLaunch"


def read(run: dict):
    view = run["view"]
    if not view.panoramas:
        return None
    return view.host_ms(EVENT) / view.panoramas
