"""Host milliseconds inside CUDA graph launches (``cudaGraphLaunch``
in the trace) per panorama of the traced calls, for a batch member (``_stitch_one_fixed``, one graph a member)."""

LAYER = "programs (core/programs.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "panoramas_per_s"
EVENT = "GraphLaunch"


def read(run: dict):
    view = run["view"]
    if not view.panoramas:
        return None
    return view.host_ms(EVENT) / view.panoramas
