"""Device-to-host copies per panorama in the trace: the u8 panorama's
readback, with the ordering's counts and the plan (a few bytes each)."""

LAYER = "enhance (models/equalization.py) and the readback"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "panorama_ms"
EVENT = "DtoH"


def read(run: dict):
    view = run["view"]
    if not view.panoramas:
        return None
    ms = view.device_ms([EVENT])
    return ms / view.panoramas if ms > 0 else None
