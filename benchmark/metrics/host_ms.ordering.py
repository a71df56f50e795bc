"""Wall of the stitcher's ``ordering`` stage per panorama (graph ordering:
kernel B5 over every i < j pair of the frames, its counts read back, the
adjacency and start frame on the host), the mean over the traced run's
untraced calls (``Stitcher.stage_times``). The stage ends in the counts'
readback, so the device's time is in it."""

LAYER = "orchestrator (models/stitcher.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "panorama_ms"
STAGE = "ordering"


def read(run: dict):
    return run["stage_ms"].get(STAGE)
