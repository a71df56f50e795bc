"""Host wall of the stitcher's ``stitching`` stage per panorama, the mean
over the traced run's untraced calls (``Stitcher.stage_times``: it does
not synchronise inside the stage, so it is the host's time)."""

LAYER = "orchestrator (models/stitcher.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "panorama_ms"
STAGE = "stitching"


def read(run: dict):
    return run["stage_ms"].get(STAGE)
