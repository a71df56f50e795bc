"""Host milliseconds of the frames' upload per panorama, untraced: the
stitcher's ``upload`` total (``Stitcher.prepare``: the frames stacked on
the host and copied to the device), the mean over the traced run's
untraced calls (``Stitcher.stage_times``)."""

LAYER = "orchestrator (models/stitcher.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "panorama_ms"
TOTAL = "upload"


def read(run: dict):
    return run["stage_ms"].get(TOTAL)
