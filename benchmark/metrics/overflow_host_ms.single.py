"""Host milliseconds per panorama of the calls a full program scope runs
eagerly: the program's ``overflow`` total (``core/programs.py``: a key
that finds every graph its program keeps used by the stitch, such as the
edges of a stitch with more canvases than ``MAX_GRAPHS``), the mean over
the traced run's untraced calls (``Stitcher.stage_times``). None where no
call overflowed."""

LAYER = "programs (core/programs.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "panorama_ms"
TOTAL = "overflow"


def read(run: dict):
    return run["stage_ms"].get(TOTAL)
