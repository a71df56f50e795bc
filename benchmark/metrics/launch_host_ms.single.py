"""Host milliseconds inside CUDA graph launches per panorama, untraced:
the program's ``launch`` total (``core/programs.py``: the span around each
graph's replay call, ``cudaGraphLaunch`` with its device guard), the mean
over the traced run's untraced calls (``Stitcher.stage_times``). The
traced ``graph_launch_host_ms.single`` adds the profiler's cost on every
graph node."""

LAYER = "programs (core/programs.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "panorama_ms"
TOTAL = "launch"


def read(run: dict):
    return run["stage_ms"].get(TOTAL)
