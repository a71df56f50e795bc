"""Set-up: from the process's start to the window's, on the host clock:
imports, the frames made from the seed, the kernels loaded (built on a
checkout's first run), the program built and its cold and warm calls,
whose first captures the cell's CUDA graphs."""


def read(timing: dict, peak: int) -> float:
    return timing["setup_s"]
