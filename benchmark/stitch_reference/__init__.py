"""The plain reference the benchmark holds the port to: a frozen copy of
the port's plain PyTorch path (its configuration dataclasses, SIFT,
matching, RANSAC, the plan, composite + blend and equalisation), taken
from the port at the commit the benchmark was written against and cut to
what ``pipeline.stitch`` and ``pipeline.stitch_fixed`` run.

It imports nothing of the port and runs no CUDA kernel and no CUDA
graph: where the copied docstrings name a kernel (B1-B7) or a program,
they describe the port; here the plain version always runs, eagerly, on
whatever device the frames are on. ``config.SiftConfig.
scale_space_dtype`` is its one addition, for the lower-precision
control.
"""
