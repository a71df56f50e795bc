"""Per-keypoint SIFT walks in plain PyTorch (the benchmark's frozen copy of
the port's ``ops/sift_walks.py``, its CPU path only): the orientation
histograms and the descriptors of ``sift_kernels``."""
from __future__ import annotations

from . import sift_kernels as sk

orientation_hist = sk.orientation_hist
descriptors = sk.descriptors
