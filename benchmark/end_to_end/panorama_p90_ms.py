"""The 90th percentile of the window's calls of one panorama each (host
clock, every call of the window; numpy's linear interpolation)."""
import numpy as np


def read(timing: dict, peak: int) -> float:
    per = np.asarray(timing["durations"]) / timing["per_call"]
    return float(np.percentile(per, 90)) * 1e3
