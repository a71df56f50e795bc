"""The share of the traced window in which the device ran nothing:
1 - busy / window, busy the union of its kernels, copies and memsets."""

LAYER = "device (H100, kernels in csrc/)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "panorama_ms"


def read(run: dict):
    view = run["view"]
    return (1.0 - view.busy_s() / view.window_s()) * 100.0
