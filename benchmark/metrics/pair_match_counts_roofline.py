"""Kernel B5 (the ordering's all-pairs match counts): the least time the
card needs for the work its inputs need (every i < j pair of the frames'
live descriptors, ``harness/work.py::pair_counts``) over its device time
in the trace, per panorama. Its device kernels are named here: a kernel
renamed by the program is renamed in this file."""
from harness import work

LAYER = "kernels (csrc/, via ops/_native.py)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "panorama_ms"
KERNELS = ("pair_plan_kernel", "pair_tile_kernel", "pair_count_kernel")


def read(run: dict):
    view, records = run["view"], run["records"]
    ms = view.device_ms(KERNELS)
    if not records or ms <= 0 or not view.panoramas:
        return None
    rec = records[0][1][0]
    if "features" not in rec:
        return None
    live = [int(f[3].sum()) for f in rec["features"]]
    cap = -(-max(max(live), 512) // 512) * 512  # the live prefix's slots
    return work.pair_counts(live, cap) * 1e3 / (ms / view.panoramas) * 100.0
