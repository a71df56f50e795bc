"""Kernel B4 (bidirectional L1 2-NN, one launch per edge of the plan):
the least time the card needs for the work of each edge's live
descriptors (``harness/work.py::l1_bidir``) over its device time in the
trace, per panorama. Its device kernels are named here: a kernel renamed
by the program is renamed in this file."""
from harness import work

LAYER = "kernels (csrc/, via ops/_native.py)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "panorama_ms"
KERNELS = ("l1_bidir_tile_kernel", "l1_bidir_merge_kernel")


def read(run: dict):
    view, records = run["view"], run["records"]
    ms = view.device_ms(KERNELS)
    if not records or ms <= 0 or not view.panoramas:
        return None
    rec = records[0][1][0]
    if "features" not in rec or "edges" not in rec:
        return None
    live = [int(f[3].sum()) for f in rec["features"]]
    cap = -(-max(max(live), 512) // 512) * 512  # the live prefix's slots
    need = sum(work.l1_bidir(live[s], live[d], cap, cap)
               for s, d, _ in rec["edges"])
    return need * 1e3 / (ms / view.panoramas) * 100.0
