"""Kernel B8 (the separable Gaussian's 1-D pass) in the batch: its device
milliseconds per batch member in the trace (``_stitch_one_fixed``, whose
graph blurs the member's scale space and its edges' blends). Its device
kernel is named here: a kernel renamed by the program is renamed in this
file. None where the trace holds none."""

LAYER = "kernels (csrc/, via ops/_native.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "panoramas_per_s"
KERNELS = ("separable_blur_kernel",)


def read(run: dict):
    view = run["view"]
    ms = view.device_ms(KERNELS)
    if ms <= 0 or not view.panoramas:
        return None
    return ms / view.panoramas
