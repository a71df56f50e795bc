"""Kernel B8 (the separable Gaussian's 1-D pass, one launch a pass of
every blur of the SIFT scale space and of the blend's pyramid): its device
milliseconds per panorama in the trace. Its device kernel is named here: a
kernel renamed by the program is renamed in this file. None where the
trace holds none (a program whose blur is not B8)."""

LAYER = "kernels (csrc/, via ops/_native.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "panorama_ms"
KERNELS = ("separable_blur_kernel",)


def read(run: dict):
    view = run["view"]
    ms = view.device_ms(KERNELS)
    if ms <= 0 or not view.panoramas:
        return None
    return ms / view.panoramas
