"""Device milliseconds per panorama inside the stitcher's ``features``
stage: the union of the device's kernels, copies and memsets within each
``stage:features`` span of the traced window, over the panoramas. The
stage ends in a synchronise, so its device work lies inside its span:
``host_ms.features`` minus this is the stage's idle time."""

LAYER = "device (H100) inside the stitcher's features stage"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "panorama_ms"
SPAN = "stage:features"


def busy_ms(view, span: str):
    """Device milliseconds per panorama inside the ``span`` annotations
    of ``view``'s window; None when it holds none."""
    w0, w1 = view.window
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in view.host
             if e["name"] == span and e.get("cat") == "user_annotation"
             and w0 <= e["ts"] and e["ts"] + e["dur"] <= w1]
    if not spans or not view.panoramas:
        return None
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in view.device)
    busy = 0.0
    for s0, s1 in spans:
        at = s0
        for s, e in device:
            if s >= s1:
                break
            s, e = max(s, at), min(e, s1)
            if e > s:
                busy += e - s
                at = e
    return busy / 1e3 / view.panoramas


def read(run: dict):
    return busy_ms(run["view"], SPAN)
