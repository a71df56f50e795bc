"""Device milliseconds per panorama of the edges blended on the area-gated
seam band: the union of the device work launched inside the stitcher's
``blend:band`` spans (``models/stitcher.py::Stitcher._blend``, one a
composite + blend call, graph replay or eager). The host queues an edge
and goes on, so its kernels run after its span has closed: the work is
found by the correlation id that ties each kernel, copy and memset (a
graph's nodes with it) to the runtime call that launched it, a call made
inside the span. None where the trace holds no such span."""

LAYER = "blend (models/blender.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "panorama_ms"
SPANS = ("blend:band",)
LAUNCHES = ("cuda_runtime", "cuda_driver")


def launched_ms(view, spans):
    """Device milliseconds per panorama of the work launched by the
    runtime calls inside the ``spans`` annotations of ``view``'s window
    (the union of their intervals); None when the window holds none."""
    w0, w1 = view.window
    marks = sorted((e["ts"], e["ts"] + e["dur"]) for e in view.host
                   if e.get("cat") == "user_annotation"
                   and e["name"] in spans
                   and w0 <= e["ts"] and e["ts"] + e["dur"] <= w1)
    if not marks or not view.panoramas:
        return None
    corr = set()
    for e in view.host:
        c = e.get("args", {}).get("correlation")
        if c is not None and e.get("cat") in LAUNCHES and any(
                s <= e["ts"] <= t for s, t in marks):
            corr.add(c)
    busy, at = 0.0, None
    for s, e in sorted((e["ts"], e["ts"] + e["dur"]) for e in view.device
                       if e.get("args", {}).get("correlation") in corr):
        s = s if at is None else max(s, at)
        if e > s:
            busy += e - s
            at = e
    return busy / 1e3 / view.panoramas


def read(run: dict):
    return launched_ms(run["view"], SPANS)
