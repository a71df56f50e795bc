"""CUDA graph misses per panorama in the traced window: the program's
``capture:<program>`` spans (a key captured anew, after a first use or an
eviction) and ``overflow:<program>`` spans (a key run eagerly because the
stitch's scope holds every graph kept), over the panoramas
(``core/programs.py``). None where the trace holds no ``stitch`` span: a
program without the spans."""

LAYER = "programs (core/programs.py)"
UNIT = "misses/panorama"
SOURCE = "program_span"
MOVES = "panorama_ms"
ROOT = "stitch"
MISSES = ("capture:", "overflow:")


def misses(view, root: str):
    """The ``MISSES`` annotations of ``view``'s window per panorama; None
    without a ``root`` annotation there."""
    w0, w1 = view.window
    notes = [e["name"] for e in view.host
             if e.get("cat") == "user_annotation" and w0 <= e["ts"] <= w1]
    if root not in notes or not view.panoramas:
        return None
    return sum(n.startswith(MISSES) for n in notes) / view.panoramas


def read(run: dict):
    return misses(run["view"], ROOT)
