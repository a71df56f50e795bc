"""``graph_misses.single`` (whose arithmetic it takes) for a batch: the
``capture:*`` and ``overflow:*`` spans per member panorama, under the
``batch_chain`` span of ``parallel/batched.py::batched_stitch_chain``."""
from harness import registry

LAYER = "programs (core/programs.py)"
UNIT = "misses/panorama"
SOURCE = "program_span"
MOVES = "panoramas_per_s"
ROOT = "batch_chain"


def read(run: dict):
    single = registry.reader("metrics", "graph_misses.single")
    return single.misses(run["view"], ROOT)
