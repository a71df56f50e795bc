"""``graph_pool_gib`` of the cells whose memory is read as
``device_mem_gib.4k``: reserved bytes of the CUDA graphs' private memory
pools after the window (``programs.graph_memory``, from the allocator's
segments)."""

LAYER = "programs (core/programs.py)"
UNIT = "GiB"
SOURCE = "program_counter"
MOVES = "device_mem_gib.4k"


def read(run: dict):
    mem = run["graph_memory"]
    return None if mem is None else mem["graph_pools_reserved_gib"]
