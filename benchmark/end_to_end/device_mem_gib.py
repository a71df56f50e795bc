"""The caching allocator's peak reserved device memory over the run up to
the window's close, the CUDA graphs' private pools with it
(``torch.cuda.max_memory_reserved``): what bounds frame size and batch."""


def read(timing: dict, peak: int) -> float:
    return peak / 2 ** 30
