"""Panoramas completed over the whole window (host clock): a photo
service's throughput, batches of frame sets in, u8 canvases out."""


def read(timing: dict, peak: int) -> float:
    return timing["panoramas"] / timing["window_s"]
