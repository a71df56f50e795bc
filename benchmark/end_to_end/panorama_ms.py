"""The whole window over the panoramas completed in it (host clock): u8
frames in, the u8 panorama on the host out, one caller in a closed loop.
What a user waits for."""


def read(timing: dict, peak: int) -> float:
    return timing["window_s"] * 1e3 / timing["panoramas"]
