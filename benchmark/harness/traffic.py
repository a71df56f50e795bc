"""The one generator every traffic mix goes through: a configuration's
frame geometry and a mix's parameters in, the frame sets of a run out,
each made from ``--seed``.

A mix (``traffic/<name>.json``) says which entry of the program it drives
(``entry``), whether every call sees one frame set (``"sets": "same"``) or
takes the next of a bank (``"sets": "bank"``, ``bank`` sets, ``batch`` of
them a call), in which order the frames are handed over (``order``:
``"scrambled"``, the reference app's any-order use, or ``"chain"``, scene
order), how many calls the traced run traces (``trace_calls``) and how
many of the window's outputs the check compares (``check_samples``)."""
from __future__ import annotations

import numpy as np

from . import scenes


def frame_set(geom: dict, order: str, seed) -> np.ndarray:
    """One set of ``geom["count"]`` overlapping u8 crops [N, H, W, 3] of
    the scene of ``seed``, in ``order``."""
    imgs = scenes.crops(geom["height"], geom["width"], geom["step"],
                        geom["feature_scale"], seed, geom["count"])
    if order == "scrambled":
        if geom["count"] != len(scenes.SCRAMBLE):
            raise ValueError(f"the scrambled order is of "
                             f"{len(scenes.SCRAMBLE)} frames, not "
                             f"{geom['count']}")
        imgs = scenes.scrambled(imgs)
    elif order != "chain":
        raise ValueError(f"unknown frame order {order!r}")
    return np.stack(imgs)


def frame_sets(geom: dict, mix: dict, seed: int) -> list[np.ndarray]:
    """The distinct frame sets a run's calls take: one under
    ``"sets": "same"`` (the scene of ``seed``), ``mix["bank"]`` under
    ``"sets": "bank"`` (set i the scene of the seed sequence (seed,
    i))."""
    if mix["sets"] == "same":
        return [frame_set(geom, mix["order"], seed)]
    if mix["sets"] == "bank":
        return [frame_set(geom, mix["order"], np.random.SeedSequence(
            [int(seed), i])) for i in range(int(mix["bank"]))]
    raise ValueError(f"unknown sets {mix['sets']!r}")


def call_sets(mix: dict, n_sets: int, call: int) -> list[int]:
    """The indices of the sets call ``call`` (0, 1, ...) takes: the one
    set, or the next ``batch`` of the bank in turn."""
    if mix["sets"] == "same":
        return [0]
    b = int(mix["batch"])
    return [(call * b + k) % n_sets for k in range(b)]
