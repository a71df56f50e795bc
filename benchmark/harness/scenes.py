"""The benchmark's inputs: seeded synthetic scenes cut into overlapping
crops, a copy of the port's ``tools/scenes.py`` (its ``make_scene`` and
``crops`` give the same bits; a test holds them to the SHA-256 that the
port's tests pin). No photo set is on the machines the benchmark runs on,
so every frame is made here from a seed; the program receives only the
u8 frames."""
from __future__ import annotations

import numpy as np
import torch

SCRAMBLE = [2, 0, 3, 1]  # scene position of each image handed over


def make_scene(rng, h: int, w: int, scale: int) -> np.ndarray:
    """tests/test_integration.py::make_scene at ``scale`` times its feature
    size: box-smoothed noise (made at 1/scale and upsampled bilinearly)
    plus solid discs, at the same density per feature area."""
    lh, lw = -(-h // scale), -(-w // scale)
    img = rng.uniform(60, 200, (lh, lw, 3))
    for _ in range(3):
        img = (np.roll(img, 1, 0) + img + np.roll(img, -1, 0)) / 3
        img = (np.roll(img, 1, 1) + img + np.roll(img, -1, 1)) / 3
    t = torch.as_tensor(img).permute(2, 0, 1)[None]
    img = torch.nn.functional.interpolate(
        t, size=(h, w), mode="bilinear", align_corners=False)[0]
    img = img.permute(1, 2, 0).numpy().copy()
    n_blobs = int(25 * lh * lw / (140 * 200))
    for _ in range(n_blobs):
        cy, cx = rng.uniform(10, h - 10), rng.uniform(10, w - 10)
        r = rng.uniform(3, 9) * scale
        col = rng.uniform(0, 255, 3)
        y0, y1 = int(max(cy - r, 0)), int(min(cy + r + 1, h))
        x0, x1 = int(max(cx - r, 0)), int(min(cx + r + 1, w))
        ys, xs = np.mgrid[y0:y1, x0:x1]
        m = (ys - cy) ** 2 + (xs - cx) ** 2 < r * r
        img[y0:y1, x0:x1][m] = col
    return np.clip(img, 0, 255).astype(np.uint8)


def crops(h: int, w: int, step: int, scale: int, seed: int, n: int = 4):
    """``n`` overlapping [h, w, 3] u8 crops of one deterministic scene."""
    scene = make_scene(np.random.default_rng(seed), h, w + (n - 1) * step,
                       scale)
    return [np.ascontiguousarray(scene[:, i * step: i * step + w])
            for i in range(n)]


def scrambled(images):
    return [images[k] for k in SCRAMBLE]

