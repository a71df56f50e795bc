"""Canvas planning and compositing (counterpart of
``computervisionimagestich2_tpu.models.compose``).

- ``canvas_plan`` <- getMin/MaxX/YAfterWarping + the min/max clamps
  (ImageProcess.cpp:206-216, 532-594): host math on the forward model's 8
  (bilinear) or 9 (projective) floats.
- ``bucket_size``  pads a canvas extent onto a geometric size grid
  (``exact_canvas=False`` and the streaming canvas).
- ``composite``   <- warpingImageByHomography + movingImageByOffset
  (ImageProcess.cpp:596-620): the inverse warp (kernel B6 on CUDA, either
  model) and the offset copy onto one canvas size, from host floats or
  device tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.warp import shift_image, warp_image


def bucket_size(v: int, base: int = 128, ratio: float = 1.3) -> int:
    """Smallest size >= v on the geometric grid base, ceil(base * ratio /
    base) * base, ...: a chain of N edges then blends O(log) distinct
    canvas sizes."""
    s = base
    while s < v:
        s = int(math.ceil(s * ratio / base) * base)
    return s


def warp_corners(coeffs: np.ndarray, w: int, h: int,
                 model: str = "bilinear") -> np.ndarray:
    """Warp the 4 corners (0,0), (w-1,0), (0,h-1), (w-1,h-1) in float32
    under ``model``. Returns [4, 2]."""
    c = np.asarray(coeffs, dtype=np.float32)
    xs = np.array([0, w - 1, 0, w - 1], np.float32)
    ys = np.array([0, 0, h - 1, h - 1], np.float32)
    if model == "bilinear":
        xw = c[0] * xs + c[1] * ys + c[2] * xs * ys + c[3]
        yw = c[4] * xs + c[5] * ys + c[6] * xs * ys + c[7]
    elif model == "projective":
        den = c[6] * xs + c[7] * ys + c[8]
        xw = (c[0] * xs + c[1] * ys + c[2]) / den
        yw = (c[3] * xs + c[4] * ys + c[5]) / den
    else:
        raise ValueError(f"unknown warp model {model!r}")
    return np.stack([xw, yw], axis=-1)


def canvas_plan(forward_coeffs: np.ndarray, src_shape: tuple[int, int],
                result_shape: tuple[int, int], model: str = "bilinear"):
    """New canvas size and offsets (ImageProcess.cpp:206-216).

    src_shape / result_shape: (H, W). Returns (new_h, new_w, min_x, min_y);
    the minima are clamped to <= 0 and the maxima to >= the current
    result's extents."""
    src_h, src_w = src_shape
    res_h, res_w = result_shape
    corners = warp_corners(forward_coeffs, src_w, src_h, model)
    min_x = float(min(corners[:, 0].min(), 0.0))
    min_y = float(min(corners[:, 1].min(), 0.0))
    max_x = float(max(corners[:, 0].max(), float(res_w)))
    max_y = float(max(corners[:, 1].max(), float(res_h)))
    return (int(math.ceil(max_y - min_y)), int(math.ceil(max_x - min_x)),
            min_x, min_y)


def composite(src_img: torch.Tensor, result_img: torch.Tensor,
              backward_coeffs, min_x, min_y,
              canvas_hw: tuple[int, int], model: str = "bilinear"):
    """The two canvases of one stitch step (ImageProcess.cpp:218-224):
    a = src_img inverse-warped through backward_coeffs at offset (min_x,
    min_y); b = the previous result shifted by the truncated offsets. The
    model and offsets are host floats, or device tensors (the plan's
    rows, as the programs hand them over), which pass through to the warp
    and the shift, so nothing is read back."""
    a = warp_image(src_img, backward_coeffs, min_x, min_y, canvas_hw, model)
    if not isinstance(min_x, torch.Tensor):
        min_x, min_y = int(min_x), int(min_y)
    b = shift_image(result_img, min_x, min_y, canvas_hw)
    return a, b
