"""Reference-shaped API wrappers (counterpart of
``computervisionimagestich2_tpu.api.compat``), each on an explicit
``device``:

- ``ImageProcess(file_dic, pic_sum)``: construction runs the whole
  pipeline (ImageProcess.cpp:3-8); the panorama is ``.result`` (RGB
  uint8), ``save(path)`` writes it (src/ex6/main.cpp:14-16).
- ``Projection.imageProjection`` / ``Projection.bilinearInterpolation``
  (Projection.h:28-38).
- ``equalization(img, mode)`` (equalization.h:35).
- ``transfer(src, template)`` (transfer.h:30).

Arrays are numpy RGB uint8 [H, W, 3] in CImg's top-down row order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, StitchConfig
from ..device import resolve_device
from ..models import equalization as eq_model
from ..models import transfer as transfer_model
from ..models.stitcher import Stitcher
from ..ops import warp as warp_ops
from ..utils import load_image, save_image


def _image(img: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(img), dtype=torch.float32,
                           device=resolve_device(device))


def _u8(img: torch.Tensor) -> np.ndarray:
    return img.cpu().numpy().astype(np.uint8)


class Projection:
    """Static-method namespace matching the reference class."""

    @staticmethod
    def imageProjection(src: np.ndarray, angle_deg: float = 15.0,
                        device: str | torch.device = "cuda") -> np.ndarray:
        return _u8(warp_ops.cylindrical_project(_image(src, device),
                                                angle_deg))

    @staticmethod
    def bilinearInterpolation(src: np.ndarray, x: float, y: float,
                              channel: int,
                              device: str | torch.device = "cuda") -> int:
        img = _image(src, device)
        val = warp_ops.bilinear_sample(
            img, torch.tensor(x, dtype=torch.float32, device=img.device),
            torch.tensor(y, dtype=torch.float32, device=img.device))
        return int(val[channel])


class ImageProcess:
    """Construction = execution, like the reference (ImageProcess.cpp:3-8)."""

    def __init__(self, file_dic: str, pic_sum: int,
                 config: StitchConfig = DEFAULT_CONFIG,
                 device: str | torch.device = "cuda"):
        paths = [f"{file_dic.rstrip('/')}/{i}.bmp"
                 for i in range(1, pic_sum + 1)]
        images = [load_image(p) for p in paths]
        self._stitcher = Stitcher(config, device)
        self.result: np.ndarray = self._stitcher.stitch(images)

    def save(self, path: str) -> None:
        save_image(path, self.result)

    @property
    def stage_times(self):
        return self._stitcher.stage_times


def equalization(img: np.ndarray, mode: int = 1,
                 device: str | torch.device = "cuda") -> np.ndarray:
    """equalization(src, mode) (equalization.cpp:4-25). mode 1 = color
    (returns the equalized image); mode 0 = gray, whose reference computes
    the equalized gray image but writes the original back (colorOutput is
    never updated, equalization.cpp:24), so the input comes back
    unchanged."""
    if mode == 1:
        return _u8(eq_model.equalize_color(_image(img, device)))
    if mode == 0:
        return np.asarray(img)
    raise ValueError("ERROR mode input!")  # equalization.cpp:21


def transfer(src: np.ndarray, template: np.ndarray,
             device: str | torch.device = "cuda") -> np.ndarray:
    """transfer(src, template, output) ctor (transfer.cpp:4-13)."""
    return _u8(transfer_model.color_transfer(_image(src, device),
                                             _image(template, device)))
