"""Minimal BMP codec (numpy only): the port's copy of
``computervisionimagestich2_tpu.utils.bmp``.

Replaces CImg's BMP I/O (CImg.h load_bmp/save_bmp) used by the reference
pipeline (ImageProcess.cpp:18, src/ex6/ImageProcess.cpp:15-16).
Supports the uncompressed 24/32-bit and 8-bit-palette BMPs used by the
reference datasets. Returns RGB uint8 arrays of shape [H, W, 3]
(row 0 = top row, matching CImg's coordinate convention).
"""
from __future__ import annotations

import struct

import numpy as np


def decode_bmp(data: bytes) -> np.ndarray:
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    pixel_offset = struct.unpack_from("<I", data, 10)[0]
    header_size = struct.unpack_from("<I", data, 14)[0]
    if header_size < 40:
        raise ValueError(f"unsupported BMP header size {header_size}")
    width, height = struct.unpack_from("<ii", data, 18)
    planes, bpp = struct.unpack_from("<HH", data, 26)
    compression = struct.unpack_from("<I", data, 30)[0]
    if compression not in (0, 3):  # BI_RGB / BI_BITFIELDS(treated as RGB masks)
        raise ValueError(f"unsupported BMP compression {compression}")

    flipped = height > 0
    height = abs(height)
    row_stride = ((width * bpp + 31) // 32) * 4

    raw = np.frombuffer(data, dtype=np.uint8, count=row_stride * height,
                        offset=pixel_offset)
    rows = raw.reshape(height, row_stride)

    if bpp == 24:
        px = rows[:, : width * 3].reshape(height, width, 3)
        rgb = px[:, :, ::-1]  # BGR -> RGB
    elif bpp == 32:
        px = rows[:, : width * 4].reshape(height, width, 4)
        rgb = px[:, :, 2::-1]
    elif bpp == 8:
        n_colors = struct.unpack_from("<I", data, 46)[0] or 256
        palette = np.frombuffer(
            data, dtype=np.uint8, count=n_colors * 4, offset=14 + header_size
        ).reshape(n_colors, 4)[:, 2::-1]  # BGRX -> RGB
        idx = rows[:, :width]
        rgb = palette[idx]
    else:
        raise ValueError(f"unsupported BMP bpp {bpp}")

    if flipped:
        rgb = rgb[::-1]
    return np.ascontiguousarray(rgb)


def encode_bmp(img: np.ndarray) -> bytes:
    """Encode an RGB (or grayscale) uint8 image as a 24-bit BMP."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    h, w, _ = img.shape
    row_stride = ((w * 3 + 3) // 4) * 4
    rows = np.zeros((h, row_stride), dtype=np.uint8)
    rows[:, : w * 3] = img[::-1, :, ::-1].reshape(h, w * 3)  # bottom-up BGR
    pixel_data = rows.tobytes()
    file_size = 14 + 40 + len(pixel_data)
    header = struct.pack("<2sIHHI", b"BM", file_size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(pixel_data),
                       2835, 2835, 0, 0)
    return header + info + pixel_data


def read_bmp(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_bmp(f.read())


def write_bmp(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_bmp(img))
