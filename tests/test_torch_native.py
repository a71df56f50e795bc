"""The port's native BMP codec (``computervisionimagestich2_tpu_torch.
native.codec``, built with g++ at first use from the port's own
``codec.cpp``) against the port's numpy codec and the JAX package's, and
the choice ``utils.io`` makes between them.
"""
import re
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu.utils import bmp as jbmp
from computervisionimagestich2_tpu_torch.native import codec
from computervisionimagestich2_tpu_torch.utils import bmp, io

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """A thread pool per pytest worker oversubscribes the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(seed: int, h: int, w: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def _bmp_bytes(img: np.ndarray, bpp: int, top_down: bool) -> bytes:
    """A BMP of ``img`` written by hand: 24- or 32-bit BGR(X), or 8-bit
    with a palette of the image's own colours, bottom-up or top-down."""
    h, w = img.shape[:2]
    palette = b""
    if bpp == 8:
        colours, idx = np.unique(img.reshape(-1, 3), axis=0,
                                 return_inverse=True)
        assert len(colours) <= 256
        palette = np.concatenate(
            [colours[:, ::-1], np.zeros((len(colours), 1), np.uint8)],
            axis=1).tobytes()
        px = idx.reshape(h, w).astype(np.uint8)[..., None]
    elif bpp == 32:
        px = np.concatenate([img[..., ::-1], np.full((h, w, 1), 7, np.uint8)],
                            axis=2)
    else:
        px = img[..., ::-1]
    stride = (w * bpp + 31) // 32 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * bpp // 8] = px.reshape(h, -1)
    if not top_down:
        rows = rows[::-1]
    offset = 54 + len(palette)
    n_colours = len(palette) // 4
    header = struct.pack("<2sIHHI", b"BM", offset + rows.size, 0, 0, offset)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp,
                       0, rows.size, 2835, 2835, n_colours, 0)
    return header + info + palette + rows.tobytes()


@pytest.mark.parametrize("hw", [(37, 53), (1, 1), (8, 4), (5, 2)])
def test_roundtrip(tmp_path, hw):
    """write_bmp then read_bmp gives the image back, at widths whose rows
    need 0-3 bytes of padding; the file equals the numpy codec's."""
    img = _image(0, *hw)
    p = tmp_path / "x.bmp"
    codec.write_bmp(str(p), img)
    np.testing.assert_array_equal(codec.read_bmp(str(p)), img)
    assert p.read_bytes() == bmp.encode_bmp(img)


def test_write_gray_and_float(tmp_path):
    """A 2-D image is written as gray RGB, a float one clipped to u8, as
    the numpy codec does; another channel count is refused."""
    gray = _image(1, 9, 11)[..., 0]
    flt = np.random.default_rng(2).uniform(-20, 280, (6, 7, 3))
    for k, img in enumerate((gray, flt)):
        p = tmp_path / f"{k}.bmp"
        codec.write_bmp(str(p), img)
        assert p.read_bytes() == bmp.encode_bmp(img)
    with pytest.raises(ValueError):
        codec.write_bmp(str(tmp_path / "x.bmp"), _image(3, 4, 4)[..., :2])


@pytest.mark.parametrize("bpp", [24, 32, 8])
@pytest.mark.parametrize("top_down", [False, True],
                         ids=["bottom_up", "top_down"])
def test_read_equals_numpy_and_jax_codecs(tmp_path, bpp, top_down):
    """read_bmp on a file of each supported layout equals the port's numpy
    codec and the JAX package's ``utils/bmp.read_bmp``, pixel for pixel."""
    img = _image(4, 13, 19)
    if bpp == 8:  # at most 256 colours
        img = (img // 64 * 64).astype(np.uint8)
    p = tmp_path / "x.bmp"
    p.write_bytes(_bmp_bytes(img, bpp, top_down))
    got = codec.read_bmp(str(p))
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, bmp.read_bmp(str(p)))
    np.testing.assert_array_equal(got, jbmp.read_bmp(str(p)))


def test_load_batch_equals_read_bmp(tmp_path):
    """load_batch of four files (one thread each) equals four read_bmp
    calls; a file of another size fails the batch with ValueError."""
    paths = []
    for k in range(4):
        paths.append(str(tmp_path / f"{k + 1}.bmp"))
        bmp.write_bmp(paths[-1], _image(10 + k, 24, 31))
    batch = codec.load_batch(paths, n_threads=4)
    assert batch.shape == (4, 24, 31, 3)
    for k, p in enumerate(paths):
        np.testing.assert_array_equal(batch[k], codec.read_bmp(p))
    bmp.write_bmp(paths[2], _image(20, 24, 30))
    with pytest.raises(ValueError, match="1 file"):
        codec.load_batch(paths)


def test_garbage_raises_value_error(tmp_path):
    p = tmp_path / "bad.bmp"
    p.write_bytes(b"NOTABMP" * 20)
    with pytest.raises(ValueError, match="not a BMP"):
        codec.read_bmp(str(p))
    with pytest.raises(ValueError):
        codec.load_batch([str(p)])


def test_library_is_built_under_build():
    """The library is built from the port's source into build/ at the root
    of the checkout, keyed by the source's hash, not beside the source."""
    assert codec.available(), codec.unavailable_reason()
    lib = codec.library_path()
    assert lib.exists()
    assert lib.parent.parent == REPO / "build" / "torch_native"
    package = REPO / "computervisionimagestich2_tpu_torch"
    assert not list(package.rglob("*.so"))


def test_codec_source_equals_jax(tmp_path):
    """The port's codec.cpp is the JAX package's byte for byte, but for the
    reference checkout's directory in two comments."""
    ours = codec.SRC.read_bytes()
    theirs = (REPO / "computervisionimagestich2_tpu" / "native"
              / "codec.cpp").read_bytes()
    assert ours == re.sub(rb"/\w+/reference/", b"", theirs)
    assert ours.count(b"\n") == theirs.count(b"\n")


@pytest.fixture
def fresh_choice(monkeypatch):
    """``utils.io`` as in a new process: no codec chosen yet."""
    monkeypatch.setattr(io, "_CODEC", None)


def test_io_takes_native_and_logs_it(tmp_path, capsys, fresh_choice):
    """With the codec available, load_image and save_image go through it,
    and the choice is logged once."""
    img = _image(5, 10, 12)
    p = str(tmp_path / "x.bmp")
    io.save_image(p, img)
    np.testing.assert_array_equal(io.load_image(p), img)
    assert io.codec() is codec
    err = capsys.readouterr().err
    assert err.count("codec=") == 1
    assert "codec=native" in err and str(codec.library_path()) in err


def test_io_falls_back_to_numpy_and_logs_it(tmp_path, capsys, monkeypatch,
                                            fresh_choice):
    """Without the native codec, utils.io takes the numpy one and says so
    with the reason; the pixels are the same."""
    monkeypatch.setattr(codec, "available", lambda: False)
    monkeypatch.setattr(codec, "_error", "no g++")
    img = _image(6, 10, 12)
    p = str(tmp_path / "x.bmp")
    io.save_image(p, img)
    np.testing.assert_array_equal(io.load_image(p), img)
    assert io.codec() is bmp
    err = capsys.readouterr().err
    assert "codec=numpy native_unavailable=no g++" in err
    assert err.count("codec=") == 1
