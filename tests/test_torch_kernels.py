"""The CUDA kernels of the PyTorch port against their plain versions, and
the wrappers' dispatch rule: a CPU tensor takes the plain PyTorch version,
a CUDA tensor launches the kernel or raises.

This file imports no jax, so the ``cuda``-marked tests also run on a GPU
machine without it (``tests/conftest.py`` imports jax; skip it there):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Without a GPU they skip: a CUDA kernel has no CPU mode.
"""
import dataclasses

import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu_torch import SLICE_CONFIG
from computervisionimagestich2_tpu_torch.models.stitcher import Stitcher
from computervisionimagestich2_tpu_torch.ops import _native
from computervisionimagestich2_tpu_torch.ops import warp as twarp

T = torch.as_tensor
WARP_COEFFS = np.array([1.01, 0.02, 1e-4, -7.5, -0.015, 0.99, 2e-4, 5.25],
                       np.float32)


def _u8_image(seed, h, w):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, 3)).astype(np.float32)


def _walk_inputs(seed=12, h=96, w=80, n=48, nv=31):
    """Gradient planes and keypoint lists, some keypoints off the image."""
    rng = np.random.default_rng(seed)
    mod = rng.random((h, w), dtype=np.float32)
    ang = (rng.random((h, w)) * 2 * np.pi).astype(np.float32)
    x = (rng.random(n) * (w - 1) * 1.06 - 2).astype(np.float32)
    y = (rng.random(n) * (h - 1) * 1.06 - 2).astype(np.float32)
    sig = (1.2 + rng.random(n) * 2.5).astype(np.float32)
    a0 = (rng.random(n) * 2 * np.pi).astype(np.float32)
    return mod, ang, x, y, sig, a0, np.array([nv], np.int32)


def _scene(seed=0, h=120, w=200):
    """Noise plus solid discs: enough texture for SIFT and RANSAC."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(60, 200, (h, w, 3))
    ys, xs = np.mgrid[0:h, 0:w]
    for _ in range(20):
        cy, cx = rng.uniform(10, h - 10), rng.uniform(10, w - 10)
        r = rng.uniform(3, 9)
        img[(ys - cy) ** 2 + (xs - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    return img.astype(np.uint8)


# ------------------------------------------------------ dispatch, device
def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor never reaches a kernel: no launch is counted and no
    library is built."""
    _native.reset_launch_counts()
    src = T(_u8_image(11, 20, 20))
    coef = T(np.array([1, 0, 0, 0, 0, 1, 0, 0], np.float32))
    out = twarp.warp_image(src, coef, 0.0, 0.0, (20, 20))
    torch.testing.assert_close(out, src)
    assert _native.launch_counts() == dict.fromkeys(_native.LAUNCHES, 0)


def test_cuda_device_raises_without_gpu():
    from computervisionimagestich2_tpu_torch.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


# -------------------------------------------- kernels vs plain (on the card)
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_b2_b3_match_plain(cuda_device):
    """B2 raw histograms rtol 1e-5 and B3 descriptors atol 2e-6 against
    the plain versions on the CPU (the tolerances of the Pallas kernels'
    own tests); equal ``ok``."""
    from computervisionimagestich2_tpu_torch.ops import sift_walks

    args = [T(a) for a in _walk_inputs()]
    mod, ang, x, y, sig, a0, nv = args
    hc, okc = sift_walks.orientation_hist(mod, ang, x, y, sig, nv, 17)
    g = [a.to(cuda_device) for a in args]
    hg, okg = sift_walks.orientation_hist(g[0], g[1], g[2], g[3], g[4],
                                          g[6], 17)
    torch.cuda.synchronize()
    np.testing.assert_allclose(hg.cpu().numpy(), hc.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(okg.cpu(), okc)
    dc, okc = sift_walks.descriptors(mod, ang, x, y, sig, a0, nv, 28)
    dg, okg = sift_walks.descriptors(*g, 28)
    torch.cuda.synchronize()
    np.testing.assert_allclose(dg.cpu().numpy(), dc.numpy(), atol=2e-6)
    assert torch.equal(okg.cpu(), okc)


@pytest.mark.cuda
def test_kernel_b4_b6_match_plain(cuda_device):
    """B4 d1/d2 rtol 1e-5 in both directions; B6 exact."""
    from computervisionimagestich2_tpu_torch.ops import distance

    rng = np.random.default_rng(13)
    q = T(rng.random((300, 128), dtype=np.float32))
    r = T(rng.random((260, 128), dtype=np.float32))
    qv, rv = T(np.arange(300) < 250), T(np.arange(260) < 200)
    cpu = distance.two_nearest_bidir(q, r, qv, rv)
    gpu = distance.two_nearest_bidir(*(a.to(cuda_device)
                                       for a in (q, r, qv, rv)))
    for (c1, c2, _), (g1, g2, _) in zip(cpu, gpu):
        np.testing.assert_allclose(g1.cpu().numpy(), c1.numpy(), rtol=1e-5)
        np.testing.assert_allclose(g2.cpu().numpy(), c2.numpy(), rtol=1e-5)

    src = T(_u8_image(14, 60, 50))
    coef = T(WARP_COEFFS)
    ref = twarp.warp_image(src, coef, -3.5, -7.25, (80, 90))
    out = twarp.warp_image(src.to(cuda_device), coef.to(cuda_device), -3.5,
                           -7.25, (80, 90))
    assert torch.equal(out.cpu(), ref)


@pytest.mark.cuda
def test_slice_on_card_goes_through_the_kernels(cuda_device):
    """A small stitch on the card launches every kernel and gives the
    canvas of the CPU run: shape within +-3 px, MAD <= 3 u8 levels (the
    end-to-end gate of tests/test_torch_stitch.py)."""
    img = _scene()
    crops = [img[:, :120], img[:, 80:]]
    cfg = dataclasses.replace(SLICE_CONFIG, sift=dataclasses.replace(
        SLICE_CONFIG.sift, n_octaves=2, max_keypoints_per_octave=512,
        max_keypoints=1024))
    _native.reset_launch_counts()
    out = Stitcher(cfg, device=cuda_device).stitch(crops)
    counts = _native.launch_counts()
    assert all(c > 0 for c in counts.values()), counts
    ref = Stitcher(cfg, device="cpu").stitch(crops)
    assert abs(out.shape[0] - ref.shape[0]) <= 3, (out.shape, ref.shape)
    assert abs(out.shape[1] - ref.shape[1]) <= 3, (out.shape, ref.shape)
    h, w = min(out.shape[0], ref.shape[0]), min(out.shape[1], ref.shape[1])
    mad = np.abs(out[:h, :w].astype(np.int64)
                 - ref[:h, :w].astype(np.int64)).mean()
    assert mad <= 3.0, mad
