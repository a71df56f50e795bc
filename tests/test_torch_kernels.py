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

from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG, SLICE_CONFIG
from computervisionimagestich2_tpu_torch.models.stitcher import Stitcher
from computervisionimagestich2_tpu_torch.core.programs import const
from computervisionimagestich2_tpu_torch.models import blender
from computervisionimagestich2_tpu_torch.ops import (_native, detect, distance,
                                                     gaussian)
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


def _dog_inputs():
    """(dog, peak_thresh, capacity) cases of kernel B1: random DoG stacks
    (tests/test_pallas_sift.py:116-163, including a binding capacity) and
    one row of 298 strict extrema, more than the 128 a row keeps."""
    rng = np.random.default_rng(11)
    cases = [(rng.normal(size=(4, h, w)).astype(np.float32) * 2, 1.0, 512)
             for h, w in ((64, 96), (61, 130), (33, 40))]
    rng = np.random.default_rng(5)
    cases.append((rng.normal(size=(4, 48, 64)).astype(np.float32) * 3, 0.5,
                  8))
    cases.append((row_overflow_dog(), 1.0, 512))
    return cases


def row_overflow_dog(w=300):
    """A DoG stack whose level-1 row 3 alternates +-5 over width ``w`` and
    is zero elsewhere: every interior x of that row is a strict maximum or
    minimum, so the row holds w - 2 hits."""
    dog = np.zeros((4, 8, w), np.float32)
    dog[1, 3] = np.where(np.arange(w) % 2 == 0, 5.0, -5.0)
    return dog


def _pair_inputs(asymmetric=False):
    """tests/test_pallas_distance.py:115-136: four images of 256 slots with
    lives 200/130/256/77 and two clustered pairs. ``asymmetric`` adds ten
    second copies of matched references to image 1: they pass as queries
    against image 0 but make the ratio test fail the other way, so the
    two columns differ and a swapped (i, j) shows."""
    rng = np.random.default_rng(0)
    n, cap, f = 4, 256, 128
    desc = rng.random(size=(n, cap, f)).astype(np.float32)
    desc[1, :50] = desc[0, 10:60] + rng.normal(size=(50, f)) * 1e-3
    desc[3, :40] = desc[2, 5:45] + rng.normal(size=(40, f)) * 1e-3
    if asymmetric:
        desc[1, 60:70] = desc[0, 10:20] + rng.normal(size=(10, f)) * 1e-3
    valid = np.stack([np.arange(cap) < nv for nv in (200, 130, 256, 77)])
    pairs = np.asarray([(i, j) for i in range(n) for j in range(i + 1, n)],
                       np.int32)
    return desc, valid, pairs


PAIR_CASES = ["reference", "asymmetric", "empty", "holes", "dups", "n5"]


def _pair_case(case):
    """Kernel B5's cases (desc [N, CAP, 128], valid [N, CAP], all i<j
    pairs): the two standing ones; an image with no valid row; masks with
    holes inside the live prefix and across the 64-row tile edge;
    descriptors duplicated across a tile edge (exact d1 = d2 ties, which
    fail the ratio test, and d1 = 0 matches); five images of 192 slots with
    live counts on and beside tile edges (10 pairs); ten images (45
    pairs)."""
    if case in ("reference", "asymmetric"):
        return _pair_inputs(case == "asymmetric")
    if case in ("n5", "n10"):
        n, cap = (5, 192) if case == "n5" else (10, 256)
        rng = np.random.default_rng(31)
        desc = rng.random(size=(n, cap, 128)).astype(np.float32)
        lives = [(192, 100, 150, 64, 65, 129, 1, 180, 30, 128)[m]
                 for m in range(n)]
        for m in range(1, n):  # each image shares 20 + m rows with the last
            k = min(20 + m, lives[m], lives[m - 1])
            desc[m, :k] = (desc[m - 1, 5:5 + k]
                           + rng.normal(size=(k, 128)) * 1e-3)
        valid = np.stack([np.arange(cap) < nv for nv in lives])
    else:
        desc, valid, _ = _pair_inputs()
        valid = valid.copy()
        if case == "empty":
            valid[1] = False
        elif case == "holes":
            valid[0, 20:35] = False    # matched references of image 1
            valid[2, 60:70] = False    # across the first tile edge
            valid[1, [0, 3, 63, 64]] = False
            valid[3, 10:20] = False
        elif case == "dups":
            desc[0, 64] = desc[0, 63]    # two equal references: d1 = d2
            desc[1, 5] = desc[0, 63]     # ... for this query, both 0
            desc[2, 128] = desc[2, 127]
            desc[3, 70] = desc[2, 127]
            desc[3, 71] = desc[2, 191]   # one exact match across tiles
        else:
            raise KeyError(case)
    n = desc.shape[0]
    pairs = np.asarray([(i, j) for i in range(n) for j in range(i + 1, n)],
                       np.int32)
    return desc, valid, pairs


WALK_EDGE_RADIUS = 17


def _walk_edge_inputs(case, h=72, w=64):
    """Kernel B2's edge cases at the level radius 17. ``border``: keypoints
    on and beside every image border and corner (windows clipped by the
    image, one rounding off it). ``radius``: window radii wr = floor(4.5
    sigma) at the level's static radius, one below it, above it (the walk
    is capped at the radius) and at the minimum of 1."""
    rng = np.random.default_rng(17)
    mod = rng.random((h, w), dtype=np.float32)
    ang = (rng.random((h, w)) * 2 * np.pi).astype(np.float32)
    if case == "border":
        xs = [0.0, 0.4, w - 1.0, w - 1.4, w - 0.6, w - 0.4, 3.3, w / 2, -0.4,
              -0.6]
        ys = [0.0, 0.3, h - 1.0, h - 1.3, h - 0.6, h - 0.4, 2.7, h / 2, -0.4,
              -0.6]
        x, y = (np.array(v, np.float32).ravel()
                for v in np.meshgrid(xs, ys))
        sig = (1.3 + rng.random(x.size) * 2.4).astype(np.float32)
    elif case == "radius":
        sig = np.array([3.78, 3.9, 3.999, 3.7, 4.0, 4.5, 7.0, 0.2, 0.23, 1.0],
                       np.float32)
        x = np.array([30.2, 20.0, 40.7, 8.1, 31.5, 25.0, 33.3, 10.0, 50.5,
                      0.2], np.float32)
        y = np.array([35.1, 22.5, 30.0, 60.9, 36.5, 7.0, 40.4, 10.0, 5.5,
                      70.8], np.float32)
    else:
        raise KeyError(case)
    n = x.size
    pad = -n % 8 + 8  # dead slots after the live prefix
    x, y, sig = (np.concatenate([v, np.zeros(pad, np.float32)])
                 for v in (x, y, sig))
    return mod, ang, x, y, sig, np.array([n], np.int32)


def _masked_2nn_inputs():
    """tests/test_pallas_distance.py:13-26 (a hole in the reference mask
    inside the live prefix), plus invalid queries inside the query
    prefix."""
    rng = np.random.default_rng(0)
    qry = rng.normal(size=(256, 128)).astype(np.float32)
    ref = rng.normal(size=(512, 128)).astype(np.float32)
    qv = np.ones(256, bool)
    qv[[3, 40, 41, 200]] = False
    qv[250:] = False
    rv = np.ones(512, bool)
    rv[100:120] = False
    return qry, ref, qv, rv


ONE_WAY_CASES = ["holes", "dups", "ragged", "no_reference_rows",
                 "no_valid_reference", "one_query"]


def _one_way_case(case):
    """Kernel B7's cases (qry, ref, qry_valid, ref_valid): holes in both
    masks; duplicated descriptors (exact ties at d1, within and across the
    64-row tiles); row counts that are no multiple of 64; no reference
    row at all; no valid reference; one query."""
    if case == "holes":
        qry, ref, qv, rv = _masked_2nn_inputs()
        rv[60:70] = False  # across the first tile edge
        rv[430:] = False
        ref[61] = qry[5]   # a masked exact match never wins
        return qry, ref, qv, rv
    if case == "dups":
        return _bidir_inputs("dups")
    rng = np.random.default_rng(23)
    nb, na = {"ragged": (131, 201), "no_reference_rows": (70, 0),
              "no_valid_reference": (70, 130), "one_query": (1, 150)}[case]
    qry = rng.random((nb, 128), dtype=np.float32)
    ref = rng.random((na, 128), dtype=np.float32)
    qv, rv = np.ones(nb, bool), np.ones(na, bool)
    if case == "ragged":
        qv[[0, 64, 130]] = False
        rv[190:] = False
    elif case == "no_valid_reference":
        rv[:] = False
    return qry, ref, qv, rv


OCTAVE_SHAPES = {"512x384": [(512, 384), (256, 192), (128, 96), (64, 48)],
                 "1440x1080": [(1440, 1080), (720, 540), (360, 270),
                               (180, 135)]}


def _octave_dogs(case):
    """Kernel B1's multi-octave cases (DoG stacks of one call, peak
    threshold, capacities). ``512x384`` / ``1440x1080``: the four octave
    shapes of a frame of that size, noise sparse enough to fit the
    extractor's capacities (area / 128, at least 1024). ``edges``: widths
    that are no multiple of 32, fewer than three rows, a row of 298 hits
    (over the per-row cap), a list over its capacity, and a stack without a
    hit, together in one call."""
    if case == "edges":
        dogs, caps = [], []
        for dog, _, cap in _dog_inputs():  # threshold 1.0 for all
            dogs.append(dog)
            caps.append(cap)
        rng = np.random.default_rng(29)
        dogs += [rng.normal(size=(5, 2, 40)).astype(np.float32) * 3,
                 np.zeros((4, 16, 20), np.float32)]
        caps += [16, 16]
        return dogs, 1.0, caps
    rng = np.random.default_rng(19)
    shapes = OCTAVE_SHAPES[case]
    dogs = [rng.normal(size=(5, h, w)).astype(np.float32) for h, w in shapes]
    return dogs, 4.0, [max(1024, min(h * w // 128, 32768)) for h, w in shapes]


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
    plane = src[..., 0].contiguous()
    taps = const(gaussian.gauss_taps(1.6), torch.float32, "cpu")
    assert torch.equal(gaussian.gaussian_blur(plane, 1.6),
                       gaussian._shift_and_add(
                           gaussian._shift_and_add(plane, taps, -1), taps, -2))
    blender._blur_hwc(src, 2.0)
    coef = T(np.array([1, 0, 0, 0, 0, 1, 0, 0], np.float32))
    out = twarp.warp_image(src, coef, 0.0, 0.0, (20, 20))
    torch.testing.assert_close(out, src)
    dog, tp, cap = _dog_inputs()[0]
    detect.detect_compact(T(dog), tp, cap)
    desc, valid, pairs = _pair_inputs()
    distance.pair_match_counts(T(desc), T(valid), T(pairs))
    distance.ratio_match(T(desc[0]), T(desc[1]), T(valid[0]), T(valid[1]))
    assert _native.launch_counts() == dict.fromkeys(_native.LAUNCHES, 0)


def test_b8_is_built_and_bound():
    """B8's source is compiled into the library with the others, its C
    entry bound with 64-bit sizes and strides, and its launches counted
    and traced under one name."""
    from computervisionimagestich2_tpu_torch.tools import probes

    assert "blur.cu" in _native.SOURCES
    assert _native._SIGNATURES["cvs_separable_blur"] == (
        _native._P, _native._L, _native._I, _native._I, _native._L,
        _native._L, _native._P, _native._I, _native._I, _native._P,
        _native._P)
    assert "separable_blur" in _native.LAUNCHES
    assert probes.KERNELS["separable_blur"][:3] == (
        "B8", "cuda", probes.CSRC + "blur.cu")
    assert probes.DEVICE_KERNELS["separable_blur"] == (
        "separable_blur_kernel",)


@pytest.mark.parametrize("k", [131, 4, 0])
def test_b8_refuses_taps_it_does_not_take_on_any_device(k):
    """A radius above ``MAX_BLUR_RADIUS`` (64), an even or empty tap list
    is refused before the device is looked at, so on the CPU too; within
    the limit a CPU tensor is refused as not a CUDA tensor."""
    x = torch.zeros((3, 5))
    with pytest.raises(ValueError, match="odd number of taps"):
        _native.separable_blur(x, torch.ones(k), -1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _native.separable_blur(x, torch.ones(129), -1)


@pytest.mark.parametrize("case", ["plane_w", "plane_h", "batch_h",
                                  "decimated", "resized_hwc", "hwc_h"])
def test_b8_view_addresses_every_element(case):
    """``blur_view`` gives the [outer, length, inner] view B8 reads through
    its outer and axis strides, without a copy, for the layouts the main
    path hands over (an octave's decimated base, a resized blend level,
    which is a transpose); the strides address each element of x."""
    from computervisionimagestich2_tpu_torch.ops.resize import (
        cimg_resize, vlfeat_downsample)

    rng = np.random.default_rng(3)
    plane = T(rng.random((9, 12), np.float32))
    hwc = T(rng.random((9, 12, 7), np.float32))
    x, axis = {"plane_w": (plane, -1), "plane_h": (plane, 0),
               "batch_h": (torch.stack([plane, plane]), 1),
               "decimated": (vlfeat_downsample(plane, 1), -1),
               "resized_hwc": (cimg_resize(hwc, 5, 6), 1),
               "hwc_h": (hwc, 0)}[case]
    view = _native.blur_view(x, axis)
    assert view.data_ptr() == x.data_ptr()
    outer, length, inner = view.shape
    assert length == x.shape[axis] and outer * length * inner == x.numel()
    assert inner == 1 or view.stride(2) == 1
    walked = torch.as_strided(x, view.shape, view.stride())
    assert torch.equal(walked, x.reshape(outer, length, inner))


def test_b8_view_refuses_what_does_not_merge():
    """Leading dimensions that do not merge, or trailing ones that are
    not contiguous, are refused rather than copied."""
    x = torch.zeros((2, 9, 12))[:, ::2]
    with pytest.raises(ValueError, match="does not view"):
        _native.blur_view(x, -1)
    with pytest.raises(ValueError, match="does not view"):
        _native.blur_view(torch.zeros((4, 6, 3)).transpose(0, 1), 0)


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


# B6's cases: (model, coefficients, source [h, w, C], canvas (h, w),
# offsets). The projective "horizon" homography has den = 0 inside the
# canvas, so inf / NaN source coordinates land on it and must write 0.
B6_PROJECTIVE = [0.98, 0.03, -4.0, -0.02, 1.01, 6.5, 2e-4, -1e-4, 1.0]
B6_HORIZON = [1.0, 0.02, 3.0, 0.01, 1.0, 2.0, -0.0105, 1e-4, 1.0]
B6_CASES = {
    "bilinear": ("bilinear", WARP_COEFFS.tolist(), (60, 50, 3), (80, 92),
                 (-3.5, -7.25)),
    "bilinear_w_not_4": ("bilinear", WARP_COEFFS.tolist(), (60, 50, 3),
                         (77, 93), (-3.5, -7.25)),
    "bilinear_c1": ("bilinear", WARP_COEFFS.tolist(), (60, 50, 1), (80, 90),
                    (-3.5, -7.25)),
    "bilinear_1x1": ("bilinear", WARP_COEFFS.tolist(), (60, 50, 3), (1, 1),
                     (10.0, 12.0)),
    "projective": ("projective", B6_PROJECTIVE, (60, 50, 3), (81, 96),
                   (-3.5, -7.25)),
    "projective_w_not_4": ("projective", B6_PROJECTIVE, (60, 50, 3),
                           (81, 93), (-3.5, -7.25)),
    "projective_c1": ("projective", B6_PROJECTIVE, (60, 50, 1), (81, 93),
                      (-3.5, -7.25)),
    "projective_c4": ("projective", B6_PROJECTIVE, (60, 50, 4), (81, 93),
                      (-3.5, -7.25)),
    "projective_1x1": ("projective", B6_PROJECTIVE, (60, 50, 3), (1, 1),
                       (10.0, 12.0)),
    "projective_horizon": ("projective", B6_HORIZON, (60, 50, 3), (70, 130),
                           (-3.5, -7.25)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(B6_CASES))
def test_kernel_b6_matches_plain(cuda_device, case):
    """B6 exact against its plain version for both models: canvas widths
    that are and are not multiples of 4 (the vector stores and the scalar
    tail), one and four channels, a 1 x 1 canvas and a horizon crossing the
    canvas; the coefficients by value (host floats), as a tensor, and with
    the offsets as tensors too (the device-parameter entry) give the same
    canvas, and each call counts one launch of its branch."""
    model, coeffs, (h, w, c), canvas, (ox, oy) = B6_CASES[case]
    rng = np.random.default_rng(15)
    src = T(rng.integers(0, 256, (h, w, c)).astype(np.float32))
    ref = twarp.warp_image_plain(src, T(np.float32(coeffs)), ox, oy, canvas,
                                 model)
    g = src.to(cuda_device)
    name = "warp_image" if model == "bilinear" else "warp_image_projective"
    _native.reset_launch_counts()
    by_value = twarp.warp_image(g, coeffs, ox, oy, canvas, model)
    as_tensor = twarp.warp_image(g, T(np.float32(coeffs)).to(cuda_device),
                                 ox, oy, canvas, model)
    on_device = twarp.warp_image(
        g, T(np.float32(coeffs)).to(cuda_device),
        *(T(np.float32(v)).to(cuda_device) for v in (ox, oy)), canvas, model)
    torch.cuda.synchronize()
    assert _native.launch_counts()[name] == 3
    assert torch.equal(by_value.cpu(), ref)
    assert torch.equal(as_tensor.cpu(), ref)
    assert torch.equal(on_device.cpu(), ref)
    if not case.endswith("1x1"):
        assert (ref != 0).any() and (ref == 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(5))
def test_kernel_b1_matches_plain(cuda_device, i):
    """B1 exact against its plain version: coords, valid and n_total,
    including a binding capacity and a row past the per-row cap."""
    dog, tp, cap = _dog_inputs()[i]
    cc, vc, nc = detect.detect_compact(T(dog), tp, cap)
    cg, vg, ng = detect.detect_compact(T(dog).to(cuda_device), tp, cap)
    torch.cuda.synchronize()
    assert torch.equal(cg.cpu(), cc) and torch.equal(vg.cpu(), vc)
    assert int(ng) == int(nc)
    if i == 4:
        assert int(nc) == 298 and int(vc.sum()) == 128


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["512x384", "1440x1080", "edges"])
def test_kernel_b1_octaves_match_plain(cuda_device, case):
    """B1 over all the DoG stacks of a call in one launch: every octave's
    coords, valid and n_total exact against the plain version, and the
    same bits in a second run."""
    dogs, tp, caps = _octave_dogs(case)
    g = [T(d).to(cuda_device) for d in dogs]
    _native.reset_launch_counts()
    got = detect.detect_compact_octaves(g, tp, caps)
    again = detect.detect_compact_octaves(g, tp, caps)
    torch.cuda.synchronize()
    assert _native.launch_counts()["detect_compact"] == 2
    kept = []
    for k, (dog, cap) in enumerate(zip(g, caps)):
        cp, vp, npl = detect.detect_compact_plain(dog, tp, cap)
        (ck, vk, nk), (ca, va, na) = got[k], again[k]
        assert ck.shape == (cap, 3) and ck.dtype == torch.int64
        assert torch.equal(ck, cp) and torch.equal(vk, vp), (case, k)
        assert int(nk) == int(npl), (case, k, int(nk), int(npl))
        assert torch.equal(ck, ca) and torch.equal(vk, va)
        assert int(nk) == int(na)
        kept.append((int(vk.sum()), int(nk)))
    if case == "edges":
        # capacity 8 binds; the 298-hit row keeps 128; two rows and the
        # zero stack hold nothing
        assert kept[3][0] == 8 < kept[3][1]
        assert kept[4] == (128, 298) and kept[5] == kept[6] == (0, 0)
    else:
        assert all(0 < k == n for k, n in kept), kept


def _assert_b5_equals_plain_and_b4(desc, valid, pairs, cuda_device):
    plain = distance.pair_match_counts(T(desc), T(valid), T(pairs))
    d, v, p = (T(a).to(cuda_device) for a in (desc, valid, pairs))
    got = distance.pair_match_counts(d, v, p)
    again = distance.pair_match_counts(d, v, p)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), plain), (got, plain)
    assert torch.equal(got, again), "B5 is not deterministic"
    for k, (i, j) in enumerate(pairs.tolist()):
        okq, _, okr, _ = distance.ratio_match_bidir(d[j], d[i], v[j], v[i])
        assert [int(okq.sum()), int(okr.sum())] == got[k].tolist()
    return plain


@pytest.mark.cuda
@pytest.mark.parametrize("asymmetric", [False, True])
def test_kernel_b5_matches_plain_and_b4(cuda_device, asymmetric):
    """B5 counts exact against the plain per-pair loop, equal to the
    ratio counts of one B4 launch per pair on the card (the same
    ascending L1 sum, so the same bits), and equal in two runs."""
    desc, valid, pairs = _pair_inputs(asymmetric)
    plain = _assert_b5_equals_plain_and_b4(desc, valid, pairs, cuda_device)
    assert int(plain[:, 0].max()) > 0 and int(plain[:, 1].max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empty", "holes", "dups", "n5", "n10"])
def test_kernel_b5_cases_match_plain_and_b4(cuda_device, case):
    """B5 on an image with no valid row, holed masks, duplicates across a
    tile edge, 10 and 45 pairs: exact against plain and against B4."""
    desc, valid, pairs = _pair_case(case)
    plain = _assert_b5_equals_plain_and_b4(desc, valid, pairs, cuda_device)
    assert int(plain.max()) > 0
    if case == "empty":
        assert (plain[[0, 3, 4]] == 0).all()  # the pairs with image 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["reference", "n10"])
def test_kernel_b5_chunks_within_scratch_budget(cuda_device, case,
                                                monkeypatch):
    """A scratch budget of two pairs' partials: B5 walks the pairs in
    chunks of two (the last of one at 45 pairs) and gives the same
    counts, with one launch counted for the whole call."""
    desc, valid, pairs = _pair_case(case)
    cap = desc.shape[1]
    budget = 2 * 16 * -(-cap // distance.TILE) * cap
    assert distance.pair_chunk(cap, len(pairs), budget) == 2
    d, v, p = (T(a).to(cuda_device) for a in (desc, valid, pairs))
    want = distance.pair_match_counts(d, v, p)
    monkeypatch.setattr(distance, "PAIR_SCRATCH_BYTES", budget)
    _native.reset_launch_counts()
    got = distance.pair_match_counts(d, v, p)
    torch.cuda.synchronize()
    assert _native.launch_counts()["pair_match_counts"] == 1
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(),
                       distance.pair_match_counts(T(desc), T(valid), T(pairs)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["border", "radius"])
def test_kernel_b2_edge_cases_match_plain(cuda_device, case):
    """B2 on keypoints at the image border and with the window radius at,
    below and above the level's static radius: rtol 1e-5 (atol 1e-5 x
    max) against the plain version, equal ``ok``, zero rows past the live
    count."""
    from computervisionimagestich2_tpu_torch.ops import sift_walks

    args = [T(a) for a in _walk_edge_inputs(case)]
    hc, okc = sift_walks.orientation_hist(*args, WALK_EDGE_RADIUS)
    hg, okg = sift_walks.orientation_hist(
        *(a.to(cuda_device) for a in args), WALK_EDGE_RADIUS)
    torch.cuda.synchronize()
    np.testing.assert_allclose(hg.cpu().numpy(), hc.numpy(), rtol=1e-5,
                               atol=1e-5 * float(hc.max()))
    assert torch.equal(okg.cpu(), okc)
    n = int(args[5][0])
    assert (hg[n:] == 0).all() and float(hg[:n].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("nv", [0, 1, 48])
def test_kernel_b2_live_counts(cuda_device, nv):
    """B2 with no live keypoint, one, and the full capacity."""
    from computervisionimagestich2_tpu_torch.ops import sift_walks

    mod, ang, x, y, sig, _, _ = (T(a) for a in _walk_inputs())
    n_valid = T(np.array([nv], np.int32))
    hc, okc = sift_walks.orientation_hist(mod, ang, x, y, sig, n_valid, 17)
    hg, okg = sift_walks.orientation_hist(
        *(a.to(cuda_device) for a in (mod, ang, x, y, sig, n_valid)), 17)
    torch.cuda.synchronize()
    np.testing.assert_allclose(hg.cpu().numpy(), hc.numpy(), rtol=1e-5,
                               atol=1e-5 * float(hc.max()))
    assert torch.equal(okg.cpu(), okc)
    assert (hg[nv:] == 0).all()


@pytest.mark.cuda
def test_kernel_b7_honours_masks(cuda_device):
    """B7 on masks with holes inside the live prefix: d1 / d2 rtol 1e-5
    against the plain version, i1 equal where the 2-NN gap exceeds
    1e-4 d1, and invalid queries at BIG."""
    qry, ref, qv, rv = _masked_2nn_inputs()
    d1c, d2c, i1c = distance.two_nearest(T(qry), T(ref), T(qv), T(rv))
    d1g, d2g, i1g = distance.two_nearest(
        *(T(a).to(cuda_device) for a in (qry, ref, qv, rv)))
    torch.cuda.synchronize()
    np.testing.assert_allclose(d1g.cpu().numpy(), d1c.numpy(), rtol=1e-5)
    np.testing.assert_allclose(d2g.cpu().numpy(), d2c.numpy(), rtol=1e-5)
    clear = qv & ((d2c - d1c) > 1e-4 * d1c).numpy()
    np.testing.assert_array_equal(i1g.cpu().numpy()[clear],
                                  i1c.numpy()[clear])
    assert not np.isin(i1g.cpu().numpy()[qv], np.arange(100, 120)).any()
    assert (d1g.cpu().numpy()[~qv] > 1e37).all()


def _bidir_inputs(case):
    """Kernel B4's cases: holed masks on both sides with live counts that
    are not a multiple of the 64-row tile, and duplicated rows across tile
    edges (exact d1 ties between tiles, d1 = 0)."""
    if case == "holes":
        qry, ref, qv, rv = _masked_2nn_inputs()
        rv[60:70] = False
        rv[430:] = False
        ref[61] = qry[5]  # a masked exact match never wins
        return qry, ref, qv, rv
    rng = np.random.default_rng(21)
    qry = rng.random((300, 128), dtype=np.float32)
    ref = rng.random((260, 128), dtype=np.float32)
    ref[64] = ref[63]
    ref[199] = ref[63]
    ref[130] = ref[10]
    qry[63] = qry[64] = qry[128] = ref[63]
    qry[100] = ref[130]
    return qry, ref, np.arange(300) < 250, np.arange(260) < 200


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["holes", "dups"])
def test_kernel_b4_bidir_matches_plain_and_b7(cuda_device, case):
    """B4 in both directions: d1 / d2 rtol 1e-5 against the plain version,
    i1 equal where the 2-NN gap exceeds 1e-4 d1, invalid rows at BIG,
    masked rows never win; equal bits to B7 run each way (the same
    ascending summation) and to a second B4 run."""
    qry, ref, qv, rv = _bidir_inputs(case)
    g = [T(a).to(cuda_device) for a in (qry, ref, qv, rv)]
    got = distance.two_nearest_bidir(*g)
    again = distance.two_nearest_bidir(*g)
    one_way = (distance.two_nearest(*g),
               distance.two_nearest(g[1], g[0], g[3], g[2]))
    torch.cuda.synchronize()
    plain = (distance.two_nearest_plain(*(T(a) for a in (qry, ref, qv, rv))),
             distance.two_nearest_plain(*(T(a) for a in (ref, qry, rv, qv))))
    for side, ok, other_ok in ((0, qv, rv), (1, rv, qv)):
        d1g, d2g, i1g = (t.cpu() for t in got[side])
        d1c, d2c, i1c = plain[side]
        np.testing.assert_allclose(d1g[ok].numpy(), d1c[ok].numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(d2g[ok].numpy(), d2c[ok].numpy(),
                                   rtol=1e-5)
        clear = ok & ((d2c - d1c) > 1e-4 * d1c).numpy()
        np.testing.assert_array_equal(i1g.numpy()[clear], i1c.numpy()[clear])
        assert other_ok[i1g.numpy()[ok]].all(), "a masked row won"
        assert (d1g.numpy()[~ok] > 1e37).all()
        assert (d2g.numpy()[~ok] > 1e37).all()
        for a, b, c in zip(got[side], one_way[side], again[side]):
            assert torch.equal(a, b) and torch.equal(a, c)
    if case == "dups":
        d1q, d2q, i1q = (t.cpu() for t in got[0])
        assert d1q[63] == d2q[63] == 0 and int(i1q[63]) == 63


@pytest.mark.cuda
@pytest.mark.parametrize("case", ONE_WAY_CASES)
def test_kernel_b7_cases_match_plain_and_b4(cuda_device, case):
    """B7 on the tile pass: d1, d2 and i1 equal to the query side of one
    B4 launch bit for bit and to a second B7 run; against the plain
    version d1 / d2 rtol 1e-5 and i1 equal where the 2-NN gap exceeds 1e-4
    d1; invalid queries, and every query when no reference is valid, get
    BIG, BIG, 0; a masked row never wins."""
    qry, ref, qv, rv = _one_way_case(case)
    g = [T(a).to(cuda_device) for a in (qry, ref, qv, rv)]
    _native.reset_launch_counts()
    got = [t.cpu() for t in distance.two_nearest(*g)]
    again = [t.cpu() for t in distance.two_nearest(*g)]
    assert _native.launch_counts()["l1_two_nearest"] == 2
    b4 = [t.cpu() for t in distance.two_nearest_bidir(*g)[0]]
    torch.cuda.synchronize()
    for a, b, c in zip(got, again, b4):
        assert torch.equal(a, b) and torch.equal(a, c)
    d1g, d2g, i1g = (t.numpy() for t in got)
    d1c, d2c, i1c = (t.numpy() for t in distance.two_nearest_plain(
        *(T(a) for a in (qry, ref, qv, rv))))
    np.testing.assert_allclose(d1g, d1c, rtol=1e-5)
    np.testing.assert_allclose(d2g, d2c, rtol=1e-5)
    clear = qv & ((d2c - d1c) > 1e-4 * d1c)
    np.testing.assert_array_equal(i1g[clear], i1c[clear])
    assert (d1g[~qv] > 1e37).all() and (d2g[~qv] > 1e37).all()
    assert (i1g[~qv] == 0).all()
    if rv.any():
        assert rv[i1g[qv]].all(), "a masked row won"
    else:
        assert (d1g > 1e37).all() and (i1g == 0).all()
    if case == "dups":
        assert d1g[63] == d2g[63] == 0 and i1g[63] == 63


@pytest.mark.cuda
def test_kernel_walks_are_deterministic(cuda_device):
    """B2 and B3 twice on the same inputs give the same bits."""
    from computervisionimagestich2_tpu_torch.ops import sift_walks

    g = [T(a).to(cuda_device) for a in _walk_inputs()]
    h = [sift_walks.orientation_hist(*g[:5], g[6], 17)[0] for _ in range(2)]
    d = [sift_walks.descriptors(*g, 28)[0] for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(h[0], h[1]) and torch.equal(d[0], d[1])
    assert float(d[0].abs().sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["default", "slice"])
def test_slice_on_card_goes_through_the_kernels(cuda_device, config):
    """A small stitch on the card launches every kernel of its path (all
    six under DEFAULT_CONFIG; no B1 / B5 on the chain slice; B7, the
    one-direction 2-NN, on neither) and gives the
    canvas of the CPU run: shape within +-3 px, MAD <= 3 u8 levels (the
    end-to-end gate of tests/test_torch_stitch.py)."""
    img = _scene()
    if config == "default":  # scrambled: graph ordering finds the pair
        crops = [img[:, 60:], img[:, :140]]
    else:
        crops = [img[:, :120], img[:, 80:]]
    base = DEFAULT_CONFIG if config == "default" else SLICE_CONFIG
    cfg = dataclasses.replace(
        base, sift=dataclasses.replace(
            base.sift, n_octaves=2, max_keypoints_per_octave=512,
            max_keypoints=1024),
        match=dataclasses.replace(base.match, pair_threshold=5))
    _native.reset_launch_counts()
    out = Stitcher(cfg, device=cuda_device).stitch(crops)
    counts = _native.launch_counts()
    off_path = {"l1_two_nearest", "warp_image_projective"} | (
        set() if config == "default"
        else {"detect_compact", "pair_match_counts"})
    assert all((c == 0) == (k in off_path) for k, c in counts.items()), counts
    ref = Stitcher(cfg, device="cpu").stitch(crops)
    assert abs(out.shape[0] - ref.shape[0]) <= 3, (out.shape, ref.shape)
    assert abs(out.shape[1] - ref.shape[1]) <= 3, (out.shape, ref.shape)
    h, w = min(out.shape[0], ref.shape[0]), min(out.shape[1], ref.shape[1])
    mad = np.abs(out[:h, :w].astype(np.int64)
                 - ref[:h, :w].astype(np.int64)).mean()
    assert mad <= 3.0, mad


def _small(base):
    return dataclasses.replace(
        base, sift=dataclasses.replace(
            base.sift, n_octaves=2, max_keypoints_per_octave=512,
            max_keypoints=1024),
        match=dataclasses.replace(base.match, pair_threshold=5))


def _assert_close_canvas(out, ref):
    """Shape within +-3 px and MAD <= 3 u8 levels over the common canvas
    (the end-to-end gate of tests/test_torch_stitch.py)."""
    assert abs(out.shape[0] - ref.shape[0]) <= 3, (out.shape, ref.shape)
    assert abs(out.shape[1] - ref.shape[1]) <= 3, (out.shape, ref.shape)
    h, w = min(out.shape[0], ref.shape[0]), min(out.shape[1], ref.shape[1])
    mad = np.abs(out[:h, :w].astype(np.int64)
                 - ref[:h, :w].astype(np.int64)).mean()
    assert mad <= 3.0, mad


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", ["uniform", "mixed"])
def test_incremental_on_card_goes_through_the_kernels(cuda_device, shapes):
    """The incremental stitch on bucketed canvases (planned=False,
    exact_canvas=False) over three scrambled crops: uniform shapes launch
    all six kernels of the default path; mixed shapes take their graph
    counts from B4 per pair and never launch B5. The canvas is the CPU
    run's within the end-to-end gate."""
    img = _scene(w=200)
    if shapes == "uniform":
        crops = [img[:, 80:], img[:, :120], img[:, 40:160]]
    else:
        crops = [img[:110, 80:], img[:, :120], img[:, 40:156]]
    cfg = dataclasses.replace(_small(DEFAULT_CONFIG), planned=False,
                              exact_canvas=False)
    _native.reset_launch_counts()
    out = Stitcher(cfg, device=cuda_device).stitch(crops)
    counts = _native.launch_counts()
    off_path = {"l1_two_nearest", "warp_image_projective"} | (
        set() if shapes == "uniform" else {"pair_match_counts"})
    assert all((c == 0) == (k in off_path) for k, c in counts.items()), counts
    _assert_close_canvas(out, Stitcher(cfg, device="cpu").stitch(crops))


@pytest.mark.cuda
def test_stream_on_card_goes_through_the_kernels(cuda_device):
    """Three frames through StreamingStitcher on the card: the stream
    launches B1-B4 and B6, never B5 or B7; the canvas sizes after each frame
    equal the CPU stream's and the final canvases agree within the
    end-to-end gate."""
    from computervisionimagestich2_tpu_torch.models.streaming import (
        StreamingStitcher)

    img = _scene(w=240)
    frames = [img[:, i * 50:i * 50 + 140] for i in range(3)]
    cfg = _small(DEFAULT_CONFIG)
    ss = StreamingStitcher(cfg, device=cuda_device)
    _native.reset_launch_counts()
    sizes = [ss.push(f) for f in frames]
    counts = _native.launch_counts()
    assert all((c == 0) == (k in ("pair_match_counts", "l1_two_nearest",
                                  "warp_image_projective"))
               for k, c in counts.items()), counts
    ref = StreamingStitcher(cfg, device="cpu")
    assert sizes == [ref.push(f) for f in frames]
    _assert_close_canvas(ss.canvas(), ref.canvas())


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["incremental", "mixed", "stream",
                                  "register"])
def test_registration_programs_on_card_equal_eager(cuda_device, path):
    """The registration programs off the plan as CUDA graphs on the card:
    each path twice with graphs (a cold run that captures, a warm one that
    captures nothing) equals its run under ``disable_graphs()`` bit for
    bit, launches included; the warm run replays ``register_edge`` once
    per registration (incremental, mixed, stream), the mixed-shape
    ordering's pair program once per pair, ``_register_one`` once per
    pair."""
    from computervisionimagestich2_tpu_torch.core import programs
    from computervisionimagestich2_tpu_torch.models.streaming import (
        StreamingStitcher)
    from computervisionimagestich2_tpu_torch.ops.color import to_gray
    from computervisionimagestich2_tpu_torch.parallel import batched

    img = _scene(w=240)
    cfg = dataclasses.replace(_small(DEFAULT_CONFIG), planned=False)
    crops = [img[:, 80:200], img[:, :120], img[:, 40:160]]
    if path == "mixed":
        crops = [img[:110, 80:], img[:, :120], img[:, 40:156]]

    def run():
        if path == "stream":
            ss = StreamingStitcher(cfg, device=cuda_device)
            for i in range(3):
                ss.push(img[:, i * 50:i * 50 + 140])
            return [torch.as_tensor(ss.canvas())]
        if path == "register":
            g = to_gray(torch.as_tensor(img, device=cuda_device).float())
            return list(batched.batched_pairwise_register(
                torch.stack([g[:, 0:140], g[:, 40:180]]),
                torch.stack([g[:, 30:170], g[:, 70:210]]), cfg, cuda_device))
        return [torch.as_tensor(Stitcher(cfg, device=cuda_device).stitch(
            crops))]

    def counted():
        _native.reset_launch_counts()
        out = [t.cpu() for t in run()]
        return out, _native.launch_counts()

    with programs.disable_graphs():
        ref, ref_counts = counted()
    programs.clear_graphs()
    for warm in (False, True):
        before = programs.capture_stats()
        out, counts = counted()
        delta = programs.captures_since(before)
        assert all(torch.equal(a, b) for a, b in zip(out, ref)), warm
        assert counts == ref_counts, (counts, ref_counts)
        assert delta["captures"] == 0 or not warm, delta
    replays = delta["replays_by_program"]
    want = {"incremental": ("register_edge", 2), "mixed": (
        "mixed_pair_counts", 3), "stream": ("register_edge", None),
        "register": ("register_one", 2)}[path]
    assert replays.get(want[0], 0) == (want[1] or counts[
        "l1_two_nearest_bidir"]) > 0, replays
    programs.clear_graphs()


@pytest.mark.cuda
@pytest.mark.parametrize("planned", [True, False],
                         ids=["planned", "incremental"])
def test_projective_on_card_goes_through_the_kernels(cuda_device, planned):
    """warp_model="projective" on the card launches B6's projective branch
    and never its bilinear one; the canvas is the CPU run's within the
    end-to-end gate."""
    img = _scene(w=200)
    crops = [img[:, 60:], img[:, :140]]
    cfg = dataclasses.replace(_small(DEFAULT_CONFIG), warp_model="projective",
                              planned=planned)
    _native.reset_launch_counts()
    out = Stitcher(cfg, device=cuda_device).stitch(crops)
    counts = _native.launch_counts()
    off_path = {"l1_two_nearest", "warp_image"}
    assert all((c == 0) == (k in off_path) for k, c in counts.items()), counts
    _assert_close_canvas(out, Stitcher(cfg, device="cpu").stitch(crops))


@pytest.mark.cuda
def test_batched_stitch_on_card_equals_one_at_a_time(cuda_device):
    """Two panoramas of three crops through ``batched_stitch_chain`` on the
    card: each equals ``_stitch_one_fixed`` on that panorama alone, bit for
    bit; the batch launches B1 once per image, B4 and B6 once per edge, B8
    for every blur pass and nothing else; the canvases are the CPU batch's
    within the end-to-end gate (equal shape, MAD <= 3 u8 levels)."""
    from computervisionimagestich2_tpu_torch.parallel import batched

    img = _scene(w=260)
    pans = np.stack([np.stack([img[:, o + 50 * i:o + 50 * i + 140]
                               for i in range(3)]) for o in (0, 10)])
    cfg = _small(DEFAULT_CONFIG)
    _native.reset_launch_counts()
    out, plans = batched.batched_stitch_chain(pans, cfg, device=cuda_device)
    counts = _native.launch_counts()
    want = {"detect_compact": 6, "sift_orientation_hist": None,
            "sift_descriptors": None, "l1_two_nearest_bidir": 4,
            "warp_image": 4, "separable_blur": None}
    for k, c in counts.items():
        assert (c == 0) == (k not in want), counts
        assert want.get(k) in (None, c), counts
    seq = batched.chain_edge_seq(3)
    canvas = tuple(out.shape[1:3])
    for b in range(2):
        one, plan = batched._stitch_one_fixed(
            torch.as_tensor(pans[b], device=cuda_device), cfg, canvas, seq)
        assert torch.equal(out[b], one)
        np.testing.assert_array_equal(plans[b], plan.cpu().numpy())
    ref, _ = batched.batched_stitch_chain(pans, cfg, device="cpu")
    for b in range(2):
        _assert_close_canvas(out[b].cpu().numpy().astype(np.uint8),
                             ref[b].numpy().astype(np.uint8))


@pytest.mark.cuda
def test_batched_register_on_card_launches_b7_per_pair(cuda_device):
    """``batched_pairwise_register`` on three pairs: kernel B7 once per
    pair (``match_features``), B4 never; the warps reproject within 2 px
    of the CPU run's over the image."""
    from computervisionimagestich2_tpu_torch.ops.color import to_gray
    from computervisionimagestich2_tpu_torch.ops.warp import warp_points
    from computervisionimagestich2_tpu_torch.parallel import batched

    img = to_gray(torch.as_tensor(_scene(w=260)).float())
    ga = torch.stack([img[:, o:o + 140] for o in (0, 40, 80)])
    gb = torch.stack([img[:, o + 30:o + 170] for o in (0, 40, 80)])
    cfg = _small(DEFAULT_CONFIG)
    _native.reset_launch_counts()
    coeffs, inliers = batched.batched_pairwise_register(ga, gb, cfg,
                                                        cuda_device)
    counts = _native.launch_counts()
    assert counts["l1_two_nearest"] == 3, counts
    assert counts["l1_two_nearest_bidir"] == 0, counts
    ref, ref_n = batched.batched_pairwise_register(ga, gb, cfg, "cpu")
    px, py = (t.ravel() for t in torch.meshgrid(
        torch.linspace(4, 136, 8), torch.linspace(4, 116, 8), indexing="xy"))
    for k in range(3):
        xk, yk = warp_points(coeffs[k].cpu(), px, py)
        xr, yr = warp_points(ref[k], px, py)
        assert float(torch.hypot(xk - xr, yk - yr).max()) < 2.0
        assert float(torch.hypot(xk - (px + 30), yk - py).max()) < 2.0
    assert (inliers.cpu() - ref_n).abs().max() <= 0.1 * ref_n.max() + 2


@pytest.mark.cuda
def test_l2pre_candidate_order_on_card(cuda_device):
    """The l2pre candidates on CUDA tensors follow (distance, index)
    order, as on the CPU: [5, 6, 1, 2] on the tie row (torch.topk picks
    another set), index order on a long row of ties; the whole prefilter
    on the tie row's references gives i1 = 5, the first of the tied
    candidates."""
    row = torch.tensor([[3.0, 1.0, 1.0, 2.0, 1.0, 0.5, 0.5]],
                       device=cuda_device)
    assert distance._first_m(row, 4).tolist() == [[5, 6, 1, 2]]
    long = torch.full((2, 4000), 0.25, device=cuda_device)
    long[1, 3000] = 0.1
    got = distance._first_m(long, 12).cpu()
    assert got[0].tolist() == list(range(12))
    assert got[1].tolist() == [3000] + list(range(11))
    ref = torch.zeros((7, 128), device=cuda_device)
    for k, v in enumerate(row[0].tolist()):
        if v == 0.5:
            ref[k, :2] = 0.5
        else:
            ref[k, :int(v)] = 1.0
    q = torch.zeros((1, 128), device=cuda_device)
    ok_q = torch.ones(1, dtype=torch.bool, device=cuda_device)
    ok_r = torch.ones(7, dtype=torch.bool, device=cuda_device)
    d1, d2, i1 = distance.two_nearest(q, ref, ok_q, ok_r, "l1", "l2pre", 4)
    assert [float(d1), float(d2), int(i1)] == [1.0, 1.0, 5]


@pytest.mark.cuda
def test_kernel_b6_launches_on_the_tensors_card(cuda_device):
    """B6 on ``cuda:1`` while the current device is 0 launches on card 1's
    stream (``_native.launch`` runs under the tensors' device) and equals
    its plain version. Needs two cards: with fewer it skips, since a
    tensor on one card cannot show which card's stream took the launch."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rng = np.random.default_rng(15)
    src = T(rng.integers(0, 256, (60, 50, 3)).astype(np.float32))
    ref = twarp.warp_image_plain(src, T(WARP_COEFFS), -3.5, -7.25, (81, 93))
    with torch.cuda.device(0):
        _native.reset_launch_counts()
        out = twarp.warp_image(src.to("cuda:1"), WARP_COEFFS, -3.5, -7.25,
                               (81, 93))
        torch.cuda.synchronize(1)
    assert out.device == torch.device("cuda:1")
    assert _native.launch_counts()["warp_image"] == 1
    assert torch.equal(out.cpu(), ref)


@pytest.mark.cuda
def test_mesh_on_card_launches_b6_per_stripe(cuda_device):
    """A virtual mesh of four stripes on the card: ``sharded_composite``
    launches B6 once per stripe and its stripes equal the single-device
    composite bit for bit; the mesh Stitcher shards every edge (B6 edges x
    4) and its panorama is the single-device one's within the mesh
    tolerance of tests/test_parallel.py:310-313."""
    from computervisionimagestich2_tpu_torch.models import compose
    from computervisionimagestich2_tpu_torch.parallel import (
        make_mesh, sharded_composite)
    from computervisionimagestich2_tpu_torch.parallel.mesh import gather_rows

    mesh = make_mesh(4, sp=4, devices=[cuda_device] * 4)
    rng = np.random.default_rng(0)
    src = T(rng.uniform(10, 250, (96, 128, 3)).astype(np.float32)).to(
        cuda_device)
    prev = T(rng.uniform(10, 250, (96, 108, 3)).astype(np.float32)).to(
        cuda_device)
    _native.reset_launch_counts()
    a_s, b_s = sharded_composite(src, prev, WARP_COEFFS, -12.7, -8.3,
                                 (128, 160), mesh)
    assert _native.launch_counts()["warp_image"] == 4
    a_e, b_e = compose.composite(src, prev, WARP_COEFFS, -12.7, -8.3,
                                 (128, 160))
    assert torch.equal(gather_rows(a_s, cuda_device), a_e)
    assert torch.equal(gather_rows(b_s, cuda_device), b_e)

    img = _scene(w=260)
    crops = [img[:, 50 * i:50 * i + 140] for i in range(3)]
    cfg = dataclasses.replace(_small(DEFAULT_CONFIG), ordering="chain",
                              exact_canvas=False)
    _native.reset_launch_counts()
    meshed = Stitcher(cfg, device=cuda_device, mesh=mesh).stitch(crops)
    assert _native.launch_counts()["warp_image"] == 2 * 4
    single = Stitcher(cfg, device=cuda_device).stitch(crops)
    assert meshed.shape == single.shape
    diff = np.abs(meshed.astype(np.int32) - single.astype(np.int32))
    assert (diff > 1).mean() < 1e-3 and diff.max() <= 16, diff.max()


# B8's cases: the scale space's sigmas (DEFAULT_CONFIG: the first blur and
# the four increments; o_min=-1's first blur), the blend's, and the
# radius's ends (1 and MAX_BLUR_RADIUS = 64)
B8_SIGMAS = (1.52, 1.6, 2.2627, 3.2, 4.5255, 2.0, 1.249, 0.2, 16.0)
B8_SHAPES = ((1, 1), (3, 50), (48, 64), (384, 512), (2160, 3840))


@pytest.mark.cuda
@pytest.mark.parametrize("hw", B8_SHAPES, ids=lambda hw: "%dx%d" % hw)
@pytest.mark.parametrize("sigma", B8_SIGMAS)
def test_kernel_b8_matches_plain(cuda_device, sigma, hw):
    """B8 equals the plain shift-and-add on the card bit for bit: [H, W]
    along W and H, a batch [2, H, W] along both, [H, W, 7] along W and H
    in float32 and in bfloat16, an octave's decimated base and a resized
    blend level (strided inputs); one launch a pass."""
    from computervisionimagestich2_tpu_torch.ops.resize import (
        cimg_resize, vlfeat_downsample)

    h, w = hw
    gen = torch.Generator(cuda_device).manual_seed(h * 7919 + w)
    plane = torch.rand((h, w), generator=gen, device=cuda_device) * 255
    hwc = torch.rand((h, w, 7), generator=gen, device=cuda_device) * 255
    batch = torch.stack([plane, plane.flip(0)])
    cases = [(plane, -1), (plane, -2), (batch, -1), (batch, -2),
             (hwc, 1), (hwc, 0), (hwc.bfloat16(), 1), (hwc.bfloat16(), 0),
             (cimg_resize(hwc, max(h // 2, 1), max(w // 2, 1)), 1)]
    if w > 1:  # a one-column plane decimates to nothing
        cases.append((vlfeat_downsample(plane, 1), -1))
    taps = gaussian.gauss_taps(sigma)
    for x, axis in cases:
        t = const(taps, x.dtype, cuda_device)
        _native.reset_launch_counts()
        got = _native.separable_blur(x, t, axis)
        assert _native.launch_counts()["separable_blur"] == 1
        want = gaussian._shift_and_add(x, t, axis)
        assert got.dtype == want.dtype and got.is_contiguous()
        assert torch.equal(got, want), (tuple(x.shape), x.dtype, axis)


@pytest.mark.cuda
def test_b8_stitch_on_card_equals_the_plain_blur(cuda_device, monkeypatch):
    """A DEFAULT_CONFIG stitch of four scrambled 512x384 crops on the card,
    with graphs: a warm stitch launches B8 once a pass, two passes for
    every Gaussian of the scale space (each octave's increments, the first
    octave's first blur) and two for each blurred pyramid level of each
    edge's blend; its features, plan and panorama equal bit for bit the
    same stitch with ``_native.separable_blur`` replaced by the plain
    shift-and-add."""
    from computervisionimagestich2_tpu_torch.core import programs
    from computervisionimagestich2_tpu_torch.models import stitcher as stm
    from computervisionimagestich2_tpu_torch.models.sift import (
        scale_space_sigmas)
    from computervisionimagestich2_tpu_torch.tools.scenes import (crops,
                                                                  scrambled)

    images = scrambled(crops(512, 384, 224, 2, seed=0))
    plans = []
    plan_rows = stm.plan_edges_with_rows

    def recorded_plan(*args):
        plan, rows = plan_rows(*args)
        plans.append(plan)
        return plan, rows

    monkeypatch.setattr(stm, "plan_edges_with_rows", recorded_plan)

    def stitch():
        programs.clear_graphs()
        st = Stitcher(DEFAULT_CONFIG, device=cuda_device)
        st.stitch(images)  # cold: captures the graphs
        _native.reset_launch_counts()
        out = st.stitch(images)
        feats = [t.cpu() for t in st._feats_stacked]
        return out, feats, plans[-1], _native.launch_counts()

    out, feats, plan, counts = stitch()
    plain_calls, levels = [0], []
    blend_stacked = blender.blend_stacked

    def plain_blur(x, taps, axis):
        plain_calls[0] += 1
        return gaussian._shift_and_add(x, taps, axis)

    def counted_blend(s0, n_levels, *args):
        levels.append(n_levels)
        return blend_stacked(s0, n_levels, *args)

    monkeypatch.setattr(_native, "separable_blur", plain_blur)
    ref_out, ref_feats, ref_plan, ref_counts = stitch()
    assert np.array_equal(out, ref_out)
    assert all(torch.equal(a, b) for a, b in zip(feats, ref_feats))
    assert np.array_equal(plan, ref_plan)
    assert ref_counts["separable_blur"] == 0
    # every pass once, counted where its Python runs: eagerly
    plain_calls[0] = 0
    monkeypatch.setattr(blender, "blend_stacked", counted_blend)
    with programs.disable_graphs():
        Stitcher(DEFAULT_CONFIG, device=cuda_device).stitch(images)
    first, inc = scale_space_sigmas(DEFAULT_CONFIG.sift)
    sift_passes = 2 * len(images) * (
        DEFAULT_CONFIG.sift.n_octaves * len(inc) + (first is not None))
    blend_passes = 2 * sum(n - 1 for n in levels)
    assert len(levels) == len(images) - 1 and blend_passes > 0, levels
    assert counts["separable_blur"] == sift_passes + blend_passes == \
        plain_calls[0], (counts, sift_passes, blend_passes, plain_calls)
    programs.clear_graphs()


@pytest.mark.cuda
def test_many_frames_on_card_equal_eager(cuda_device):
    """The benchmark's dataset2 geometry on the card, 18 crops of 800x600
    350 px apart, 17 edges (``chip_smoke.py``'s phase 18d on one seed):
    the panorama and launch counts with graphs equal the eager ones bit
    for bit; a warm stitch captures and drops nothing, replays 8 edge
    graphs and runs the 9 other edges eagerly; no pair of frames that
    shares nothing draws the pair threshold's matches."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    from computervisionimagestich2_tpu_torch.core import programs

    try:
        (scene,) = chip_smoke.many_edges_phase(
            seeds=chip_smoke.MANY_SEEDS[:1])["scenes"]
    finally:
        programs.clear_graphs()
    warm = scene["warm"]
    assert warm["overflows"] == 9 and warm["captures"] == 0, warm
    assert warm["replays_by_program"]["composite_and_blend"] == 8, warm
    assert scene["most_chance_matches"] < DEFAULT_CONFIG.match.pair_threshold
