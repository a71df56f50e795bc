"""The frames' upload of ``Stitcher.prepare`` (``models/stitcher.py::
Stitcher._upload``). On the CPU: each frame taken as it is, one
``direct_frames`` count a frame and none staged, each frame's features
program called before the next frame goes up, and strided, flipped and
read-only frames giving the bits of their contiguous copies. On the card
(``cuda``-marked): the kept pinned buffer gives the panoramas of the one
stacked pageable upload it replaced, at 512x384 and at 4K; a warm stitch
stages every frame through the same pinned buffer, also after a CUDA
graph capture; nothing of the caller's arrays is kept past a call.

This file imports no jax, so its ``cuda``-marked tests also run on a GPU
machine without it (``tests/conftest.py`` imports jax; skip it there):

    python -m pytest --noconftest tests/test_torch_upload.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG, SLICE_CONFIG
from computervisionimagestich2_tpu_torch.core import programs
from computervisionimagestich2_tpu_torch.models import stitcher as tstm
from computervisionimagestich2_tpu_torch.parallel import batched
from computervisionimagestich2_tpu_torch.tools import scenes
from computervisionimagestich2_tpu_torch.utils import obs

# the small sizes of tests/test_torch_programs.py
SMALL = dataclasses.replace(
    SLICE_CONFIG,
    sift=dataclasses.replace(SLICE_CONFIG.sift, n_octaves=2,
                             max_keypoints_per_octave=512,
                             max_keypoints=1024))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """A thread pool per pytest worker oversubscribes the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(h=96, w=160):
    return scenes.make_scene(np.random.default_rng(3), h, w, 2)


def _counts_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in tstm.UPLOADS.items()}


# ------------------------------------------------------------- the CPU
def test_cpu_frames_go_up_one_at_a_time_before_their_features(monkeypatch):
    """On the CPU every frame is taken directly (``direct_frames`` grows
    by the frame count, nothing is staged and no pinned buffer made), and
    each frame's upload comes right before its features program: frame
    k+1 goes up only after frame k's features were called."""
    events = []
    host_tensor = tstm._host_tensor
    features = batched._project_and_extract_one

    def upload(img):
        events.append("upload")
        return host_tensor(img)

    def extract(img, cfg):
        events.append("features")
        return features(img, cfg)

    monkeypatch.setattr(tstm, "_host_tensor", upload)
    monkeypatch.setattr(batched, "_project_and_extract_one", extract)
    img = _scene()
    frames = [img[:, s:s + 64] for s in (0, 48, 96)]
    before = dict(tstm.UPLOADS)
    tstm.Stitcher(SMALL, device="cpu").prepare(frames)
    assert events == ["upload", "features"] * len(frames)
    assert _counts_since(before) == {"staged_frames": 0,
                                     "direct_frames": len(frames),
                                     "staging_allocs": 0}


def _views(case: str) -> list[np.ndarray]:
    """Two frames of one scene as views the caller might hand over."""
    img = _scene()
    if case == "crop":  # columns of the wider scene
        return [img[:, s:s + 64] for s in (0, 48)]
    if case == "step":  # every other row and column
        return [img[::2, s:s + 128:2] for s in (0, 32)]
    if case == "flipped":  # negative strides
        return [img[:, ::-1][:, s:s + 64] for s in (0, 48)]
    if case == "planar":  # a channel-first array seen channel-last
        planar = np.ascontiguousarray(img.transpose(2, 0, 1))
        return [planar[:, :, s:s + 64].transpose(1, 2, 0) for s in (0, 48)]
    frames = [np.ascontiguousarray(img[:, s:s + 64]) for s in (0, 48)]
    for f in frames:  # "readonly"
        f.flags.writeable = False
    return frames


@pytest.mark.parametrize("case", ["crop", "step", "flipped", "planar",
                                  "readonly"])
def test_prepare_on_views_equals_their_contiguous_copies(case):
    """``prepare`` on frames given as views (strided, flipped, channel-
    last over planar memory) or read-only arrays returns the features and
    projections of their contiguous copies, bit for bit."""
    views = _views(case)
    assert case == "readonly" or not any(v.flags.c_contiguous
                                         for v in views)
    st = tstm.Stitcher(SMALL, device="cpu")
    proj, feats = st.prepare(views)
    ref_proj, ref_feats = st.prepare([np.array(v) for v in views])
    for a, b in zip(proj, ref_proj):
        assert torch.equal(a, b)
    for f, g in zip(feats, ref_feats):
        for a, b in zip(f, g):
            assert torch.equal(a, b)


# ------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pinned staging buffer feeds "
                    "the card")
    return torch.device("cuda")


class _StackedUpload(tstm.Stitcher):
    """The upload the pinned buffer replaced: the frames stacked on the
    host and copied up in one copy from pageable memory."""

    def _upload(self, images, uniform):
        with obs.span("upload"):
            frames = torch.as_tensor(np.stack([np.asarray(i)
                                               for i in images]),
                                     device=self.device)
        yield from frames


def _cell(size: str):
    """(frames, config) of the benchmark's 512x384 and 4K cells."""
    if size == "512x384":
        return (scenes.scrambled(scenes.crops(512, 384, 224, 2, seed=0)),
                DEFAULT_CONFIG)
    return (scenes.scrambled(scenes.crops(2160, 3840, 1120, 6, seed=0)),
            scenes.config4())


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["512x384", "4k"])
def test_pinned_upload_on_card_equals_the_stacked_upload(cuda_device, size):
    """A stitch whose frames go up through the pinned buffer gives the
    panorama of the stacked pageable upload, bit for bit, cold and warm;
    the cold stitch stages every frame into one new pinned buffer, the
    warm one, after the cold one's graph captures and one more, stages
    every frame again through the same buffer and makes none."""
    images, cfg = _cell(size)
    st = tstm.Stitcher(cfg, device=cuda_device)
    before = dict(tstm.UPLOADS)
    cold = st.stitch(images)
    assert _counts_since(before) == {"staged_frames": len(images),
                                     "direct_frames": 0,
                                     "staging_allocs": 1}
    graph, x = torch.cuda.CUDAGraph(), torch.zeros(1, device=cuda_device)
    with torch.cuda.graph(graph):  # a capture empties torch's pinned cache
        x += 1
    before, staging = dict(tstm.UPLOADS), st._staging.data_ptr()
    warm = st.stitch(images)
    assert _counts_since(before) == {"staged_frames": len(images),
                                     "direct_frames": 0,
                                     "staging_allocs": 0}
    assert st._staging.data_ptr() == staging
    ref = _StackedUpload(cfg, device=cuda_device).stitch(images)
    assert torch.equal(torch.from_numpy(cold), torch.from_numpy(ref))
    assert torch.equal(torch.from_numpy(warm), torch.from_numpy(ref))
    programs.clear_graphs()


@pytest.mark.cuda
def test_pinned_upload_keeps_nothing_of_the_callers_arrays(cuda_device):
    """Writing into the caller's arrays after ``stitch`` returns changes
    nothing of the next call's result, and the next call on those arrays
    stitches what they now hold."""
    images, cfg = _cell("512x384")
    other = scenes.scrambled(scenes.crops(512, 384, 224, 2, seed=1))
    st = tstm.Stitcher(cfg, device=cuda_device)
    mine = [np.array(i) for i in images]
    first = st.stitch(mine)
    for m, o in zip(mine, other):
        m[...] = o
    assert np.array_equal(st.stitch(images), first)
    assert np.array_equal(st.stitch(mine),
                          tstm.Stitcher(cfg, device=cuda_device).stitch(other))
    programs.clear_graphs()

