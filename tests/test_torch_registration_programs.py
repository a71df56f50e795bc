"""The registration programs off the edge plan (``core/programs.py``, the
counterpart of ``jax.jit``): ``register_edge`` as the incremental loop and
the stream call it, the mixed-shape ordering's pair program
(``models/stitcher.py::_pair_counts``) and a batch's registration pair
(``parallel/batched.py::_register_one``). Each against the JAX function it
stands for, on the same inputs, and on the stand-in for CUDA graphs of
tests/test_torch_programs.py (``fake_graphs``) against its eager run, bit
for bit, with the captures and replays each caller makes.
"""
import dataclasses
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu.core.types import Features as JFeatures
from computervisionimagestich2_tpu.models import registration as jreg
from computervisionimagestich2_tpu.models import stitcher as jstm
from computervisionimagestich2_tpu.parallel import batched as jbatched
from computervisionimagestich2_tpu_torch.core import programs
from computervisionimagestich2_tpu_torch.core.types import features_from_numpy
from computervisionimagestich2_tpu_torch.models import registration as treg
from computervisionimagestich2_tpu_torch.models import stitcher as tstm
from computervisionimagestich2_tpu_torch.models import streaming
from computervisionimagestich2_tpu_torch.ops.warp import warp_points
from computervisionimagestich2_tpu_torch.parallel import batched
from test_integration import make_scene
from test_torch_batched import JTINY, TINY, _register_scene
from test_torch_graph_stitch import SMALL_DEFAULT
from test_torch_programs import (  # noqa: F401
    SMALL, _crops, _one_torch_thread, fake_graphs)

T = torch.as_tensor
# the stream at TINY's sizes: 96 x 128 frames panning by 32 px, the
# keyframe switching within the four frames
STREAM_CFG = dataclasses.replace(TINY, canvas_bucket=32)


@pytest.fixture
def graphs(fake_graphs):  # noqa: F811
    """Programs on CPU tensors take the graph path (``fake_graphs``),
    starting from no graph and leaving none behind."""
    programs.clear_graphs()
    yield
    programs.clear_graphs()


def _slot_at(prog, key, name: str) -> bool:
    """Whether argument ``name`` of a call of ``prog`` with ``key`` was a
    tensor (a slot in the key), not a static value."""
    args_spec = key[0][1][0][1]  # ((tuple, args), (dict, kwargs))
    position = list(prog.signature.parameters).index(name)
    return args_spec[position] == (programs._Slot,)


# ------------------------------------------------------------ register_edge
def _edge_features(seed: int = 0):
    """Two feature sets of 256 slots (200 live) on 160 x 160 images: 120
    of dst's keypoints are src's moved by (-80, 1.5) px with 0.3 px of
    noise, their descriptors src's with noise; the rest are random."""
    rng = np.random.default_rng(seed)
    cap, live, shared = 256, 200, 120
    desc = rng.uniform(0, 255, (2, cap, 128)).astype(np.float32)
    xy = rng.uniform(0, 160, (2, cap, 2)).astype(np.float32)
    desc[1, :shared] = desc[0, :shared] + rng.normal(0, 2, (shared, 128))
    xy[1, :shared] = xy[0, :shared] - np.float32([80.0, -1.5]) + rng.normal(
        0, 0.3, (shared, 2))
    valid = np.arange(cap) < live
    return [features_from_numpy((desc[k], xy[k], np.ones(cap, np.float32),
                                 valid), "cpu") for k in (0, 1)]


@pytest.mark.parametrize("edge_id", [0, 3, 65537, 2 ** 20 + 5])
def test_register_edge_int_and_tensor_ids(edge_id):
    """The edge id as an int (folded on the host) and as a 0-dim int64
    tensor (folded on its device, as the programs hand it over) give the
    same bits: models, match count and overflow. Against the JAX
    package's ``register_edge`` on the same features and id at
    tests/test_torch_match.py::test_plan_edges_on_jax_features's
    tolerance: equal counts and overflow, coefficients rtol 1e-3."""
    src, dst = _edge_features()
    img_hw = (160, 160)
    host = treg.register_edge(src, dst, SMALL, edge_id, img_hw)
    dev = treg.register_edge(src, dst, SMALL,
                             torch.tensor(edge_id, dtype=torch.int64),
                             img_hw)
    for a, b in zip(host, dev):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    jout = jreg.register_edge(*(JFeatures(*(jnp.asarray(x.numpy())
                                            for x in f)) for f in (src, dst)),
                              SMALL, edge_id, img_hw)
    assert int(host[2]) == int(jout[2]) >= 100
    assert int(host[3]) == int(jout[3])
    for t, j in zip(host[:2], jout[:2]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-3,
                                   atol=1e-5)
    # the forward model carries dst's keypoints onto src's
    np.testing.assert_allclose(host[0].numpy()[[3, 7]], [80.0, -1.5],
                               atol=0.2)


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


class _Replayed:
    """Records what ``fn`` returns for each input (by the digest of its
    first argument), then hands it back: the graph run of a test reuses
    the eager run's SIFT, which costs the plain version its seconds."""

    def __init__(self, fn):
        self.fn, self.seen = fn, {}

    def __call__(self, x, *a):
        key = _digest(x)
        if key not in self.seen:
            self.seen[key] = self.fn(x, *a)
        return self.seen[key]


def _modes(run, patch_attr, monkeypatch):
    """``run()`` eagerly (``disable_graphs``), then on the stand-in graphs
    with ``patch_attr`` (module, name) replaying the eager run's outputs;
    returns (eager result, graph result, the programs' activity in the
    graph run)."""
    mod, name = patch_attr
    monkeypatch.setattr(mod, name, _Replayed(getattr(mod, name)))
    with programs.disable_graphs():
        eager = run()
    before = programs.capture_stats()
    got = run()
    return eager, got, programs.captures_since(before)


def test_incremental_edges_make_one_register_edge_capture(graphs,
                                                          monkeypatch):
    """The incremental loop (``planned=False``, the chain of three crops,
    two edges) on the stand-in graphs: one ``register_edge`` capture, two
    replays, the key holding the edge id as a tensor; the panorama equal
    to the eager run's bit for bit."""
    cfg = dataclasses.replace(TINY, ordering="chain", planned=False)
    images = _crops()

    def run():
        return tstm.Stitcher(cfg, device="cpu").stitch(images)
    eager, got, delta = _modes(run, (batched, "_project_and_extract_one"),
                               monkeypatch)
    np.testing.assert_array_equal(got, eager)
    prog = treg.register_edge
    assert delta["by_program"]["register_edge"] == 1, delta
    assert len(prog.graphs) == 1 and prog.replays == 2
    assert _slot_at(prog, next(iter(prog.graphs)), "edge_id")


def _stream_frames():
    scene = make_scene(np.random.default_rng(0), h=96, w=128 + 3 * 32)
    return [scene[:, i * 32:i * 32 + 128] for i in range(4)]


@pytest.fixture(scope="module")
def stream_runs():
    """Four frames through ``StreamingStitcher`` eagerly and on the
    stand-in graphs (``fake_graphs``'s patches; SIFT replayed from the
    eager run), with the edge ids of the graph run's ``register_edge``
    calls."""
    from test_torch_programs import _FakeGraphs

    calls, fn = [], treg.register_edge

    def run():
        ss = streaming.StreamingStitcher(STREAM_CFG, project=False,
                                         device="cpu")
        sizes = [ss.push(f) for f in _stream_frames()]
        return ss, sizes

    def counted(*a, **kw):
        calls.append(int(a[3]))  # the counter moves on after the call
        return fn(*a, **kw)
    mp = pytest.MonkeyPatch()
    mp.setattr(programs, "_BACKEND", _FakeGraphs)
    mp.setattr(programs, "_graphable", lambda device: True)
    mp.setattr(streaming, "register_edge", counted)
    programs.clear_graphs()
    try:
        (ss_e, sizes_e), (ss_g, sizes_g), delta = _modes(
            run, (streaming, "sift_extract"), mp)
        graphs = list(fn.graphs)
    finally:
        programs.clear_graphs()
        mp.undo()
    return ss_e, sizes_e, ss_g, sizes_g, delta, calls[len(calls) // 2:], \
        graphs


def test_stream_under_graphs_equals_eager(stream_runs):
    """The stream's canvas after four frames, its sizes and its keyframe
    switches with the registration as a graph equal the eager run's."""
    ss_e, sizes_e, ss_g, sizes_g, _, _, _ = stream_runs
    assert sizes_g == sizes_e
    assert ss_g.n_keyframe_switches == ss_e.n_keyframe_switches >= 1
    np.testing.assert_array_equal(ss_g.canvas(), ss_e.canvas())


def test_stream_pushes_make_one_register_edge_capture(stream_runs):
    """Three pushes (and the re-registrations of the keyframe switches)
    make one ``register_edge`` capture and replay it on every call; the
    edge id reaches the program as the stream's device counter, the frame
    index of each push."""
    _, _, ss_g, _, delta, calls, graphs = stream_runs
    assert len(calls) == 3 + ss_g.n_keyframe_switches
    assert delta["by_program"] == {"register_edge": 1}, delta
    assert delta["replays"] == len(calls) and len(graphs) == 1
    assert _slot_at(treg.register_edge, graphs[0], "edge_id")
    assert calls == sorted(calls) and calls[0] == 1 and calls[-1] == 3, calls
    assert ss_g._frame_id.dtype == torch.int64 and int(ss_g._frame_id) == 4


# ------------------------------------------------------ mixed-shape ordering
def _synthetic_features(caps, seed: int = 0):
    """One feature set per capacity in ``caps`` (the capacity follows the
    image shape): each holds 90 descriptors drawn from a shared pool of
    180, with noise, then 30 of its own, in its live prefix."""
    rng = np.random.default_rng(seed)
    pool = rng.uniform(0, 255, (180, 128)).astype(np.float32)
    feats = []
    for cap in caps:
        live = 120
        desc = np.zeros((cap, 128), np.float32)
        desc[:90] = pool[rng.choice(180, 90, replace=False)] + rng.normal(
            0, 4, (90, 128))
        desc[90:live] = rng.uniform(0, 255, (live - 90, 128))
        xy = np.zeros((cap, 2), np.float32)
        xy[:live] = rng.uniform(0, 100, (live, 2))
        feats.append((desc, xy, np.ones(cap, np.float32),
                      np.arange(cap) < live))
    return feats


def _ordering_counts(module, stitcher, feats) -> np.ndarray:
    """The [N, N] counts a ``Stitcher._match_graph`` of ``module`` (either
    package's) hands to ``directed_adjacency``, on ``feats`` with no
    stacked features: the mixed-shape ordering."""
    seen, adjacency = {}, module.directed_adjacency

    def keep(counts, threshold):
        seen["counts"] = np.asarray(counts)
        return adjacency(counts, threshold)
    stitcher._feats_stacked = None
    mp = pytest.MonkeyPatch()
    mp.setattr(module, "directed_adjacency", keep)
    try:
        stitcher._match_graph(feats)
    finally:
        mp.undo()
    return seen["counts"]


def _port_counts(feats, cfg) -> np.ndarray:
    return _ordering_counts(tstm, tstm.Stitcher(cfg, device="cpu"),
                            [features_from_numpy(f, "cpu") for f in feats])


def test_mixed_shape_ordering_counts_match_jax(graphs):
    """Four feature sets of three capacities: the port's pair counts
    equal the JAX package's loop (its ``Stitcher._match_graph`` on the
    same features) exactly, eagerly and on the stand-in graphs, where the
    six pairs of five distinct keys make five captures and a replay."""
    feats = _synthetic_features((256, 192, 256, 320))
    want = _ordering_counts(jstm, jstm.Stitcher(SMALL_DEFAULT), [
        JFeatures(*(jnp.asarray(a) for a in f)) for f in feats])
    with programs.disable_graphs():
        eager = _port_counts(feats, SMALL_DEFAULT)
    before = programs.capture_stats()
    got = _port_counts(feats, SMALL_DEFAULT)
    delta = programs.captures_since(before)
    np.testing.assert_array_equal(eager, want)
    np.testing.assert_array_equal(got, want)
    assert want[0, 2] > 25 and (np.diag(want) == 0).all(), want
    assert delta["by_program"] == {"mixed_pair_counts": 5}, delta
    assert delta["replays"] == 6, delta


def test_mixed_shape_ordering_overflows_in_a_scope(graphs):
    """Five capacities, ten pairs of ten keys, more than ``MAX_GRAPHS``:
    inside one scope (a stitch) eight pairs capture and the other two run
    eagerly, and a second scope replays the eight and runs the two
    eagerly again; every count equals the eager run's."""
    feats = _synthetic_features((128, 192, 256, 320, 384), seed=1)
    with programs.disable_graphs():
        eager = _port_counts(feats, SMALL_DEFAULT)
    prog = tstm._pair_counts
    for captures in (8, 0):
        before = programs.capture_stats()
        with programs.scope():
            got = _port_counts(feats, SMALL_DEFAULT)
        delta = programs.captures_since(before)
        np.testing.assert_array_equal(got, eager)
        assert delta["by_program"].get("mixed_pair_counts", 0) == captures
        assert delta["overflows"] == 2 and delta["evictions"] == 0, delta
    assert len(prog.graphs) == prog.max_graphs == 8


# ------------------------------------------------------ batched registration
def test_batched_register_under_graphs_equals_eager_and_jax(graphs):
    """Two pairs of one frame shape through ``batched_pairwise_register``
    on the stand-in graphs: one ``register_one`` capture replayed per
    pair, its SIFT inlined (no capture of its own), coefficients and
    inliers equal to the eager run's bit for bit; against the JAX
    package's at tests/test_torch_batched.py::
    test_batched_pairwise_register_matches_jax's tolerance: an 8 x 8 grid
    within 2 px, inliers within 10% of the larger plus 2."""
    a, b = _register_scene()
    gray_a, gray_b = np.stack([a, a[:, ::-1]]), np.stack([b, b[:, ::-1]])
    cfg, jcfg = TINY, JTINY
    with programs.disable_graphs():
        ec, en = batched.batched_pairwise_register(gray_a, gray_b, cfg,
                                                   device="cpu")
    before = programs.capture_stats()
    gc, gn = batched.batched_pairwise_register(gray_a, gray_b, cfg,
                                               device="cpu")
    delta = programs.captures_since(before)
    assert delta["by_program"] == {"register_one": 1}, delta
    assert delta["replays"] == 2, delta
    np.testing.assert_array_equal(gc.numpy(), ec.numpy())
    np.testing.assert_array_equal(gn.numpy(), en.numpy())
    jc, jn = jbatched.batched_pairwise_register(jnp.asarray(gray_a),
                                                jnp.asarray(gray_b), jcfg)
    px, py = np.meshgrid(np.linspace(4, 60, 8), np.linspace(4, 44, 8))
    px, py = T(px.ravel().astype(np.float32)), T(py.ravel().astype(np.float32))
    for k in range(2):
        xt, yt = warp_points(gc[k], px, py)
        xj, yj = warp_points(T(np.array(jc[k])), px, py)
        assert float(torch.hypot(xt - xj, yt - yj).max()) < 2.0
    jn = np.asarray(jn)
    assert np.abs(gn.numpy() - jn).max() <= 0.1 * jn.max() + 2


def test_prng_key_on_is_a_cached_constant_with_prng_keys_bits():
    """The RANSAC key that ``register_edge`` and ``_register_one`` read
    inside their programs, ``rng.prng_key_on``: ``prng_key``'s bits (a
    seed past 2^32 masked as JAX masks it), the same tensor every call."""
    from computervisionimagestich2_tpu_torch.ops import rng

    for seed in (TINY.ransac.seed, 2 ** 32 + 7):
        key = rng.prng_key_on(seed, "cpu")
        np.testing.assert_array_equal(key.numpy(),
                                      rng.prng_key(seed).numpy())
        assert rng.prng_key_on(seed, "cpu") is key
