"""The port's per-shape programs (``core/programs.py``, the counterpart of
``jax.jit``) and what they run: the edge plan on device-resident edges
against the plan of Python-int edges and the JAX package's; the tensor-key
threefry against ``jax.random``; the per-image features program against
the JAX package's; no host synchronisation and no upload in a warm call of
either program; the program wrapper's key, nesting and eager modes on a
stand-in for CUDA graphs; and the constant cache (H1).
"""
import collections
import dataclasses
import sys
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from computervisionimagestich2_tpu.models import registration as jreg
from computervisionimagestich2_tpu.models.stitcher import Stitcher as JStitcher
from computervisionimagestich2_tpu.parallel import batched as jbatched
from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG, SLICE_CONFIG
from computervisionimagestich2_tpu_torch.core import programs
from computervisionimagestich2_tpu_torch.core.types import (
    Features, features_from_numpy)
from computervisionimagestich2_tpu_torch.models import registration as treg
from computervisionimagestich2_tpu_torch.models import sift as tsift
from computervisionimagestich2_tpu_torch.models import stitcher as tstm
from computervisionimagestich2_tpu_torch.ops import _native, detect, distance
from computervisionimagestich2_tpu_torch.ops import rng as trng
from computervisionimagestich2_tpu_torch.ops import sift_walks
from computervisionimagestich2_tpu_torch.parallel import batched as tbatched
from test_integration import make_scene

T = torch.as_tensor
GRAPHABLE = programs._graphable  # CUDA devices only
# the small sizes of tests/test_torch_match.py
SMALL = dataclasses.replace(
    SLICE_CONFIG,
    sift=dataclasses.replace(SLICE_CONFIG.sift, n_octaves=2,
                             max_keypoints_per_octave=512,
                             max_keypoints=1024),
    match=dataclasses.replace(SLICE_CONFIG.match, max_matches=512),
    ransac=dataclasses.replace(SLICE_CONFIG.ransac, n_hypotheses=64))
# the default path (fused detect, graph ordering) at those sizes
SMALL_DEFAULT = dataclasses.replace(
    DEFAULT_CONFIG,
    sift=dataclasses.replace(DEFAULT_CONFIG.sift, n_octaves=2,
                             max_keypoints_per_octave=512,
                             max_keypoints=1024),
    match=SMALL.match, ransac=SMALL.ransac)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """A thread pool per pytest worker oversubscribes the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _crops():
    scene = make_scene(np.random.default_rng(0), h=160, w=320)
    return [scene[:, s:s + 160] for s in (0, 80, 160)]


@pytest.fixture(scope="module")
def jax_feats():
    """The JAX package's stacked features of three overlapping crops."""
    st = JStitcher(SMALL)
    proj, _ = st.prepare(_crops())
    return tuple(np.array(a) for a in st._matching_feats()), proj[0].shape[:2]


# ---------------------------------------------------------------- (a) plan
def _plan_host_edges(feats, edges, img_hw, start_hw, cfg):
    """The edge plan as a loop over Python-int edges: views of the stacked
    features, RANSAC keys folded on the host, rows written by indexing
    (the port's plan before its edges moved to the device)."""
    h_img, w_img = img_hw
    dev = feats.desc.device
    xy_all = feats.xy.clone()
    cur_w = torch.tensor(float(start_hw[1]), device=dev)
    cur_h = torch.tensor(float(start_hw[0]), device=dev)
    pad = [torch.zeros(1, device=dev)] if cfg.warp_model == "bilinear" else []
    rows = []
    for src, dst, pre in edges:
        def at_img(i):
            return Features(desc=feats.desc[i], xy=xy_all[i],
                            scale=feats.scale[i], valid=feats.valid[i])

        fwd, bwd, _, ovf = treg.register_edge(at_img(src), at_img(dst), cfg,
                                              src * 65536 + dst, img_hw)
        min_x, min_y, new_w, new_h = treg._canvas_bounds(
            fwd, w_img, h_img, cur_w, cur_h, cfg.warp_model)
        xy_all[dst] = treg.update_features_by_warp(
            at_img(dst), fwd, min_x, min_y, cfg.warp_model).xy
        xy_all[pre] = xy_all[pre] - torch.stack(
            [torch.trunc(min_x), torch.trunc(min_y)])[None, :]
        rows.append(torch.cat([fwd, *pad, bwd, *pad, torch.stack(
            [min_x, min_y, new_w, new_h, ovf.float()])]))
        cur_w, cur_h = new_w, new_h
    return torch.stack(rows).numpy()


@pytest.mark.parametrize("edges", [[(1, 2, 1), (1, 0, 2)],
                                   [(1, 0, 1), (1, 2, 0)]])
def test_device_edge_plan_matches_host_edges_and_jax(jax_feats, edges):
    """The plan on int32 device edges equals the Python-int plan bit for
    bit, and the JAX package's plan within
    tests/test_torch_match.py::test_plan_edges_on_jax_features's
    tolerance: equal canvas dims and overflow, min_x / min_y within
    0.5 px, coefficients rtol 1e-3."""
    stacked, img_hw = jax_feats
    feats = features_from_numpy(stacked, "cpu")
    plan = treg.plan_edges(feats, edges, img_hw, img_hw, SMALL)
    np.testing.assert_array_equal(
        plan, _plan_host_edges(feats, edges, img_hw, img_hw, SMALL))
    jplan = np.asarray(jreg.plan_edges(
        jax.tree.map(jnp.asarray, _jax_features(stacked)),
        jnp.asarray(np.asarray(edges, np.int32)), img_hw, img_hw, SMALL))
    assert plan.shape == jplan.shape == (2, treg.PLAN_ROW)
    np.testing.assert_array_equal(plan[:, 20:], jplan[:, 20:])
    np.testing.assert_allclose(plan[:, 18:20], jplan[:, 18:20], atol=0.5)
    np.testing.assert_allclose(plan[:, :18], jplan[:, :18], rtol=1e-3,
                               atol=1e-5)


def _jax_features(stacked):
    from computervisionimagestich2_tpu.core.types import Features as JF

    return JF(*stacked)


# ----------------------------------------------------------------- (b) rng
# (src, dst) edges, and the id src * 65536 + dst past 2^31 and at 2^32 - 1
EDGES = [(0, 1), (3, 2), (1, 65535), (32767, 65535), (32768, 0),
         (40000, 5), (65535, 65535)]


@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_tensor_key_fold_in_and_uniform_match_jax(seed):
    """The plan's keys, folded on the device from an int32 edge row,
    ``fold_in(fold_in(PRNGKey(seed), src * 65536 + dst), 0 or 1)``, and
    their ``uniform`` draws equal ``jax.random``'s bit for bit, as the
    host-folded keys do."""
    ids = torch.tensor([[s, d, 0] for s, d in EDGES], dtype=torch.int32)
    base = torch.tensor([0, seed], dtype=torch.int64)
    tags = torch.tensor([0, 1], dtype=torch.int64)
    for e, (src, dst) in enumerate(EDGES):
        row = ids[e].long()
        key = trng.fold_in(base, row[0] * 65536 + row[1])
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed),
                                  jnp.uint32((src * 65536 + dst) % 2 ** 32))
        np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
        np.testing.assert_array_equal(
            key.numpy(), trng.fold_in(trng.prng_key(seed),
                                      src * 65536 + dst).numpy())
        for tag in (0, 1):
            sub = trng.fold_in(key, tags[tag])
            jsub = jax.random.fold_in(jkey, tag)
            np.testing.assert_array_equal(sub.numpy(), np.asarray(jsub))
            u = trng.uniform(sub, (64, 4))
            ju = np.asarray(jax.random.uniform(jsub, (64, 4)))
            np.testing.assert_array_equal(u.numpy().view(np.int32),
                                          ju.view(np.int32))


# ------------------------------------------------------- (c) features program
def test_project_and_extract_one_matches_jax():
    """The per-image features program against the JAX package's
    ``_project_and_extract_one`` on a seeded 160x120 frame: the
    projection within one u8 level (the JAX program projects by its banded
    form), the SIFT stats equal and the features at the gates of
    tests/test_torch_sift.py::test_sift_extract_stats_matches_jax."""
    img = make_scene(np.random.default_rng(3), h=160, w=120)
    jf, jproj, js = jbatched._project_and_extract_one(jnp.asarray(img), SMALL)
    tf, tproj, ts = tbatched._project_and_extract_one(T(img), SMALL)
    diff = np.abs(tproj.numpy() - np.asarray(jproj))
    assert diff.max() <= 1.0 and (diff > 0).mean() < 0.01, diff.max()
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jv, tv = np.asarray(jf.valid), tf.valid.numpy()
    jxy, txy = np.asarray(jf.xy)[jv], tf.xy.numpy()[tv]
    jd, td = np.asarray(jf.desc)[jv], tf.desc.numpy()[tv]
    assert len(jxy) > 20
    assert abs(len(jxy) - len(txy)) <= max(2, 0.05 * len(jxy))
    d = np.linalg.norm(jxy[:, None] - txy[None], axis=-1)
    matched = d.min(axis=1) < 0.5
    assert matched.mean() >= 0.9, matched.mean()
    cos = np.where(d < 0.5, jd @ td.T, -1.0).max(axis=1)[matched]
    assert cos.min() > 0.999, cos.min()


def test_prepare_runs_the_features_program():
    """``Stitcher.prepare`` on uniform shapes dispatches the features
    program once per frame and returns what it returns."""
    calls, fn = [], tbatched._project_and_extract_one
    mp = pytest.MonkeyPatch()
    mp.setattr(tbatched, "_project_and_extract_one",
               lambda img, cfg: calls.append(cfg) or fn(img, cfg))
    try:
        frames = [c[:96, :64] for c in _crops()[:2]]
        proj, feats = tstm.Stitcher(SMALL, device="cpu").prepare(frames)
    finally:
        mp.undo()
    assert calls == [SMALL, SMALL]
    f, p, _ = fn(T(frames[1]), SMALL)
    np.testing.assert_array_equal(p.numpy(), proj[1].numpy())
    for a, b in zip(f, feats[1]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_prepare_runs_the_features_program_on_mixed_shapes():
    """Mixed shapes go through the same features program, one frame at a
    time, and leave nothing stacked."""
    calls, fn = [], tbatched._project_and_extract_one
    mp = pytest.MonkeyPatch()
    mp.setattr(tbatched, "_project_and_extract_one",
               lambda img, cfg: calls.append(tuple(img.shape))
               or fn(img, cfg))
    frames = [c[:96, :64] for c in _crops()[:2]]
    frames[1] = frames[1][:80]
    try:
        st = tstm.Stitcher(SMALL, device="cpu")
        proj, feats = st.prepare(frames)
    finally:
        mp.undo()
    assert calls == [(96, 64, 3), (80, 64, 3)]
    assert st._feats_stacked is None
    f, p, _ = fn(T(frames[1]), SMALL)
    np.testing.assert_array_equal(p.numpy(), proj[1].numpy())
    for a, b in zip(f, feats[1]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# --------------------------------------------- (d) no sync, no upload, warm
# the plain versions of the kernels: they run on the CPU only, the card
# runs the kernels instead
PLAIN = {f.__code__ for f in (
    detect.detect_compact_plain, sift_walks.orientation_hist_plain,
    sift_walks.descriptors_plain, distance.two_nearest_plain,
    distance.pair_match_counts_plain)}
HOST_DATA = ("tensor", "as_tensor", "from_numpy")
SYNCS = ("item", "__int__", "__float__", "__bool__", "tolist", "cpu")
# operators that read a tensor's value on the host inside PyTorch (an
# index by a 0-dim tensor reads it with _local_scalar_dense)
SYNC_OPS = ("_local_scalar_dense", "nonzero", "masked_select", "unique",
            "equal", "is_nonzero")


def _in_plain() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code in PLAIN:
            return True
        f = f.f_back
    return False


def _site() -> str:
    """The innermost caller in the port (else the innermost caller)."""
    stack = traceback.extract_stack()[:-2]
    port = [s for s in stack if "computervisionimagestich2_tpu_torch/"
            in s.filename and "core/programs.py" not in s.filename]
    site = (port or stack)[-1]
    return f"{site.filename.split('/')[-1]}:{site.lineno}"


class _SyncOps(TorchDispatchMode):
    """Counts the ``SYNC_OPS`` that run outside the plain versions."""

    def __init__(self, hits):
        super().__init__()
        self.hits = hits

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name in SYNC_OPS and not _in_plain():
            self.hits[f"aten.{name} {_site()}"] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def host_calls():
    """While open, count (with the call site) every tensor built from host
    data and every read of a tensor's value on the host (``SYNCS`` and,
    within ``_SyncOps``, ``SYNC_OPS``), except inside the plain versions
    of the kernels."""
    hits = collections.Counter()

    def counted(name, fn):
        def call(*a, **kw):
            if not _in_plain():
                hits[f"{name} {_site()}"] += 1
            return fn(*a, **kw)
        return call

    mp = pytest.MonkeyPatch()
    for name in HOST_DATA:
        mp.setattr(torch, name, counted("torch." + name, getattr(torch, name)))
    for name in SYNCS:
        mp.setattr(torch.Tensor, name,
                   counted("Tensor." + name, getattr(torch.Tensor, name)))
    yield hits
    mp.undo()


@pytest.fixture(scope="module")
def plan_args():
    """The default path's features of the three crops and their edges, as
    ``Stitcher`` hands them to the plan."""
    st = tstm.Stitcher(SMALL_DEFAULT, device="cpu")
    st.prepare(_crops())
    feats = st._matching_feats()
    edges = torch.tensor([(1, 2, 1), (1, 0, 2)], dtype=torch.int32)
    return feats, edges, (160, 160), (160, 160), SMALL_DEFAULT


def _edge_args(seam: bool):
    """The arguments of one composite + blend program call: a crop warped
    onto a canvas beside the previous result, the backward model and the
    offsets as tensors (the plan's rows), with the area-gated seam band
    (window on the device, rgb gain) or the full-canvas blend."""
    crops = _crops()
    cfg = dataclasses.replace(SMALL_DEFAULT, blend=dataclasses.replace(
        SMALL_DEFAULT.blend, seam_auto_area=20_000 if seam else 0,
        seam_auto_band=16))
    bwd = T(np.array([0.998, 0.002, 1e-5, -79.5, -0.001, 1.001, -1e-5, 2.25],
                     np.float32))
    offsets = T(np.array([0.0, -2.5], np.float32))
    return (T(crops[1]).float(), T(crops[0]).float(), bwd, offsets,
            (166, 245), (163, 240), cfg)


def test_warm_programs_make_no_sync_and_no_upload(host_calls, plan_args):
    """A warm call of the features program (fused and dense detection),
    of the plan, of an edge's composite + blend (the full-canvas blend
    and the seam band), of the enhance tail, of a batch's whole panorama,
    of ``register_edge`` (its edge id a device constant, as the
    incremental loop hands it over), of the ordering's counts (exact L1
    and ``l2pre``), of the mixed-shape ordering's pair program and of a
    batch's registration pair builds no tensor from host data and reads
    no tensor on the host, outside the plain versions of the kernels (the
    card runs the kernels). The stream's registration (``register_edge``
    on its device frame counter, then the counter's step) reads back only
    its one copy of the models and counts."""
    from computervisionimagestich2_tpu_torch.models import streaming
    from test_torch_batched import TINY, _panoramas, _register_scene

    img = T(_crops()[0])
    assert SMALL_DEFAULT.sift.detect_impl == "pallas"
    assert SMALL.sift.detect_impl == "xla"
    edge, seam_edge = _edge_args(False), _edge_args(True)
    pano = T(_panoramas((0,))[0])
    feats, _, img_hw, _, cfg = plan_args
    f1, f2 = (Features(*(t[i] for t in feats)) for i in (1, 2))
    f0_part = Features(*(t[0, :256] for t in feats))
    l2pre = dataclasses.replace(cfg, match=dataclasses.replace(
        cfg.match, method="l2pre"))
    gray_a, gray_b = (T(g) for g in _register_scene())
    ss = streaming.StreamingStitcher(cfg, device="cpu")
    ss._frame_id = torch.ones((), dtype=torch.int64)

    def stream_register():
        out = ss._register(f1, f2, img_hw)
        ss._frame_id += 1
        return out
    calls = {
        "features": lambda: tbatched._project_and_extract_one(
            img, SMALL_DEFAULT),
        "features, dense detection": lambda: tbatched._project_and_extract_one(
            img, SMALL),
        "plan": lambda: treg.plan_rows(*plan_args),
        "composite + blend": lambda: tstm._composite_and_blend(*edge),
        "composite + seam band": lambda: tstm._composite_and_blend(
            *seam_edge),
        "enhance": lambda: tstm.equalize_and_mix(edge[1]),
        "batched panorama": lambda: tbatched._stitch_one_fixed(
            pano, TINY, (192, 256), tbatched.chain_edge_seq(3)),
        "register_edge": lambda: treg.register_edge(
            f1, f2, cfg, programs.const(65538, torch.int64, "cpu"), img_hw),
        "ordering": lambda: treg.all_pairs_match_counts(
            feats.desc, feats.valid, cfg),
        "ordering, l2pre": lambda: treg.all_pairs_match_counts(
            feats.desc, feats.valid, l2pre),
        "mixed-shape pair": lambda: tstm._pair_counts(f0_part, f2,
                                                       cfg.match),
        "registration pair": lambda: tbatched._register_one(gray_a, gray_b,
                                                            TINY),
        "stream registration": stream_register}
    # the stream's one readback of forward, backward, count and overflow
    allowed = {"stream registration": {"Tensor.cpu streaming.py"}}
    for name, call in calls.items():
        call()
        host_calls.clear()
        with _SyncOps(host_calls):
            out = call()
        sites = {site.split(":")[0]: n for site, n in host_calls.items()}
        assert sites == dict.fromkeys(allowed.get(name, ()), 1), (
            name, dict(host_calls))
        assert out is not None
    # the counters see what they are meant to see: an upload, an index
    # by a 0-dim tensor and an item()
    host_calls.clear()
    t = torch.tensor([1.0, 2.0])
    with _SyncOps(host_calls):
        t[t.argmax()].item()
    by_kind = collections.Counter()
    for site, n in host_calls.items():
        by_kind[site.split()[0]] += n
    assert by_kind == {"torch.tensor": 1, "Tensor.item": 1,
                       "aten._local_scalar_dense": 2}, dict(host_calls)


# ------------------------------------------------------ (e) the program key
class _FakeGraphs:
    """Stands in for CUDA graphs on the CPU: a capture runs the function
    and keeps it with its outputs; a replay runs it again on the static
    inputs and writes the outputs in place, with the launch counters as
    they were (a real replay runs no Python)."""

    @staticmethod
    def warm_up(fn, device):
        fn()

    @staticmethod
    def capture(fn, device):
        out = fn()
        return (fn, out), out

    @staticmethod
    def replay(graph, device):
        fn, out = graph
        counts = dict(_native.LAUNCHES)
        programs._INLINE += 1  # what was inlined in the capture stays so
        try:
            new = fn()
        finally:
            programs._INLINE -= 1
        _native.LAUNCHES.update(counts)
        a, b = [], []
        programs._flatten(out, a)
        programs._flatten(new, b)
        for x, y in zip(a, b):
            x.copy_(y)


@pytest.fixture
def fake_graphs(monkeypatch):
    """Programs on CPU tensors take the graph path, on ``_FakeGraphs``."""
    monkeypatch.setattr(programs, "_BACKEND", _FakeGraphs)
    monkeypatch.setattr(programs, "_graphable", lambda device: True)
    made = []

    def make(fn, name):
        p = programs.Program(fn, name)
        made.append(p)
        return p
    yield make
    for p in made:
        programs._PROGRAMS.remove(p)


def test_program_key_and_replays(fake_graphs):
    """Another static argument or tensor shape is another key; the same
    key replays without a capture; the outputs are fresh tensors each
    call; the kernel launches counted in the capture come back with every
    replay, once per call."""
    ran = []

    def fn(x, scale: float, pair=(1, 2)):
        ran.append(scale)
        _native.LAUNCHES["warp_image"] += 1
        return {"y": x * scale + pair[0], "n": x.shape[0]}

    prog = fake_graphs(fn, "f")
    _native.reset_launch_counts()
    x = torch.arange(4.0)
    out1 = prog(x, 2.0)
    assert prog.captures == 1 and _native.LAUNCHES["warp_image"] == 1
    out2 = prog(x + 1, 2.0)
    assert prog.captures == 1 and _native.LAUNCHES["warp_image"] == 2
    np.testing.assert_array_equal(out1["y"].numpy(), [1, 3, 5, 7])
    np.testing.assert_array_equal(out2["y"].numpy(), [3, 5, 7, 9])
    assert out1["n"] == 4 and out1["y"] is not out2["y"]
    prog(x, 3.0)                      # another static argument
    prog(x, 2.0, (1, 3))              # another static tuple
    prog(torch.arange(5.0), 2.0)      # another shape
    prog(torch.arange(4), 2.0)        # another dtype
    assert prog.captures == 5 and len(prog.graphs) == 5
    prog(x, scale=2.0)                # keywords bind to the same key
    assert prog.captures == 5
    assert _native.LAUNCHES["warp_image"] == 7
    _native.reset_launch_counts()


def test_graphs_are_bounded_least_recent_first(fake_graphs):
    """A program keeps at most ``max_graphs`` graphs: a new key drops the
    least recently replayed one, which captures again when it comes
    back; the counters and the replays' outputs stay right."""
    prog = fake_graphs(lambda x, k: x * k, "bounded")
    prog.max_graphs = 2
    x = torch.ones(2)
    prog(x, 1), prog(x, 2), prog(x, 1)        # 1 is now the most recent
    np.testing.assert_array_equal(prog(x, 3).numpy(), [3, 3])   # drops 2
    assert len(prog.graphs) == 2 and prog.evictions == 1
    before = prog.captures
    prog(x, 1)                                # kept: a replay
    assert prog.captures == before
    np.testing.assert_array_equal(prog(x, 2).numpy(), [2, 2])   # again
    assert prog.captures == before + 1 and prog.evictions == 2
    assert prog.replays == 6
    stats = programs.capture_stats()
    assert stats["evictions"] >= 2 and stats["graphs"] >= 2


def test_a_scope_keeps_the_graphs_it_used(fake_graphs):
    """Inside ``scope()`` a graph the scope used is not dropped for
    another of its keys: a key that finds every graph kept used by the
    scope runs eagerly (an overflow, no capture), so a cycle of more keys
    than ``max_graphs`` replays the same graphs scope after scope instead
    of capturing every key anew; a later scope drops the least recently
    replayed graph as before."""
    prog = fake_graphs(lambda x, k: x * k, "scoped")
    prog.max_graphs = 2
    x = torch.ones(2)
    for _ in range(3):
        with programs.scope():
            outs = [prog(x, k) for k in (1, 2, 3)]
        for k, out in zip((1, 2, 3), outs):
            np.testing.assert_array_equal(out.numpy(), [k, k])
    assert prog.captures == 2 and prog.evictions == 0
    assert prog.overflows == 3 and prog.replays == 6
    with programs.scope():
        with programs.scope():        # nested: one scope
            prog(x, 4), prog(x, 1)
        np.testing.assert_array_equal(prog(x, 2).numpy(), [2, 2])
    # 4 dropped 1 (the least recent), 1 then dropped 2, and 2 found both
    # graphs used by the scope
    assert prog.captures == 4 and prog.evictions == 2
    assert prog.overflows == 4 and list(prog.graphs) == [
        prog.key(x, 4)[0], prog.key(x, 1)[0]]
    prog(x, 2)                        # outside a scope: the plain bound
    assert prog.captures == 5 and prog.evictions == 3


def test_a_stitch_with_more_edge_canvases_than_graphs(fake_graphs,
                                                      monkeypatch):
    """A stitch is one scope: with the composite + blend program bound
    to one graph and two edge canvases, the first edge replays its graph
    and the second runs eagerly in every stitch; the second stitch
    captures nothing, and both panoramas equal the eager one."""
    monkeypatch.setattr(programs, "_BACKEND", _FakeGraphs)
    monkeypatch.setattr(programs, "_graphable", lambda device: True)
    edge = tstm._composite_and_blend
    monkeypatch.setattr(edge, "max_graphs", 1)
    programs.clear_graphs()
    images = _crops()
    try:
        with programs.disable_graphs():
            ref = tstm.Stitcher(SMALL, device="cpu").stitch(images)
        st = tstm.Stitcher(SMALL, device="cpu")
        c0 = programs.capture_stats()
        cold = st.stitch(images)
        cold_d, c1 = programs.captures_since(c0), programs.capture_stats()
        warm = st.stitch(images)
        warm_d = programs.captures_since(c1)
    finally:
        programs.clear_graphs()
    np.testing.assert_array_equal(cold, ref)
    np.testing.assert_array_equal(warm, ref)
    assert cold_d["by_program"]["composite_and_blend"] == 1, cold_d
    assert cold_d["overflows"] == 1 and warm_d["overflows"] == 1
    assert warm_d["captures"] == 0 and warm_d["evictions"] == 0, warm_d


def test_plan_key_holds_no_edge_values(fake_graphs, plan_args):
    """Two edge sequences of one length replay one plan graph, each
    with its own rows, equal to the eager plan's."""
    feats, edges, img_hw, start_hw, cfg = plan_args
    prog = fake_graphs(treg.plan_rows.fn, "plan")
    other = torch.tensor([(1, 0, 1), (1, 2, 0)], dtype=torch.int32)
    a, b = prog(feats, edges, img_hw, start_hw, cfg), prog(
        feats, other, img_hw, start_hw, cfg)
    assert prog.captures == 1 and len(prog.graphs) == 1
    with programs.disable_graphs():
        for rows, e in ((a, edges), (b, other)):
            np.testing.assert_array_equal(rows.numpy(), treg.plan_rows(
                feats, e, img_hw, start_hw, cfg).numpy())
    assert not np.array_equal(a.numpy(), b.numpy())
    prog(feats, edges[:1], img_hw, start_hw, cfg)   # another count of edges
    assert prog.captures == 2


def test_nested_programs_run_inline(fake_graphs):
    """A program called in another's warm-up or capture runs inline: it
    captures nothing of its own."""
    inner = fake_graphs(lambda x: x + 1, "inner")
    outer = fake_graphs(lambda x: inner(x) * 2, "outer")
    out = outer(torch.ones(3))
    np.testing.assert_array_equal(out.numpy(), [4, 4, 4])
    assert outer.captures == 1 and inner.captures == 0
    inner(torch.ones(3))
    assert inner.captures == 1


def test_disable_graphs_and_the_cpu_run_eagerly(fake_graphs, monkeypatch):
    """Under ``disable_graphs()`` (nested too) and on CPU tensors a
    program runs its function and captures nothing."""
    prog = fake_graphs(lambda x: x * 2, "eager")
    with programs.disable_graphs():
        with programs.disable_graphs():
            prog(torch.ones(2))
        prog(torch.ones(2))
        assert not programs.graphs_enabled()
    assert prog.captures == 0 and programs.graphs_enabled()
    monkeypatch.setattr(programs, "_graphable", GRAPHABLE)
    np.testing.assert_array_equal(prog(torch.ones(2)).numpy(), [2, 2])
    assert prog.captures == 0
    assert GRAPHABLE(torch.device("cuda", 0))


def test_failed_capture_raises_with_name_and_key(fake_graphs, monkeypatch):
    """A capture that fails raises, naming the program and its key, and
    leaves no graph; the warm-up's own errors pass through as they are."""
    class Broken(_FakeGraphs):
        @staticmethod
        def capture(fn, device):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    monkeypatch.setattr(programs, "_BACKEND", Broken)
    prog = fake_graphs(lambda x, k: x * k, "broken")
    with pytest.raises(RuntimeError, match="program broken: .*capture "
                                           "failed for key .*7"):
        prog(torch.ones(2), 7)
    assert not prog.graphs and programs._CAPTURING == 0

    def bad(x):
        raise ValueError("bad input")
    with pytest.raises(ValueError, match="bad input"):
        fake_graphs(bad, "bad")(torch.ones(2))


def test_the_port_programs():
    """The features program, the SIFT program inlined into it, the plan,
    an edge's composite + blend, the enhance tail, a batch's whole
    panorama, ``register_edge`` (which the plan inlines), the ordering's
    counts, the mixed-shape ordering's pair and a batch's registration
    pair; each wraps the function the JAX package jits (the pair: the
    body of its loop, ``models/stitcher.py:339-348``; the registration
    pair: the member of its vmapped ``batched_pairwise_register``)."""
    from computervisionimagestich2_tpu_torch.models import (equalization,
                                                            streaming)

    names = {p.name: p for p in programs._PROGRAMS}
    assert len(names) == len(programs._PROGRAMS) == 10
    assert names["register_edge"] is treg.register_edge
    assert tstm.register_edge is streaming.register_edge is treg.register_edge
    assert names["all_pairs_match_counts"] is treg.all_pairs_match_counts
    assert tstm.all_pairs_match_counts is treg.all_pairs_match_counts
    assert names["mixed_pair_counts"] is tstm._pair_counts
    assert names["register_one"] is tbatched._register_one
    assert names["project_and_extract"] is tbatched._project_and_extract_one
    assert names["sift_extract_stats"] is tsift.sift_extract_stats
    assert names["plan_edges"] is treg.plan_rows
    assert names["composite_and_blend"] is tstm._composite_and_blend
    assert names["equalize_and_mix"] is equalization.equalize_and_mix
    assert tstm.equalize_and_mix is equalization.equalize_and_mix
    assert names["stitch_one_fixed"] is tbatched._stitch_one_fixed


# ------------------------------------------------------- (f) constant cache
def test_const_is_uploaded_once_with_the_same_bits():
    a = programs.const(0.1, torch.float32, "cpu")
    assert programs.const(0.1, torch.float32, "cpu") is a
    assert a.item() == torch.tensor(0.1, dtype=torch.float32).item()
    b = programs.const(0.1, torch.bfloat16, "cpu")
    assert b is not a and b.dtype == torch.bfloat16
    assert b.item() == torch.tensor(0.1, dtype=torch.bfloat16).item()
    w = np.array([0.2, 0.5, 0.3], np.float32)
    assert programs.const(w, torch.float32, "cpu") is programs.const(
        w.copy(), torch.float32, "cpu")
    assert programs.const(w[::-1], torch.float32, "cpu") is not \
        programs.const(w, torch.float32, "cpu")


def test_const_raises_on_a_first_upload_in_a_capture(monkeypatch):
    programs.const(2.5, torch.float32, "cpu")
    monkeypatch.setattr(programs, "_CAPTURING", 1)
    assert programs.const(2.5, torch.float32, "cpu").item() == 2.5
    with pytest.raises(RuntimeError, match="first requested during a "
                                           "capture"):
        programs.const(12345.25, torch.float32, "cpu")


def test_no_caller_writes_into_a_cached_constant():
    """After a default-path stitch every constant the cache handed out
    has its first version; a write into one is caught at its next
    lookup."""
    tstm.Stitcher(SMALL_DEFAULT, device="cpu").stitch(_crops())
    consts = programs._CONSTS
    assert len(consts) > 20
    for t, version in consts.values():
        assert t._version == version, (tuple(t.shape), t.dtype)
    key_values = np.float32(-98765.5)
    t = programs.const(key_values, torch.float32, "cpu")
    try:
        t.add_(1.0)
        with pytest.raises(RuntimeError, match="written in place"):
            programs.const(key_values, torch.float32, "cpu")
    finally:
        consts.pop(next(k for k, v in consts.items() if v[0] is t))


def test_graph_replays_in_a_trace():
    """The profile's count of replays from Chrome-trace events: two
    ``cudaGraphLaunch`` calls, each with its host time and the device
    events under its correlation id, and a host-to-device copy inside a
    replay's span (caught) beside one outside every replay (not
    counted)."""
    from computervisionimagestich2_tpu_torch.tools import probes

    def ev(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        ev("user_annotation", probes.CALL_SPAN, 0, 100),
        ev("cuda_runtime", "cudaGraphLaunch", 1, 5, 7),
        ev("kernel", "detect_octaves_kernel", 10, 2, 7),
        ev("kernel", "descriptors_kernel", 14, 2, 7),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 12, 1, 3),
        ev("cuda_runtime", "cudaGraphLaunch", 20, 5, 9),
        ev("kernel", "l1_bidir_tile_kernel", 30, 2, 9),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 50, 1, 4),
        ev("kernel", "warp_bilinear_kernel", 60, 2, 5)]
    out = probes.summarize(events, wall=1e-4)
    assert out["graph_launches"] == 2 and out["graph_device_events"] == 3
    assert out["graph_launch_host_ms"] == [[0.005, 2], [0.005, 1]]
    assert out["memcpy_htod_in_replays"] == 1
    assert out["memcpy_htod_events"] == 2 and out["device_events"] == 6
    assert out["kernels"]["detect_compact"]["device_launches"] == 1


def test_launch_counters_against_the_trace():
    """``launches_vs_trace``: a counted launch of B4 is two device kernels
    in the trace, of B5 three; a counter that replays more launches than
    ran, or fewer, is reported."""
    from computervisionimagestich2_tpu_torch.tools import probes

    def k(counted, device):
        return {"counted_launches": counted, "device_launches": device}

    kernels = {"detect_compact": k(4, 4), "l1_two_nearest_bidir": k(3, 6),
               "pair_match_counts": k(1, 3), "l1_two_nearest": k(0, 0)}
    assert probes.launches_vs_trace(kernels) == {}
    kernels["detect_compact"] = k(8, 4)
    kernels["l1_two_nearest_bidir"] = k(3, 5)
    wrong = probes.launches_vs_trace(kernels)
    assert set(wrong) == {"detect_compact", "l1_two_nearest_bidir"}
    assert wrong["l1_two_nearest_bidir"]["device_kernels_per_launch"] == 2


def test_profile_call_leaves_out_its_lead_and_traces_again(monkeypatch):
    """On a card ``profile_call`` opens each session with spin kernels: a
    session whose trace kept none of them (the profiler lost its first
    records) is traced again, the kept ones are left out of the report,
    and sessions that all lose them raise."""
    from computervisionimagestich2_tpu_torch.tools import probes

    def ev(name, ts):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": 1}

    kept = [ev("spin_kernel(long)", 0), ev("detect_octaves_kernel<4>", 5)]
    traces = iter([[ev("detect_octaves_kernel<4>", 5)], kept])
    seen = []
    monkeypatch.setattr(probes, "_lead_kernels", lambda: 2)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(probes, "_trace", lambda prof: next(traces))
    monkeypatch.setattr(probes, "summarize", lambda events, wall, gaps: (
        seen.append(events) or {"device_busy_ms": 1.0, "kernels": {
            n: {"ms": 1.0, "device_launches": 0}
            for n in probes.DEVICE_KERNELS}}))
    calls = []
    out = probes.profile_call(lambda: calls.append(1), off=set())
    assert len(calls) == 2 and out["profiler_lead_kept"] == 1
    assert seen == [[kept[1]]]
    monkeypatch.setattr(probes, "_trace", lambda prof: [])
    with pytest.raises(RuntimeError, match="lost all 2 lead kernels"):
        probes.profile_call(lambda: None, off=set())


def test_profile_call_counts_the_calls_launches(monkeypatch):
    """``profile_call`` puts each wrapper's launches in the profiled call
    beside the trace's count (here on the CPU, where the trace holds no
    device kernel)."""
    from computervisionimagestich2_tpu_torch.tools import probes

    def fn():
        _native.LAUNCHES["warp_image"] += 3

    monkeypatch.setattr(probes, "summarize", lambda events, wall, gaps: {
        "device_busy_ms": 1.0, "kernels": {
            n: {"ms": 1.0, "device_launches": 0}
            for n in probes.DEVICE_KERNELS}})
    out = probes.profile_call(fn, off=set())
    assert out["kernels"]["warp_image"]["counted_launches"] == 3
    assert out["kernels"]["detect_compact"]["counted_launches"] == 0
