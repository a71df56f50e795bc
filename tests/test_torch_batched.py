"""Batched panoramas (BASELINE config 3) in the port's ``parallel`` package
against the JAX package's ``parallel/batched.py`` on the CPU, and a batch
against its members run one at a time.

The JAX batch functions vmap whole pipelines (their tests in
tests/test_parallel.py are marked slow for the compile); the panorama
comparison calls the JAX package's unvmapped ``_stitch_one_fixed``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu import config as jconfig
from computervisionimagestich2_tpu.parallel import batched as jbatched
from computervisionimagestich2_tpu_torch import config as tconfig
from computervisionimagestich2_tpu_torch.ops.warp import warp_points
from computervisionimagestich2_tpu_torch.parallel import batched
from test_integration import make_scene
from test_torch_incremental import _one_torch_thread  # noqa: F401

T = torch.as_tensor


def _tiny(config_module):
    """tests/test_parallel.py's TINY in either package's classes."""
    base = config_module.DEFAULT_CONFIG
    return dataclasses.replace(
        base,
        sift=config_module.SiftConfig(n_octaves=1,
                                      max_keypoints_per_octave=128,
                                      max_keypoints=256),
        match=config_module.MatchConfig(max_matches=128),
        ransac=config_module.RansacConfig(n_hypotheses=32))


TINY, JTINY = _tiny(tconfig), _tiny(jconfig)
H, W, K = 128, 112, 3
STEP = int(W * 0.4)


def _panoramas(offsets=(0, 24)):
    """tests/test_parallel.py:226-235: panoramas of K crops of one scene,
    each crop STEP right of the last, from each offset; u8 [B, K, H, W, 3]."""
    base = make_scene(np.random.default_rng(3), H, 3 * W).astype(np.float32)
    return np.stack([np.stack([base[:, o + i * STEP:o + i * STEP + W]
                               for i in range(K)])
                     for o in offsets]).astype(np.uint8)


def _register_scene():
    """tests/test_parallel.py:165-181: blobs on smoothed noise (48 x 64)
    and the same scene shifted 5 px right."""
    rng = np.random.default_rng(0)
    base = rng.uniform(60, 200, (48, 64)).astype(np.float32)
    for _ in range(2):
        base = (np.roll(base, 1, 0) + base + np.roll(base, -1, 0)) / 3
        base = (np.roll(base, 1, 1) + base + np.roll(base, -1, 1)) / 3
    ys_g, xs_g = np.mgrid[0:48, 0:64]
    for _ in range(18):
        cy, cx = rng.uniform(6, 42), rng.uniform(6, 58)
        r = rng.uniform(2, 5)
        m = ((ys_g - cy) ** 2 + (xs_g - cx) ** 2) < r * r
        base[m] = rng.uniform(0, 255)
    return base.astype(np.float32), np.roll(base, 5, axis=1)


def test_batched_project_and_extract_matches_jax():
    """Two crops through both packages' batch: projections within one u8
    level (the JAX package projects through another CPU formula,
    tests/test_torch_cli.py), and per image the extractor gates of
    tests/test_torch_sift.py: counts within max(2, 5%), >= 90% of the JAX
    keypoints within 0.5 px of a port keypoint, best co-located descriptor
    cosine > 0.999."""
    images = _panoramas()[0, :2]
    tf, tp = batched.batched_project_and_extract(images, TINY, device="cpu")
    jf, jp = jbatched.batched_project_and_extract(jnp.asarray(images), JTINY)
    assert tp.shape == (2, H, W, 3) and tf.desc.shape[0] == 2
    assert np.abs(tp.numpy() - np.asarray(jp)).max() <= 1.0
    for b in range(2):
        jv, tv = np.asarray(jf.valid[b]), tf.valid[b].numpy()
        jxy, txy = np.asarray(jf.xy[b])[jv], tf.xy[b].numpy()[tv]
        jd, td = np.asarray(jf.desc[b])[jv], tf.desc[b].numpy()[tv]
        assert len(jxy) > 20
        assert abs(len(jxy) - len(txy)) <= max(2, 0.05 * len(jxy))
        d = np.linalg.norm(jxy[:, None] - txy[None], axis=-1)
        matched = d.min(axis=1) < 0.5
        assert matched.mean() >= 0.9, matched.mean()
        cos = np.where(d < 0.5, jd @ td.T, -1.0).max(axis=1)[matched]
        assert cos.min() > 0.999, cos.min()


def test_batched_pairwise_register_matches_jax():
    """Two pairs (the scene and its 5 px shift, the second pair mirrored):
    at tests/test_parallel.py:185-200's tolerances, the port's warp
    reprojects an 8 x 8 grid within 2 px of JAX's and of the ground truth,
    and the inlier counts agree within 10% of the larger plus 2."""
    a, b = _register_scene()
    gray_a = np.stack([a, a[:, ::-1]])
    gray_b = np.stack([b, b[:, ::-1]])
    tc, tn = batched.batched_pairwise_register(gray_a, gray_b, TINY,
                                               device="cpu")
    jc, jn = jbatched.batched_pairwise_register(jnp.asarray(gray_a),
                                                jnp.asarray(gray_b), JTINY)
    assert tc.shape == (2, 8) and tn.shape == (2,)
    px, py = np.meshgrid(np.linspace(4, 60, 8), np.linspace(4, 44, 8))
    px, py = T(px.ravel().astype(np.float32)), T(py.ravel().astype(np.float32))
    for k, shift in enumerate((-5.0, 5.0)):
        xt, yt = warp_points(tc[k], px, py)
        xj, yj = warp_points(T(np.array(jc[k])), px, py)
        assert float(torch.hypot(xt - xj, yt - yj).max()) < 2.0
        assert float(torch.hypot(xt - (px + shift), yt - py).max()) < 2.0
    jn = np.asarray(jn)
    assert np.abs(tn.numpy() - jn).max() <= 0.1 * jn.max() + 2


def test_batch_equals_its_panoramas_one_at_a_time():
    """B = 2 panoramas of K = 3: the batch's canvases and plans equal
    ``_stitch_one_fixed`` on each panorama alone, bit for bit, and the
    synthetic shift is recovered (final width ~ W + 2 STEP)."""
    pans = _panoramas()
    canvas = (192, 256)
    out, plans = batched.batched_stitch_chain(pans, TINY, canvas, "cpu")
    assert out.shape == (2, 192, 256, 3) and plans.shape == (2, K - 1, 23)
    seq = batched.chain_edge_seq(K)
    assert seq == ((1, 2, 1), (1, 0, 2))
    for b in range(2):
        one, plan = batched._stitch_one_fixed(T(pans[b]), TINY, canvas, seq)
        assert torch.equal(out[b], one)
        np.testing.assert_array_equal(plans[b], plan)
    assert np.all(np.abs(plans[:, -1, 20] - (W + 2 * STEP)) < 10), plans
    assert float(out.max()) <= 255 and float(out.mean()) > 20


def test_stitch_one_fixed_matches_jax():
    """One panorama on the fixed canvas against the JAX package's
    ``_stitch_one_fixed`` (every Pallas backend off): canvas MAD <= 3 u8
    levels (tests/test_torch_stitch.py's gate) and the content extents
    plans[:, 18:22] within atol 1.0 (tests/test_parallel.py:288). The
    crops and SIFT capacities of tests/test_torch_graph_stitch.py: at
    TINY's 28-41 live keypoints a one-level difference in the two
    packages' CPU projections can move a RANSAC fit by pixels (given the
    same features the plans agree: tests/test_torch_match.py)."""
    scene = make_scene(np.random.default_rng(0), h=160, w=320)
    pans = np.stack([np.stack([scene[:, s:s + 160] for s in (0, 80, 160)])])
    cfg, jcfg = (dataclasses.replace(
        m.DEFAULT_CONFIG, sift=m.SiftConfig(
            n_octaves=2, max_keypoints_per_octave=512, max_keypoints=1024),
        match=m.MatchConfig(max_matches=512),
        ransac=m.RansacConfig(n_hypotheses=64)) for m in (tconfig, jconfig))
    canvas = (256, 384)
    out, plans = batched.batched_stitch_chain(pans, cfg, canvas, "cpu")
    jout, jplan = jbatched._stitch_one_fixed(
        jnp.asarray(pans[0]), jbatched._nopallas(jcfg), canvas,
        batched.chain_edge_seq(3))
    mad = np.abs(out[0].numpy() - np.asarray(jout)).mean()
    assert mad <= 3.0, mad
    np.testing.assert_allclose(plans[0][:, 18:22], np.asarray(jplan)[:, 18:22],
                               atol=1.0)
    assert plans[0, -1, 20] > 300  # all three crops on the canvas


@pytest.mark.parametrize("scene", ["panoramas_0", "panoramas_24",
                                   "jax_scene"])
def test_plan_on_full_capacity_equals_live_prefix(scene):
    """``_stitch_one_fixed`` plans on the features' whole capacity (no
    readback of the live counts inside its program): the [E, 23] plan
    equals, bit for bit, the plan on ``live_prefix`` of the features, for
    the batched scenes of this file at a capacity (1024) that the live
    prefix trims to 512."""
    from computervisionimagestich2_tpu_torch.models.registration import (
        plan_rows)
    from computervisionimagestich2_tpu_torch.models.stitcher import (
        live_prefix)
    if scene == "jax_scene":
        full = make_scene(np.random.default_rng(0), h=160, w=320)
        images = np.stack([full[:, s:s + 160] for s in (0, 80, 160)])
    else:
        images = _panoramas()[0 if scene == "panoramas_0" else 1]
    cfg = dataclasses.replace(
        tconfig.DEFAULT_CONFIG, sift=tconfig.SiftConfig(
            n_octaves=2, max_keypoints_per_octave=512, max_keypoints=1024),
        match=tconfig.MatchConfig(max_matches=512),
        ransac=tconfig.RansacConfig(n_hypotheses=64))
    feats, proj, _ = batched._project_and_extract(T(images), cfg)
    trimmed = live_prefix(feats)
    assert feats.desc.shape[1] == 1024 and trimmed.desc.shape[1] == 512
    img_hw = tuple(proj.shape[1:3])
    edges = T(np.array(batched.chain_edge_seq(3), np.int32))
    full_plan = plan_rows(feats, edges, img_hw, img_hw, cfg)
    live_plan = plan_rows(trimmed, edges, img_hw, img_hw, cfg)
    np.testing.assert_array_equal(full_plan.numpy().view(np.uint32),
                                  live_plan.numpy().view(np.uint32))
    assert np.isfinite(full_plan.numpy()).all()


def test_small_canvas_warns_batched_canvas_overflow(capfd):
    """A canvas narrower than the panorama's content extent: the stitch
    runs and prints the batched_canvas_overflow warning with the extent it
    needed; the default canvas (1.6 H, 0.85 K W on the 128 grid) holds
    it without a warning."""
    pans = _panoramas((0,))
    out, plans = batched.batched_stitch_chain(pans, TINY, (H, 128), "cpu")
    err = capfd.readouterr().err
    assert out.shape == (1, H, 128, 3)
    need_w = int(plans[0, -1, 20])
    assert need_w > 128
    assert "WARNING batched_canvas_overflow" in err, err
    assert f"canvas=({H}, 128)" in err and str(need_w) in err, err
    assert batched.default_canvas(H, W, K, TINY) == (256, 384)
    out, _ = batched.batched_stitch_chain(pans, TINY, device="cpu")
    assert out.shape == (1, 256, 384, 3)
    assert "batched_canvas_overflow" not in capfd.readouterr().err
    with pytest.raises(ValueError, match="smaller than an image"):
        batched.batched_stitch_chain(pans, TINY, (H - 1, 384), "cpu")
