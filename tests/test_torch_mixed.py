"""The PyTorch port on images of mixed shapes, on the CPU against the JAX
package's ``Stitcher``: per-image SIFT, graph counts from one
bidirectional match per i<j pair (not the stacked all-pairs call), and the
incremental stitch. Each package's run happens once per module.
"""
import shutil

import numpy as np
import pytest

from computervisionimagestich2_tpu.models.stitcher import Stitcher as JStitcher
from computervisionimagestich2_tpu_torch.models.stitcher import (
    Stitcher as TStitcher)
from computervisionimagestich2_tpu_torch.utils import artifacts
from test_integration import make_scene
from test_torch_graph_stitch import SMALL_DEFAULT, _record_ordering
from test_torch_incremental import (  # noqa: F401
    _one_torch_thread, assert_close_canvas)


def _mixed():
    """Three crops of one scene in scrambled order (scene order 1 - 2 - 0),
    each of another shape."""
    scene = make_scene(np.random.default_rng(0), h=160, w=320)
    return [scene[:150, 160:], scene[:, :160], scene[:, 80:236]]


@pytest.fixture(scope="module")
def jax_run():
    st = JStitcher(SMALL_DEFAULT)
    seen = _record_ordering(st)
    return st.stitch(_mixed()), seen


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    art = str(tmp_path_factory.mktemp("port_artifacts"))
    st = TStitcher(SMALL_DEFAULT, device="cpu", artifact_dir=art)
    seen = _record_ordering(st)
    out = st.stitch(_mixed())
    return out, seen, st, art


def test_mixed_shapes_match_jax_stitcher(jax_run, port_run):
    """Same discovered adjacency (the scene's chain) and start as JAX;
    canvas shape within +-3 px, MAD <= 3 u8 levels."""
    out_j, seen_j = jax_run
    out_t, seen_t, st, _ = port_run
    assert st._feats_stacked is None
    assert seen_t == seen_j
    edges = {(i, j) for i, row in enumerate(seen_t["adj"])
             for j, a in enumerate(row) if a and i < j}
    assert edges == {(1, 2), (0, 2)}, seen_t["adj"]
    assert_close_canvas(out_t, out_j)


def test_mixed_shape_resume_stays_incremental(port_run, tmp_path):
    """A resumed mixed-shape run takes the incremental path like the
    original run and returns the same panorama bit for bit, although the
    three feature sets share one capacity and would stack."""
    out, _, _, art = port_run
    feats = artifacts.load_features(f"{art}/features.npz")
    assert len({f.desc.shape for f in feats}) == 1
    run = tmp_path / "run"
    run.mkdir()
    shutil.copy(f"{art}/features.npz", run / "features.npz")
    st = TStitcher(SMALL_DEFAULT, device="cpu", artifact_dir=str(run))
    st.prepare = None
    np.testing.assert_array_equal(out, st.stitch(_mixed(), resume=True))
    assert st._feats_stacked is None
