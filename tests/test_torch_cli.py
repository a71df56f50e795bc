"""The port's command line (``panorama-torch``) and its reference-shaped
API (``api/compat.py``) on the CPU: the flags map onto the same
``StitchConfig`` as the JAX package's ``panorama-tpu``, a whole run on
small BMPs loads no jax, ``--sp`` is refused where the JAX CLI refuses it
and otherwise stitches on a mesh, and the compat functions agree with the
JAX package's.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu import cli as jcli
from computervisionimagestich2_tpu.api import compat as jcompat
from computervisionimagestich2_tpu_torch import cli
from computervisionimagestich2_tpu_torch.api import compat
from computervisionimagestich2_tpu_torch.models.stitcher import (
    Stitcher as TStitcher)
from computervisionimagestich2_tpu_torch.utils import load_image, save_image
from test_integration import make_scene
from test_torch_graph_stitch import SMALL_DEFAULT
from test_torch_incremental import _one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _write_crops(d: Path, n: int = 3) -> Path:
    """1.bmp..n.bmp: overlapping 140x140 crops of one scene, left to
    right."""
    scene = make_scene(np.random.default_rng(0), h=140, w=320)
    d.mkdir(exist_ok=True)
    for i in range(n):
        save_image(str(d / f"{i + 1}.bmp"), scene[:, i * 90:i * 90 + 140])
    return d


# flag sets whose StitchConfig the two command lines must agree on
ARGVS = {
    "default": [],
    "chain": ["--ordering", "chain"],
    "exact_no_enhance": ["--exact-canvas", "--no-enhance"],
    "transfer": ["--color-transfer", "--bucketed-canvas"],
    "gain_band": ["--gain-compensation", "--gain-mode", "rgb",
                  "--seam-band", "8"],
    "blend": ["--blend-dtype", "f32", "--no-seam-auto"],
    "match_warp": ["--match-method", "exact", "--warp-model", "projective"],
}


@pytest.mark.parametrize("argv", list(ARGVS.values()), ids=list(ARGVS))
def test_build_config_matches_jax(argv):
    """The port's parser and the JAX package's turn the same flags into
    the same StitchConfig; the port's default device is cuda."""
    base = ["--input", "in"]
    args_t = cli.make_parser().parse_args(base + argv)
    args_j = jcli.make_parser().parse_args(base + argv)
    assert dataclasses.asdict(cli.build_config(args_t)) == \
        dataclasses.asdict(jcli.build_config(args_j))
    assert args_t.device == "cuda"
    assert vars(args_j).items() <= vars(args_t).items()


# options whose help differs from the JAX CLI's on purpose: the JAX text
# names TPU mechanisms or measurements, or the port's option does more
HELP_OWN = {
    "timing": "also prints the kernel launches and the frames' uploads",
    "blend_dtype": "the JAX text quotes a TPU measurement",
    "no_seam_auto": "the same words, one in lower case",
    "seam_band": "the JAX text gives the TPU cost model",
    "match_method": "'auto' means exact off a TPU",
    "l2pre_m": "the JAX text gives TPU defaults",
    "exact_canvas": "the JAX text counts TPU compiles",
    "sp": "a mesh of --device, not a jax.sharding Mesh",
    "resume": "the JAX text cites its survey",
}
_JAX_HELP = {a.dest: a.help for a in jcli.make_parser()._actions}


@pytest.mark.parametrize("dest", sorted(_JAX_HELP))
def test_help_text_matches_jax(dest):
    """Every option of the JAX CLI has the port's counterpart, with the
    JAX package's help text unless ``HELP_OWN`` says why not; no help text
    says a mode is not ported (all of them are)."""
    ours = {a.dest: a.help for a in cli.make_parser()._actions}
    assert "not ported" not in (ours[dest] or ""), ours[dest]
    if dest not in HELP_OWN:
        assert ours[dest] == _JAX_HELP[dest]


_CLI_NO_JAX = textwrap.dedent("""
    import sys
    from computervisionimagestich2_tpu_torch.cli import main
    main(sys.argv[1:])
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib"))
    assert not loaded, loaded
    print("NO_JAX_OK")
""")


def test_cli_runs_on_cpu_without_jax(tmp_path):
    """A whole CLI run on small BMPs (bucketed canvases, the default; chain
    ordering, as the reference's stitchability threshold of 20 matches
    is calibrated for photographs) in a fresh interpreter that loads no
    jax; the written panorama is the port's Stitcher output for the same
    config, bit for bit, wider than one input."""
    d = _write_crops(tmp_path / "in")
    out = tmp_path / "pano.bmp"
    argv = ["--input", str(d), "--output", str(out), "--timing",
            "--ordering", "chain", "--device", "cpu"]
    proc = subprocess.run(
        [sys.executable, "-c", _CLI_NO_JAX] + argv, cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    for line in ("features:", "stitching:", "enhance:",
                 "total time:", "kernel launches:", "uploads:", "wrote "):
        assert line in proc.stdout, proc.stdout
    pano = load_image(str(out))
    cfg = cli.build_config(cli.make_parser().parse_args(argv))
    assert not cfg.exact_canvas
    ref = TStitcher(cfg, device="cpu").stitch(
        [load_image(str(d / f"{i}.bmp")) for i in (1, 2, 3)])
    np.testing.assert_array_equal(pano, ref)
    assert pano.shape[1] > 200, pano.shape


def _cli_error(capsys, argv) -> str:
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 2
    return capsys.readouterr().err


def test_resume_without_artifacts_is_refused(tmp_path, capsys):
    err = _cli_error(capsys, ["--input", str(tmp_path), "--resume"])
    assert "--resume requires --artifacts" in err


@pytest.mark.parametrize("argv,item", [
    (["--sp", "2"], "--sp 2 needs 2 devices, have 1"),
    (["--sp", "2", "--exact-canvas"], "--sp requires --bucketed-canvas"),
], ids=["sp", "sp_exact_canvas"])
def test_outside_the_port_is_refused(tmp_path, capsys, argv, item):
    """--sp follows the JAX CLI's rules: more devices than --device has
    (the CPU counts as one) and --exact-canvas are usage errors."""
    d = _write_crops(tmp_path / "in", 2)
    err = _cli_error(capsys, ["--input", str(d), "--device", "cpu"] + argv)
    assert item in err, err


def test_sp_one_writes_a_panorama(tmp_path):
    """--sp 1 --device cpu stitches through the mesh path (one stripe):
    the panorama equals the run without --sp within the mesh Stitcher's
    tolerance (tests/test_parallel.py:310-313)."""
    d = _write_crops(tmp_path / "in", 3)
    base = ["--input", str(d), "--ordering", "chain", "--device", "cpu"]
    cli.main(base + ["--output", str(tmp_path / "sp.bmp"), "--sp", "1"])
    cli.main(base + ["--output", str(tmp_path / "one.bmp")])
    meshed = load_image(str(tmp_path / "sp.bmp")).astype(np.int32)
    single = load_image(str(tmp_path / "one.bmp")).astype(np.int32)
    assert meshed.shape == single.shape and meshed.shape[1] > 300
    diff = np.abs(meshed - single)
    assert (diff > 1).mean() < 1e-3 and diff.max() <= 16, diff.max()


def test_projective_writes_a_panorama(tmp_path):
    """--warp-model projective runs: the CLI writes the port's Stitcher
    output for the same flags, bit for bit, wider than one input."""
    scene = make_scene(np.random.default_rng(0), h=160, w=320)
    d = tmp_path / "in"
    d.mkdir()
    for i, x0 in enumerate((0, 80)):
        save_image(str(d / f"{i + 1}.bmp"), scene[:, x0:x0 + 160])
    out = tmp_path / "pano.bmp"
    argv = ["--input", str(d), "--output", str(out), "--ordering", "chain",
            "--warp-model", "projective", "--device", "cpu"]
    cli.main(argv)
    cfg = cli.build_config(cli.make_parser().parse_args(argv))
    assert cfg.warp_model == "projective"
    pano = load_image(str(out))
    ref = TStitcher(cfg, device="cpu").stitch(
        [load_image(str(d / f"{i}.bmp")) for i in (1, 2)])
    np.testing.assert_array_equal(pano, ref)
    assert pano.shape[1] > 200, pano.shape


@pytest.mark.parametrize("extra", [[], ["--l2pre-m", "16"]],
                         ids=["config_m", "m16"])
def test_l2pre_writes_a_panorama(tmp_path, extra):
    """--match-method l2pre runs: the CLI writes the port's Stitcher
    output for the same flags, bit for bit, across all three crops."""
    d = _write_crops(tmp_path / "in", 3)
    out = tmp_path / "pano.bmp"
    argv = ["--input", str(d), "--output", str(out), "--ordering", "chain",
            "--match-method", "l2pre", "--device", "cpu"] + extra
    cli.main(argv)
    cfg = cli.build_config(cli.make_parser().parse_args(argv))
    assert cfg.match.method == "l2pre"
    assert cfg.match.l2pre_m == (16 if extra else 12)
    pano = load_image(str(out))
    ref = TStitcher(cfg, device="cpu").stitch(
        [load_image(str(d / f"{i}.bmp")) for i in (1, 2, 3)])
    np.testing.assert_array_equal(pano, ref)
    assert pano.shape[1] > 300, pano.shape


def test_cuda_without_gpu_is_refused(tmp_path, capsys):
    """The default --device cuda on a host with no GPU is a usage error;
    nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    d = _write_crops(tmp_path / "in", 2)
    err = _cli_error(capsys, ["--input", str(d),
                              "--output", str(tmp_path / "o.bmp")])
    assert "cuda" in err and not (tmp_path / "o.bmp").exists()


def _image(seed=0, h=48, w=64):
    return make_scene(np.random.default_rng(seed), h=h, w=w)


def test_projection_matches_jax():
    """imageProjection within one u8 level of the JAX package's on under
    5% of the values (its CPU projection samples through another formula;
    the port's projection is held bit for bit against the JAX gather form
    in tests/test_torch_ops.py); bilinearInterpolation agrees exactly at
    interior, fractional and edge points."""
    img = _image()
    with jax.disable_jit():
        ref = jcompat.Projection.imageProjection(img, 15.0)
        pts = [(3.25, 7.5, 0), (10.0, 20.0, 1), (62.9, 47.1, 2),
               (0.5, 0.5, 1)]
        ref_pts = [jcompat.Projection.bilinearInterpolation(img, x, y, c)
                   for x, y, c in pts]
    out = compat.Projection.imageProjection(img, 15.0, device="cpu")
    assert out.dtype == np.uint8 and out.shape == img.shape
    diff = np.abs(out.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.05, (diff > 0).mean()
    assert [compat.Projection.bilinearInterpolation(img, x, y, c,
                                                    device="cpu")
            for x, y, c in pts] == ref_pts


def test_equalization_and_transfer_match_jax():
    """Against the JAX package's functions run unjitted (jitted XLA:CPU
    contracts multiply-adds, see tests/test_torch_ops.py): equalization
    mode 1 bit for bit, mode 0 returns its input, other modes raise;
    transfer (Reinhard, images of different sizes) within one u8 level on
    under 1% of the values."""
    src, tpl = _image(0), _image(1, 40, 72)
    with jax.disable_jit():
        eq_ref = jcompat.equalization(src, 1)
        tr_ref = jcompat.transfer(src, tpl)
    np.testing.assert_array_equal(compat.equalization(src, 1, device="cpu"),
                                  eq_ref)
    tr = compat.transfer(src, tpl, device="cpu")
    assert tr.dtype == np.uint8 and tr.shape == src.shape
    diff = np.abs(tr.astype(int) - tr_ref.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (diff > 0).mean()
    np.testing.assert_array_equal(compat.equalization(src, 0, device="cpu"),
                                  src)
    with pytest.raises(ValueError, match="mode"):
        compat.equalization(src, 2, device="cpu")


def test_color_transfer_matches_jax_in_float():
    """models.transfer.color_transfer against the JAX function on float32
    images: within 1e-3 of 255."""
    from computervisionimagestich2_tpu.models import transfer as jtransfer
    from computervisionimagestich2_tpu_torch.models import transfer

    src, tpl = _image(2).astype(np.float32), _image(3).astype(np.float32)
    ref = np.asarray(jtransfer.color_transfer(jnp.asarray(src),
                                              jnp.asarray(tpl)))
    out = transfer.color_transfer(torch.as_tensor(src), torch.as_tensor(tpl))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3 * 255, rtol=0)


def test_image_process_runs_the_pipeline(tmp_path):
    """ImageProcess(dir, n): construction stitches 1.bmp..n.bmp; the result
    is the Stitcher's panorama and save() writes it."""
    d = _write_crops(tmp_path / "in", 2)
    cfg = dataclasses.replace(SMALL_DEFAULT, ordering="chain")
    ip = compat.ImageProcess(str(d), 2, cfg, device="cpu")
    ref = TStitcher(cfg, device="cpu").stitch(
        [load_image(str(d / f"{i}.bmp")) for i in (1, 2)])
    np.testing.assert_array_equal(ip.result, ref)
    ip.save(str(tmp_path / "result.bmp"))
    np.testing.assert_array_equal(load_image(str(tmp_path / "result.bmp")),
                                  ref)
    assert set(ip.stage_times) >= {"features", "stitching"}
