"""The port stands alone: it imports nothing of the JAX package, and its
own copies of the JAX package's configuration and command-line mapping
equal the originals field for field.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

from computervisionimagestich2_tpu import cli as jcli
from computervisionimagestich2_tpu import config as jconfig
from computervisionimagestich2_tpu_torch import cli, config
from computervisionimagestich2_tpu_torch.config import check_supported
from test_torch_cli import ARGVS

REPO = Path(__file__).resolve().parents[1]
CONFIG_CLASSES = ["SiftConfig", "MatchConfig", "RansacConfig",
                  "ProjectionConfig", "BlendConfig", "EnhanceConfig",
                  "StitchConfig"]

_IMPORTS = """
import sys
import computervisionimagestich2_tpu_torch
import computervisionimagestich2_tpu_torch.cli
import computervisionimagestich2_tpu_torch.models.stitcher
import computervisionimagestich2_tpu_torch.models.streaming
import computervisionimagestich2_tpu_torch.api.compat
from computervisionimagestich2_tpu_torch.parallel import (
    batched_stitch_chain, make_mesh, shard_batch, sharded_blend_two_images,
    sharded_composite, sharded_composite_and_blend, sharded_gaussian_blur)
bad = sorted(m for m in sys.modules
             if m == "computervisionimagestich2_tpu"
             or m.startswith("computervisionimagestich2_tpu.")
             or m.split(".")[0] in ("jax", "jaxlib"))
print("LOADED", bad)
"""


def test_port_imports_nothing_of_the_jax_package():
    """A fresh interpreter imports the port's package, its CLI, both
    stitchers, the compat API, the batched panoramas and the mesh mode
    (``parallel``); no module of the JAX package (nor jax) is loaded."""
    proc = subprocess.run([sys.executable, "-c", _IMPORTS], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


def _default(f: dataclasses.Field):
    if f.default_factory is not dataclasses.MISSING:
        return f.default_factory()
    return f.default


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_dataclass_equals_jax(name):
    """Each config dataclass is the port's own class, with the JAX
    package's field names, types, defaults, docstring and properties."""
    ours, theirs = getattr(config, name), getattr(jconfig, name)
    assert ours is not theirs
    fo, ft = dataclasses.fields(ours), dataclasses.fields(theirs)
    assert [f.name for f in fo] == [f.name for f in ft]
    assert [str(f.type) for f in fo] == [str(f.type) for f in ft]
    for a, b in zip(fo, ft):
        da, db = _default(a), _default(b)
        if dataclasses.is_dataclass(da):
            assert dataclasses.asdict(da) == dataclasses.asdict(db), a.name
        else:
            assert da == db, a.name
    assert ours.__doc__ == theirs.__doc__
    assert ours.__dataclass_params__.frozen
    props = [k for k, v in vars(theirs).items() if isinstance(v, property)]
    assert props == [k for k, v in vars(ours).items()
                     if isinstance(v, property)]
    for k in props:
        assert getattr(ours(), k) == getattr(theirs(), k), k


def test_default_config_equals_jax():
    assert type(config.DEFAULT_CONFIG) is config.StitchConfig
    assert dataclasses.asdict(config.DEFAULT_CONFIG) == \
        dataclasses.asdict(jconfig.DEFAULT_CONFIG)


@pytest.mark.parametrize("argv", list(ARGVS.values()), ids=list(ARGVS))
def test_build_config_is_the_ports_own(argv):
    """The port's ``build_config`` builds the port's classes and equals
    the JAX package's, field for field (``asdict``)."""
    args = cli.make_parser().parse_args(["--input", "in"] + argv)
    cfg = cli.build_config(args)
    assert type(cfg) is config.StitchConfig
    assert type(cfg.blend) is config.BlendConfig
    jcfg = jcli.build_config(jcli.make_parser().parse_args(
        ["--input", "in"] + argv))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_jax_config_works_in_the_port():
    """A ``StitchConfig`` of the JAX package is read by attribute: the
    port's checks accept the JAX default and refuse what it refuses, and
    ``dataclasses.replace`` works on it."""
    jcfg = jconfig.DEFAULT_CONFIG
    check_supported(jcfg)
    chain = dataclasses.replace(jcfg, ordering="chain")
    check_supported(chain)
    check_supported(dataclasses.replace(
        jcfg, match=dataclasses.replace(jcfg.match, method="l2pre")))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        check_supported(dataclasses.replace(
            jcfg, blend=dataclasses.replace(jcfg.blend,
                                            blur_impl="fir_fused")))
