"""Nothing under benchmark/ imports JAX or the JAX package, and the plain
reference imports nothing of the program: each import's top-level module
name (the part before the first dot) compared whole, since the port's
name begins with the JAX package's."""
from __future__ import annotations

import ast

from harness import registry

FORBIDDEN = {"jax", "jaxlib", "flax", "computervisionimagestich2_tpu"}
PORT = "computervisionimagestich2_tpu_torch"


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(registry.BENCH_DIR.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not top_level_imports(f) & FORBIDDEN, f


def test_the_reference_imports_nothing_of_the_program():
    ref = registry.BENCH_DIR / "stitch_reference"
    allowed = {"__future__", "collections", "dataclasses", "functools",
               "math", "typing", "numpy", "torch"}
    for f in sorted(ref.rglob("*.py")):
        names = top_level_imports(f)
        assert PORT not in names and not names & FORBIDDEN, f
        assert names <= allowed, (f, names - allowed)


def test_the_run_compares_whole_names(monkeypatch):
    """The port's name begins with the JAX package's: the run's check of
    ``sys.modules`` passes the port and catches the JAX package."""
    import sys
    import types

    from run import forbidden_modules
    for name in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, PORT + ".models",
                        types.ModuleType(PORT + ".models"))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "computervisionimagestich2_tpu.ops",
                        types.ModuleType("computervisionimagestich2_tpu.ops"))
    assert forbidden_modules() == ["computervisionimagestich2_tpu"]
