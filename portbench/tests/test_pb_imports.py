"""The check for JAX modules compares whole top-level names, and the
benchmark's own modules import neither JAX nor the JAX package."""

import ast
import sys
import types
from pathlib import Path

from portbench.lib import harness

BENCH = Path(__file__).resolve().parents[1]


def test_forbidden_by_whole_top_level_name(monkeypatch):
    for name in ("jax.numpy", "symmetry_tpu.engine", "flax", "jaxlib"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    for name in ("symmetry_tpu_torch.engine", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = harness.forbidden_modules()
    assert {"jax.numpy", "symmetry_tpu.engine", "flax", "jaxlib"} <= set(found)
    assert not {"symmetry_tpu_torch.engine", "jaxtyping",
                "flaxen"} & set(found)


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN), path


def test_reference_side_imports_nothing_of_the_program():
    for name in ("reference.py", "weights.py", "check.py", "work.py",
                 "stats.py", "traffic.py"):
        assert "symmetry_tpu_torch" not in _imports(BENCH / "lib" / name)
