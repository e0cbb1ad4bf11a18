"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program: top-level names, the part before
the first dot, compared whole (the port's name begins with the JAX
package's)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "virnet_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "virnet_tpu_torch" not in top_level_imports(path)


def test_the_scan_sees_what_it_must(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import jax.numpy as jnp\nfrom virnet_tpu.ops import x\n"
                 "import virnet_tpu_torch\nfrom . import y\n")
    got = top_level_imports(p)
    assert got == {"jax", "virnet_tpu", "virnet_tpu_torch"}
    assert got & FORBIDDEN == {"jax", "virnet_tpu"}


def test_run_refuses_jax_in_sys_modules(monkeypatch):
    import sys
    import types

    from portbench.core.main import jax_loaded

    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "virnet_tpu_torch_extra",
                        types.ModuleType("y"))
    assert "flax" in jax_loaded()
    assert "virnet_tpu_torch_extra" not in jax_loaded()
