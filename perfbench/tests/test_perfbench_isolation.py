"""Nothing under ``perfbench/`` imports JAX or the JAX package, and the
references import nothing of this repository's packages either; names
are compared whole on their top-level part (the port's name begins with
the JAX package's)."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "event_based_bos_tpu"}
FORBIDDEN_IN_REFERENCE = FORBIDDEN | {"event_based_bos_tpu_torch"}


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


MODULES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(HERE)) for p in MODULES])
def test_no_forbidden_imports(path):
    names = set(_top_level_imports(path))
    forbidden = (FORBIDDEN_IN_REFERENCE if "reference" in path.parts
                 else FORBIDDEN)
    assert not names & forbidden, (path, names & forbidden)


def test_the_measured_process_check_compares_whole_names(monkeypatch):
    import sys
    import types

    from perfbench import harness

    monkeypatch.setitem(sys.modules, "event_based_bos_tpu_torch_probe",
                        types.ModuleType("x"))
    assert "event_based_bos_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert "jax" in harness.forbidden_modules()
