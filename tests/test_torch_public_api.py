"""The port has a counterpart for every public name of the JAX package.

For every module of ``event_based_bos_tpu/`` the test reads (with ``ast``,
importing nothing of JAX) its public top-level functions, classes, class
methods and assignments, and looks each up on the port's module of the same
path, imported: a name the port module defines or imports counts, and a
class method counts where the port's class has it, inherited included (the
facades' ``estimate`` and ``prewarm`` from ``SolverBase``, the loaders'
``load_calib`` from ``DataLoaderBase``).  A module's imports are not its
API, except a package's re-exports: the names an ``__init__.py`` imports
from its own modules.  The exclusions below give their reasons; a name
that drifts out of the port fails here.
"""

import ast
import importlib
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "event_based_bos_tpu"

#: JAX module → the port module that holds its counterparts
MODULE_MAP = {
    "ops/iwe_pallas.py": "ops/iwe_cuda.py",
    "ops/cmax_pallas.py": "ops/cmax_cuda.py",
}

#: JAX name → the port's name where the two differ
NAME_MAP = {
    "ops/iwe_pallas.py": {"bilinear_vote_pallas": "bilinear_vote_cuda",
                          "signed_vote_pallas": "signed_vote_cuda",
                          "polarity_iwe_pallas": "polarity_iwe_cuda"},
}

#: (JAX module, name) → why the port has no counterpart
EXCLUDED = {
    ("utils/misc.py", "enable_persistent_cache_if_beneficial"):
        "JAX's persistent compile cache; the port's CUDA graphs are "
        "captured in the process that replays them and cannot be kept "
        "across processes (its kernels are cached by build/kernels/)",
    ("ops/iwe_pallas.py", "INTERPRET"):
        "Pallas interpret mode; a CUDA kernel has none (a CPU tensor takes "
        "the plain version)",
    ("ops/cmax_pallas.py", "INTERPRET"):
        "Pallas interpret mode; a CUDA kernel has none (a CPU tensor takes "
        "the plain version)",
}

#: names no module exports as API
NOT_API = {"logger", "__all__"}


def _public(name: str) -> bool:
    return not name.startswith("_") and name not in NOT_API


def public_names(path: pathlib.Path) -> list:
    """``name`` or ``Class.method`` for each public definition of a module,
    and for a package the names it re-exports from its own modules."""
    out = []
    for node in ast.parse(path.read_text()).body:
        if (path.name == "__init__.py" and isinstance(node, ast.ImportFrom)
                and node.level > 0):
            out += [a.asname or a.name for a in node.names if a.name != "*"]
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(node.name)
        elif isinstance(node, ast.ClassDef):
            out.append(node.name)
            out += [f"{node.name}.{sub.name}" for sub in node.body
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))]
        elif isinstance(node, ast.Assign):
            out += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif (isinstance(node, ast.AnnAssign)
              and isinstance(node.target, ast.Name)):
            out.append(node.target.id)
    return [n for n in out if all(_public(part) for part in n.split("."))]


def _jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def _port_module(rel: str):
    rel = MODULE_MAP.get(rel, rel)
    parts = list(pathlib.Path(rel).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return importlib.import_module(".".join(["event_based_bos_tpu_torch"]
                                            + parts))


def test_the_walk_sees_the_api():
    """The walk finds definitions, methods and registries, and leaves out
    imports and private names."""
    assert "functional" in public_names(JAX_PKG / "solver" / "__init__.py")
    utils = public_names(JAX_PKG / "utils" / "__init__.py")
    assert {"PivSettings", "profile", "write_video"} <= set(utils)
    grads = public_names(JAX_PKG / "ops" / "gradients.py")
    assert {"sobel_divergence", "strain_variant"} <= set(grads)
    assert "jax" not in grads and "_conv2d_same" not in grads
    api = public_names(JAX_PKG / "solver" / "api.py")
    assert "SolverBase.undistort_image" in api
    assert not [n for n in api if "._" in n]


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_public_name_has_a_port_counterpart(rel):
    module = _port_module(rel)
    names = NAME_MAP.get(rel, {})
    missing = []
    for name in public_names(JAX_PKG / rel):
        if (rel, name) in EXCLUDED:
            continue
        obj = module
        for part in names.get(name, name).split("."):
            obj = getattr(obj, part, None)
            if obj is None:
                missing.append(name)
                break
    assert not missing, f"{rel}: no counterpart in the port for {missing}"


def test_exclusions_name_real_jax_definitions():
    """Each exclusion still names a definition of the JAX package, so the
    list cannot outlive what it excuses."""
    for rel, name in EXCLUDED:
        assert name in public_names(JAX_PKG / rel), (rel, name)
