"""The port stands alone: no JAX, no module of the JAX package, and no
silent fallback to the CPU.

The port must run on a GPU machine that has no JAX installed, and may lack
OpenCV, PyYAML, PIL, matplotlib and h5py, so every module of
``event_based_bos_tpu_torch``, ``chip_smoke.py`` and the GPU tools
(``tools/torch_solve_probe.py``, ``tools/stencil_ab.py``) is imported in a
subprocess where ``import jax`` fails, and so do ``import cv2``, ``import
yaml``, ``import PIL``, ``import matplotlib`` and ``import h5py``.  Entry
points called without ``device=`` must raise here (no GPU) rather than run
on the CPU.  The port builds its own native runtime and never loads the JAX
package's.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "event_based_bos_tpu_torch"


def _port_modules():
    mods = []
    for py in sorted(PORT.rglob("*.py")):
        rel = py.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_and_chip_smoke_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['optax'] = None\n"
        "sys.modules['event_based_bos_tpu'] = None\n"
        "for m in ('cv2', 'yaml', 'PIL', 'matplotlib', 'h5py'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        "sys.path.insert(0, 'tools')\n"
        f"for m in {_port_modules()!r} + ['chip_smoke', 'torch_solve_probe',"
        " 'stencil_ab']:"
        "\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' and sys.modules[m]"
        " or m.startswith('jax.') or m.startswith('event_based_bos_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("ok")


def test_no_port_source_names_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu")) + [
        REPO / "chip_smoke.py", REPO / "tools" / "torch_solve_probe.py",
        REPO / "tools" / "stencil_ab.py"]
    offenders = [str(f) for f in files
                 if "event_based_bos_tpu." in f.read_text()
                 or "import jax" in f.read_text()]
    assert not offenders, offenders


def test_runtime_builds_its_own_library_outside_native():
    from event_based_bos_tpu_torch import runtime

    path = runtime.library_path()
    assert path.parent == REPO / "build" / "runtime"
    assert runtime.available()
    assert runtime._lib._name == str(path)
    source = (PORT / "runtime.py").read_text()
    assert "libebt_runtime.so" not in source


def test_entry_points_without_device_raise_on_a_cpu_only_machine():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from event_based_bos_tpu_torch import events_from_ndarray, resolve_device
    from event_based_bos_tpu_torch.convert import state_from_numpy
    from event_based_bos_tpu_torch.solver import (
        CmaxSpec, GenerativeSpec, GmlSpec, PatchSpec, PyramidSpec,
        estimate_frame, estimate_frame_cmax, estimate_frame_dependent,
        estimate_frame_gml, estimate_frame_patch)

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        events_from_ndarray(np.zeros((4, 4)))
    with pytest.raises(RuntimeError):
        state_from_numpy({"init_params": np.zeros((3, 1, 1))})
    spec = PyramidSpec(gen=GenerativeSpec(image_size=(16, 16)),
                       roi=(0, 16, 0, 16), coarsest_patch=8, finest_patch=8,
                       n_iter=2)
    with pytest.raises(RuntimeError):
        estimate_frame(None, np.zeros((16, 16)), np.ones((16, 16)), None,
                       spec, cache=(np.zeros((16, 16)), None,
                                    np.ones((16, 16))))
    ev = events_from_ndarray(np.array([[1.0, 2.0, 0.0, 1.0],
                                       [3.0, 4.0, 1.0, -1.0]]), device="cpu")
    with pytest.raises(RuntimeError):
        estimate_frame_cmax(ev, None, None, CmaxSpec(image_size=(16, 16)))
    gen = GenerativeSpec(image_size=(16, 16))
    frame = np.zeros((16, 16))
    with pytest.raises(RuntimeError):
        estimate_frame_gml(ev, frame, None, GmlSpec(gen=gen,
                                                    roi=(0, 16, 0, 16)))
    for estimator in (estimate_frame_patch, estimate_frame_dependent):
        with pytest.raises(RuntimeError):
            estimator(ev, frame, None, PatchSpec(gen=gen,
                                                 roi=(0, 16, 0, 16)))
    assert resolve_device("cpu").type == "cpu"


def test_remaining_ops_and_data_are_covered_and_need_a_device():
    """The modules of the remaining ops and data (PIV, the voxel grids,
    the statistics, the E2VID and HELIUM loaders) are among those the
    subprocess above imports without JAX, cv2, yaml or h5py, and their
    entry points called without ``device=`` raise here (no GPU)."""
    torch = pytest.importorskip("torch")
    mods = _port_modules()
    for m in ("piv", "ops.voxel", "ops.stats", "data.e2vid", "data.helium"):
        assert f"event_based_bos_tpu_torch.{m}" in mods, m
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from event_based_bos_tpu_torch.frame_flow import FrameFlowEstimator
    from event_based_bos_tpu_torch.ops.events import generate_events
    from event_based_bos_tpu_torch.ops.flow import (
        generate_dense_optical_flow, generate_uniform_optical_flow)
    from event_based_bos_tpu_torch.piv import piv_multipass
    from event_based_bos_tpu_torch.utils.config import PivSettings

    frame = np.zeros((16, 16))
    for call in (
            lambda: piv_multipass(frame, frame, PivSettings(
                windowsizes=(8,), overlap=(4,))),
            lambda: generate_events(torch.Generator(), 8, 4, 4),
            lambda: generate_dense_optical_flow(torch.Generator(), (4, 4)),
            lambda: generate_uniform_optical_flow((4, 4)),
            lambda: FrameFlowEstimator()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_mesh_and_wire_are_covered_and_need_a_device():
    """``parallel/*`` and ``solver/wire.py`` are among the modules the
    subprocess above imports without JAX, and their entry points called
    without ``device=`` raise here (no GPU) before any rank starts."""
    torch = pytest.importorskip("torch")
    mods = _port_modules()
    for m in ("parallel", "parallel.mesh", "parallel.sharding",
              "parallel.sweep", "parallel.launch", "parallel.dryrun",
              "solver.wire"):
        assert f"event_based_bos_tpu_torch.{m}" in mods, m
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from event_based_bos_tpu_torch.parallel import launch, make_mesh
    from event_based_bos_tpu_torch.parallel.dryrun import dryrun_multichip
    from event_based_bos_tpu_torch.types import (decode_wire_events,
                                                 encode_wire_events)

    wire = encode_wire_events(np.array([[1.0, 2.0, 0.0, 1.0]]), 4096)
    for call in (lambda: decode_wire_events(wire),
                 lambda: make_mesh(),
                 lambda: launch.run(print, 2),
                 lambda: dryrun_multichip(4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_chip_smoke_fails_without_a_gpu():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
