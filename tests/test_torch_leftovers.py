"""The JAX package's last public names in the port, against the JAX package.

The gradient helpers (``sobel_divergence``, ``strain_variant``) run in
float64 on the same numpy inputs through both packages (within 1e-12); the
cost keys, the ``functional`` registry and ``device_fence`` compare equal;
``undistort_image`` is bit-identical (both call cv2 with the same
arguments); ``timeit``, ``trace``, ``profile`` and ``ensure_built`` are
checked for what they produce on the CPU.
"""

import hashlib
import json
import pathlib
import pstats

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_based_bos_tpu.costs as jcosts
import event_based_bos_tpu.ops.gradients as jgrad
import event_based_bos_tpu.solver as jsolver
import event_based_bos_tpu.solver.facades as jfacades
import event_based_bos_tpu.utils.tracing as jtracing
import event_based_bos_tpu_torch.costs as tcosts
import event_based_bos_tpu_torch.ops.gradients as tgrad
import event_based_bos_tpu_torch.solver as tsolver
import event_based_bos_tpu_torch.solver.facades as tfacades
from event_based_bos_tpu_torch import runtime
from event_based_bos_tpu_torch.utils import misc, tracing
from event_based_bos_tpu_torch.utils.config import propagate_config
from torch_parity import CPU, rel_err, small_config, torch_threads

REPO = pathlib.Path(__file__).resolve().parent.parent
H, W = 37, 53


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _f64(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape)


@pytest.mark.parametrize("shape", [(2, H, W), (3, 2, H, W)])
@pytest.mark.parametrize("ksize", [3, 5])
def test_sobel_divergence_matches_jax(shape, ksize):
    flow = _f64(*shape)
    got = tgrad.sobel_divergence(torch.from_numpy(flow), ksize)
    want = np.asarray(jgrad.sobel_divergence(jnp.asarray(flow), ksize))
    assert got.shape == want.shape == shape[:-3] + (H, W)
    assert rel_err(got.numpy(), want) < 1e-12


@pytest.mark.parametrize("shape", [(H, W), (3, H, W)])
def test_strain_variant_matches_jax(shape):
    u, v = _f64(*shape, seed=1), _f64(*shape, seed=2)
    got = tgrad.strain_variant(torch.from_numpy(u), torch.from_numpy(v))
    want = np.asarray(jgrad.strain_variant(jnp.asarray(u), jnp.asarray(v)))
    assert got.shape == want.shape == shape
    assert rel_err(got.numpy(), want) < 1e-12


def test_new_gradients_are_exported():
    assert {"sobel_divergence", "strain_variant"} <= set(tgrad.__all__)
    assert "required_keys" in tcosts.__all__
    assert {"device_fence", "timeit", "trace"} <= set(tracing.__all__)


@pytest.mark.parametrize("name", sorted(tcosts.functions))
def test_required_keys_match_jax(name):
    assert tcosts.required_keys({name: 1.0}) == jcosts.required_keys(
        {name: 1.0})


def test_required_keys_of_the_pyramid_hybrid_match_jax():
    hybrid = {"diff_norm": 1.0, "image_gradient": 0.5, "flow_norm_pxy": 0.1}
    keys = tcosts.required_keys(hybrid)
    assert keys == jcosts.required_keys(hybrid)
    assert keys == ["prediction", "measurement", "flow", "omit_boundary",
                    "pxy"]
    assert tcosts.required_keys({"unregistered": 1.0}) == []


def test_functional_registry_matches_jax():
    assert list(tsolver.functional) == list(jsolver.functional)
    assert tsolver.functional["patch_eklt_pyramid2"] is tsolver.estimate_frame
    assert tsolver.functional["generative_max_likelihood"] is (
        tsolver.estimate_frame_gml)
    assert tsolver.functional["patch_eklt"] is tsolver.estimate_frame_patch
    assert tsolver.functional["patch_eklt_dependent"] is (
        tsolver.estimate_frame_dependent)


def test_undistort_image_matches_the_jax_facade():
    pytest.importorskip("cv2")
    cfg = small_config("synthetic_plume")
    propagate_config(cfg)
    d = cfg["data"]
    rng = np.random.default_rng(3)
    calib = {"K": np.array([[90.0, 0.0, 47.5], [0.0, 88.0, 31.0],
                            [0.0, 0.0, 1.0]]),
             "D": np.array([-0.21, 0.05, 0.001, -0.002, 0.0])}
    args = ((d["height"], d["width"]), (d["crop_height"], d["crop_width"]))
    kw = dict(calibration_parameter=calib, solver_config=cfg["solver"],
              visualize_module=None)
    tsolv = tfacades.collections[cfg["solver"]["method"]](*args, device=CPU,
                                                           **kw)
    jsolv = jfacades.collections[cfg["solver"]["method"]](*args, **kw)
    for image in (rng.uniform(0, 255, (d["height"], d["width"])),
                  rng.integers(0, 256, (d["height"], d["width"]),
                               dtype=np.uint8)):
        got = tsolv.undistort_image(image)
        want = jsolv.undistort_image(image)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert not np.array_equal(got, image)


def test_device_fence_matches_jax():
    a, b = np.arange(6.0).reshape(2, 3), np.full((4,), 0.5)
    assert tracing.device_fence({}) == 0.0 == jtracing.device_fence({})
    assert tracing.device_fence([[], ()]) == 0.0
    assert tracing.device_fence([None, 3]) == 0.0
    tree = {"b": [torch.from_numpy(b)], "a": (torch.from_numpy(a),)}
    jtree = {"b": [jnp.asarray(b)], "a": (jnp.asarray(a),)}
    assert tracing.device_fence(tree) == jtracing.device_fence(jtree) == 15.0
    assert tracing.device_fence(torch.from_numpy(b)) == 2.0
    # numpy leaves count as JAX's do: anything with a dtype
    for np_tree in ([None, b, a], {"x": a}, np.float32(2.5)):
        assert tracing.device_fence(np_tree) == jtracing.device_fence(
            np_tree)
    assert tracing.device_fence([None, b, a]) == 2.0


def test_timeit_returns_the_jax_keys():
    stats = tracing.timeit(lambda x: x * 2.0, torch.ones(8), repeats=3)
    want = jtracing.timeit(lambda x: x * 2.0, jnp.ones(8), repeats=3)
    assert sorted(stats) == sorted(want)
    assert stats["n"] == 3
    assert stats["min_s"] <= stats["median_s"] <= stats["max_s"]
    assert stats["fence_s"] >= 0.0


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    log_dir = tmp_path / "trace"
    with tracing.trace(str(log_dir)) as got:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert got == str(log_dir)
    (path,) = log_dir.glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_profile_writes_its_prof(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)

    @misc.profile()
    def work(n):
        return sum(range(n))

    out = tmp_path / "named.prof"

    @misc.profile(output_file=str(out), lines_to_print=5, strip_dirs=True)
    def named(n):
        return n + 1

    assert work(100) == 4950 and named(1) == 2
    assert work.__name__ == "work"
    for path in (tmp_path / "work.prof", out):
        assert pstats.Stats(str(path)).total_calls > 0


#: the JAX runtime's build product in ``native/`` (git-ignored): the JAX
#: package's ``runtime.ensure_built`` runs ``make -C native`` to write it,
#: which other test processes may do at any moment
JAX_BUILD_PRODUCT = "libebt_runtime.so"


def _native_digest(root):
    """The names in ``root`` and the bytes of every file there but the JAX
    runtime's build product."""
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        rel = p.relative_to(root)
        if str(rel) == JAX_BUILD_PRODUCT:
            continue
        h.update(str(rel).encode())
        if p.is_file():
            h.update(p.read_bytes())
    return h.hexdigest()


def test_ensure_built_force_rebuilds_outside_native(monkeypatch):
    """A forced build compiles into ``runtime.BUILD_DIR`` and writes nothing
    into ``native/``: the compiler's ``-o`` target lies under the build
    directory, and the names and tracked sources of ``native/`` are
    unchanged."""
    native = REPO / "native"
    before = _native_digest(native)
    real_run = runtime.subprocess.run
    targets = []

    def run(cmd, *args, **kwargs):
        if "-o" in cmd:
            targets.append(pathlib.Path(cmd[cmd.index("-o") + 1]).resolve())
        return real_run(cmd, *args, **kwargs)

    monkeypatch.setattr(runtime.subprocess, "run", run)
    assert runtime.ensure_built(force=True) is True
    assert runtime.library_path().is_file()
    assert runtime.available()
    assert runtime.ensure_built() is True
    build_dir = runtime.BUILD_DIR.resolve()
    assert targets, "the forced build ran no compiler"
    assert all(build_dir in t.parents for t in targets), targets
    assert _native_digest(native) == before


def test_ensure_built_force_retries_after_a_failure(monkeypatch):
    """A failed build latches the plain versions; ``force`` retries."""
    monkeypatch.setattr(runtime, "_failed", False)
    monkeypatch.setattr(runtime, "_lib", None)
    real = runtime._build

    def broken(force=False):
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(runtime, "_build", broken)
    assert runtime.ensure_built() is False
    assert runtime._failed and not runtime.available()
    assert runtime.ensure_built() is False  # latched: no second try
    monkeypatch.setattr(runtime, "_build", real)
    assert runtime.ensure_built() is False
    assert runtime.ensure_built(force=True) is True
    assert runtime.available()
