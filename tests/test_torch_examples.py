"""The port's examples (``examples/torch_0*.py``) keep working.

01 and 04 run on the CPU (``--device cpu``), as ``test_examples.py`` runs
the JAX package's 01 and 04; 01's three contrasts are held to the JAX
example's, computed here on the same events, within 1e-4 relative
(float32), with the gradient's sign.  02, 03 and 05 are too slow for the
suite and are compiled only.
"""

import os
import runpy
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import event_based_bos_tpu_torch.costs as tcosts
from event_based_bos_tpu import events_from_ndarray
from event_based_bos_tpu.ops import create_iwe, warp_event
from torch_parity import torch_threads

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _jax_example_01_contrasts():
    """JAX's example 01 (``examples/01_library_quickstart.py``) on its own
    events, at each of its candidate flows, and its gradient at 0."""
    h, w, n = 120, 160, 30_000
    rng = np.random.default_rng(0)
    true_flow = np.array([2.0, -1.0])
    t = np.sort(rng.uniform(0.0, 1.0, n))
    x = rng.uniform(10, h - 10, n) + true_flow[0] * t
    y = rng.uniform(10, w - 10, n) + true_flow[1] * t
    p = rng.integers(0, 2, n) * 2 - 1
    ev = events_from_ndarray(np.stack([x, y, t, p], 1), capacity=1 << 15)

    def contrast_at(flow_2):
        dense = jnp.broadcast_to(flow_2[:, None, None], (2, h, w))
        warped = warp_event(ev, dense, "dense-flow", direction="first")
        return jnp.var(create_iwe(warped, (h, w), sigma=1))

    contrasts = {c: float(contrast_at(jnp.asarray(c, jnp.float32)))
                 for c in [(0.0, 0.0), (2.0, -1.0), (-2.0, 1.0)]}
    grad = np.asarray(jax.grad(contrast_at)(jnp.zeros(2, jnp.float32)))
    return contrasts, grad


def test_library_quickstart_runs_and_matches_jax(capsys):
    got = runpy.run_path(os.path.join(EXAMPLES,
                                      "torch_01_library_quickstart.py"),
                         run_name="example")["main"](["--device", "cpu"])
    out = capsys.readouterr().out
    assert "contrast" in out and "grad" in out
    want, want_grad = _jax_example_01_contrasts()
    assert list(got["contrast"]) == list(want)
    for c, value in want.items():
        assert abs(got["contrast"][c] - value) <= 1e-4 * abs(value), c
        assert f"flow {c}: contrast {got['contrast'][c]:.6f}" in out
    # the true motion (2, −1) is the sharpest candidate in both
    assert max(got["contrast"], key=got["contrast"].get) == (2.0, -1.0)
    assert np.array_equal(np.sign(got["grad"]), np.sign(want_grad))
    assert np.array_equal(np.sign(got["grad"]), [1.0, -1.0])


def test_custom_cost_runs(capsys, monkeypatch):
    """04 as a script (``__main__``), its registry entry undone after."""
    monkeypatch.setattr(tcosts, "functions", dict(tcosts.functions))
    monkeypatch.setattr(sys, "argv", ["torch_04_custom_cost.py", "--device",
                                      "cpu"])
    runpy.run_path(os.path.join(EXAMPLES, "torch_04_custom_cost.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "divergence" in out and "flow finite: True" in out
    for name in ("diff_norm", "image_gradient", "flow_norm_pxy"):
        assert name in out


@pytest.mark.parametrize("name", ["torch_02_solve_synthetic_frame.py",
                                  "torch_03_multichip_batch.py",
                                  "torch_05_serving_and_sweeps.py"])
def test_slow_examples_compile(name):
    """Syntax sanity for the examples too slow for the suite."""
    rc = subprocess.run([sys.executable, "-m", "py_compile",
                         os.path.join(EXAMPLES, name)])
    assert rc.returncode == 0
