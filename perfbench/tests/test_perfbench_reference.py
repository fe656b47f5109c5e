"""The references against the port on the CPU, at the tiny size: the
same losses step by step (the pyramid in float64 to round-off; CMax's
stencil computes in float32 on every route, so to float32's)."""

import copy

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny


@pytest.mark.parametrize("cell,precision,tol", [
    ("hot_plate1.sync", "64", 1e-12),
    ("hot_plate1.sync", "32", 1e-6),
    ("cmax_dense.sync", "64", 1e-6),
])
def test_reference_follows_the_program(cell, precision, tol):
    config, traffic = tiny.cell(cell)
    config = copy.deepcopy(config)
    config["solver"]["precision"] = precision
    dev = torch.device("cpu")
    windows, facade, _up, k, _cap = harness.prepare(
        config, traffic, 5, dev, log=lambda _m: None)
    frames = harness.closed_loop(facade, windows, k, 1, count=3)
    for f in frames:
        f.losses = [h.numpy() for h in f.losses]
    ref = harness.reference_module(config)
    steps = len(frames[0].losses[0])
    traj = ref.trajectories(windows, [(f.index, f.window) for f in frames],
                            config, 5, steps, dev)
    gaps = harness.loss_gaps(frames, traj, steps)
    assert np.all(gaps <= tol), gaps


def test_pyramid_starts_are_the_facades_draws():
    from perfbench.reference import pyramid

    config, _t = tiny.cell("hot_plate1.sync")
    facade = harness.build_facade(config, 123, torch.device("cpu"))
    from event_based_bos_tpu_torch.solver.generative import initialize_params
    from event_based_bos_tpu_torch.solver.pyramid import pyramid_grids

    shape = pyramid_grids(facade.spec)[0].shape
    drawn = [initialize_params(facade._generator, shape, facade.gen, "cpu")
             for _ in range(3)]
    starts = pyramid.starts(config, 123, 3, "cpu")
    for a, b in zip(drawn, starts):
        assert torch.equal(a, b)


def test_steps_after_a_near_tie_are_not_compared(monkeypatch):
    from perfbench.reference import pyramid

    config, traffic = tiny.cell("hot_plate1.sync")
    windows = harness.scenes.load(traffic["scene"]).make_windows(
        tuple(config["image_size"]), 1, 2000, traffic["scene_params"], 3)
    monkeypatch.setattr(pyramid, "TIE_MARGIN", 1.0)  # every step a tie
    traj = pyramid.trajectories(windows, [(0, 0)], config, 3, 4, "cpu")[0]
    assert np.isfinite(traj[0]) and np.all(np.isnan(traj[1:]))
    frames = [harness.Frame(0, 0, 0.0, 0.0, 0.0, None,
                            [np.r_[traj[0] * (1 + 1e-9), 5.0, 6.0, 7.0]])]
    gaps = harness.loss_gaps(frames, {0: traj}, 4)
    assert gaps[0] == pytest.approx(1e-9) and np.all(gaps[1:] == 0)


@pytest.mark.parametrize("cell,tol", [("hot_plate1.sync", 1e-12),
                                      ("cmax_dense.sync", 1e-6)])
def test_field_checks_follow_the_program(cell, tol):
    """In float64 the finer scales from the program's own starts, the
    objective at its best fields and the flow they give agree with the
    program to round-off (CMax's stencil: float32's; the flow: float32's,
    since the facade hands it to the host in float32)."""
    config, traffic = tiny.cell(cell)
    config = copy.deepcopy(config)
    config["solver"]["precision"] = "64"
    dev = torch.device("cpu")
    windows, facade, _up, k, _cap = harness.prepare(
        config, traffic, 6, dev, log=lambda _m: None)
    frames = harness.closed_loop(facade, windows, k, 1, count=3)
    harness.to_host(frames)
    assert all(f.fields is not None for f in frames)
    checks = harness.reference_module(config).field_checks(
        frames, windows, config, 6, dev)
    assert checks["flow_gap"] <= 1e-6, checks
    assert checks and all(v <= tol for k, v in checks.items()
                          if k != "flow_gap"), checks
