"""The ``patch_eklt`` cell and ``hot_plate1.pipe2``: their files resolve by
name; at a tiny size on the CPU a sound run of the independent patch solve
is correct and a run with its answer negated or doubled, its active mask
dropped, the last iterate in place of the best, a third of its patch flow
zeroed or its objective in bfloat16 is not; on the card
(``python -m pytest perfbench/tests -q -m card``) the same controls, with
TF32, at the cell's own size."""

import copy

import numpy as np
import pytest

from perfbench import harness

CELLS = ("patch_eklt.sync", "hot_plate1.pipe2")
#: the tiny patch cell: a 48×64 frame, ROI rows 0–48 × cols 16–48, 4/2 px
#: patches, 3,000 events a window; limits of its own
SIZE, ROI = (48, 64), (0, 48, 16, 48)
TINY_LIMITS = {"loss_gap": 1e-5, "flow_gap": 1e-5, "fit_gap": 1e-5,
               "fit_share": 0.01}


def tiny_cell(n_iter=20):
    """``(config, traffic)`` of the tiny ``patch_eklt.sync``, ``n_iter``
    Adam steps a solve."""
    _b, _c, config, traffic = harness.cell_spec("patch_eklt.sync")
    c, t = copy.deepcopy(config), copy.deepcopy(traffic)
    c["image_size"] = list(SIZE)
    s = c["solver"]
    x0, x1, y0, y1 = ROI
    s["filter"]["parameters"].update(xmin=x0, xmax=x1, ymin=y0, ymax=y1)
    s["crop_height"], s["crop_width"] = x1 - x0, y1 - y0
    s["optimizer"]["n_iter"] = n_iter
    c["correct"] = {"steps": 5, "limits": dict(TINY_LIMITS)}
    t["events_per_window"] = 3000
    t["scene_params"]["plume_speed"] = 300.0
    return c, t


def tiny_run(seed=7, overrides=None):
    c, t = tiny_cell()
    c["solver"].update(overrides or {})
    bench = harness.benchmark()
    return harness.run_cell("patch_eklt.sync", c, t, seed, 0.5, False, "cpu",
                            harness.cell_metrics(bench, "patch_eklt.sync",
                                                 False),
                            harness.clock(), log=lambda _m: None)


def _negated(monkeypatch):
    from event_based_bos_tpu_torch.solver import api

    original = api.EstimationHandle.result
    monkeypatch.setattr(api.EstimationHandle, "result",
                        lambda self: -original(self))


def _mask_dropped(monkeypatch):
    import torch

    from event_based_bos_tpu_torch.solver import patch

    monkeypatch.setattr(patch, "active_patch_mask", lambda ev, spec: torch.ones(
        spec.grid.shape, dtype=spec.gen.dtype, device=ev.x.device))


def _doubled(monkeypatch):
    from event_based_bos_tpu_torch.solver import api

    original = api.EstimationHandle.result
    monkeypatch.setattr(api.EstimationHandle, "result",
                        lambda self: 2.0 * original(self))


def _last_iterate(monkeypatch):
    from event_based_bos_tpu_torch import optim
    from event_based_bos_tpu_torch.solver import patch

    monkeypatch.setattr(patch, "FirstOrderLoop", lambda *a, **kw: (
        optim.FirstOrderLoop(*a, **dict(kw, track_best=False))))


def _third_zeroed(monkeypatch):
    from event_based_bos_tpu_torch.solver import patch

    original = patch.solve_patches_independent

    def solve(*args, **kwargs):
        patched, aux = original(*args, **kwargs)
        flat = patched.reshape(2, -1).clone()
        flat[:, ::3] = 0.0
        return flat.reshape(patched.shape), aux

    monkeypatch.setattr(patch, "solve_patches_independent", solve)


def bfloat16_objective(monkeypatch):
    """The independent objective in bfloat16, the precision below the
    configuration's: the patch windows cast once, each patch's parameters
    cast in and its loss cast back out (the solver itself reads no
    ``compute_dtype``)."""
    import torch

    from event_based_bos_tpu_torch.solver import patch

    cut, objective = patch._patch_constants, patch._patch_objective

    def constants(*args, **kwargs):
        return {k: None if v is None else v.to(torch.bfloat16)
                for k, v in cut(*args, **kwargs).items()}

    def one(theta, *args, **kwargs):
        return objective(theta.to(torch.bfloat16), *args,
                         **kwargs).to(theta.dtype)

    monkeypatch.setattr(patch, "_patch_constants", constants)
    monkeypatch.setattr(patch, "_patch_objective", one)


FAULTS = {"negated": _negated, "doubled": _doubled,
          "mask_dropped": _mask_dropped, "last_iterate": _last_iterate,
          "third_zeroed": _third_zeroed}


@pytest.mark.parametrize("cell", CELLS)
def test_new_cells_resolve_their_files(cell):
    bench, spec, config, traffic = harness.cell_spec(cell)
    assert spec["chips"] == 1
    assert (harness.HERE / "traffic" / f"{spec['traffic']}.json").exists()
    ref = harness.reference_module(config)
    for name in ("FLOW_SIGN", "trajectories", "schedule_faults",
                 "assembly_faults"):
        assert hasattr(ref, name), name
    assert harness.scenes.load(traffic["scene"]).make_windows
    for m in harness.cell_metrics(bench, cell, True):
        assert callable(harness.metric_reader(m["name"]).read)


def test_pipe2_is_the_sync_traffic_with_two_in_flight():
    sync = harness.load_json(harness.HERE / "traffic" / "plume_sync.json")
    pipe2 = harness.load_json(harness.HERE / "traffic" / "plume_pipe2.json")
    assert pipe2 == dict(sync, in_flight=2, trace_frames=2)


def test_patch_configuration_is_hot_plate1_with_the_method_switched():
    hot = harness.load_json(harness.HERE / "configs" / "hot_plate1.json")
    patch = harness.load_json(harness.HERE / "configs" / "patch_eklt.json")
    # the source names the solver that defines the deployment; every
    # number of its solver dict is hot_plate1's
    assert patch["source"] != hot["source"] and patch["reduced"] == []
    assert patch["source"].endswith("/src/solver/patch_eklt.py")
    assert patch["solver"] == dict(hot["solver"], method="patch_eklt")


class _FakeRun:
    """A traced run of 3 solves (the last traced), 600 steps busy 3 s."""

    def __init__(self):
        from perfbench import devtrace

        self.trace = devtrace.Trace([devtrace.Activity("k", 0.0, 3.0)], [],
                                    (0.0, 4.0), steps=600)
        self.traced = [harness.Frame(2, 0, 0.0, 0.0, 0.0, None, [])]
        self.config = harness.load_json(harness.HERE / "configs"
                                        / "patch_eklt.json")
        self.kind = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("counted,share", [
    ({"patch.fits": 3 * 229401, "patch.active": 3 * 115239}, 115239 / 229401),
    ({}, None), ({"patch.fits": 10}, None)])
def test_the_patch_readers_read_the_counters(monkeypatch, counted, share):
    from event_based_bos_tpu_torch.utils import tracing
    from perfbench.metrics import patch_active_share, patch_step_roofline

    monkeypatch.setattr(tracing, "counters", lambda: dict(counted))
    run = _FakeRun()
    assert patch_active_share.read(run) == share
    got = patch_step_roofline.read(run)
    if share is None:
        assert got is None
    else:
        # 115,239 patches a solve: 384 B each at 3.35 TB/s against 5 ms
        want = 100.0 * 115239 * 384 / 3.35e12 / 5e-3
        assert got == pytest.approx(want)


def test_sound_tiny_run_is_correct():
    result = tiny_run()
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result["checks"]) == ["loss_gap", "flow_gap", "fit_gap",
                                      "fit_share", "schedule_faults",
                                      "assembly_faults"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_tiny_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = tiny_run()
    assert not result["correct"], (fault, result["checks"])


def test_tiny_bfloat16_objective_is_not_correct(monkeypatch):
    bfloat16_objective(monkeypatch)
    result = tiny_run()
    checks = result["checks"]
    assert checks["loss_gap"]["value"] > checks["loss_gap"]["limit"], checks


# ---------------------------------------------------------------------------
# on the card, at the cell's size
# ---------------------------------------------------------------------------

SEEDS = (2147483711, 2147483712)


def _card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda:0")


def _over(reading, limits):
    got = {k: max(reading["gap_by_step"]) if k == "loss_gap" else reading[k]
           for k in limits}
    return {k: v for k, v in got.items() if v > limits[k]}


@pytest.mark.card
@pytest.mark.parametrize("mode", ["program", "tf32", "bf16"])
def test_card_precision_controls_are_not_correct(mode, monkeypatch):
    dev = _card()
    from perfbench import calibrate

    _b, _c, config, traffic = harness.cell_spec("patch_eklt.sync")
    limits = config["correct"]["limits"]
    if mode == "bf16":
        bfloat16_objective(monkeypatch)
    r = calibrate.readings("patch_eklt.sync", config, traffic, SEEDS[0],
                           "program" if mode == "bf16" else mode, 2,
                           config["correct"]["steps"], dev, lambda _m: None)
    assert r["schedule_faults"] == 0 and r["assembly_faults"] == 0
    assert bool(_over(r, limits)) == (mode != "program"), (mode, r)


@pytest.mark.card
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_card_faults_are_not_correct(fault, monkeypatch):
    dev = _card()
    _b, _c, config, traffic = harness.cell_spec("patch_eklt.sync")
    FAULTS[fault](monkeypatch)
    windows, facade, _up, k, _cap = harness.prepare(
        config, traffic, SEEDS[0], dev, log=lambda _m: None)
    frames = harness.closed_loop(facade, windows, k, 1, count=2)
    harness.to_host(frames)
    run = harness.Run("patch_eklt.sync", config, traffic, SEEDS[0], "", 0.0,
                      0.0, 0.0, 1.0, frames, [], {})
    ref = harness.reference_module(config)
    run.epe = [harness.epe(f.flow, windows[f.window].true_flow,
                           ref.FLOW_SIGN, harness.roi_of(config))
               for f in frames]
    checks = harness.compare(run, windows, config, dev, lambda _m: None)
    assert not all(v <= lim for v, lim in checks.values()), checks
    assert np.all([np.isfinite(f.flow).all() for f in frames])
