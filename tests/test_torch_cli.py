"""The port's CLI (``cli.main``) against the JAX package's.

Both CLIs run a copy of ``configs/synthetic_plume.yaml`` cut to a small
scene (64×96, float64, a few Adam steps per scale, three frames,
``visualize: false`` unless a case says otherwise), written to
``tmp_path``; the port runs with ``device="cpu"``.  Every cold frame of
both starts from one numpy init (the ``estimate_frame`` name in each
package's ``solver.facades`` is wrapped; no file of the JAX package
changes).

Tolerances: the error texts hold the same frames and keys, with values
within 1e-6 relative; ``pred_flow{i}.npy`` within 1e-6 px with the same
signs.  The visualizing loop and the run modes write the same artifact
names (mp4s only where cv2 has a codec); a PNG's decoded pixels differ on
at most 0.1 % of its pixels (the render bundle's hue plane), a Poisson
view's by at most 1 LSB.  The JAX CLI's visualizing loop runs pipelined
there: in its synchronous loop a frame's loss plot is drawn before the
frame index is pinned, under the previous frame's name.  The port's
pipelined loop equals its synchronous loop bit for bit.
"""

import ast
import logging
import pathlib

import numpy as np
import pytest
import torch
import yaml

import cv2
import event_based_bos_tpu.cli as jcli
import event_based_bos_tpu.solver.facades as jfacades
import event_based_bos_tpu_torch.cli as tcli
import event_based_bos_tpu_torch.solver.facades as tfacades
from event_based_bos_tpu_torch.utils import read_flow_error_text
from torch_parity import (inject_init, jax_piv_multipass64, pyramid_init,
                          small_config, torch_threads)

TEXTS = ("flow_error_per_frame_without_mask.txt",
         "flow_error_per_frame_with_mask.txt", "timestamps_per_frame.txt")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True)
def restore_logging():
    """``save_config`` replaces the root logger's handlers; put them
    back."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    for h in root.handlers:
        if h not in handlers:
            h.close()
    root.handlers[:] = handlers
    root.setLevel(level)


def _write(tmp_path, tag, cfg):
    cfg = dict(cfg, output_dir=str(tmp_path / f"out_{tag}"))
    path = tmp_path / f"config_{tag}.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return ["--config_file", str(path), "--eval"], pathlib.Path(
        cfg["output_dir"])


def _run_port(tmp_path, tag, cfg, argv_eval=True):
    argv, out = _write(tmp_path, tag, cfg)
    assert tcli.main(argv if argv_eval else argv[:-1], device="cpu") == 0
    return out


def _run_jax(tmp_path, cfg, argv_eval=True):
    argv, out = _write(tmp_path, "jax", cfg)
    assert jcli.main(argv if argv_eval else argv[:-1]) == 0
    return out


def _has_codec(tmp_path):
    w = cv2.VideoWriter(str(tmp_path / "probe.mp4"),
                        cv2.VideoWriter_fourcc(*"mp4v"), 20.0, (16, 16))
    ok = w.isOpened()
    w.release()
    return ok


def _assert_artifacts_close(tmp_path, got_dir, want_dir):
    """The same artifact names (the copied configs and, without a codec,
    the mp4s aside); PNG pixels within the bundle tolerances; mp4s of the
    same frame count and size."""
    skip = (".yaml",) if _has_codec(tmp_path) else (".yaml", ".mp4")

    def names(d):
        return sorted(p.name for p in d.iterdir()
                      if not p.name.endswith(skip))

    got = names(got_dir)
    assert got == names(want_dir)
    for name in got:
        if name.endswith(".png"):
            a, b = (cv2.imread(str(d / name), cv2.IMREAD_UNCHANGED)
                    for d in (got_dir, want_dir))
            assert a.shape == b.shape, name
            diff = np.abs(a.astype(int) - b.astype(int))
            if "poisson" in name:
                assert diff.max() <= 1, name
            px = diff.reshape(a.shape[0], a.shape[1], -1).max(-1)
            assert np.mean(px > 0) <= 1e-3, (name, np.mean(px > 0))
        elif name.endswith(".mp4"):
            caps = [cv2.VideoCapture(str(d / name)) for d in (got_dir,
                                                              want_dir)]
            n, shape = zip(*((c.get(cv2.CAP_PROP_FRAME_COUNT),
                              (c.get(cv2.CAP_PROP_FRAME_HEIGHT),
                               c.get(cv2.CAP_PROP_FRAME_WIDTH)))
                             for c in caps))
            for c in caps:
                c.release()
            assert n[0] == n[1] > 0 and shape[0] == shape[1], (name, n, shape)
    return got


def _assert_flows_close(got, want, n_frames):
    for i in range(n_frames):
        g = np.load(got / f"pred_flow{i}.npy")
        w = np.load(want / f"pred_flow{i}.npy")
        assert g.dtype == w.dtype and g.shape == w.shape == (2, 64, 96)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        assert np.array_equal(np.signbit(g), np.signbit(w))
    assert not (got / f"pred_flow{n_frames}.npy").exists()


def _lines(path):
    """``[(frame, {dict})]`` of an error text."""
    out = []
    for line in open(path):
        head, payload = line.split("::", 1)
        out.append((int(head.split()[1]), ast.literal_eval(payload)))
    return out


def _assert_texts_close(got_dir, want_dir, names, rtol):
    for name in names:
        got, want = _lines(got_dir / name), _lines(want_dir / name)
        assert [f for f, _ in got] == [f for f, _ in want], name
        for (_, g), (_, w) in zip(got, want):
            assert list(g) == list(w), name
            for k in w:
                assert abs(g[k] - w[k]) <= rtol * abs(w[k]), (name, k, g, w)


@pytest.mark.parametrize("data,visualize", [
    ({}, False),
    ({"n_events_per_batch": 2500, "max_time_per_event_batch": 0.02,
      "remove_nose": True}, False),
    ({}, True),
    ({"n_events_per_batch": 2500, "max_time_per_event_batch": 0.02,
      "remove_nose": True}, True),
], ids=["plain", "rebalanced", "visualize", "visualize_rebalanced"])
def test_port_cli_matches_jax_cli(tmp_path, monkeypatch, data, visualize):
    """``visualize``: the config has no ``visualize`` key (the default, as
    in the shipped configs), two frames."""
    cfg = small_config(flow_convention="physical")
    cfg["data"].update(data)
    cfg["evaluation"]["metrics"] = ["flow", "fwl"]
    n_frames = 3
    if visualize:
        del cfg["visualize"]
        cfg["evaluation"]["time_list"] = [[0.01, 0.15]]
        n_frames = 2
    init = pyramid_init(cfg)
    inject_init(monkeypatch, tfacades, init)
    inject_init(monkeypatch, jfacades, init)
    got = _run_port(tmp_path, "torch", cfg)
    want = _run_jax(tmp_path, dict(cfg, pipeline=True) if visualize else cfg)
    _assert_texts_close(got, want, TEXTS + ("fwl_per_frame.txt",), 1e-6)
    assert [f for f, _ in _lines(got / TEXTS[0])] == list(range(n_frames))
    _assert_flows_close(got, want, n_frames)
    if visualize:
        names = _assert_artifacts_close(tmp_path, got, want)
        for prefix in ("original", "original_filter", "pred_flow",
                       "pred_flow_poisson", "pred_masked", "gt_flow",
                       "gt_flow_poisson", "gt_masked", "flow_comparison_pred",
                       "flow_comparison_gt", "optimization_steps"):
            assert f"{prefix}1.png" in names, prefix
        assert "color_wheel.png" in names


#: solver overrides and the injected init of the other generative solvers
#: on the small scene (the shipped generative_ml section: the poisson model
#: with the warp pair)
GENERATIVE = {
    "generative_max_likelihood": ({}, "gml", lambda: np.array(
        [0.3, -0.2, 0.05])),
    "patch_eklt": ({"patch_size": 8, "sliding_window": 8}, None, None),
    "patch_eklt_dependent": ({"patch_size": 16, "sliding_window": 16},
                             "dependent", lambda: np.random.default_rng(
                                 2).uniform(-1, 1, (3, 4, 6))),
}


@pytest.mark.parametrize("method,visualize", [
    ("generative_max_likelihood", False), ("patch_eklt", False),
    ("patch_eklt_dependent", False), ("generative_max_likelihood", True)])
def test_generative_methods_cli_match_jax(tmp_path, monkeypatch, method,
                                          visualize):
    """``cli.main … --eval`` with ``solver.method`` set to each of the
    other generative solvers, from one injected init: the texts and flows
    as in the plain case; with ``visualize`` the same artifacts (the JAX
    CLI pipelined, as above)."""
    patch, solver, make_init = GENERATIVE[method]
    cfg = small_config(flow_convention="physical")
    cfg["solver"]["method"] = method
    cfg["solver"]["patch_eklt"].update(patch)
    n_frames = 3
    if visualize:
        del cfg["visualize"]
        cfg["evaluation"]["time_list"] = [[0.01, 0.15]]
        n_frames = 2
    if solver is not None:
        inject_init(monkeypatch, tfacades, make_init(), solver)
        inject_init(monkeypatch, jfacades, make_init(), solver)
    got = _run_port(tmp_path, "torch", cfg)
    want = _run_jax(tmp_path, dict(cfg, pipeline=True) if visualize else cfg)
    _assert_texts_close(got, want, TEXTS, 1e-6)
    _assert_flows_close(got, want, n_frames)
    if visualize:
        names = _assert_artifacts_close(tmp_path, got, want)
        assert "optimization_steps1.png" in names


@pytest.mark.parametrize("top,argv_eval", [
    ({"method": "opencv_flow_two_steps"}, True),
    ({"run_mode": "accumulate"}, False),
    ({}, False),
    ({"run_mode": "sequential_estimate"}, False),
], ids=["two_step_gt", "accumulate", "sequential", "sequential_estimate"])
def test_port_run_modes_match_jax_cli(tmp_path, monkeypatch, top, argv_eval):
    """The visualizing run modes on the default ``visualize``: the
    two-step Farnebäck GT in the evaluation loop (its uint8 Poisson views
    and flow equal JAX's bit for bit on this scene), and, without
    ``--eval``, the accumulated polarity images, the sequential event
    images, and the sequential solve (three 10 ms windows)."""
    cfg = small_config(**top)
    del cfg["visualize"]
    cfg["evaluation"]["time_list"] = ([[0.01, 0.15]] if argv_eval
                                      else [[0.01, 0.04]])
    init = pyramid_init(cfg)
    inject_init(monkeypatch, tfacades, init)
    inject_init(monkeypatch, jfacades, init)
    got = _run_port(tmp_path, "torch", cfg, argv_eval)
    want = _run_jax(tmp_path, dict(cfg, pipeline=True) if argv_eval else cfg,
                    argv_eval)
    names = _assert_artifacts_close(tmp_path, got, want)
    if argv_eval:
        _assert_texts_close(got, want, TEXTS, 1e-6)
        _assert_flows_close(got, want, 2)
        assert "gt_flow_poisson1.png" in names
        return
    assert ((got / "timestamps_per_frame.txt").read_text()
            == (want / "timestamps_per_frame.txt").read_text())
    want_names = {"accumulate": ["orig2.png", "filter2.png"],
                  "sequential": ["original2.png", "original_filter2.png",
                                 "original.mp4"],
                  "sequential_estimate": ["pred_flow2.npy",
                                          "pred_masked2.png"]}
    for name in want_names[top.get("run_mode", "sequential")]:
        if name.endswith(".mp4") and not _has_codec(tmp_path):
            continue
        assert name in names, name
    if top.get("run_mode") == "sequential_estimate":
        _assert_flows_close(got, want, 3)


def test_debug_nans(tmp_path, monkeypatch):
    """``debug_nans``: the same outputs when every value is finite; a NaN in
    a frame's flow raises ``FloatingPointError``."""
    cfg = small_config(debug_nans=True)
    cfg["evaluation"]["time_list"] = [[0.01, 0.11]]
    plain = _run_port(tmp_path, "plain", dict(cfg, debug_nans=False))
    checked = _run_port(tmp_path, "checked", cfg)
    assert (np.load(plain / "pred_flow0.npy").tobytes()
            == np.load(checked / "pred_flow0.npy").tobytes())
    orig = tfacades.estimate_frame

    def nan_flow(*args, **kwargs):
        flow, aux = orig(*args, **kwargs)
        return flow * float("nan"), aux

    monkeypatch.setattr(tfacades, "estimate_frame", nan_flow)
    argv, _out = _write(tmp_path, "nan", cfg)
    with pytest.raises(FloatingPointError, match="frame 0"):
        tcli.main(argv, device="cpu")


def test_pipeline_is_bit_identical_to_sync(tmp_path):
    """No shared init: the solver's generator draws the cold starts, in
    frame order in both loops."""
    cfg = small_config()
    sync = _run_port(tmp_path, "sync", cfg)
    piped = _run_port(tmp_path, "pipe", dict(cfg, pipeline=True))
    for name in TEXTS[:2]:
        assert (sync / name).read_text() == (piped / name).read_text()
    for i in range(3):
        a = np.load(sync / f"pred_flow{i}.npy")
        b = np.load(piped / f"pred_flow{i}.npy")
        assert a.tobytes() == b.tobytes()
    # a different seed gives a different flow: the draws are used
    other = _run_port(tmp_path, "seed", dict(cfg, solver=dict(
        cfg["solver"], seed=5)))
    assert not np.array_equal(np.load(other / "pred_flow0.npy"),
                              np.load(sync / "pred_flow0.npy"))


def test_resume_skips_computed_frames(tmp_path):
    cfg = small_config(resume=True)
    first = dict(cfg, evaluation=dict(cfg["evaluation"],
                                      time_list=[[0.01, 0.15]]))
    out = _run_port(tmp_path, "r", first)
    assert [f for f, _ in _lines(out / TEXTS[0])] == [0, 1]
    _run_port(tmp_path, "r", cfg)
    # the second run appended frame 2 only
    assert [f for f, _ in _lines(out / TEXTS[0])] == [0, 1, 2]
    log = (out / "main.log").read_text()
    assert "Frame 0 already computed" in log
    assert "Frame 1 already computed" in log
    assert sorted(p.name for p in out.glob("flow_*.npy")) == [
        "flow_000000.npy", "flow_000001.npy", "flow_000002.npy"]


def test_profile_logs_the_section_report(tmp_path):
    out = _run_port(tmp_path, "p", small_config(profile=True))
    log = (out / "main.log").read_text()
    assert "Per-section host timings" in log
    assert "Steady-state sections (frames 3+, n=1" in log
    for section in ("prepare:", "preprocess:", "estimate:", "finalize:",
                    "finalize/errors:", "finalize/solve_wait:"):
        assert section in log


def test_contrast_maximization_cli_writes_parsable_texts(tmp_path):
    cfg = small_config("synthetic_cmax")
    cfg["evaluation"]["time_list"] = [[0.01, 0.15]]
    out = _run_port(tmp_path, "cmax", cfg)
    for name in TEXTS[:2]:
        arrays, stats = read_flow_error_text(str(out / name))
        assert stats["EPE"]["n_data"] == 2
        assert np.isfinite(arrays["EPE"]).all()
    flows = [np.load(out / f"pred_flow{i}.npy") for i in range(2)]
    assert all(f.shape == (2, 64, 96) and np.isfinite(f).all()
               for f in flows)


#: the event-grid PIV's section (not in the shipped configs)
PIV_EVENTS = {"integration_time": 0.02, "frame_distance": 0.02,
              "do_inversion": True}


def _recorded_piv(monkeypatch, frame_flow_module):
    """Wrap the module's ``FrameFlowEstimator.consecutive_openpiv`` to
    record each returned flow, and run its PIV in float64 (the JAX
    package's through ``torch_parity.jax_piv_multipass64``)."""
    import functools

    if frame_flow_module.__name__.startswith("event_based_bos_tpu."):
        import event_based_bos_tpu.piv as piv

        monkeypatch.setattr(piv, "piv_multipass", jax_piv_multipass64)
    else:
        import event_based_bos_tpu_torch.piv as piv

        monkeypatch.setattr(piv, "piv_multipass", functools.partial(
            piv.piv_multipass, dtype=torch.float64))
    cls = frame_flow_module.FrameFlowEstimator
    orig = cls.consecutive_openpiv
    flows = []

    def recorded(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        flows.append(np.asarray(out[0]))
        return out

    monkeypatch.setattr(cls, "consecutive_openpiv", recorded)
    return flows


def _assert_openpiv_cli_matches_jax(tmp_path, monkeypatch, top):
    """``estimation_method: openpiv``: the same histogram PNGs bit for
    bit (integer event pixels), the same artifact names, and each pair's
    PIV flow within 1e-9 px.  ``method: openpiv``: the PIV GT of each of
    two solver frames within 1e-9 px, and the error texts within 1e-6
    relative.  Both packages' PIV runs in float64 here: in float32 the
    two FFT libraries round differently, and a near-tie of two
    correlation peaks can then fall either way."""
    import event_based_bos_tpu.frame_flow as jframe_flow
    import event_based_bos_tpu_torch.frame_flow as tframe_flow

    cfg = small_config(**top)
    cfg["evaluation"]["time_list"] = [[0.01, 0.15]]
    if top.get("estimation_method") == "openpiv":
        cfg["params_openpiv_events"] = dict(PIV_EVENTS)
        del cfg["visualize"]
        # dense enough that no interrogation window of a histogram is
        # blank: a blank window's correlation is all rounding noise, and
        # its peak falls anywhere
        cfg["data"]["events_per_frame"] = 200000
        # no 8-px pass: on this scene's first pair one of its windows
        # holds two near-equal correlation peaks, and a 1e-15 px
        # difference in the previous pass's field picks either
        # (tests/test_torch_piv.py holds every pass size to JAX)
        cfg["params_openpiv"].update(windowsizes=[64, 32, 16],
                                     overlap=[32, 16, 8])
    init = pyramid_init(cfg)
    inject_init(monkeypatch, tfacades, init)
    inject_init(monkeypatch, jfacades, init)
    tflows = _recorded_piv(monkeypatch, tframe_flow)
    jflows = _recorded_piv(monkeypatch, jframe_flow)
    got = _run_port(tmp_path, "torch", cfg)
    want = _run_jax(tmp_path, cfg)
    assert len(tflows) == len(jflows) == 2
    for a, b in zip(tflows, jflows):
        assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
        assert np.max(np.abs(a - b)) <= 1e-9 and np.abs(a).max() > 0
    if top.get("estimation_method") == "openpiv":
        names = _assert_artifacts_close(tmp_path, got, want)
        for prefix in ("hist1", "hist2", "event_flow_openpiv"):
            assert f"{prefix}1.png" in names, prefix
        for name in names:
            if name.startswith("hist"):
                assert np.array_equal(cv2.imread(str(got / name)),
                                      cv2.imread(str(want / name))), name
    else:
        _assert_texts_close(got, want, TEXTS, 1e-6)
        _assert_flows_close(got, want, 2)


@pytest.mark.parametrize("top,argv_eval,match", [
    ({"mesh": {"data": 1, "event": 1}}, True, "#15"),
    ({"estimation_method": "openpiv"}, True, "#14b"),
    ({"method": "openpiv"}, True, "#14b"),
])
def test_options_not_ported_raise(tmp_path, monkeypatch, top, argv_eval,
                                  match):
    """``mesh:`` is not ported (ROADMAP Queue 1 #15) and raises.  The PIV
    options raised until #14b ported them; those cases now hold the
    port's CLI to the JAX CLI (:func:`_assert_openpiv_cli_matches_jax`)."""
    if match == "#14b":
        _assert_openpiv_cli_matches_jax(tmp_path, monkeypatch, top)
        return
    argv, _out = _write(tmp_path, "x", small_config(**top))
    if not argv_eval:
        argv = argv[:-1]
    with pytest.raises(NotImplementedError, match=match):
        tcli.main(argv, device="cpu")


def test_main_defaults_to_the_gpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    argv, _out = _write(tmp_path, "g", small_config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(argv)


def test_frame_result_store_matches_jax(tmp_path):
    from event_based_bos_tpu.utils.checkpoint import FrameResultStore as J
    from event_based_bos_tpu_torch.utils.checkpoint import (
        FrameResultStore as T)

    rng = np.random.default_rng(0)
    stores = T(str(tmp_path / "t")), J(str(tmp_path / "j"))
    for i in range(3):
        flow = rng.normal(size=(2, 4, 5)).astype(np.float32)
        epe = float(rng.uniform())
        for s in stores:
            s.record(i, flow=flow, t1=0.1 * i, t2=0.1 * i + 0.05, EPE=epe,
                     AE=0.5)
    # the same manifest on disk, read back by a new store (a resume)
    t, j = T(str(tmp_path / "t")), J(str(tmp_path / "j"))
    assert len(t) == 3 and 2 in t and 3 not in t
    assert t.get(1) == j.get(1)
    assert t.summary() == j.summary()
    assert np.array_equal(t.load_flow(2), j.load_flow(2))
    assert t.load_flow(7) is None


def test_fix_random_seed_seeds_numpy_and_torch():
    import random

    import torch

    from event_based_bos_tpu_torch.utils import fix_random_seed

    draws = []
    for _ in range(2):
        fix_random_seed(11)
        draws.append((np.random.rand(), random.random(),
                      float(torch.rand(()))))
    assert draws[0] == draws[1]
