"""The solver facades of the port against the JAX package's.

Both facades are built from the same YAML config (``synthetic_plume`` and
``synthetic_cmax`` cut to 64×96, float64) and fed the same events, window
by window, from the synthetic loader.  Random streams differ between the
frameworks, so every cold pyramid frame starts from one numpy
``init_params``: the ``estimate_frame`` name in each package's
``solver.facades`` is wrapped to pass it (no file of the JAX package
changes).

Tolerances: the pyramid and CMax flows within 1e-6 px (float64 solves,
float32 fetch), with the signs of the zeros outside the ROI equal; the
error pair within 1e-6 relative (float32 metrics).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import event_based_bos_tpu.solver.facades as jfacades
import event_based_bos_tpu.utils.config as jconfig
import event_based_bos_tpu_torch.solver.facades as tfacades
from event_based_bos_tpu_torch import data as tdata
from event_based_bos_tpu_torch.solver import api as tapi
from event_based_bos_tpu_torch.utils.config import propagate_config
from torch_parity import (CPU, SMALL_ROI, inject_init, pyramid_init,
                          small_config, torch_threads)

H, W = 64, 96
ROI_BOX = (SMALL_ROI["xmin"], SMALL_ROI["xmax"], SMALL_ROI["ymin"],
           SMALL_ROI["ymax"])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _config(name="synthetic_plume", **solver):
    cfg = small_config(name)
    cfg["solver"].update(solver)
    propagate_config(cfg)
    want = small_config(name)
    want["solver"].update(solver)
    jconfig.propagate_config(want)
    assert cfg == want  # the port's propagation is the JAX package's
    return cfg


def _build(cfg, package):
    d = cfg["data"]
    args = ((d["height"], d["width"]), (d["crop_height"], d["crop_width"]))
    kw = dict(solver_config=copy.deepcopy(cfg["solver"]),
              visualize_module=None)
    if package == "torch":
        return tfacades.collections[cfg["solver"]["method"]](
            *args, device=CPU, **kw)
    return jfacades.collections[cfg["solver"]["method"]](*args, **kw)


def _windows(cfg, n_frames=3):
    """``(events (n, 4), frame)`` of the first frames of ``time_list``."""
    loader = tdata.collections["SYNTHETIC"](config=cfg["data"])
    loader.set_sequence(cfg["data"]["sequence"])
    out = []
    for i1 in range(1, 1 + n_frames):
        im1, t1 = loader.load_image(i1)
        _im2, t2 = loader.load_image(i1 + 1)
        ev = loader.load_event(max(loader.time_to_index(t1), 0),
                               min(loader.time_to_index(t2), len(loader)))
        out.append((ev, im1))
    return out


def _solve(solv, windows):
    flows = []
    for ev, frame in windows:
        filtered, _period = solv.preprocess(ev)
        flows.append(solv.estimate(filtered, frame=frame))
    return flows


def _outside():
    out = np.ones((H, W), bool)
    out[ROI_BOX[0]:ROI_BOX[1], ROI_BOX[2]:ROI_BOX[3]] = False
    return out


@pytest.mark.parametrize("convention", ["reference", "physical"])
def test_pyramid_facade_matches_jax(monkeypatch, convention):
    cfg = _config(flow_convention=convention)
    init = pyramid_init(cfg)
    inject_init(monkeypatch, tfacades, init)
    inject_init(monkeypatch, jfacades, init)
    windows = _windows(cfg, 1)
    (tflow,) = _solve(_build(cfg, "torch"), windows)
    (jflow,) = _solve(_build(cfg, "jax"), windows)
    assert tflow.dtype == np.float32 and tflow.shape == (2, H, W)
    np.testing.assert_allclose(tflow, jflow, rtol=0, atol=1e-6)
    assert np.array_equal(np.signbit(tflow), np.signbit(jflow))
    outside = _outside()
    assert (tflow[:, outside] == 0).all()
    # the solve writes +0.0 outside the ROI; physical negates it
    assert np.signbit(tflow[:, outside]).all() == (convention == "physical")
    assert np.abs(tflow[:, ~outside]).max() > 0


def test_pyramid_facade_warm_start_matches_jax(monkeypatch):
    """``warm_start`` with ``steady_n_iter`` over three frames: frame 0 cold
    from the shared init, frames 1 and 2 warm on the shortened schedule."""
    cfg = _config(warm_start=True, steady_n_iter=6)
    init = pyramid_init(cfg)
    inject_init(monkeypatch, tfacades, init)
    inject_init(monkeypatch, jfacades, init)
    windows = _windows(cfg, 3)
    tsolv = _build(cfg, "torch")
    tflows = _solve(tsolv, windows)
    jflows = _solve(_build(cfg, "jax"), windows)
    for t, j in zip(tflows, jflows):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    assert tsolv.spec_steady.n_iter == 6
    assert tsolv.previous_frame_best_estimation is not None
    # warm frames start elsewhere than a cold frame on the same window
    cold = _solve(_build(cfg, "torch"), windows[1:2])[0]
    assert not np.array_equal(cold, tflows[1])


def _moving_dots(vx, vy, n=6000, seed=0):
    """A rigidly translating dot pattern over one window (``(n, 4)``
    events), whose contrast peaks away from flow 0."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 1, n))
    x = rng.choice(np.arange(6, H - 14, 4), n) + vx * t + rng.normal(0, .1, n)
    y = rng.choice(np.arange(6, W - 14, 5), n) + vy * t + rng.normal(0, .1, n)
    return np.stack([x, y, t, np.ones(n)], 1)


def test_cmax_facade_matches_jax_on_the_stencil_route():
    """The dense CMax solve starts from flow 0 (no init to share), here on
    a translating dot pattern.  On the CPU the JAX facade takes the stencil
    sum; the port is put on its stencil route (``use_kernel=False``) to
    match."""
    cfg = _config("synthetic_cmax")
    windows = [(_moving_dots(2.0, -3.0), np.zeros((H, W)))]
    tsolv = _build(cfg, "torch")
    assert tsolv.spec.use_kernel
    tsolv.spec = dataclasses.replace(tsolv.spec, use_kernel=False)
    (tflow,) = _solve(tsolv, windows)
    (jflow,) = _solve(_build(cfg, "jax"), windows)
    assert tflow.shape == (2, H, W) and np.isfinite(tflow).all()
    np.testing.assert_allclose(tflow, jflow, rtol=0, atol=1e-6)
    assert np.abs(tflow).max() > 0


@pytest.mark.parametrize("convention", ["reference", "physical"])
def test_flow_errors_match_jax_and_the_device_pair(monkeypatch, convention):
    """``calculate_flow_errors`` equals the JAX facade's; the pair queued
    behind the solve from its device flow equals it bit for bit."""
    cfg = _config(flow_convention=convention)
    inject_init(monkeypatch, tfacades, pyramid_init(cfg))
    ((ev, frame),) = _windows(cfg, 1)
    tsolv, jsolv = _build(cfg, "torch"), _build(cfg, "jax")
    filtered, _ = tsolv.preprocess(ev)
    handle = tsolv.estimate_async(filtered, frame=frame)
    flow = handle.result()
    sign = -1.0 if convention == "physical" else 1.0
    assert torch.equal(handle.device_flow.to(torch.float32) * sign,
                       torch.as_tensor(flow))
    gt = np.random.default_rng(0).normal(0, 1, (2, H, W)).astype(np.float32)
    x0, x1, y0, y1 = ROI_BOX
    est_c, gt_c = flow[:, x0:x1, y0:y1], gt[:, x0:x1, y0:y1]
    got = tsolv.calculate_flow_errors(est_c, gt_c, ev, SMALL_ROI)
    want = jsolv.calculate_flow_errors(est_c, gt_c, ev, SMALL_ROI)
    for g, w in zip(got, want):
        assert list(g) == list(w)  # the same keys, in the same order
        assert all(isinstance(v, float) for v in g.values())
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-6 * abs(w[k]), (k, g[k], w[k])
    assert got[0] != got[1]
    device_pair = tsolv.flow_errors_async(filtered, gt, handle.device_flow,
                                          ROI_BOX)()
    assert device_pair == got
    single = tsolv.calculate_flow_error(est_c, gt_c, events=ev,
                                        roi=SMALL_ROI)
    assert single == got[1]


def test_fwl_async_equals_host_fwl(monkeypatch):
    cfg = _config(flow_convention="physical")
    inject_init(monkeypatch, tfacades, pyramid_init(cfg))
    ((ev, frame),) = _windows(cfg, 1)
    tsolv = _build(cfg, "torch")
    filtered, _ = tsolv.preprocess(ev)
    handle = tsolv.estimate_async(filtered, frame=frame)
    flow = handle.result()
    got = tsolv.calculate_fwl_async(filtered, handle.device_flow, 2.0)()
    want = tsolv.calculate_fwl(flow * np.float32(2.0), filtered)
    assert set(got) == {"FWL"} and isinstance(got["FWL"], float)
    assert got == want


def test_prewarm_draws_nothing_and_generator_is_seeded(monkeypatch):
    cfg = _config()
    windows = _windows(cfg, 1)
    a, b = _build(cfg, "torch"), _build(cfg, "torch")
    before = a._generator.get_state()
    a.prewarm(4096)
    assert torch.equal(a._generator.get_state(), before)
    assert np.array_equal(_solve(a, windows)[0], _solve(b, windows)[0])


def test_solver_texts_are_parsable(tmp_path):
    from event_based_bos_tpu_torch.utils import read_flow_error_text

    solv = _build(_config(), "torch")
    solv.output_dir = str(tmp_path)
    for i in range(3):
        solv.save_flow_error_as_text(i, {"EPE": 0.5 + i, "AE": 0.0})
        solv.save_flow_error_as_text(i, {"t1": 0.1, "t2": 0.2},
                                     "timestamps_per_frame.txt")
    assert solv.evaluation_text_list == [
        str(tmp_path / "flow_error_per_frame.txt")]
    arrays, stats = read_flow_error_text(solv.evaluation_text_list[0])
    assert list(arrays["EPE"]) == [0.5, 1.5, 2.5]
    assert stats["EPE"]["n_data"] == 3


@pytest.mark.parametrize("overrides,exc,match", [
    ({"restart_mode": "pmap"}, ValueError, "restart_mode"),
    ({"restrict_to_roi": True, "roi_margin": 1}, ValueError, "roi_margin"),
    ({"n_restarts": 4, "warm_start": True}, ValueError, "warm_start"),
    ({"steady_n_iter": 5}, ValueError, "warm_start"),
    ({"steady_n_iter": 0, "warm_start": True}, ValueError, ">= 1"),
    ({"split_iwe_cache": "fused"}, ValueError, "split_iwe_cache"),
    ({"quantized_upload": True}, NotImplementedError, "#16"),
    ({"quantized_upload": "exact"}, NotImplementedError, "#16"),
    ({"quantized_upload": "round"}, NotImplementedError, "#16"),
    ({"quantized_upload": "lossy"}, ValueError, "quantized_upload"),
    ({"flow_fetch_dtype": "float16"}, NotImplementedError, "#16"),
    ({"flow_fetch_dtype": "bfloat16"}, NotImplementedError, "#16"),
    ({"flow_fetch_dtype": "int8"}, ValueError, "flow_fetch_dtype"),
    ({"generative_ml": {"model_image": "e2vid"}}, NotImplementedError,
     "#14"),
])
def test_options_not_ported_or_invalid_raise(overrides, exc, match):
    """Invalid values raise, and the wire options (ROADMAP Queue 1 #16)
    are not ported.  ``model_image: e2vid`` raised until #14 ported the
    E2VID loader: that case now builds as in the JAX package, and without
    a ``generative_ml.e2vid`` loader both facades' model frame is the
    supplied ``frame`` (``tests/test_torch_loaders.py`` holds the loader
    route to JAX)."""
    cfg = _config()
    cfg["solver"].update(overrides)
    if match == "#14":
        frame = np.arange(H * W, dtype=float).reshape(H, W)
        for package in ("torch", "jax"):
            solv = _build(cfg, package)
            assert np.array_equal(solv._model_frame({"frame": frame}), frame)
        return
    with pytest.raises(exc, match=match):
        _build(cfg, "torch")


#: the three generative facades on the small scene: the generative_ml
#: section as shipped (the poisson model with the warp pair) for GML and
#: the joint solver, the angle model for the independent solver
GENERATIVE = {
    "generative_max_likelihood": ({}, "gml", lambda: np.array(
        [0.3, -0.2, 0.05])),
    "patch_eklt": ({"patch_eklt": dict(patch_size=8, sliding_window=8,
                                       coarsest_patch_size=16,
                                       finest_patch_size=8),
                    "generative_ml": dict(angle_model=True,
                                          poisson_model=False,
                                          optimize_warp=True, iwe_sigma=2,
                                          weight_loss_by_inverse_event_hist=(
                                              True))}, None, None),
    "patch_eklt_dependent": ({"patch_eklt": dict(patch_size=16,
                                                 sliding_window=16,
                                                 coarsest_patch_size=16,
                                                 finest_patch_size=8)},
                             "dependent", lambda: np.random.default_rng(
                                 2).uniform(-1, 1, (3, 4, 6))),
}


@pytest.mark.parametrize("method", list(GENERATIVE))
@pytest.mark.parametrize("convention", ["reference", "physical"])
def test_generative_facades_match_jax(monkeypatch, method, convention):
    """Two windows through each facade from one injected init, against the
    JAX facade: the flow (float64, not rounded) within 1e-10, the signs of
    its zeros equal."""
    extra, solver, make_init = GENERATIVE[method]
    cfg = _config(method=method, flow_convention=convention, **extra)
    if solver is not None:
        inject_init(monkeypatch, tfacades, make_init(), solver)
        inject_init(monkeypatch, jfacades, make_init(), solver)
    windows = _windows(cfg, 2)
    tsolv = _build(cfg, "torch")
    tflows = _solve(tsolv, windows)
    jflows = _solve(_build(cfg, "jax"), windows)
    for t, j in zip(tflows, jflows):
        assert t.dtype == j.dtype == np.float64 and t.shape == (2, H, W)
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-10)
        assert np.array_equal(np.signbit(t), np.signbit(j))
        assert np.abs(t).max() > 0
    assert tsolv.iter_cnt == tsolv.dispatch_cnt == 2


def test_gml_facade_reads_the_optimizer_section():
    """``method: optuna`` takes ``optimizer.sampler``; the boxes are
    ``optimizer.parameters``; the learning rate is the solver's own."""
    box = {"min": -2, "max": 2}
    opt = {"method": "optuna", "sampler": "grid", "n_iter": 81, "lr": 0.5,
           "parameters": {"v_x": box, "v_y": box, "p_x": box, "p_y": box}}
    cfg = _config(method="generative_max_likelihood", optimizer=opt,
                  generative_ml=dict(poisson_model=False,
                                     optimize_warp=True))
    solv = _build(cfg, "torch")
    assert solv.spec.method == "grid" and solv.spec.lr == 0.01
    assert solv.spec.param_bounds == ((-2.0, 2.0),) * 4
    (flow,) = _solve(solv, _windows(cfg, 1))
    assert flow.dtype == np.float32  # the trials are float32
    # the velocity is one of the 3^4 grid's points, constant over the frame
    for plane in flow:
        assert plane.min() == plane.max() and plane[0, 0] in (-2, 0, 2)


def test_gml_facade_tpe_draws_its_seed_in_estimate_async(monkeypatch):
    """``TPE`` runs the sequential study; its seed is one draw of the
    facade's generator in ``estimate_async``, none in ``prewarm``."""
    opt = {"method": "optuna", "sampler": "TPE", "n_iter": 12,
           "parameters": {"p": {"min": -1, "max": 1},
                          "p_x": {"min": -0.4, "max": 0.4},
                          "p_y": {"min": -0.4, "max": 0.4}}}
    cfg = _config(method="generative_max_likelihood", optimizer=opt)
    solv = _build(cfg, "torch")
    assert solv.spec.method == "TPE" and solv._tpe_solver is not None
    seeds = []
    orig = solv._tpe_solver
    solv._tpe_solver = lambda ev, fr, seed: seeds.append(seed) or orig(
        ev, fr, seed)
    before = solv._generator.get_state()
    solv.prewarm(4096)
    assert torch.equal(solv._generator.get_state(), before)
    (flow,) = _solve(solv, _windows(cfg, 1))
    g = torch.Generator(CPU)
    g.set_state(before)
    assert seeds == [int(torch.randint(0, 2 ** 31 - 1, (1,), generator=g))]
    assert torch.equal(solv._generator.get_state(), g.get_state())
    assert np.isfinite(flow).all()


@pytest.mark.parametrize("overrides", [
    {"restrict_to_roi": True},
    {"n_restarts": 4},
    {"compute_dtype": "bfloat16"},
], ids=["restrict_to_roi", "n_restarts", "compute_dtype"])
def test_pyramid_options_build_and_run(monkeypatch, overrides):
    """The pyramid's speed and quality options build through the facade
    and solve a frame: the restricted solve equals the JAX facade's from
    the same init; the multi-start draws its four inits from the facade's
    generator; the bfloat16 interior gives a finite flow."""
    cfg = _config(**overrides)
    windows = _windows(cfg, 1)
    solv = _build(cfg, "torch")
    if "restrict_to_roi" in overrides:
        assert solv.spec.restrict_to_roi and solv.spec.roi_norm_stride == 4
        init = pyramid_init(cfg)
        inject_init(monkeypatch, tfacades, init)
        inject_init(monkeypatch, jfacades, init)
        (jflow,) = _solve(_build(cfg, "jax"), windows)
    state = solv._generator.get_state()
    (tflow,) = _solve(solv, windows)
    assert np.isfinite(tflow).all() and np.abs(tflow).max() > 0
    assert (tflow[:, _outside()] == 0).all()
    if "restrict_to_roi" in overrides:
        np.testing.assert_allclose(tflow, jflow, rtol=0, atol=1e-6)
    if "n_restarts" in overrides:
        g = torch.Generator(CPU)
        g.set_state(state)
        for _ in range(4):
            torch.rand((4, 6), generator=g, dtype=torch.float64)
        assert torch.equal(solv._generator.get_state(), g.get_state())
    if "compute_dtype" in overrides:
        assert solv.spec.gen.compute_dtype == torch.bfloat16
        assert solv.spec.gen.dtype == torch.float64


@pytest.mark.parametrize("value,want", [
    ("bfloat16", torch.bfloat16), ("float32", torch.float32),
    ("float64", None), (None, None)])
def test_compute_dtype_maps_as_in_jax(value, want):
    spec = _build(_config(compute_dtype=value), "torch").spec
    assert spec.gen.compute_dtype == want
    assert spec.gen.dtype == torch.float64


@pytest.mark.parametrize("mode", ["auto", False, "off", "scatter",
                                  "pallas"])
def test_split_iwe_cache_modes_are_accepted(mode):
    assert _build(_config(split_iwe_cache=mode), "torch").spec.n_iter == 12


@pytest.mark.parametrize("dataset", ["E2VID", "HELIUM"])
def test_recorded_dataset_loaders_are_not_ported_yet(dataset):
    """The E2VID and HELIUM loaders raised until ROADMAP Queue 1 #14b
    ported them: the registry now gives the port's loader, configured as
    the JAX package's (``tests/test_torch_loaders.py`` holds their reads
    to JAX)."""
    from event_based_bos_tpu import data as jdata

    cfg = {"height": H, "width": W, "root": "/data"}
    loader = tdata.collections[dataset](config=dict(cfg))
    want = jdata.collections[dataset](config=dict(cfg))
    assert loader.NAME == dataset
    assert type(loader).__name__ == type(want).__name__
    assert loader.dataset_dir == want.dataset_dir
    assert type(loader).__module__.startswith("event_based_bos_tpu_torch.")


def test_ccs_loader_is_registered():
    from event_based_bos_tpu_torch.data.ccs import CcsDataLoader

    loader = tdata.collections["CCS"](config={"height": H, "width": W})
    assert isinstance(loader, CcsDataLoader) and loader.NAME == "CCS"


def test_model_frame_modes():
    solv = _build(_config(), "torch")
    frame = np.arange(H * W, dtype=float).reshape(H, W)
    bg = np.ones((H, W))
    assert solv._model_frame({"frame": frame}) is not None
    for mode, want in (("current", frame), ("black", np.zeros((H, W))),
                       ("background", bg)):
        solv.slv_config["generative_ml"]["model_image"] = mode
        got = solv._model_frame({"frame": frame, "background": bg})
        assert np.array_equal(got, want)
    solv.slv_config["generative_ml"]["model_image"] = "sketch"
    with pytest.raises(ValueError):
        solv._model_frame({"frame": frame})


def test_visualize_methods_need_no_visualizer(tmp_path):
    """Without a visualizer the ``visualize_*`` methods do nothing; with
    one they write the JAX facade's files, pixel for pixel (the Poisson
    views, made on the device, within 1 LSB)."""
    solv = _build(_config(), "torch")
    names = ["visualize_original_sequential", "visualize_pred_sequential",
             "visualize_gt_sequential", "visualize_flows",
             "visualize_one_batch_warp", "visualize_one_batch_warp_gt"]
    for name in names:
        assert getattr(solv, name)(None, None) is None
    import cv2

    import event_based_bos_tpu.visualizer as jviz
    import event_based_bos_tpu_torch.visualizer as tviz

    cfg = _config("synthetic_cmax")
    (events, _frame), = _windows(cfg, 1)
    rng = np.random.default_rng(4)
    flow = rng.normal(0, 0.4, (2, H, W)).astype(np.float32)
    gt = rng.normal(0, 0.4, (2, H, W))
    for tag, vis in (("torch", tviz.Visualizer((H, W), save_dir=str(
            tmp_path / "torch"), device=CPU)),
                     ("jax", jviz.Visualizer((H, W), save_dir=str(
                         tmp_path / "jax")))):
        s = _build(cfg, tag)
        s.visualizer = vis
        filtered, _ = s.preprocess(events)
        s.visualize_original_sequential(events, filtered)
        s.visualize_pred_sequential(filtered, flow)
        s.visualize_gt_sequential(filtered, gt)
        s.visualize_flows(flow, gt)
        s.visualize_one_batch_warp(filtered)
        s.visualize_one_batch_warp(filtered, warp=flow)
        s.visualize_one_batch_warp_gt(filtered, gt.transpose(1, 2, 0))
        assert s.sequential_video_list == [
            "original", "original_filter", "pred_flow", "pred_flow_poisson",
            "pred_masked", "gt_flow", "gt_flow_poisson", "gt_masked"]
    files = sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert "pred_flow0.npy" in files and "image3.png" in files
    for name in files:
        if name.endswith(".mp4"):  # streams still open: no video yet
            continue
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(tmp_path / "torch" / name),
                                          np.load(tmp_path / "jax" / name))
            continue
        a, b = (cv2.imread(str(tmp_path / t / name), cv2.IMREAD_UNCHANGED)
                for t in ("torch", "jax"))
        diff = np.abs(a.astype(int) - b.astype(int)).max()
        assert diff <= (1 if "poisson" in name else 0), (name, diff)


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    cfg = _config()
    d = cfg["data"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.collections["patch_eklt_pyramid2"](
            (d["height"], d["width"]), (d["crop_height"], d["crop_width"]),
            solver_config=cfg["solver"])
