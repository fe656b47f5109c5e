"""The visualizing loop's pieces of the port against the JAX package's.

Every input is made with numpy from a seed and handed to both packages;
the port runs on the CPU, the JAX package on its CPU backend (x64 on).

Tolerances:

* ``poisson_reconstruct``: ≤ 1e-9 absolute in float64, ≤ 1e-4 relative in
  float32 (the matmuls sum in another order);
* the render bundle (``solver/programs.py::render_bundle``) against
  ``programs.jit_render_bundle``: the clipped IWE and the event mask bit
  for bit; the uint8 Poisson views within 1 LSB; the uint8 hue plane
  within 1 LSB on at most 0.1 % of the pixels; the float16 magnitude plane
  within one float16 step; the error dicts within 1e-6 relative (NaN where
  JAX has NaN);
* every ``Visualizer`` method: the same file names as the JAX class, and
  decoded pixels equal where both render on the host (the Poisson view,
  made on the device, within 1 LSB);
* the two-step Farnebäck GT: its uint8 Poisson views within 1 LSB on at
  most 0.1 % of the pixels, and the two-step flow within 0.05 px (a view
  pixel one LSB off moves Farnebäck's polynomial fit a little).
"""

import logging
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_based_bos_tpu.frame_flow as jframe_flow
import event_based_bos_tpu.solver.facades as jfacades
import event_based_bos_tpu.solver.programs as jprograms
import event_based_bos_tpu.utils.config as jconfig
import event_based_bos_tpu.visualizer as jviz
import event_based_bos_tpu_torch.frame_flow as tframe_flow
import event_based_bos_tpu_torch.solver.facades as tfacades
import event_based_bos_tpu_torch.visualizer as tviz
from event_based_bos_tpu.ops import image_warp as jwarp
from event_based_bos_tpu.ops import poisson as jpoisson
from event_based_bos_tpu_torch import data as tdata
from event_based_bos_tpu_torch.ops import image_warp as twarp
from event_based_bos_tpu_torch.ops import poisson as tpoisson
from event_based_bos_tpu_torch.solver import programs as tprograms
from event_based_bos_tpu_torch.utils.config import propagate_config
from torch_parity import (CPU, both_events, inject_init, np_of, pyramid_init,
                          rand_event_fields, small_config, torch_threads)

cv2 = pytest.importorskip("cv2")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


# -- Poisson integration and the display normalisations ----------------------

@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-9), (np.float32, 1e-4)],
                         ids=["float64", "float32"])
def test_poisson_reconstruct_matches_jax(dtype, tol):
    rng = np.random.default_rng(0)
    gy, gx, b = (rng.normal(size=(40, 56)).astype(dtype) for _ in range(3))
    want = np.asarray(jpoisson.poisson_reconstruct(
        jnp.asarray(gy), jnp.asarray(gx), jnp.asarray(b)))
    got = tpoisson.poisson_reconstruct(torch.as_tensor(gy),
                                       torch.as_tensor(gx),
                                       torch.as_tensor(b)).numpy()
    assert got.dtype == want.dtype
    err = np.abs(got - want).max()
    if dtype == np.float64:
        assert err <= tol, err
    else:
        assert err <= tol * np.abs(want).max(), err
    # the boundary stays, the input is not written
    np.testing.assert_array_equal(got[0], b[0])
    flow = rng.normal(size=(2, 40, 56)).astype(dtype)
    np.testing.assert_allclose(
        tpoisson.poisson_integrate_flow(torch.as_tensor(flow)).numpy(),
        np.asarray(jpoisson.poisson_integrate_flow(jnp.asarray(flow))),
        rtol=0, atol=tol * (1 if dtype == np.float64 else 10))


def test_dst2_matrix_is_cached_and_matches_jax():
    a = tpoisson.dst2_matrix(37, torch.float64, "cpu")
    assert a is tpoisson.dst2_matrix(37, torch.float64, torch.device("cpu"))
    np.testing.assert_array_equal(
        a.numpy(), np.asarray(jpoisson.dst2_matrix(37, jnp.float64)))
    # orthonormal: D⁻¹ = Dᵀ
    np.testing.assert_allclose(a.numpy() @ a.numpy().T, np.eye(37),
                               atol=1e-12)
    assert tpoisson.dst2_matrix(37).dtype == torch.float32


@pytest.mark.parametrize("name,kwargs", [
    ("standardize_image_minmax", {}),
    ("standardize_image_minmax", {"new_min": -1.0, "new_max": 1.0}),
    ("standardize_image_center", {}),
    ("range_norm", {}),
    ("range_norm", {"lower": -0.25, "upper": 0.25}),
], ids=["minmax", "minmax_range", "center", "range", "range_bounds"])
def test_display_normalisations_match_jax(name, kwargs):
    x = np.random.default_rng(1).normal(size=(9, 13)) * 0.3
    got = getattr(twarp, name)(torch.as_tensor(x), **kwargs).numpy()
    want = np.asarray(getattr(jwarp, name)(jnp.asarray(x), **kwargs))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_poisson_view_matches_the_jax_visualizer():
    rng = np.random.default_rng(2)
    flow = rng.normal(size=(2, 60, 80))
    got = tviz._poisson_view(flow[1], flow[0], "cpu")
    want = np.asarray(jviz._poisson_view(flow[1], flow[0]))
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and np.mean(diff > 0) <= 1e-3


# -- the render bundle ---------------------------------------------------------

BH, BW = 48, 64
CROP = (4, 44, 8, 56)


def _assert_bundle_close(got, want):
    """``got``/``want``: dicts of numpy planes (``errors``: dict pairs)."""
    np.testing.assert_array_equal(got["clipped"], want["clipped"])
    assert got["clipped"].dtype == want["clipped"].dtype == np.uint8
    np.testing.assert_array_equal(got["mask"], want["mask"])
    assert got["mask"].dtype == bool
    for k in ("poisson_est", "poisson_gt"):
        assert got[k].dtype == np.uint8 and got[k].shape == want[k].shape
        assert np.abs(got[k].astype(int) - want[k].astype(int)).max() <= 1, k
    for k in ("polar_est", "polar_gt"):
        (ga, gm), (wa, wm) = got[k], want[k]
        assert ga.dtype == wa.dtype == np.uint8
        assert gm.dtype == wm.dtype == np.float16
        dang = np.abs(ga.astype(int) - wa.astype(int))
        assert dang.max() <= 1 and np.mean(dang > 0) <= 1e-3, k
        np.testing.assert_allclose(gm.astype(np.float32),
                                   wm.astype(np.float32), rtol=2.0 ** -10,
                                   atol=2.0 ** -24, err_msg=k)
    assert ("errors" in got) == ("errors" in want)
    for g, w in zip(got.get("errors", ()), want.get("errors", ())):
        assert sorted(g) == sorted(w)
        for key in w:
            gv, wv = float(g[key]), float(w[key])
            if np.isnan(wv):
                assert np.isnan(gv), key
            else:
                assert abs(gv - wv) <= 1e-6 * abs(wv) + 1e-12, (key, gv, wv)


def _bundle_inputs(case):
    rng = np.random.default_rng(5)
    fields = rand_event_fields(3000, BH, BW, rng)
    keep = np.ones(3000, bool) if case != "invalid" else np.zeros(3000, bool)
    est = np.zeros((2, BH, BW), np.float32)
    est[:, 2:46, 6:60] = rng.normal(0, 1.5, (2, 44, 54))
    gt = np.zeros((2, BH, BW))
    gt[:, CROP[0]:CROP[1], CROP[2]:CROP[3]] = rng.normal(0, 1.0, (2, 40, 48))
    if case == "nan":
        est[:, 10, 12] = np.nan
        gt[1, 20, 30] = np.inf
    return both_events(fields, keep=keep), est, gt


@pytest.mark.parametrize("case,sign,err_crop", [
    ("plain", 1.0, None), ("plain", -1.0, None),
    ("plain", 1.0, CROP), ("plain", -1.0, CROP),
    ("nan", -1.0, CROP), ("invalid", 1.0, CROP),
], ids=["reference", "physical", "reference_errors", "physical_errors",
        "nan_flow", "all_invalid"])
def test_render_bundle_matches_jax(case, sign, err_crop):
    (jev, tev), est, gt = _bundle_inputs(case)
    sc, err_sc = 1.7 * sign, sign
    out = jprograms.jit_render_bundle((BH, BW), err_crop)(
        jev, jnp.asarray(est), jnp.asarray(gt),
        jnp.asarray(50.0, jnp.float32), jnp.asarray(sc, jnp.float32),
        jnp.asarray(err_sc, jnp.float32))
    out = [np.asarray(a) if not isinstance(a, (tuple, dict)) else a
           for a in out]
    want = dict(zip(("clipped", "mask", "poisson_est", "poisson_gt"),
                    out[:4]))
    want["polar_est"] = tuple(np.asarray(a) for a in out[4])
    want["polar_gt"] = tuple(np.asarray(a) for a in out[5])
    if err_crop is not None:
        want["errors"] = tuple({k: float(v) for k, v in d.items()}
                               for d in out[6:8])
    t = tprograms.render_bundle(tev, torch.as_tensor(est),
                                torch.as_tensor(gt), (BH, BW), 50.0, sc,
                                err_sc, err_crop)
    got = {k: (tuple(np_of(a) for a in v) if k.startswith("polar") else
               np_of(v)) for k, v in t.items() if k != "errors"}
    if err_crop is not None:
        got["errors"] = tuple({k: float(v) for k, v in d.items()}
                              for d in t["errors"])
    _assert_bundle_close(got, want)
    if case == "invalid":
        assert not got["mask"].any() and (got["clipped"] == 255).all()
    if case == "nan":
        # the non-finite pixel is zeroed before the polar planes
        assert np.isfinite(got["polar_est"][1].astype(float)).all()
        assert got["polar_est"][1][10, 12] == 0


def _facades(convention):
    cfg = small_config(flow_convention=convention)
    propagate_config(cfg)
    d = cfg["data"]
    args = ((d["height"], d["width"]), (d["crop_height"], d["crop_width"]))
    cls = cfg["solver"]["method"]
    return (cfg, tfacades.collections[cls](*args, solver_config=dict(
        cfg["solver"]), visualize_module=None, device=CPU),
        jfacades.collections[cls](*args, solver_config=dict(cfg["solver"]),
                                  visualize_module=None))


@pytest.mark.parametrize("convention", ["reference", "physical"])
def test_facade_render_bundle_matches_jax_full_frame(convention):
    """The port's bundle is the full-frame planes that the JAX fetch
    rebuilds from its shrunk transfer (the ROI-box polar planes, the
    cropped GT, the bit-packed mask)."""
    cfg, tsolv, jsolv = _facades(convention)
    h, w = cfg["data"]["height"], cfg["data"]["width"]
    roi = tuple(cfg["common_params"][k] for k in ("xmin", "xmax", "ymin",
                                                  "ymax"))
    rng = np.random.default_rng(6)
    est = np.zeros((2, h, w))
    est[:, roi[0]:roi[1], roi[2]:roi[3]] = rng.normal(
        0, 1, (2, roi[1] - roi[0], roi[3] - roi[2]))
    gt = np.zeros((2, h, w))
    gt[:, 4:60, 20:76] = rng.normal(0, 1, (2, 56, 56))
    crop = (4, 60, 20, 76)
    events = np.stack([rng.integers(0, h, 2000), rng.integers(0, w, 2000),
                       np.sort(rng.uniform(0, 0.03, 2000)),
                       rng.integers(0, 2, 2000)], 1).astype(np.float64)
    want = jsolv.render_bundle_async(events, None, gt,
                                     est_device=jnp.asarray(est),
                                     est_scale=1.3, err_crop=crop)()
    got = tsolv.render_bundle_async(events, None, gt,
                                    est_device=torch.as_tensor(est),
                                    est_scale=1.3, err_crop=crop)()
    _assert_bundle_close(got, want)
    # the host-flow path: the scaled flow uploaded, the errors unscaled
    est_host = (tsolv._orient_flow(est.astype(np.float32)) * 1.3)
    want = jsolv.render_bundle(events, est_host, gt, est_scale=1.3,
                               err_crop=crop)
    got = tsolv.render_bundle(events, est_host, gt, est_scale=1.3,
                              err_crop=crop)
    _assert_bundle_close(got, want)


# -- the Visualizer ------------------------------------------------------------

VH, VW = 24, 32


def _viz_inputs():
    rng = np.random.default_rng(3)
    flow = rng.normal(size=(2, VH, VW))
    flow2 = 0.5 * rng.normal(size=(2, VH, VW))
    ev = np.stack([rng.integers(0, VH, 300), rng.integers(0, VW, 300),
                   np.sort(rng.uniform(0, 1, 300)),
                   rng.integers(0, 2, 300)], 1).astype(float)
    img = rng.integers(0, 256, (VH, VW)).astype(np.uint8)
    mask = rng.uniform(size=(1, VH, VW)) > 0.5

    def polar(f):
        ang = ((np.arctan2(f[1], f[0]) + np.pi) * 90 / np.pi).astype(np.uint8)
        return ang, np.sqrt(np.hypot(f[0], f[1])).astype(np.float16)

    return dict(flow=flow, flow2=flow2, ev=ev, img=img, mask=mask,
                polar=polar(flow), polar2=polar(flow2))


def _video(v, x):
    for i in range(4):
        v.visualize_image(x["img"] // (i + 1), "seq")
        v.visualize_image(x["img"][::-1] // (i + 1), "seq2")
    v.visualize_sequential_images_as_video("seq")
    v.visualize_sequential_images_as_video("seq2")
    v.concat_videos(["seq", "seq2"], "cat")


def _video_streamed(v, x):
    v.enable_video_stream("seq")
    _video(v, x)


def _history(v, x):
    v.visualize_scipy_history({"loss": np.linspace(1, 0, 50),
                               "diff_norm": np.linspace(2, 1, 50)})
    v.visualize_scipy_history({"loss": np.linspace(2, 0.5, 40),
                               "diff_norm": np.linspace(3, 1, 40)})
    v.visualize_scipy_history({"scale0": np.linspace(1, 0, 10)})
    v.visualize_optuna_history(np.random.default_rng(0).random(30))
    v.visualize_optuna_history(np.random.default_rng(1).random(20))


def _figures(v, x):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.plot(np.arange(5), np.arange(5) ** 2)
    v.visualize_plt_figure(fig, "fig")
    v.visualize_vector_field(x["flow"], step=4)


SCENARIOS = {
    "images": lambda v, x: (v.visualize_image(x["img"], "img"),
                            v.visualize_image(x["img"] * 1.5 - 20, "img"),
                            v.visualize_image(x["img"])),
    "flow_and_npy": lambda v, x: v.visualize_optical_flow(
        x["flow"][0], x["flow"][1], True, file_prefix="flow", save_flow=True),
    "flow_polar": lambda v, x: v.visualize_optical_flow(
        None, None, True, file_prefix="fp", polar=x["polar"]),
    "pred_and_gt": lambda v, x: v.visualize_optical_flow_pred_and_gt(
        x["flow"], x["flow2"], pred_file_prefix="p", gt_file_prefix="g"),
    "pred_and_gt_polar": lambda v, x: v.visualize_optical_flow_pred_and_gt(
        None, None, pred_file_prefix="p", gt_file_prefix="g",
        polar_pred=x["polar"], polar_gt=x["polar2"]),
    "overlay": lambda v, x: v.visualize_overlay_optical_flow_on_event(
        x["flow"], x["ev"], file_prefix="ovl"),
    "masked_mask_from_events": lambda v, x: (
        v.visualize_optical_flow_on_event_mask(x["flow"], x["ev"],
                                               file_prefix="m",
                                               mask_morph=True),
        v.visualize_optical_flow_on_event_mask(x["flow"], x["ev"],
                                               file_prefix="m",
                                               max_color_on_mask=False)),
    "masked_polar": lambda v, x: v.visualize_optical_flow_on_event_mask(
        x["flow"], None, file_prefix="mp", mask_color="black",
        mask_morph=True, mask=x["mask"], polar=x["polar"]),
    "poisson": lambda v, x: v.visualize_poisson_integration(
        x["flow"], file_prefix="poi"),
    "events": lambda v, x: (
        v.visualize_event(x["ev"], file_prefix="ev"),
        v.visualize_event(x["ev"], grayscale=False, file_prefix="evc"),
        v.visualize_event(x["ev"], ignore_polarity=True, file_prefix="evi"),
        v.visualize_event(np.zeros((0, 4)), file_prefix="eve")),
    "save_array": lambda v, x: (
        v.save_array(np.arange(6.0), file_prefix="arr", new_prefix=True),
        v.save_array(x["flow"], file_prefix="arr")),
    "frame_index_pinning": lambda v, x: (
        v.set_frame_index(5), v.visualize_image(x["img"], "pin"),
        v.visualize_poisson_integration(x["flow"], file_prefix="pinp"),
        v.set_frame_index(None), v.visualize_image(x["img"], "pin")),
    "video_rebuilt": _video,
    "video_streamed": _video_streamed,
    "history_plots": _history,
    "figures": _figures,
}


def _decoded(path):
    if path.suffix == ".png":
        return [cv2.imread(str(path), cv2.IMREAD_UNCHANGED)]
    if path.suffix == ".npy":
        return [np.load(path)]
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        frames.append(fr)
    cap.release()
    return frames


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_visualizer_methods_match_jax(tmp_path, scenario):
    x = _viz_inputs()
    dirs = {}
    for tag, cls, kw in (("torch", tviz.Visualizer, {"device": CPU}),
                         ("jax", jviz.Visualizer, {})):
        d = tmp_path / tag
        v = cls((VH, VW), save=True, show=False, save_dir=str(d),
                async_writes=True, **kw)
        SCENARIOS[scenario](v, x)
        v.flush()
        dirs[tag] = d
    names = sorted(p.name for p in dirs["torch"].iterdir())
    assert names == sorted(p.name for p in dirs["jax"].iterdir())
    assert names, "nothing written"
    for name in names:
        got = _decoded(dirs["torch"] / name)
        want = _decoded(dirs["jax"] / name)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert g.shape == w.shape, name
            diff = np.abs(g.astype(float) - w.astype(float)).max()
            # the Poisson view is made on the device: 1 LSB
            assert diff <= (1 if "poi" in name or "pinp" in name else 0), \
                (name, diff)


def test_history_plots_without_matplotlib(tmp_path, monkeypatch, caplog):
    """Where matplotlib cannot be imported the history plots log one
    warning per Visualizer, write nothing, and ``flush`` does not raise
    (the JAX class would fail on its writer thread there)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    v = tviz.Visualizer((VH, VW), save=True, save_dir=str(tmp_path),
                        async_writes=True, device=CPU)
    with caplog.at_level(logging.WARNING, logger=tviz.__name__):
        v.visualize_scipy_history({"loss": np.linspace(1, 0, 10)})
        v.visualize_scipy_history({"loss": np.linspace(1, 0, 10)})
        v.visualize_optuna_history(np.arange(5.0))
        v.visualize_plt_figure(object())
        v.visualize_image(np.zeros((VH, VW), np.uint8), "img")
        v.flush()
    warned = [r for r in caplog.records if "matplotlib" in r.getMessage()]
    assert len(warned) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == ["img0.png"]
    # the counters did not move: a later plot would start at 0
    assert "optimization_steps" not in v.prefixed_save_count


def test_visualizer_defaults_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tviz.Visualizer((VH, VW), save_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tframe_flow.FrameFlowEstimator(None)


# -- the two-step GT and the evolution videos ---------------------------------

def _frames(cfg):
    from event_based_bos_tpu_torch.cli import validate_image

    loader = tdata.collections["SYNTHETIC"](config=cfg["data"])
    loader.set_sequence(cfg["data"]["sequence"])
    return [validate_image(loader.load_image(i)[0], cfg["common_params"])
            for i in (0, 1, 2)]


@pytest.mark.parametrize("convention", ["reference", "physical"])
def test_two_step_gt_matches_jax(convention):
    cfg = small_config()
    propagate_config(cfg)
    f0, f1, f2 = _frames(cfg)
    pc = cfg["params_opencv_flow"]
    t = tframe_flow.FrameFlowEstimator(None, convention, device=CPU)
    j = jframe_flow.FrameFlowEstimator(None, convention)
    got = t.estimate("opencv_flow_two_steps", f0, f1, f2, cfg)
    want = j.estimate("opencv_flow_two_steps", f0, f1, f2, cfg)
    assert got.shape == want.shape == (2, 64, 96)
    assert np.abs(got - want).max() <= 0.05
    # the uint8 Poisson views of the padded one-step flows
    for frame in (f1, f2):
        f = tframe_flow._pad_flow(tframe_flow.bos_optical_flow(
            f0, frame, pc).transpose(2, 0, 1), pc)
        a = tviz._poisson_view(f[1], f[0], CPU).astype(int)
        b = np.asarray(jviz._poisson_view(f[1], f[0])).astype(int)
        assert np.abs(a - b).max() <= 1 and np.mean(a != b) <= 1e-3


def test_pyramid_evolution_matches_jax(tmp_path, monkeypatch):
    """``record_evolution: 4`` with a visualizer: the loss curves and the
    per-call evolution frames and videos, against the JAX facade's."""
    cfg = small_config(record_evolution=4)
    cfg["solver"]["record_evolution"] = 4
    cfg["solver"]["optimizer"]["n_iter"] = 8
    propagate_config(cfg)
    jcfg = small_config()
    jcfg["solver"].update(record_evolution=4)
    jcfg["solver"]["optimizer"]["n_iter"] = 8
    jconfig.propagate_config(jcfg)
    init = pyramid_init(cfg)
    inject_init(monkeypatch, tfacades, init)
    inject_init(monkeypatch, jfacades, init)
    loader = tdata.collections["SYNTHETIC"](config=cfg["data"])
    loader.set_sequence(cfg["data"]["sequence"])
    im1, t1 = loader.load_image(1)
    _im2, t2 = loader.load_image(2)
    ev = loader.load_event(loader.time_to_index(t1), loader.time_to_index(t2))
    d = cfg["data"]
    args = ((d["height"], d["width"]), (d["crop_height"], d["crop_width"]))
    out = {}
    for tag, facades, kw, vcls, vkw in (
            ("torch", tfacades, {"device": CPU}, tviz.Visualizer,
             {"device": CPU}),
            ("jax", jfacades, {}, jviz.Visualizer, {})):
        viz = vcls(args[0], save=True, save_dir=str(tmp_path / tag), **vkw)
        solv = facades.collections[cfg["solver"]["method"]](
            *args, solver_config=dict(cfg["solver"]), visualize_module=viz,
            **kw)
        filtered, _ = solv.preprocess(ev)
        out[tag] = solv.estimate(filtered, frame=im1)
        viz.flush()
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=0, atol=1e-6)
    files = {tag: sorted(str(p.relative_to(tmp_path / tag))
                         for p in (tmp_path / tag).rglob("*") if p.is_file())
             for tag in out}
    assert files["torch"] == files["jax"]
    # the first call's evolution frames, in its numbered subdirectory
    assert ("0", "opt_prediction0.png") in {
        tuple(f.split(os.sep)) for f in files["torch"]}
    assert "optimization_steps0.png" in files["torch"]
    for name in files["torch"]:
        g = _decoded(tmp_path / "torch" / name)
        w = _decoded(tmp_path / "jax" / name)
        assert len(g) == len(w), name
        for a, b in zip(g, w):
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, name
