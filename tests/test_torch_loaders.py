"""Parity of the port's E2VID and HELIUM loaders (``data/e2vid.py``,
``data/helium.py``) and of ``model_image: e2vid`` with the JAX package's.

The sequences are written under ``tmp_path`` from the port's synthetic
generator (frames as 8-bit PNGs or TIFs, ``timestamps.txt``, an
``events.csv`` of rows ``x,y,p,t``).  Tolerances: the loaders bit for bit
(images, times, indices, lengths); the pyramid facade with ``model_image:
e2vid`` within 1e-6 px of JAX's (float64 solves, float32 fetch, one
pinned init), and bit for bit equal to the port's own ``model_image:
current`` solve fed the decoded PNG.
"""

import copy

import numpy as np
import pytest

import cv2
import event_based_bos_tpu.data as jdata
import event_based_bos_tpu.solver.facades as jfacades
import event_based_bos_tpu.utils.config as jconfig
import event_based_bos_tpu_torch.solver.facades as tfacades
from event_based_bos_tpu_torch import data as tdata
from event_based_bos_tpu_torch.utils.config import propagate_config
from torch_parity import (CPU, inject_init, pyramid_init, small_config,
                          small_scene, torch_threads)

H, W = 64, 96


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def write_e2vid_sequence(root, n_frames=5, seed=0):
    """``root/E2VID/seq``: ``n_frames`` PNG reconstructions (the
    synthetic scene's frame, shifted a little each time), their times at
    30 fps from 0.01 s, and an events CSV.  Returns the frames."""
    events, frame, _gt = small_scene(seed=seed)
    d = root / "E2VID" / "seq"
    d.mkdir(parents=True)
    frames = [np.roll(frame, i, axis=1).astype(np.uint8)
              for i in range(n_frames)]
    for i, f in enumerate(frames):
        assert cv2.imwrite(str(d / f"frame_{i:010d}.png"), f)
    np.savetxt(d / "timestamps.txt", 0.01 + np.arange(n_frames) / 30.0)
    with open(d / "events.csv", "w") as f:
        for x, y, t, p in events[:300]:
            f.write(f"{int(y)},{int(x)},{int(p > 0)},{t:.9f}\n")
    return frames


def write_helium_sequence(root, n_frames=3):
    d = root / "HELIUM" / "seq"
    d.mkdir(parents=True)
    rng = np.random.default_rng(1)
    for i in range(n_frames):
        img = rng.integers(0, 256, (H, W)).astype(np.uint8)
        assert cv2.imwrite(str(d / f"img_{i:04d}.tif"), img)
    bg = rng.integers(0, 256, (H, W)).astype(np.uint8)
    assert cv2.imwrite(str(d / "zz_background.tif"), bg)


def _loaders(name, root):
    cfg = {"root": str(root), "height": H, "width": W}
    out = []
    for pkg in (tdata, jdata):
        loader = pkg.collections[name](config=dict(cfg))
        loader.set_sequence("seq")
        out.append(loader)
    return out


def test_e2vid_loader_matches_jax(tmp_path):
    frames = write_e2vid_sequence(tmp_path)
    t, j = _loaders("E2VID", tmp_path)
    assert type(t).__name__ == type(j).__name__ == "E2vidDataLoader"
    assert len(t) == len(j) == 299 and t.num_images == j.num_images == 5
    for time in (0.0, 0.01, 0.02, 0.05, 0.2):
        assert t.time_to_index(time) == j.time_to_index(time)
        assert t.time_to_image_index(time) == j.time_to_image_index(time)
    for i in range(5):
        (ti, tt), (ji, jt) = t.load_image(i), j.load_image(i)
        assert np.array_equal(ti, ji) and np.array_equal(ti, frames[i])
        assert tt == jt == t.image_index_to_time(i)
    assert t.load_calib() == j.load_calib()
    with pytest.raises(IndexError):
        t.load_image(5)


def test_helium_loader_matches_jax(tmp_path):
    write_helium_sequence(tmp_path)
    t, j = _loaders("HELIUM", tmp_path)
    assert len(t) == len(j) == t.num_images == 3
    for i in range(4):
        (ti, tt), (ji, jt) = t.load_image(i), j.load_image(i)
        assert np.array_equal(ti, ji) and tt == jt
    assert t.time_to_image_index(0.0025) == j.time_to_image_index(0.0025)
    assert t.image_index_to_time(2) == j.image_index_to_time(2)
    with pytest.raises(NotImplementedError):
        t.load_event(0, 10)


def _e2vid_config(root, model_image="e2vid"):
    cfg = small_config()
    cfg["solver"]["generative_ml"]["model_image"] = model_image
    if model_image == "e2vid":
        cfg["solver"]["generative_ml"]["e2vid"] = {
            "root": str(root), "dataset": "E2VID", "sequence": "seq"}
    want = copy.deepcopy(cfg)
    propagate_config(cfg)
    jconfig.propagate_config(want)
    assert cfg == want
    return cfg


def _facade(cfg, package):
    args = ((H, W), (cfg["data"]["crop_height"], cfg["data"]["crop_width"]))
    kw = dict(solver_config=copy.deepcopy(cfg["solver"]),
              visualize_module=None)
    if package == "torch":
        return tfacades.collections[cfg["solver"]["method"]](
            *args, device=CPU, **kw)
    return jfacades.collections[cfg["solver"]["method"]](*args, **kw)


def test_model_image_e2vid_matches_jax_and_the_current_frame(
        tmp_path, monkeypatch):
    """The pyramid facade with ``model_image: e2vid`` over two frames, the
    reconstruction looked up by ``frame_time``: JAX's flows within 1e-6
    px; the port's equal bit for bit its ``model_image: current`` solve fed
    the same decoded PNG."""
    frames = write_e2vid_sequence(tmp_path)
    cfg = _e2vid_config(tmp_path)
    init = pyramid_init(cfg)
    inject_init(monkeypatch, tfacades, init)
    inject_init(monkeypatch, jfacades, init)
    events, frame, _gt = small_scene()
    tsolv, jsolv = _facade(cfg, "torch"), _facade(cfg, "jax")
    csolv = _facade(_e2vid_config(tmp_path, "current"), "torch")
    for k, frame_time in enumerate((0.02, 0.05)):
        window = events[k * 900:(k + 1) * 900]
        got = tsolv.estimate(tsolv.preprocess(window)[0], frame=frame,
                             frame_time=frame_time)
        want = jsolv.estimate(jsolv.preprocess(window)[0], frame=frame,
                              frame_time=frame_time)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        index = int(np.searchsorted(0.01 + np.arange(5) / 30.0,
                                    frame_time)) - 1
        same = csolv.estimate(csolv.preprocess(window)[0],
                              frame=frames[index])
        assert np.array_equal(got, same) and np.abs(got).max() > 0


def test_e2vid_frame_priority_matches_jax(tmp_path, caplog):
    """An explicit ``e2vid_frame`` wins; then the loader's image at
    ``frame_time``, else at the dispatch count; without a loader
    ``frame`` with a warning; with nothing a ``ValueError``."""
    frames = write_e2vid_sequence(tmp_path)
    explicit = np.full((H, W), 7.0)
    other = np.full((H, W), 3.0)
    for package in ("torch", "jax"):
        solv = _facade(_e2vid_config(tmp_path), package)
        got = solv._model_frame({"e2vid_frame": explicit, "frame": other,
                                 "frame_time": 0.05})
        assert np.array_equal(got, explicit)
        assert np.array_equal(solv._model_frame({"frame_time": 0.05}),
                              frames[1])
        solv.dispatch_cnt = 3
        assert np.array_equal(solv._model_frame({"frame": other}),
                              frames[3])
        bare = _e2vid_config(tmp_path)
        del bare["solver"]["generative_ml"]["e2vid"]
        solv = _facade(bare, package)
        caplog.clear()
        assert np.array_equal(solv._model_frame({"frame": other}), other)
        assert any("e2vid" in r.getMessage() for r in caplog.records)
        with pytest.raises(ValueError, match="e2vid"):
            solv._model_frame({})
