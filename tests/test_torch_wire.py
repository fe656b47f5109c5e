"""The port's quantized wire (``types.encode_wire_events`` /
``decode_wire_events``, ``solver/wire.py``) against the JAX package's.

The batches are ``tests/test_wire.py``'s.  The encoder returns the same
dict (keys, dtypes, values) for every case; the decode on the CPU equals
JAX's bit for bit in float32 and in float64.  The facade cases hold the
upload policy to JAX's: the default upload is the direct upload bit for
bit, the quantized pyramid the float32 one, the float16 fetch within
half-precision rounding (relative 2⁻¹¹ plus one float16 ulp at 0), the
errors and warnings the same.  The CLI case holds a serving run with
``quantized_upload: true`` and ``flow_fetch_dtype: float16`` to the port's
float32 run and to the JAX CLI's float16 run within the JAX package's
bound (``tests/test_pipeline_e2e.py::test_serving_f16_error_text_bound``):
2e-3 px for the continuous metrics, 0.05 for the nPE percentages.
"""

import copy
import logging
import pathlib

import numpy as np
import pytest
import torch
import yaml

import event_based_bos_tpu.cli as jcli
import event_based_bos_tpu.solver.facades as jfacades
import event_based_bos_tpu.types as jtypes
import event_based_bos_tpu_torch.cli as tcli
import event_based_bos_tpu_torch.solver.facades as tfacades
import event_based_bos_tpu_torch.solver.wire as twire
import event_based_bos_tpu_torch.types as ttypes
from event_based_bos_tpu.solver import collections as jcollections
from event_based_bos_tpu_torch.solver import collections as tcollections
from event_based_bos_tpu_torch.utils import read_flow_error_text
from reference_harness import synthetic_scene
from torch_parity import (inject_init, np_of, pyramid_init, small_config,
                          torch_threads)

H, W = 64, 96
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    with torch_threads(2):
        yield


def _batch(n=5000, frac=1.0):
    """``tests/test_wire.py``'s batch."""
    rng = np.random.default_rng(0)
    x = np.floor(rng.uniform(0, H, n) * frac) / frac
    y = np.floor(rng.uniform(0, W, n) * frac) / frac
    t = np.sort(np.rint(rng.uniform(0, 0.01, n) * 1e6)) / 1e6  # µs-aligned
    p = rng.choice([-1.0, 1.0], n)
    return np.stack([x, y, t, p], axis=1)


def _case(name):
    """``(events, encoder kwargs)`` of each encoder case."""
    arr = _batch()
    kw = {}
    if name == "round_t":
        arr[:, 2] += np.random.default_rng(1).uniform(0, 1e-6, len(arr))
        kw = {"mode": "round"}
    elif name == "round_coords":
        rng = np.random.default_rng(2)
        arr[:, 0] = rng.uniform(0, H - 1, len(arr))
        arr[:, 1] = rng.uniform(0, W - 1, len(arr))
        kw = {"mode": "round"}
    elif name == "mixed_t":
        arr[:, 2] = np.sort(np.random.default_rng(7).uniform(0, 0.008,
                                                            len(arr)))
    elif name == "huge_window":
        arr[-1, 2] += 4000.0
    elif name == "huge_window_round":
        arr[-1, 2] += 4000.0
        kw = {"mode": "round"}
    elif name == "t_bitwise":
        kw = {"t_bitwise": True}
    elif name == "tless":
        kw = {"include_t": False}
    elif name == "tless_nan_t":
        arr[7, 2] = np.nan
        kw = {"include_t": False}
    elif name.startswith("nan"):
        arr[7, int(name[-1])] = np.nan
        kw = {"mode": "round"} if "round" in name else {}
    elif name == "out_of_range":
        arr[0, 0] = 3000.0
    elif name == "negative":
        arr[0, 0] = -1.0
        kw = {"mode": "round"}
    elif name == "empty":
        arr = np.zeros((0, 4))
    elif name == "zero_one_polarity":
        arr[:, 3] = (arr[:, 3] > 0).astype(np.float64)
    elif name == "sub32":
        arr[3, 0] += 0.01
    elif name == "one_ulp_off":
        arr[7, 0] = float(np.nextafter(np.float32(100.0), np.float32(200.0)))
    elif name == "subpixel_32nd":
        arr = _batch(frac=32.0)
    elif name == "fractional_polarity":
        arr[3, 3] = 0.5
    elif name == "polarity_range_round":
        arr[3, 3] = 200.0
        kw = {"mode": "round"}
    return arr, kw


CASES = ["exact", "round_t", "round_coords", "mixed_t", "huge_window",
         "huge_window_round", "t_bitwise", "tless", "tless_nan_t", "nan0",
         "nan1", "nan2", "nan3", "nan_round1", "out_of_range", "negative",
         "empty", "zero_one_polarity", "sub32", "one_ulp_off",
         "subpixel_32nd", "fractional_polarity", "polarity_range_round"]
REFUSED = {"huge_window_round", "nan0", "nan1", "nan2", "nan3",
           "nan_round1", "out_of_range", "negative", "sub32", "one_ulp_off",
           "fractional_polarity", "polarity_range_round"}


@pytest.mark.parametrize("name", CASES)
def test_encoder_matches_jax(name):
    arr, kw = _case(name)
    cap = 8192
    got = ttypes.encode_wire_events(arr, cap, **kw)
    want = jtypes.encode_wire_events(arr, cap, **kw)
    assert (got is None) == (want is None) == (name in REFUSED)
    if want is None:
        return
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


def test_encoder_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown wire mode"):
        ttypes.encode_wire_events(_batch(), 8192, mode="lossy")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(set(CASES) - REFUSED))
def test_decode_matches_jax(name, dtype):
    """Every field and the validity mask bit for bit (JAX's decode run as
    its own tests run it, op by op)."""
    arr, kw = _case(name)
    wire = ttypes.encode_wire_events(arr, 8192, **kw)
    got = ttypes.decode_wire_events(wire, dtype=getattr(torch, dtype),
                                    device=CPU)
    want = jtypes.decode_wire_events(wire, dtype=np.dtype(dtype))
    for f, g, w in zip(ttypes.Events._fields, got, want):
        g, w = np_of(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert g.tobytes() == w.tobytes(), f


def test_decode_rebuilds_the_direct_upload():
    """Integer coordinates: x, y, p and valid equal the direct float32
    upload's; the t-less wire carries 5 B/event."""
    arr = _batch()
    ref = ttypes.events_from_ndarray(arr, capacity=8192, device=CPU)
    ev = ttypes.decode_wire_events(ttypes.encode_wire_events(arr, 8192),
                                   device=CPU)
    for a, b in ((ev.x, ref.x), (ev.y, ref.y), (ev.p, ref.p),
                 (ev.valid, ref.valid)):
        assert torch.equal(a, b)
    tless = ttypes.encode_wire_events(arr, 8192, include_t=False)
    assert ttypes.wire_nbytes(tless) == 8192 * 5 + 4


def test_decode_without_a_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttypes.decode_wire_events(ttypes.encode_wire_events(_batch(), 8192))


# ---------------------------------------------------------------------------
# The facades' upload policy
# ---------------------------------------------------------------------------

CFG = {"method": "patch_eklt_pyramid2", "outer_padding": 0,
       "cost_with_weight": {"diff_norm": 1.0, "image_gradient": 0.5},
       "optimizer": {"method": "Adam", "n_iter": 16},
       "generative_ml": {"weight_loss_by_event_hist": False,
                         "weight_sigma": 5,
                         "weight_loss_by_inverse_event_hist": True,
                         "optimize_warp": False, "iwe_sigma": 2,
                         "viz_diff_scale": [-0.25, 0.25],
                         "no_polarity": False, "model_image": "current",
                         "use_log_intensity": False, "poisson_model": True},
       "patch_eklt": {"patch_size": 4, "sliding_window": 2,
                      "do_event_thresholding": False, "event_thres": 8,
                      "coarsest_patch_size": 16, "finest_patch_size": 8}}
FILTER = {"filters": None,
          "parameters": {"xmin": 0, "xmax": H, "ymin": 0, "ymax": W}}


def _port(extra=None, method="patch_eklt_pyramid2", base=CFG):
    cfg = dict(copy.deepcopy(base), **(extra or {}))
    return tcollections[method]((H, W), (H, W), {}, cfg, None, device=CPU)


def _jax(extra=None, method="patch_eklt_pyramid2", base=CFG):
    cfg = dict(copy.deepcopy(base), **(extra or {}))
    return jcollections[method]((H, W), (H, W), {}, cfg, None)


def _init():
    """A coarsest-scale init of ``CFG``'s pyramid (the poisson base alone,
    on the 4×6 grid of 16-px patches)."""
    return np.random.default_rng(4).uniform(-1, 1, (1, 4, 6))


def _scene(continuous_t=False):
    i1, _, events = synthetic_scene(H, W, du=(1.5, -0.8), n=20000)
    events = np.array(events)
    if continuous_t:
        rng = np.random.default_rng(3)
        events[:, 2] = np.sort(rng.uniform(0.0, 0.008, len(events)))
    return np.asarray(i1), events


def test_default_upload_is_the_direct_upload(monkeypatch):
    """No ``quantized_upload`` key: the exact wire with the bit-for-bit t
    tier, equal to the direct upload and to JAX's default upload."""
    calls = []
    real = twire.encode_wire_events

    def spy(events, capacity, include_t=True, mode="exact",
            t_bitwise=False):
        calls.append((mode, t_bitwise))
        return real(events, capacity, include_t=include_t, mode=mode,
                    t_bitwise=t_bitwise)

    monkeypatch.setattr(twire, "encode_wire_events", spy)
    solv = _port()
    assert solv._wire_opportunistic and not solv.wire_quantized
    arr = _scene(continuous_t=True)[1]
    ev = solv._to_events(arr)
    assert calls == [("exact", True)]
    ref = ttypes.events_from_ndarray(arr, capacity=ev.capacity, device=CPU)
    jev = _jax()._to_events(arr)
    for a, b, c in zip(ev, ref, jev):
        assert np_of(a).tobytes() == np_of(b).tobytes() == \
            np.asarray(c).tobytes()


def test_direct_opts_out(monkeypatch):
    def boom(*a, **k):  # pragma: no cover - assertion helper
        raise AssertionError("wire encode must not run under 'direct'")

    monkeypatch.setattr(twire, "encode_wire_events", boom)
    solv = _port({"quantized_upload": "direct"})
    assert not solv._wire_opportunistic and solv.wire_mode is None
    solv._to_events(_batch())


@pytest.mark.parametrize("qu,warns", [(None, False), (True, True)])
def test_refused_batch_uploads_directly(caplog, qu, warns):
    """A batch off the 1/32-px grid uploads float32: silently by default,
    with one warning under ``quantized_upload: true`` (both as JAX)."""
    arr = _batch()
    arr[3, 0] += 0.01
    extra = {} if qu is None else {"quantized_upload": qu}
    solv, jsolv = _port(extra), _jax(extra)
    with caplog.at_level(logging.WARNING):
        ev = solv._to_events(arr)
        solv._to_events(arr)
        jsolv._to_events(arr)
    assert solv._wire_fell_back == jsolv._wire_fell_back == warns
    assert sum("quantized_upload" in r.getMessage()
               for r in caplog.records) == (2 if warns else 0)
    ref = ttypes.events_from_ndarray(arr, capacity=8192, device=CPU)
    assert torch.equal(ev.x, ref.x)


@pytest.mark.parametrize("qu", [True, "exact", "round"])
def test_quantized_pyramid_matches_float32(qu):
    """The quantized (t-less) upload gives the float32 upload's flow bit
    for bit on an integer-coordinate stream with continuous timestamps."""
    frame, events = _scene(continuous_t=True)
    cfg = dict(CFG, filter=FILTER)
    ref = _port(base=cfg).estimate(events, None, frame=frame)
    q = _port({"quantized_upload": qu}, base=cfg)
    assert q.wire_quantized and q.wire_mode == ("round" if qu == "round"
                                                else "exact")
    assert np.array_equal(q.estimate(events, None, frame=frame), ref)
    assert not q._wire_fell_back


def test_round_wire_float64_matches_jax(monkeypatch):
    """``quantized_upload: round`` keeps the wire at ``precision: 64``
    (decoded in float64); the flow equals JAX's to 1e-10 from one
    injected init."""
    frame, events = _scene(continuous_t=True)
    cfg = dict(CFG, filter=FILTER, precision="64",
               quantized_upload="round")
    init = _init()
    inject_init(monkeypatch, tfacades, init)
    inject_init(monkeypatch, jfacades, init)
    port, jax_solv = _port(base=cfg), _jax(base=cfg)
    got = port.estimate(events, None, frame=frame)
    want = jax_solv.estimate(events, None, frame=frame)
    assert got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6 * max(np.abs(want).max(), 1)
    assert not port._wire_fell_back and not jax_solv._wire_fell_back


def _f16_close(got, want, dtype):
    """``got`` is ``want`` rounded to ``dtype``: relative 2⁻¹¹ (float16)
    or 2⁻⁸ (bfloat16) plus the dtype's smallest subnormal step at 0."""
    rel, tiny = ((2.0 ** -11, 2.0 ** -24) if dtype == "float16"
                 else (2.0 ** -8, 2.0 ** -133))
    return np.all(np.abs(got - want) <= rel * np.abs(want) + tiny)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_reduced_fetch_is_the_rounded_flow(monkeypatch, dtype):
    """The fetched flow is the float32 flow rounded to the fetch dtype
    (float32 on the host); against JAX's float16 fetch within its test's
    bound (relative 1.5e-3)."""
    frame, events = _scene()
    cfg = dict(CFG, filter=FILTER,
               optimizer={"method": "Adam", "n_iter": 24})
    ref = _port(base=cfg).estimate(events, None, frame=frame)
    solv = _port({"flow_fetch_dtype": dtype}, base=cfg)
    assert solv._fetch_dtype == getattr(torch, dtype)
    handle = solv.estimate_async(events, None, frame=frame)
    got = handle.result()
    assert got.dtype == np.float32
    assert handle.device_flow.dtype == getattr(torch, dtype)
    assert _f16_close(got, ref, dtype)
    if dtype == "float16":
        init = _init()
        inject_init(monkeypatch, tfacades, init)
        inject_init(monkeypatch, jfacades, init)
        a = _port({"flow_fetch_dtype": dtype}, base=cfg).estimate(
            events, None, frame=frame)
        b = _jax({"flow_fetch_dtype": dtype}, base=cfg).estimate(
            events, None, frame=frame)
        scale = np.maximum(np.abs(b), 1e-3)
        assert (np.abs(a - b) / scale).max() < 1.5e-3


GML = {"method": "generative_max_likelihood", "outer_padding": 0,
       "cost_with_weight": {"diff_norm": 1.0},
       "optimizer": {"method": "optuna", "sampler": "random", "n_iter": 4,
                     "parameters": {"v_x": {"min": -3, "max": 3},
                                    "v_y": {"min": -3, "max": 3}}},
       "generative_ml": dict(CFG["generative_ml"], poisson_model=False)}


@pytest.mark.parametrize("method,extra", [
    ("patch_eklt_pyramid2", {"flow_fetch_dtype": "fp16"}),
    ("patch_eklt_pyramid2", {"quantized_upload": "lossy"}),
    ("generative_max_likelihood", {"flow_fetch_dtype": "float16"}),
    ("generative_max_likelihood", {"flow_fetch_dtype": "bfloat16"}),
], ids=["fetch_typo", "mode_typo", "gml_float16", "gml_bfloat16"])
def test_invalid_wire_options_raise_as_jax(method, extra):
    base = CFG if method == "patch_eklt_pyramid2" else GML
    with pytest.raises(ValueError) as got:
        _port(extra, method, base)
    with pytest.raises(ValueError) as want:
        _jax(extra, method, base)
    assert str(got.value) == str(want.value)


def test_exact_wire_off_at_precision_64(caplog):
    """``precision: 64``: the exact wire gives way to float64 direct
    uploads with one warning; ``round`` keeps the wire, decoded in
    float64."""
    cfg = dict(CFG, quantized_upload=True, precision="64")
    solv, jsolv = _port(base=cfg), _jax(base=cfg)
    with caplog.at_level(logging.WARNING):
        ev = solv._to_events(_batch())
        solv._to_events(_batch())
    assert ev.x.dtype == torch.float64
    assert solv._wire_fell_back
    warned = [r.getMessage() for r in caplog.records
              if "quantized_upload (exact)" in r.getMessage()]
    assert len(warned) == 1 and "float64" in warned[0]
    jsolv._to_events(_batch())
    assert jsolv._wire_fell_back
    r = _port(base=dict(cfg, quantized_upload="round"))
    ev_r = r._to_events(_batch())
    assert not r._wire_fell_back and ev_r.x.dtype == torch.float64
    assert torch.equal(ev_r.x, ttypes.events_from_ndarray(
        _batch(), capacity=8192, dtype=torch.float64, device=CPU).x)


def test_preprocess_period_survives_tless_wire():
    arr = _batch()
    want = float(arr[:, 2].max() - arr[:, 2].min())
    cfg = dict(CFG, quantized_upload=True)
    solv = _port(base=cfg)
    ev, period = solv.preprocess(arr, need_t=False)
    assert abs(period - want) < 1e-9
    assert float(ev.t.abs().max()) == 0.0  # t-less: the pyramid reads none
    _jev, jperiod = _jax(base=cfg).preprocess(arr, need_t=False)
    assert period == jperiod
    # a caller that reads t (need_t left at None) keeps it
    ev_t, _ = solv.preprocess(arr)
    assert float(ev_t.t.max()) > 0


# ---------------------------------------------------------------------------
# The serving CLI with the wire and the float16 fetch
# ---------------------------------------------------------------------------

TEXTS = ("flow_error_per_frame_without_mask.txt",
         "flow_error_per_frame_with_mask.txt")


@pytest.fixture
def restore_logging():
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    for h in root.handlers:
        if h not in handlers:
            h.close()
    root.handlers[:] = handlers
    root.setLevel(level)


def _run_cli(tmp_path, tag, cfg, package):
    cfg = dict(cfg, output_dir=str(tmp_path / f"out_{tag}"))
    path = tmp_path / f"config_{tag}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    argv = ["--config_file", str(path), "--eval"]
    rc = (tcli.main(argv, device=CPU) if package == "torch"
          else jcli.main(argv))
    assert rc == 0
    return pathlib.Path(cfg["output_dir"])


def _assert_error_texts_within(got, want):
    for name in TEXTS:
        a, _ = read_flow_error_text(str(got / name))
        b, _ = read_flow_error_text(str(want / name))
        assert sorted(a) == sorted(b)
        for key in b:
            x, y = np.asarray(a[key], float), np.asarray(b[key], float)
            assert x.shape == y.shape and len(y) == 3, (name, key)
            tol = 0.05 if key.endswith("PE") and key != "EPE" else 2e-3
            assert np.abs(x - y).max() <= tol, (name, key, x, y)


def test_serving_cli_wire_and_float16_fetch(tmp_path, monkeypatch,
                                            restore_logging):
    cfg = small_config()
    cfg["solver"]["precision"] = "32"
    init = pyramid_init(cfg)
    inject_init(monkeypatch, tfacades, init)
    inject_init(monkeypatch, jfacades, init)
    wire = copy.deepcopy(cfg)
    wire["solver"].update(quantized_upload=True, flow_fetch_dtype="float16")
    f32 = _run_cli(tmp_path, "f32", cfg, "torch")
    f16 = _run_cli(tmp_path, "f16", wire, "torch")
    jf16 = _run_cli(tmp_path, "jax_f16", wire, "jax")
    _assert_error_texts_within(f16, f32)
    _assert_error_texts_within(f16, jf16)
    for i in range(3):
        a = np.load(f16 / f"pred_flow{i}.npy")
        b = np.load(f32 / f"pred_flow{i}.npy")
        assert a.dtype == np.float32
        assert np.abs(a - b).max() <= 2e-3 * np.abs(b).max() + 1e-6
