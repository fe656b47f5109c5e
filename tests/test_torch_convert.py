"""The state handed between the JAX package and the port (``convert.py``)."""

import numpy as np
import pytest
import torch

import event_based_bos_tpu.types as jtypes
from event_based_bos_tpu_torch.convert import state_from_numpy, state_to_numpy
from torch_parity import CPU, np_of, rand_event_fields


def _state(dtype=np.float64):
    rng = np.random.default_rng(0)
    jev = jtypes.events_from_arrays(*rand_event_fields(20, 8, 12, rng),
                                    capacity=32)
    return {
        "init_params": rng.normal(size=(3, 2, 3)).astype(dtype),
        "x0": rng.normal(size=(4,)).astype(dtype),
        "params_per_scale": [rng.normal(size=(3, 2, 3)).astype(dtype),
                             rng.normal(size=(3, 4, 6)).astype(dtype)],
        "cache": (rng.normal(size=(8, 12)).astype(dtype), None,
                  rng.uniform(size=(8, 12)).astype(dtype)),
        "events": tuple(np.asarray(a) for a in jev),
    }


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_round_trip_is_exact(dtype):
    state = _state(dtype)
    tens = state_from_numpy(state, device=CPU)
    assert tens["init_params"].dtype == torch.from_numpy(
        np.zeros(1, dtype)).dtype
    assert tens["cache"][1] is None
    assert tens["events"].valid.dtype == torch.bool
    back = state_to_numpy(tens)
    assert np.array_equal(back["init_params"], state["init_params"])
    assert np.array_equal(back["x0"], state["x0"])
    assert tens["x0"].shape == (4,)
    for a, b in zip(back["params_per_scale"], state["params_per_scale"]):
        assert np.array_equal(a, b)
    assert back["cache"][1] is None
    assert np.array_equal(back["cache"][0], state["cache"][0])
    for a, b in zip(back["events"], state["events"]):
        assert np.array_equal(a, b)


def test_dtype_cast_and_device():
    tens = state_from_numpy({"init_params": _state()["init_params"]},
                            device=CPU, dtype=torch.float32)
    assert tens["init_params"].dtype == torch.float32
    assert tens["init_params"].device.type == "cpu"


@pytest.mark.parametrize("bad,err", [
    ({"init_params": np.zeros((2, 3))}, ValueError),
    ({"init_params": np.zeros((3, 2, 3), np.int32)}, TypeError),
    ({"x0": np.zeros((1, 4))}, ValueError),
    ({"x0": np.zeros(4, np.int64)}, TypeError),
    ({"cache": (np.zeros((8, 12)), None, np.zeros((8, 11)))}, ValueError),
    ({"events": (np.zeros(4), np.zeros(4), np.zeros(4), np.zeros(3),
                 np.ones(4, bool))}, ValueError),
    ({"events": (np.zeros(4),) * 4 + (np.ones(4),)}, TypeError),
    ({"weights": np.zeros(3)}, KeyError),
])
def test_rejects_malformed_state(bad, err):
    with pytest.raises(err):
        state_from_numpy(bad, device=CPU)


def test_values_survive_on_the_port_side():
    state = _state()
    tens = state_from_numpy(state, device=CPU)
    assert np.array_equal(np_of(tens["events"].x), state["events"][0])
    assert int(tens["events"].count()) == 20
