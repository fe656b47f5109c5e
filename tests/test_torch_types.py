"""Parity of the port's event batch and patch grid with the JAX package."""

import numpy as np
import pytest
import torch

import event_based_bos_tpu.types as jtypes
import event_based_bos_tpu_torch.types as ttypes
from torch_parity import CPU, both_events, np_of, rand_event_fields


def _assert_events_equal(jev, tev):
    for a, b in zip(jev, tev):
        assert np.array_equal(np_of(a), np_of(b))


def test_events_from_arrays_fields_and_dtype():
    rng = np.random.default_rng(0)
    fields = rand_event_fields(100, 24, 40, rng, fractional=True)
    jev, tev = both_events(fields)
    _assert_events_equal(jev, tev)
    assert tev.x.dtype == torch.float32 and tev.valid.dtype == torch.bool
    assert tev.capacity == jev.capacity == 100


@pytest.mark.parametrize("capacity", [64, 100, 257])
def test_pad_and_truncate(capacity):
    rng = np.random.default_rng(1)
    fields = rand_event_fields(100, 24, 40, rng)
    jev, tev = both_events(fields, capacity=capacity)
    assert tev.capacity == capacity
    _assert_events_equal(jev, tev)
    _assert_events_equal(jtypes.pad_events(jev, 300),
                         ttypes.pad_events(tev, 300))


def test_mask_where_count_and_astype():
    rng = np.random.default_rng(2)
    fields = rand_event_fields(200, 24, 40, rng)
    keep = rng.integers(0, 2, 256) > 0
    jev, tev = both_events(fields, keep=keep, capacity=256)
    _assert_events_equal(jev, tev)
    assert int(tev.count()) == int(jev.count()) == int(keep[:200].sum())
    # a second mask composes with the first (valid &= keep)
    keep2 = np.asarray(fields[3] > 0)
    keep2 = np.concatenate([keep2, np.ones(56, bool)])
    _assert_events_equal(jev.mask_where(keep2),
                         tev.mask_where(torch.as_tensor(keep2)))
    t64 = tev.astype(torch.float64)
    assert t64.x.dtype == torch.float64 and t64.valid.dtype == torch.bool
    assert np.array_equal(tev.to_numpy(), np.asarray(jev.to_numpy()))


def test_events_from_ndarray_including_empty():
    rng = np.random.default_rng(3)
    arr = np.stack(rand_event_fields(50, 24, 40, rng), axis=1).astype(
        np.float64)
    _assert_events_equal(jtypes.events_from_ndarray(arr, capacity=64),
                         ttypes.events_from_ndarray(arr, capacity=64,
                                                    device=CPU))
    empty = ttypes.events_from_ndarray(np.zeros((0, 4)), capacity=16,
                                       device=CPU)
    _assert_events_equal(jtypes.events_from_ndarray(np.zeros((0, 4)),
                                                    capacity=16), empty)
    assert int(empty.count()) == 0


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 523264, 1 << 19])
def test_bucket_capacity(n):
    assert ttypes.bucket_capacity(n) == jtypes.bucket_capacity(n)
    assert ttypes.bucket_capacity(n, minimum=8) == jtypes.bucket_capacity(
        n, minimum=8)


@pytest.mark.parametrize("size,patch,stride,offset", [
    ((64, 96), (16, 16), (16, 16), (0, 0)),
    ((720, 1280), (64, 64), (64, 64), (0, 0)),
    ((70, 90), (8, 8), (4, 4), (1.5, -2.0)),
])
def test_patch_grid(size, patch, stride, offset):
    jg = jtypes.PatchGrid(size, patch, stride, offset)
    tg = ttypes.PatchGrid(size, patch, stride, offset)
    assert tg.shape == jg.shape and tg.n_patch == jg.n_patch
    for a, b in zip(tg.centers(), jg.centers()):
        assert np.array_equal(a, b)
    for a, b in zip(tg.bounds(), jg.bounds()):
        assert np.array_equal(a, b)
    assert np.array_equal(tg.roi_mask(0, 40, 10, 60),
                          jg.roi_mask(0, 40, 10, 60))
