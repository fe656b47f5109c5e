"""The independent patch solve's spans and counters (``solver/patch.py``),
on the CPU:

* each solve adds the grid's size to ``patch.fits`` and the ROI's patch
  count to ``patch.active`` (with ``do_event_thresholding`` still the
  ROI's: an upper bound of the patches that enter the flow);
* under ``torch.profiler`` a frame shows ``ebt.patch.cut`` and
  ``ebt.patch.assemble`` inside ``ebt.estimate``, the cut before the loop
  and the assembly after it;
* without a profiler a solve opens no ``record_function``.
"""

import numpy as np
import pytest
import torch

from event_based_bos_tpu_torch.solver import patch as tpatch
from event_based_bos_tpu_torch.types import PatchGrid
from event_based_bos_tpu_torch.utils import tracing
from perfbench import harness
from perfbench.tests.test_perfbench_patch import ROI, SIZE, tiny_cell
from torch_parity import CPU, patch_window, torch_threads

N_ITER = 4


def _facade(thresholding=False):
    cfg, _traffic = tiny_cell(N_ITER)
    cfg["solver"]["patch_eklt"]["do_event_thresholding"] = thresholding
    return harness.build_facade(cfg, 0, CPU)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _solve(facade, seed=3):
    events, frame = patch_window(seed, SIZE)
    ev, _period = facade.preprocess(events)
    return facade.estimate_async(ev, frame=frame).result()


@pytest.mark.parametrize("thresholding", [False, True])
def test_counters_grow_by_the_grid_and_the_roi_each_solve(thresholding):
    facade = _facade(thresholding)
    grid = PatchGrid(SIZE, (4, 4), (2, 2))
    roi = int(grid.roi_mask(*ROI).sum())
    assert 0 < roi < grid.n_patch
    before = tracing.counters()
    for seed in (3, 11):
        _solve(facade, seed)
    after = tracing.counters()
    assert after["patch.fits"] - before.get("patch.fits", 0) == 2 * grid.n_patch
    assert after["patch.active"] - before.get("patch.active", 0) == 2 * roi
    events, _frame = patch_window(3, SIZE)
    ev, _period = facade.preprocess(events)
    active = int(tpatch.active_patch_mask(ev, facade.spec).sum())
    assert active <= roi and (active < roi) == thresholding


def _ranges(prof):
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            start = ev.start_ns()
            out.setdefault(ev.name(), []).append(
                (start, start + ev.duration_ns()))
    return out


def test_both_spans_show_under_a_profiler():
    facade = _facade()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _solve(facade)
    spans = _ranges(prof)
    (cut,) = spans["ebt.patch.cut"]
    (assemble,) = spans["ebt.patch.assemble"]
    (loop,) = spans["ebt.loop"]
    (estimate,) = spans["ebt.estimate"]
    assert estimate[0] <= cut[0] and cut[1] <= loop[0]
    assert loop[1] <= assemble[0] and assemble[1] <= estimate[1]


def test_a_solve_without_a_profiler_opens_no_record_function(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        opened.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    facade = _facade()
    flow = _solve(facade)
    assert np.isfinite(flow).all()
    assert not opened, opened
