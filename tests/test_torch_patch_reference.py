"""The ``patch_eklt`` facade against the benchmark's plain reference of the
independent per-patch solve (``perfbench/reference/patch.py``), on the CPU
at a small size (48×64, 4 px patches every 2 px, 20 Adam steps, seeded
random frames and events), in float64:

* each step's loss summed over the active patches, the handle's one
  history, to round-off;
* the dense flow of each active patch's best iterate, to round-off, and
  the reference's own checks of it (the refit through the patch→dense
  operator, against the reference's fit, the exact +0.0 where no active
  patch reaches);
* the handle's history is ``[n_iter]`` and a later frame leaves it as it
  was.
"""

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.reference import patch as ref
from perfbench.tests.test_perfbench_patch import SIZE, tiny_cell
from torch_parity import CPU, patch_window, torch_threads

N_ITER = 20


def _facade(cfg, precision):
    return harness.build_facade(cfg, 0, CPU, {"precision": precision})


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


class _Window:
    def __init__(self, seed):
        self.events, self.frame = patch_window(seed, SIZE)


def _frame(facade, window):
    ev, _period = facade.preprocess(window.events)
    handle = facade.estimate_async(ev, frame=window.frame)
    return handle, handle.result()


@pytest.mark.parametrize("seed", [3, 11])
def test_facade_follows_the_reference(seed):
    cfg, _traffic = tiny_cell(N_ITER)
    window = _Window(seed)
    handle, flow = _frame(_facade(cfg, "64"), window)
    (history,) = handle.loss_history
    consts = ref.frame_constants(window, cfg, CPU)
    losses, best = ref.follow(consts, cfg, N_ITER)
    np.testing.assert_allclose(history.numpy(), losses, rtol=1e-12, atol=0)
    want = ref.dense_flow(best, cfg).numpy()
    assert flow.shape == want.shape and flow.dtype == np.float64
    np.testing.assert_allclose(flow, want, rtol=0, atol=1e-13)
    assert np.abs(flow).max() > 1e-3
    frames = [type("F", (), {"flow": flow, "window": 0})]
    checks = ref.field_checks(frames, [window], cfg, seed, CPU)
    assert checks["flow_gap"] < 1e-12 and checks["fit_gap"] < 1e-9, checks
    assert ref.assembly_faults(flow, cfg) == 0
    assert ref.schedule_faults(handle.loss_history, cfg) == 0


def test_the_reference_sums_only_the_active_patches():
    cfg, _traffic = tiny_cell(N_ITER)
    rows, cols = ref.active_box(cfg)
    from event_based_bos_tpu_torch.types import PatchGrid

    mask = PatchGrid(tuple(cfg["image_size"]), (4, 4), (2, 2)).roi_mask(
        *ref.common.roi(cfg))
    assert mask.sum() == len(rows) * len(cols)
    assert mask[np.ix_(rows, cols)].all()


def test_the_handles_history_is_its_frames_own():
    cfg, _traffic = tiny_cell(N_ITER)
    facade = _facade(cfg, "32")
    first, _ = _frame(facade, _Window(3))
    (h1,) = first.loss_history
    kept = h1.clone()
    second, _ = _frame(facade, _Window(11))
    (h2,) = second.loss_history
    assert h1.shape == h2.shape == (N_ITER,) and h1.dtype == torch.float32
    assert torch.equal(h1, kept)
    assert not torch.equal(h1, h2)
    assert h1.data_ptr() != h2.data_ptr()
