"""The harness's comparison on the CPU, at the tiny size: a sound run is
correct, and a run with the timed path broken underneath is not, for each
fault a cell can have (one chip: there is no exchange to leave out), and
for the pyramid's finer scales: their schedule cut, and the prolongation
between scales broken."""

import numpy as np
import pytest

from perfbench.tests import tiny


def _state_unchanged(monkeypatch):
    from event_based_bos_tpu_torch import optim

    monkeypatch.setattr(optim.Adam, "step",
                        lambda self, x, grad, state, row: x)


def _half_batch(monkeypatch):
    from event_based_bos_tpu_torch.solver import api

    original = api.SolverBase.preprocess

    def preprocess(self, events, need_t=None):
        ev, period = original(self, events, need_t)
        keep = (np.arange(ev.capacity) % 2) == 0
        import torch

        return ev.mask_where(torch.as_tensor(keep, device=ev.x.device)), \
            period

    monkeypatch.setattr(api.SolverBase, "preprocess", preprocess)


def _answer_altered(monkeypatch):
    from event_based_bos_tpu_torch.solver import api

    original = api.EstimationHandle.result
    monkeypatch.setattr(api.EstimationHandle, "result",
                        lambda self: -3.0 * original(self))


def _answer_scaled(monkeypatch):
    from event_based_bos_tpu_torch.solver import api

    original = api.EstimationHandle.result
    monkeypatch.setattr(api.EstimationHandle, "result",
                        lambda self: 2.0 * original(self))


def _scales_cut(monkeypatch):
    from event_based_bos_tpu_torch.solver import cmax, pyramid

    for module in (cmax, pyramid):
        original = module.scale_iterations
        monkeypatch.setattr(module, "scale_iterations",
                            lambda spec, _f=original: [n // 2
                                                       for n in _f(spec)])


def _prolongation_broken(monkeypatch):
    from event_based_bos_tpu_torch.graphs import KeptSolve

    original = KeptSolve.resize
    monkeypatch.setattr(KeptSolve, "resize",
                        lambda self, image, shape: original(
                            self, 0.5 * image, shape))


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered, "answer_scaled": _answer_scaled,
          "scales_cut": _scales_cut}


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_sound_run_is_correct(cell):
    result = tiny.run(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result["checks"])[0] == "loss_gap"
    assert list(result["checks"])[-1] == "assembly_faults"
    assert result["checks"]["schedule_faults"]["value"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = tiny.run(cell)
    assert not result["correct"], (fault, result["checks"])


def test_pyramid_prolongation_fault_is_not_correct(monkeypatch):
    _prolongation_broken(monkeypatch)
    result = tiny.run("hot_plate1.sync")
    assert not result["correct"], result["checks"]
    assert result["checks"]["scale_gap"]["value"] > 1e-3
