"""The vote's and the stencils' bytes and operations against
``chip_smoke.py``'s counts at the cells' shapes."""

import json
from pathlib import Path

import pytest
import torch

import chip_smoke
from perfbench import peaks
from perfbench.metrics import stencil_roofline, vote_roofline

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
H100 = "NVIDIA H100 80GB HBM3"
CAPACITY = 1 << 19


def _config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.mark.parametrize("config,nbytes", [
    ("hot_plate1", 13 * CAPACITY + 4 * 720 * 1280),           # signed image
    ("cmax_dense", 13 * CAPACITY + 4 * 16 * 720 * 644),       # 16-bin box
])
def test_vote_bound_matches_chip_smoke(config, nbytes):
    c = _config(config)
    live = CAPACITY - 1024
    want_ms, _by = chip_smoke.vote_bound(nbytes, live)
    got = vote_roofline.bound_s(CAPACITY, live, c, H100)
    assert got * 1e3 == pytest.approx(want_ms, rel=1e-12)
    assert 4 * vote_roofline.output_floats(c) + 13 * CAPACITY == nbytes


@pytest.mark.parametrize("flow_px", [0.0, 0.37, 2.0])
def test_stencil_bound_matches_chip_smoke(flow_px):
    c = _config("cmax_dense")
    hists = torch.zeros((16, 720, 644))
    flow = torch.full((2, 720, 644), flow_px)
    dts = (torch.arange(16) + 0.5) / 16 - 0.5
    got = stencil_roofline.bounds_s(c, H100)
    for backward, mine in ((False, got[0]), (True, got[1])):
        want_ms, by, nbytes, _ops = chip_smoke.cmax_bound(hists, flow, dts,
                                                          2, backward)
        assert by == "bytes"
        assert mine * 1e3 == pytest.approx(want_ms, rel=1e-12)
        assert nbytes / peaks.peaks(H100)[0] == pytest.approx(mine)


def test_unknown_card_has_no_peaks():
    with pytest.raises(KeyError):
        peaks.peaks("NVIDIA A100-SXM4-80GB")


@pytest.mark.parametrize("memset", ["Memset (Device)", "memset32"])
def test_vote_share_spans_the_memset_and_the_kernel(memset):
    from types import SimpleNamespace

    from perfbench import devtrace

    c = _config("hot_plate1")
    A = devtrace.Activity
    trace = devtrace.Trace(
        [A(memset, 0.0, 1e-6), A(memset, 2e-6, 3e-6),
         A("void (anonymous namespace)::hat_vote_kernel(VoteArgs, float*)",
           3e-6, 9e-6)], [], (0.0, 1e-5), steps=1)
    run = SimpleNamespace(trace=trace, config=c, kind=H100,
                          traced=[SimpleNamespace(window=0)],
                          uploads={0: (CAPACITY, CAPACITY - 1024)})
    bound = vote_roofline.bound_s(CAPACITY, CAPACITY - 1024, c, H100)
    assert vote_roofline.read(run) == pytest.approx(100 * bound / 7e-6)
