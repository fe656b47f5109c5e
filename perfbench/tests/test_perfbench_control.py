"""The controls on the card, at the cells' own sizes: the program in the
nearest precision below the configuration's (TF32 matmuls, and for the
pyramid its own ``compute_dtype: bfloat16``) fails one of the numbers that
decide ``correct`` on every seed, while the program as configured passes
each of them.  Run on the card with
``python -m pytest perfbench/tests -q -m card``."""

import pytest

from perfbench import harness

SEEDS = (2147483711, 2147483712, 2147483713)
CASES = [("hot_plate1.sync", "tf32"), ("hot_plate1.sync", "bf16"),
         ("cmax_dense.sync", "tf32")]


def numbers(reading: dict, limits: dict) -> dict:
    """The numbers of a calibration reading that the cell's limits hold,
    under the names of the run's checks (over the reading's frames)."""
    out = {"loss_gap": max(reading["gap_by_step"])}
    out.update({k: reading[k] for k in limits if k in reading})
    if "epe_max" in limits:
        out["epe_max"] = max(reading["epe"])
    return out


@pytest.mark.card
@pytest.mark.parametrize("cell,mode", CASES)
def test_control_is_not_correct(cell, mode):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from perfbench import calibrate

    _b, _c, config, traffic = harness.cell_spec(cell)
    corr = config["correct"]
    limits = corr["limits"]
    for seed in SEEDS:
        for m in ("program", mode):
            r = calibrate.readings(cell, config, traffic, seed, m, 4,
                                   corr["steps"], torch.device("cuda:0"),
                                   lambda _m: None)
            got = numbers(r, limits)
            assert set(got) == set(limits), (got, limits)
            over = {k: v for k, v in got.items() if v > limits[k]}
            assert r["schedule_faults"] == 0 and r["assembly_faults"] == 0
            if m == "program":
                assert not over, (seed, got)
            else:
                assert over, (seed, mode, got)
