"""The frozen scene generators."""

import json
from pathlib import Path

import numpy as np
import pytest

from perfbench import scenes

TRAFFIC = Path(__file__).resolve().parent.parent / "traffic"


def test_plume_is_the_ports_synthetic_sequence():
    from event_based_bos_tpu_torch.data.synthetic import (SyntheticBosConfig,
                                                          generate_sequence)

    h, w, n, fps = 48, 64, 3000, 30.0
    params = {"fps": fps, "plume_speed": 900.0, "max_displacement": 3.0,
              "pattern_scale": 3, "t_offset": 10.0}
    wins = scenes.load("plume").make_windows((h, w), 2, n, params, 11)
    seq = generate_sequence(SyntheticBosConfig(
        height=h, width=w, duration=2 / fps, fps=fps, events_per_frame=n,
        max_displacement=3.0, plume_speed=900.0, seed=11))
    events = seq["events"]
    for i, win in enumerate(wins):
        ev = events[i * n:(i + 1) * n].copy()
        ev[:, 2] += 10.0
        np.testing.assert_array_equal(win.events, ev)
        np.testing.assert_array_equal(win.frame,
                                      seq["frames"][i + 1].astype(np.float32))
        np.testing.assert_array_equal(
            win.true_flow, seq["gt_flow"][i].astype(np.float32))


@pytest.mark.parametrize("mix", sorted(p.stem for p in TRAFFIC.glob("*.json")))
def test_each_mix_repeats_from_its_seed(mix):
    t = json.loads((TRAFFIC / f"{mix}.json").read_text())
    make = scenes.load(t["scene"]).make_windows
    a = make((72, 128), 2, 500, t["scene_params"], 2**31 + 99)
    b = make((72, 128), 2, 500, t["scene_params"], 2**31 + 99)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.events, y.events)
        assert np.all(x.events[:, :2] == np.round(x.events[:, :2]))


def test_dots_give_every_seed_the_same_motions():
    t = json.loads((TRAFFIC / "dots_sync.json").read_text())
    params = dict(t["scene_params"], extent=[0, 120, 40, 160])
    make = scenes.load("dots").make_windows
    sets = []
    for seed in (1, 2**32 + 5):
        wins = make((120, 200), 4, 2000, params, seed)
        sets.append(sorted(tuple(np.abs(w.true_flow[:, 0, 0]))
                           for w in wins))
        for w in wins:
            r, c = w.events[:, 0], w.events[:, 1]
            assert r.min() >= 0 and r.max() < 120
            assert c.min() >= 40 and c.max() < 160
    want = sorted(tuple(abs(v) for v in m) for m in params["motions"])
    assert sets[0] == sets[1] == want
