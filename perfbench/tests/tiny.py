"""Cells cut to a size the CPU runs in seconds, for the tests: the
configurations and traffic mixes of the benchmark with a 64×96 frame, a
64×64 ROI, 16 → 8 px patches, 40 iterations and 4,000 events a window.
Their limits are the tiny cells' own (the card's are in the configuration
files)."""

import copy

from perfbench import harness

SIZE = (64, 96)
ROI = (0, 64, 16, 80)
#: tiny cell → (configuration, traffic mix, limits)
CELLS = {
    "hot_plate1.sync": ("hot_plate1", "plume_sync",
                        {"loss_gap": 1e-5, "scale_gap": 1e-5,
                         "best_gap": 1e-5, "flow_gap": 1e-5}),
    "cmax_dense.sync": ("cmax_dense", "dots_sync",
                        {"loss_gap": 1e-5, "best_gap": 1e-5, "flow_gap": 1e-5,
                          "epe_max": 3.0}),
    "cmax_dense.pipe2": ("cmax_dense", "dots_pipe2",
                         {"loss_gap": 1e-5, "best_gap": 1e-5, "flow_gap": 1e-5,
                          "epe_max": 3.0}),
}


def cell(name: str):
    """``(config, traffic)`` of the tiny ``name``."""
    cfg_name, traffic_name, limits = CELLS[name]
    c = copy.deepcopy(harness.load_json(
        harness.HERE / "configs" / f"{cfg_name}.json"))
    t = copy.deepcopy(harness.load_json(
        harness.HERE / "traffic" / f"{traffic_name}.json"))
    c["image_size"] = list(SIZE)
    s = c["solver"]
    s["filter"]["parameters"].update(xmin=ROI[0], xmax=ROI[1], ymin=ROI[2],
                                     ymax=ROI[3])
    s["crop_height"], s["crop_width"] = ROI[1] - ROI[0], ROI[3] - ROI[2]
    s["patch_eklt"].update(coarsest_patch_size=16, finest_patch_size=8)
    s["optimizer"]["n_iter"] = 40
    c["correct"] = {"steps": 5, "scale_frames": 2, "limits": limits}
    t["events_per_window"] = 4000
    if t["scene"] == "plume":
        t["scene_params"]["plume_speed"] = 300.0
    else:
        t["scene_params"]["extent"] = list(ROI)
    return c, t


def run(name: str, seed: int = 7, seconds: float = 0.5):
    """One run of the tiny cell on the CPU (the chip's look skipped)."""
    c, t = cell(name)
    bench = harness.benchmark()
    return harness.run_cell(name, c, t, seed, seconds, False, "cpu",
                            harness.cell_metrics(bench, name, False),
                            harness.clock(), log=lambda _m: None)
