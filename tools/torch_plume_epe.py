#!/usr/bin/env python3
"""EPE of the pyramid on the SYNTHETIC loader's slow plume: the PyTorch
port's CLI beside the JAX package's, both beside zero flow.

    JAX_PLATFORMS=cpu python3 tools/torch_plume_epe.py [--scale 4]
                                                       [--frames 3]
                                                       [--seeds 0 1 2]

On the CPU, in float64: the serving loop (``cli.main … --eval``,
``visualize: false``, ``flow_convention: physical``) of each package on
the SYNTHETIC loader's scene of the chip smoke's serving phase
(``plume0``, 0.2 s at 30 fps, ``max_displacement: 3``) cut by ``--scale``
in each axis (size, ROI and events a frame; ``configs/hot_plate1.yaml``'s
solver, 600 iterations, 64→8 patches).  Each seed's numpy init is handed
to both packages' facades, so the two solves start alike.  For every
frame it prints the EPE of each package's ``pred_flow{i}.npy`` against
the loader's true flow over the ROI, and zero flow's, as one JSON line.

A comparison harness: it imports both packages (the port itself never
imports JAX).
"""

import argparse
import json
import logging
import os
import pathlib
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))


def config(scale, out_dir):
    h, w = 720 // scale, 1280 // scale
    return {
        "data": {"root": "", "dataset": "SYNTHETIC", "sequence": "plume0",
                 "height": h, "width": w, "duration": 0.2, "fps": 30,
                 "events_per_frame": 523264 // (scale * scale),
                 "max_displacement": 3.0},
        "output_dir": str(out_dir),
        "evaluation": {"metrics": ["flow"], "time_list": [[0.01, 0.18]]},
        "common_params": {"n_frames": 1, "xmin": 0, "xmax": h,
                          "ymin": 320 // scale, "ymax": 960 // scale},
        "solver": {
            "filter": {"filters": None, "parameters": {}},
            "method": "patch_eklt_pyramid2", "precision": "64",
            "cost_with_weight": {"diff_norm": 1.0, "image_gradient": 0.5,
                                 "flow_norm_pxy": 0.1},
            "optimizer": {"method": "Adam", "n_iter": 600},
            "generative_ml": {"weight_loss_by_inverse_event_hist": True,
                              "optimize_warp": True, "iwe_sigma": 2,
                              "model_image": "current",
                              "poisson_model": True},
            "patch_eklt": {"coarsest_patch_size": 64,
                           "finest_patch_size": 8}},
        "method": "opencv_flow", "estimation_method": "solver",
        "params_opencv_flow": {"pyr_scale": 0.5, "levels": 4, "winsize": 10,
                               "iterations": 3, "poly_n": 5,
                               "poly_sigma": 1.2, "flags": 0},
        "visualize": False, "flow_convention": "physical",
    }


def main(argv=None):
    import jax
    import numpy as np
    import pytest
    import yaml

    jax.config.update("jax_enable_x64", True)
    import event_based_bos_tpu.cli as jcli
    import event_based_bos_tpu.solver.facades as jfacades
    import event_based_bos_tpu_torch.cli as tcli
    import event_based_bos_tpu_torch.solver.facades as tfacades
    from event_based_bos_tpu_torch import data
    from event_based_bos_tpu_torch.types import PatchGrid
    from torch_parity import inject_init

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args(argv)
    logging.disable(logging.WARNING)

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="plume_epe_",
                                        dir=REPO / "build"
                                        if (REPO / "build").is_dir()
                                        else None))
    cfg = config(args.scale, tmp / "probe")
    d, roi = cfg["data"], cfg["common_params"]
    loader = data.collections["SYNTHETIC"](config=dict(d))
    loader.set_sequence(d["sequence"])
    x0, x1, y0, y1 = roi["xmin"], roi["xmax"], roi["ymin"], roi["ymax"]

    def epe(flow, i):
        gt = loader.load_optical_flow(i)[:, x0:x1, y0:y1]
        return float(np.mean(np.linalg.norm(
            flow[:, x0:x1, y0:y1] - gt, axis=0)))

    first = loader.time_to_image_index(cfg["evaluation"]["time_list"][0][0])
    frames = [first + 1 + k for k in range(args.frames)]
    shape = PatchGrid((d["height"], d["width"]), (64, 64), (64, 64)).shape
    out = {"scale": args.scale, "size": [d["height"], d["width"]],
           "frames": frames,
           "zero_flow": [epe(np.zeros((2, d["height"], d["width"])), i)
                         for i in frames], "seeds": {}}
    for seed in args.seeds:
        init = np.zeros((3,) + shape)
        init[0] = np.random.default_rng(seed).uniform(-1, 1, shape)
        row = {}
        with pytest.MonkeyPatch.context() as mp:
            inject_init(mp, tfacades, init)
            inject_init(mp, jfacades, init)
            for name, main, kw in (("port", tcli.main, {"device": "cpu"}),
                                   ("jax", jcli.main, {})):
                c = dict(cfg, output_dir=str(tmp / f"{name}_{seed}"))
                c["evaluation"] = dict(cfg["evaluation"])
                path = tmp / f"{name}_{seed}.yaml"
                path.write_text(yaml.safe_dump(c))
                assert main(["--config_file", str(path), "--eval"], **kw) == 0
                row[name] = [epe(np.load(os.path.join(
                    c["output_dir"], f"pred_flow{k}.npy")), i)
                    for k, i in enumerate(frames)]
        out["seeds"][seed] = row
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
