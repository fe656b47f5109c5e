#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from: the numbers the
harness compares, for the program as configured and for its controls,
over many seeds in one process.

    python perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --modes program,tf32,bf16 --frames 8 [--steps 20] [--out file]

A mode is ``program`` (as configured), ``tf32`` (the program with
float32 matmuls and convolutions in TF32) or ``bf16`` (the generative
solvers' ``compute_dtype: bfloat16``).  Each (mode, seed) solves
``--frames`` frames in the cell's closed loop after the harness's set-up
and prints one JSON line: the relative loss gap at each of the first
``--steps`` steps (the largest over the frames), the reference module's
own numbers (``field_checks``), the schedule's faults, each frame's EPE,
and the EPE of the same flows negated and doubled (answers altered where
they are made) and of zero flow.  Needs the card.
"""

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import harness  # noqa: E402

OVERRIDES = {"program": None, "tf32": None,
             "bf16": {"compute_dtype": "bfloat16"}}


def readings(cell, config, traffic, seed, mode, frames, steps, dev, log):
    import torch

    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    windows, facade, _up, k, _cap = harness.prepare(
        config, traffic, seed, dev, OVERRIDES[mode], log)
    done = harness.closed_loop(facade, windows, k,
                               int(traffic["in_flight"]), count=frames)
    harness.to_host(done)
    del facade
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = harness.reference_module(config)
    roi = harness.roi_of(config)
    traj = ref.trajectories(windows, [(f.index, f.window) for f in done],
                            config, seed, steps, dev)
    gaps = harness.loss_gaps(done, traj, steps)
    fields = (ref.field_checks(done, windows, config, seed, dev)
              if hasattr(ref, "field_checks") else {})

    def epes(sign):
        return [harness.epe(sign * f.flow, windows[f.window].true_flow,
                            ref.FLOW_SIGN, roi) for f in done]

    return {"cell": cell, "mode": mode, "seed": seed, "frames": len(done),
            "gap_by_step": gaps.tolist(),
            **{k: float(v) for k, v in fields.items()},
            "epe": epes(1.0), "epe_negated": epes(-1.0),
            "epe_doubled": epes(2.0), "epe_zero": epes(0.0),
            "schedule_faults": sum(ref.schedule_faults(f.losses, config)
                                   for f in done),
            "assembly_faults": sum(ref.assembly_faults(f.flow, config)
                                   for f in done)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default="program")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs the card", file=sys.stderr)
        return 2
    _bench, cell, config, traffic = harness.cell_spec(args.workload)
    dev = torch.device("cuda:0")
    out = open(args.out, "a") if args.out else None
    for mode in args.modes.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            r = readings(cell["name"], config, traffic, seed, mode,
                         args.frames, args.steps, dev,
                         lambda m: print(m, file=sys.stderr))
            line = json.dumps(r)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
