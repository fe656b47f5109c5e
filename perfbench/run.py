#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, the benchmark's
files and the PyTorch port (``event_based_bos_tpu_torch``).  The run needs
an NVIDIA GPU; without one, or with fewer cards than the cell asks for, it
prints no result and exits with 2.  The last line of standard output is the
result (one JSON object); the numbers that decided ``correct`` are the
last lines of standard error and the last key of the result.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "perfbench_cache")
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    from perfbench import harness

    started = harness.clock() - harness.process_age_s()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench, cell, config, traffic = harness.cell_spec(args.workload)
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        log(f"perfbench: cell {cell['name']} needs {cell['chips']} CUDA "
            f"device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " — no result")
        return 2
    t0 = time.perf_counter()
    result = harness.run_cell(
        cell["name"], config, traffic, args.seed, args.seconds,
        bool(args.trace), "cuda:0",
        harness.cell_metrics(bench, cell["name"], bool(args.trace)),
        started, log=log)
    found = harness.forbidden_modules()
    if found:
        log(f"perfbench: the measured process loaded {found} — no result")
        return 3
    log(f"perfbench: run took {time.perf_counter() - t0:.1f} s after "
        "start-up")
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
