"""Misc utilities: seeds, config key checks, the error-text reader and
the cProfile decorator.

PyTorch port's copy of the JAX package's ``utils/misc.py``.  The JAX
package's persistent compile cache has no counterpart: nothing here is
compiled per program.
"""

from __future__ import annotations

import ast
import cProfile
import functools
import io
import logging
import pstats
import random
from typing import Dict, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = ["fix_random_seed", "check_key_and_bool", "read_flow_error_text",
           "profile"]


def fix_random_seed(seed: int = 46) -> None:
    """Seed the host RNGs and torch's default generators.  The solvers draw
    from their own seeded ``torch.Generator``, not from these."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def check_key_and_bool(config: dict, key: str) -> bool:
    """True iff the key exists and is truthy."""
    return key in config and bool(config[key])


def read_flow_error_text(filename: str, abs_val: bool = False
                         ) -> Tuple[dict, dict]:
    """Parse a per-frame error text file and compute summary statistics.

    Each line is ``frame N::{dict}``; NaNs become 0; FWL columns are
    inverted; nPE columns scale to %; AE statistics exclude zeros; the
    statistics are mean/rms/std/min/max/n_data.  Returns ``(per-frame
    arrays, statistics)``.
    """
    error_per_frame: Dict[str, list] = {}
    keys = None
    with open(filename) as f:
        for line in f:
            line = line.replace("nan", "0.0")
            payload = line[line.find("::") + 2:].strip()
            data = ast.literal_eval(payload)
            if keys is None:
                keys = list(data.keys())
                error_per_frame = {k: [] for k in keys}
            for k in keys:
                error_per_frame[k].append(data[k])
    if keys is None:
        raise ValueError(f"No parsable lines in {filename}")
    arrays = {k: np.asarray(v, dtype=float)
              for k, v in error_per_frame.items()}
    if abs_val:
        arrays = {k: np.abs(v) for k, v in arrays.items()}
    for k in keys:
        if "FWL" in k:
            arrays[k] = 1.0 / arrays[k]
        if k in ("1PE", "2PE", "3PE", "5PE", "10PE", "20PE"):
            arrays[k] = arrays[k] * 100.0

    stats: Dict[str, dict] = {}
    for k in keys:
        metric = arrays[k].copy()
        if k == "AE":
            metric = metric[metric != 0]
        if metric.size == 0:
            metric = np.zeros(1)
        stats[k] = {
            "mean": float(np.mean(metric)),
            "rms": float(np.sqrt(np.mean(metric**2))),
            "std": float(np.std(metric)),
            "min": float(np.min(metric)),
            "max": float(np.max(metric)),
            "n_data": int(len(metric)),
        }
    return arrays, stats


def profile(output_file=None, sort_by="cumulative", lines_to_print=None,
            strip_dirs=False):
    """cProfile decorator: dumps the call's stats to ``output_file``
    (default ``<function name>.prof``) and logs them at debug level.

    It sees the host's Python only; for the card's kernels use
    :func:`event_based_bos_tpu_torch.utils.tracing.trace`.
    """

    def inner(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            out = output_file or func.__name__ + ".prof"
            pr = cProfile.Profile()
            pr.enable()
            try:
                return func(*args, **kwargs)
            finally:
                pr.disable()
                pr.dump_stats(out)
                s = io.StringIO()
                ps = pstats.Stats(pr, stream=s)
                if strip_dirs:
                    ps.strip_dirs()
                ps.sort_stats(sort_by).print_stats(lines_to_print)
                logger.debug(s.getvalue())

        return wrapper

    return inner
