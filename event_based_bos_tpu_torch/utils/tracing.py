"""Section timer of the evaluation loop (``profile: true``).

PyTorch port's counterpart of the JAX package's ``utils/tracing.py``
``Timer``.  It times on the host wall clock and never waits for the card
itself: a section that must include device work ends in an explicit wait
(a fetch of its result, or ``torch.cuda.synchronize(device)``) written at
the call site.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

__all__ = ["Timer"]


class Timer:
    """Accumulating host wall-clock section timer."""

    def __init__(self):
        self.sections: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sections[name] = self.sections.get(name, 0.0) + (
                time.perf_counter() - t0)

    def report(self, n_frames: Optional[int] = None,
               wall_s: Optional[float] = None) -> str:
        """The accumulated sections, largest first.

        With ``n_frames`` the values are per frame; with ``wall_s`` the
        percentages are shares of that wall-clock window (exposing untimed
        gaps) instead of shares of the recorded-section sum.  A nested
        section (``finalize/solve_wait``) runs inside its parent, so the
        sum counts only sections with no recorded ancestor.
        """
        def _has_parent(name):
            parts = name.split("/")
            return any("/".join(parts[:i]) in self.sections
                       for i in range(1, len(parts)))

        total = wall_s or sum(v for k, v in self.sections.items()
                              if not _has_parent(k)) or 1.0
        div = n_frames or 1
        unit = "s/frame" if n_frames else "s"
        return "\n".join(
            f"{k}: {v / div:.3f}{unit} ({100 * v / total:.1f}%)"
            for k, v in sorted(self.sections.items(), key=lambda kv: -kv[1]))
