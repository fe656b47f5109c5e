"""Published peaks of the chips the benchmark runs on, and the least time
an operation can take against them.

NVIDIA H100 SXM5 80 GB data sheet, dense rates at the 700 W limit: HBM3 at
3.35 TB/s, float32 outside the tensor cores at 67 TFLOP/s.  A card held
below 700 W runs slower; the result line gives its power limit.
"""

from __future__ import annotations

#: card name prefix → (HBM bytes/s, float32 FLOP/s)
PEAKS = {
    "NVIDIA H100": (3.35e12, 67e12),
}


def peaks(kind: str):
    """``(bytes/s, float32 FLOP/s)`` of the card named ``kind``; raises for
    a card the table lacks (a share against a guessed peak means
    nothing)."""
    for prefix, value in PEAKS.items():
        if kind.startswith(prefix):
            return value
    raise KeyError(f"no published peaks for {kind!r}")


def bound_s(nbytes: float, flops: float, kind: str) -> float:
    """Least seconds to move ``nbytes`` (each input read once, each output
    written once) and do ``flops`` float32 operations on ``kind``."""
    bw, fl = peaks(kind)
    return max(nbytes / bw, flops / fl)
