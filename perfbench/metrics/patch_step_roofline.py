"""``patch_step_roofline`` (patch objective): the least time of one Adam
step of the independent patch solve over the time a step took on the
device (``busy_ms_per_step``: the union of device activity in the traced
frames over their steps), in %.

The bound counts the work of the patches that enter the flow, whatever
fits them: the program's counter ``patch.active`` over the solves it
counted (one a frame the facade was given: the last traced frame's solve
index + 1; with ``do_event_thresholding`` the counter is an upper bound).
A step reads each such patch's four ``p × p`` float32 windows (the
measurement, the two gradients, the inverse-event weights) once, reads and
writes its ``d = 4`` parameters and Adam's two moments, and writes and
reads its gradient: ``4·4·p² + 4·8·d`` bytes.  Its float32 operations,
counted by hand from the objective: per pixel ~23 forward (the shifted
gradients' taps, the prediction, its norm, the difference and its column
sums) and ~46 backward; per patch ~40 (the bilinear weights, the norms,
the largest column, the regularizer) and ~12 a parameter for Adam.  On an
H100 the bytes' time is ~6× the operations', so the bound is the bytes'.
"""

from event_based_bos_tpu_torch.utils import tracing

from perfbench import peaks

FLOPS_PER_PIXEL = 69
FLOPS_PER_PATCH = 40
FLOPS_PER_PARAM = 12
PARAMS = 4


def step_bound_s(active: float, patch: int, kind: str) -> float:
    """Least seconds of one step over ``active`` patches of ``patch`` px."""
    pixels = patch * patch
    nbytes = active * (4 * 4 * pixels + 4 * 8 * PARAMS)
    flops = active * (FLOPS_PER_PIXEL * pixels + FLOPS_PER_PATCH
                      + FLOPS_PER_PARAM * PARAMS)
    return peaks.bound_s(nbytes, flops, kind)


def read(run):
    if run.trace is None or not run.trace.steps or not run.traced:
        return None
    active = tracing.counters().get("patch.active")
    if not active:
        return None
    per_solve = active / (run.traced[-1].index + 1)
    patch = int(run.config["solver"]["patch_eklt"]["patch_size"])
    step_s = run.trace.busy_s / run.trace.steps
    return 100.0 * step_bound_s(per_solve, patch, run.kind) / step_s
