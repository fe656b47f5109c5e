"""``patch_active_share`` (patch objective): the share of the independent
patch solve's fits whose result enters the flow, from the program's
counters ``patch.active`` over ``patch.fits`` (``solver/patch.py``, added
at each solve).  ``patch.active`` counts the patches whose centre lies in
the ROI, from the grid on the host; with ``do_event_thresholding`` it is
an upper bound of the patches that enter the flow.  A program that does
not count them reads nothing."""

from event_based_bos_tpu_torch.utils import tracing


def read(run):
    c = tracing.counters()
    if not c.get("patch.fits") or "patch.active" not in c:
        return None
    return c["patch.active"] / c["patch.fits"]
