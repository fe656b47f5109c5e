"""``epe_px``: the mean over the window's frames of the mean endpoint
error over the ROI against the scene's true flow."""


def read(run):
    return sum(run.epe) / len(run.epe) if run.epe else None
