"""``vote_roofline`` (vote kernel, ``csrc/hat_vote.cu``): the least time
of the traced frames' vote launches over the time the trace measured for
them, in %.

A launch reads each event slot once (row, column and polarity as float32,
the valid flag as a byte: 13 B) and writes its output once (float32), and
does about 18 float32 operations a kept event (floors, offsets, the corner
products, the add); the bound is the larger of bytes over the HBM peak and
operations over the float32 peak.  The output is the signed image for the
pyramid's IWE cache and CMax's time-binned histograms over the widened ROI
box in rows padded to 16 bytes.  Each traced frame launches one vote, of
its window's upload.  A vote is the memset that zeroes its output and the
kernel that adds into it, launched back to back (``ops/iwe_cuda.py``; a
memset inside a captured graph shows as a kernel named ``memset32``): its
measured time runs from the start of the last memset that starts before
the kernel to the kernel's end.
"""

from perfbench import peaks

BYTES_PER_EVENT = 13
OPS_PER_EVENT = 18


def output_floats(config):
    """Floats one vote writes, by the configuration's method."""
    h, w = config["image_size"]
    method = config["solver"]["method"]
    if method == "patch_eklt_pyramid2":
        return h * w
    if method == "contrast_maximization":
        from perfbench.reference import cmax

        bx0, bx1, by0, by1 = cmax.box(config)
        return cmax.TIME_BINS * (bx1 - bx0) * (-(-(by1 - by0) // 4) * 4)
    return None


def bound_s(capacity, kept, config, kind):
    return peaks.bound_s(BYTES_PER_EVENT * capacity
                         + 4 * output_floats(config),
                         OPS_PER_EVENT * kept, kind)


def read(run):
    if run.trace is None or output_floats(run.config) is None:
        return None
    launches = run.trace.kernels("hat_vote_kernel")
    if not launches or len(launches) != len(run.traced):
        return None
    memsets = [a.start for a in run.trace.device
               if "memset" in a.name.lower()]
    measured = 0.0
    for k in launches:
        before = [start for start in memsets if start <= k.start]
        if not before:
            return None
        measured += k.end - max(before)
    bound = sum(bound_s(*run.uploads[f.window], run.config, run.kind)
                for f in run.traced)
    return 100.0 * bound / measured
