"""``stencil_roofline`` (CMax stencil kernels, ``csrc/cmax_stencil.cu``,
forward and backward): the least time of the traced frames' stencil
launches over the time the trace measured for them, in %.

Over a box of ``px`` pixels and ``B`` bins, the forward reads the
histograms, the flow and the bins' times once and writes the image
(``4·(B·px + 2·px + B + px)`` bytes) and the backward also reads the
cotangent and writes the flow's gradient (``4·(B·px + 2·px + px + B +
2·px)``).  Their float32 operations depend on how many taps each pixel's
shift needs, at most 2×2: ``2·B·px + 4·n_axes + 3·n_taps`` and
``2·B·px + 7·n_axes + 9·n_taps`` (``chip_smoke.py::cmax_bound``).  At the
most taps the operations still take less time than the bytes on an H100,
so the bound is the bytes' time whatever the flow; where that would not
hold the reader gives nothing.
"""

from perfbench import peaks


def bounds_s(config, kind):
    """``(forward, backward)`` least seconds a launch."""
    from perfbench.reference import cmax

    bx0, bx1, by0, by1 = cmax.box(config)
    px, b = (bx1 - bx0) * (by1 - by0), cmax.TIME_BINS
    bw, fl = peaks.peaks(kind)
    out = []
    for nbytes, ops_max in ((4 * (b * px + 3 * px + b),
                             2 * b * px + 4 * 4 * b * px + 3 * 4 * b * px),
                            (4 * (b * px + 5 * px + b),
                             2 * b * px + 7 * 4 * b * px + 9 * 4 * b * px)):
        if ops_max / fl > nbytes / bw:
            return None
        out.append(nbytes / bw)
    return tuple(out)


def read(run):
    if run.trace is None:
        return None
    fwd = run.trace.kernels("cmax_stencil_kernel<2, false>")
    bwd = run.trace.kernels("cmax_stencil_kernel<2, true>")
    bounds = bounds_s(run.config, run.kind)
    if not fwd or not bwd or bounds is None:
        return None
    bound = len(fwd) * bounds[0] + len(bwd) * bounds[1]
    return 100.0 * bound / sum(a.seconds for a in fwd + bwd)
