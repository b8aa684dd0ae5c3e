"""The share of a fit's wall time in which no device operation runs, in
%: one minus the traced fit's device busy time (the union of its
kernels, copies and fills) over the mean wall time of the window's
unprofiled fits (``FitResult.seconds``).  The profiler slows the host
but not the device's work, so the traced fit's own wall would count its
overhead as idle."""


def read(ctx):
    if ctx.trace is None or not ctx.fits:
        return None
    wall = sum(f.seconds for f in ctx.fits) / len(ctx.fits)
    return 100.0 * (1.0 - ctx.trace.busy_s / wall)
