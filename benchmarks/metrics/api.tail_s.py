"""Seconds a fit spends after its chain that nothing hid: the exposed
fetch + the host assembly (``FitResult.phase_seconds``), the mean over
the window's unprofiled fits."""


def read(ctx):
    if not ctx.fits:
        return None
    return sum(f.phase["exposed_fetch_s"] + f.phase["assemble_s"]
               for f in ctx.fits) / len(ctx.fits)
