"""Seconds a fit spends capturing its trips' CUDA graphs
(``FitResult.graphs["capture_s"]``, inside ``chain_s``), the mean over
the window's unprofiled fits."""


def read(ctx):
    if not ctx.fits:
        return None
    return sum(f.graphs["capture_s"] for f in ctx.fits) / len(ctx.fits)
