"""Seconds a fit spends before its chain: preprocess + upload + init
(``FitResult.phase_seconds``), the mean over the window's unprofiled
fits."""


def read(ctx):
    if not ctx.fits:
        return None
    return sum(f.phase["preprocess_s"] + f.phase["upload_s"]
               + f.phase["init_s"] for f in ctx.fits) / len(ctx.fits)
