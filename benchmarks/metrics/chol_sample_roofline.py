"""K1 (chol_sample) against its roofline, in %: the least time of one
launch's bytes and operations (counts/chol_sample.py) at the card's
peaks, over its mean device time a launch in the traced fit.  K1 is the
factor-solve-sample instance of ``chol_group_kernel`` (template
arguments K, T, DIV_BWD = false, SAMPLE = true, ...)."""

K1 = r"chol_group_kernel<\s*\d+\s*,\s*\d+\s*,\s*false\s*,\s*true\b"


def read(ctx):
    if ctx.trace is None:
        return None
    sec, cnt = ctx.trace.ops(K1)
    if not cnt:
        return None
    c = ctx.counts("chol_sample")
    bound = ctx.peaks.roofline_s(c.nbytes(ctx.shape), c.flops(ctx.shape))
    return 100.0 * bound / (sec / cnt)
