"""K5 (sse_ps) against its roofline, in %: the least time of one
launch's bytes and operations (counts/sse_ps.py) at the card's peaks,
over its mean device time a launch in the traced fit."""


def read(ctx):
    if ctx.trace is None:
        return None
    sec, cnt = ctx.trace.ops(r"\bsse_ps_(fixed|any)\b")
    if not cnt:
        return None
    c = ctx.counts("sse_ps")
    bound = ctx.peaks.roofline_s(c.nbytes(ctx.shape), c.flops(ctx.shape))
    return 100.0 * bound / (sec / cnt)
