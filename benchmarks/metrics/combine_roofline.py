"""A saved draw's combine against its roofline, in %: the least time of
its bytes and operations (counts/combine.py) at the card's peaks, over
the device time a saving trip takes beyond a trip that saves nothing.

The traced fit's graph replays (one sweep a trip) are split by their
number of device operations at the widest step between two counts that
occur: the trips above it save, the ones below do not (a trip of either
kind may show an operation more or less where the trace catches a copy
of another stream).  With a single count, or other than one sweep a
trip, the metric is not read."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.replays or ctx.traced.graphs["unroll"] != 1:
        return None
    counts = sorted({ops for ops, _ in t.replays})
    if len(counts) < 2:
        return None
    step = max(range(1, len(counts)),
               key=lambda i: counts[i] - counts[i - 1])
    cut = counts[step]
    plain = [sec for ops, sec in t.replays if ops < cut]
    saving = [sec for ops, sec in t.replays if ops >= cut]
    extra = sum(saving) / len(saving) - sum(plain) / len(plain)
    if extra <= 0:
        return None
    c = ctx.counts("combine")
    bound = ctx.peaks.roofline_s(c.nbytes(ctx.shape), c.flops(ctx.shape))
    return 100.0 * bound / extra
