"""Device time of one sweep in the traced fit: the device operations of
all its graph replays over the sweeps they ran, in ms."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.replays:
        return None
    seconds = sum(t for _, t in ctx.trace.replays)
    sweeps = len(ctx.trace.replays) * ctx.traced.graphs["unroll"]
    return 1e3 * seconds / sweeps
