"""Device time of the X update (the one cross-shard update) in one sweep,
in ms: the program's stage timer ``x_update``
(``FitResult.graphs["stage_ms"]``), read from the timing events of the
trips the traced fit captured under the profiler.  Not read where the
program times no stage."""


def read(ctx):
    if ctx.traced is None:
        return None
    return ctx.traced.graphs.get("stage_ms", {}).get("x_update")
