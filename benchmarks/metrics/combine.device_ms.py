"""Device time of one saved draw's combine, in ms: the program's stage
timer ``combine`` (``FitResult.graphs["stage_ms"]``, a mean per saved
draw), read from the timing events of the saving trips the traced fit
captured under the profiler - measured, not inferred from operation
counts.  Not read where the program times no stage."""


def read(ctx):
    if ctx.traced is None:
        return None
    return ctx.traced.graphs.get("stage_ms", {}).get("combine")
