"""Device time of the health panel and the trace row in one sweep, in ms:
the program's stage timer ``health_trace``
(``FitResult.graphs["stage_ms"]``), read from the timing events of the
trips the traced fit captured under the profiler.  Not read where the
program times no stage."""


def read(ctx):
    if ctx.traced is None:
        return None
    return ctx.traced.graphs.get("stage_ms", {}).get("health_trace")
