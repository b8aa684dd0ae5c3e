"""Device time of the residual precisions' update (K5 under the Gram SSE)
in one sweep, in ms: the program's stage timer ``ps_update``
(``FitResult.graphs["stage_ms"]``), read from the timing events of the
trips the traced fit captured under the profiler.  Not read where the
program times no stage."""


def read(ctx):
    if ctx.traced is None:
        return None
    return ctx.traced.graphs.get("stage_ms", {}).get("ps_update")
