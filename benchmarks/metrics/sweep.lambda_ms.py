"""Device time of the Lambda update (K1, K2 or K4) in one sweep, in ms: the
program's stage timer ``lambda_update``
(``FitResult.graphs["stage_ms"]``), read from the timing events of the
trips the traced fit captured under the profiler.  Not read where the
program times no stage."""


def read(ctx):
    if ctx.traced is None:
        return None
    return ctx.traced.graphs.get("stage_ms", {}).get("lambda_update")
