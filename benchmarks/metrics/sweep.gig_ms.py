"""Device time of the GIG rejection sampler in one sweep, in ms: the
program's stage timer ``gig`` (``FitResult.graphs["stage_ms"]``), both
GIG calls of a Dirichlet-Laplace sweep (phi's T and tau), a stage nested
in ``prior_update``, read from the timing events of the trips the traced
fit captured under the profiler.  Not read where the program times no
such stage (another prior, or a program without the stage)."""


def read(ctx):
    if ctx.traced is None:
        return None
    return ctx.traced.graphs.get("stage_ms", {}).get("gig")
