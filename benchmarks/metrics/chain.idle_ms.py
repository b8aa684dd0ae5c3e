"""Device idle time of the chunk loop a sweep, in ms: the traced fit's
idle gaps named ``api.chain`` or one of its steps ``api.chain.*`` (the
innermost range open at a gap's middle), over the sweeps of all its
chains."""


def read(ctx):
    if ctx.trace is None or ctx.traced is None:
        return None
    idle = sum(s for name, s in ctx.trace.gaps_by_span.items()
               if name == "api.chain" or name.startswith("api.chain."))
    return 1e3 * idle / (ctx.traced.sweeps * ctx.traced.chains)
