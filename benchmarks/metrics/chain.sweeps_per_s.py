"""All chains' sweeps over the summed ``chain_s`` (captures and warm-up
trips included) of the window's unprofiled fits."""


def read(ctx):
    chain_s = sum(f.phase["chain_s"] for f in ctx.fits)
    if chain_s <= 0:
        return None
    return sum(f.sweeps * f.chains for f in ctx.fits) / chain_s
