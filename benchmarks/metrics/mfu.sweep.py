"""The whole step's share of the card's float32 peak: the operations of
every sweep and every saved draw's combine of the window's unprofiled
fits (counts/sweep.py, counts/combine.py, from the shapes) over their
summed ``chain_s`` times 67 TFLOP/s, in %."""


def read(ctx):
    chain_s = sum(f.phase["chain_s"] for f in ctx.fits)
    if chain_s <= 0:
        return None
    sweep = ctx.counts("sweep").flops(ctx.shape)
    combine = ctx.counts("combine").flops(ctx.shape)
    flops = sum(f.chains * (f.sweeps * sweep + f.saved * combine)
                for f in ctx.fits)
    return 100.0 * flops / (chain_s * ctx.peaks.FP32_FLOP_PER_S)
