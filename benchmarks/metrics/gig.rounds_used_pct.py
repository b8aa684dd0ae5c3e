"""The share of the GIG sampler's round work that its draws needed, in
%: 100 x ``rounds_needed`` / ``rounds_evaluated`` of the program's GIG
counters (``FitResult.graphs["gig"]``), summed over the traced fit's
timed replays.  The sampler computes every element's 64 rejection rounds
at once; an element needs the rounds up to its first accepting one (all
64 where none accepts), so this share is the part of that work an
early-exit sampler would keep.  Not read where the program counts no
GIG draw."""


def read(ctx):
    if ctx.traced is None:
        return None
    counts = ctx.traced.graphs.get("gig")
    if not counts or not counts.get("rounds_evaluated"):
        return None
    return 100.0 * counts["rounds_needed"] / counts["rounds_evaluated"]
