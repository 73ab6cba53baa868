"""Mean share of the slots that each decode step in the window
computes for (live rows over slots)."""


def read(ctx):
    xs = [s.n_live for s in ctx.window.steps if s.n_live]
    return 100.0 * sum(xs) / (len(xs) * ctx.slots) if xs else None
