"""Process start to the window's start: imports, the card's start, the
weights made from the seed, the kernels' build or load, the adapters'
merge, the replica and its warm-up."""


def read(ctx):
    return ctx.setup_s
