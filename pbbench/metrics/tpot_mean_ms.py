"""Mean time per output token after each request's first, over every such
token in the window (the stalls of admissions included, once for each
request they held); host clock."""
from pbb import stats


def read(ctx):
    t = stats.tpot_mean_s(list(ctx.window.stamps.values()))
    return None if t is None else 1e3 * t
