"""The whole decode step's share of the card's peak: the least time its
work needs (the larger of its operations over 989 TFLOP/s and its bytes
over 3.35 TB/s, ``costs.decode_step_cost``: the reference module's where
it states one; for the attention stack each weight read once, for an MoE
layer only the top-k experts any routing must read, the live rows' K/V
read once and the new rows written once) over the step's time as the
program counts it, summed over the window's steps outside the traced
sub-window."""
from pbb import costs, peaks


def read(ctx):
    need = took = 0.0
    for s in ctx.window_steps:
        if s.n_live:
            f, b = costs.decode_step_cost(ctx.m, s.n_live, s.cached_rows)
            need += peaks.least_s(f, b, ctx.m["dtype"])
            took += s.decode_s
    return 100.0 * need / took if took else None
