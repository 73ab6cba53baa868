"""Share of the traced sub-window in which no operation ran on the card
(the union of the device activities' intervals, as
``tools/decode_profile.py`` takes it)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.window_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
