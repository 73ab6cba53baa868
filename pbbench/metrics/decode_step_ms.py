"""Host time of one decode step as the program counts it (the captured
step's replay and its one read of the sampled tokens:
``decode_time_s`` over ``n_decode_steps``), over the window's steps
outside the traced sub-window."""


def read(ctx):
    xs = [s.decode_s for s in ctx.window_steps if s.n_live]
    return 1e3 * sum(xs) / len(xs) if xs else None
