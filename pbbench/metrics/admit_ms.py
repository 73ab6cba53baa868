"""Mean host time of the admission part of each step that admitted
requests: the step's wall time less the decode time the program counted
in it (``decode_time_s``).  Steps inside a traced sub-window are left
out."""


def read(ctx):
    xs = [s.t1 - s.t0 - s.decode_s for s in ctx.window_steps if s.admitted]
    return 1e3 * sum(xs) / len(xs) if xs else None
