"""Mean host time of a decode step's own Python around the launch: the
step inputs' upload when slots changed (``io``) and the per-slot
bookkeeping (``book``), from the program's ``decode`` records made in the
window's steps outside the traced sub-window.  None where the program
keeps no records."""
import sys


def read(ctx):
    tr = sys.modules.get("repro_torch.serving.tracing")
    if tr is None:
        return None
    t0s = {s.t0 for s in ctx.window_steps}
    xs = [r.io + r.book for r in tr.TRACER.decode if r.clock in t0s]
    return 1e3 * sum(xs) / len(xs) if xs else None
