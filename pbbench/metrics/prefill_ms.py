"""Mean host time of one admission prefill, from the program's ``prefill``
records (``repro_torch.serving.tracing``): the padded tokens' upload to
the first tokens on the host, over the records made in the window's steps
outside the traced sub-window (a record's ``clock`` is the ``now`` the
benchmark gave that step).  None where the program keeps no records."""
import sys


def read(ctx):
    tr = sys.modules.get("repro_torch.serving.tracing")
    if tr is None:
        return None
    t0s = {s.t0 for s in ctx.window_steps}
    xs = [r.seconds for r in tr.TRACER.prefill if r.clock in t0s]
    return 1e3 * sum(xs) / len(xs) if xs else None
