"""Share of the prefilled positions that are padding: 100 x (1 - real
tokens / (rows x bucket)), summed over the program's ``prefill`` records
made in the window's steps outside the traced sub-window.  None where the
program keeps no records."""
import sys


def read(ctx):
    tr = sys.modules.get("repro_torch.serving.tracing")
    if tr is None:
        return None
    t0s = {s.t0 for s in ctx.window_steps}
    recs = [r for r in tr.TRACER.prefill if r.clock in t0s]
    padded = sum(r.rows * r.bucket for r in recs)
    return 100.0 * (1.0 - sum(r.tokens for r in recs) / padded) \
        if padded else None
