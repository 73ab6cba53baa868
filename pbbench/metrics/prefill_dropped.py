"""(token, choice) assignments the MoE layers dropped over their capacity
in every admission prefill of the run, set-up included (the ``dropped`` of
the program's ``prefill`` records).  A model routed with no capacity reads
0.  None where the records do not count them."""
import sys


def read(ctx):
    tr = sys.modules.get("repro_torch.serving.tracing")
    if tr is None or not tr.TRACER.prefill:
        return None
    if not hasattr(tr.TRACER.prefill[0], "dropped"):
        return None
    return sum(r.dropped for r in tr.TRACER.prefill)
