"""The largest transient cache one admission prefill built, in GiB (the
``cache_bytes`` of the program's ``prefill`` records), over every record
of the run, set-up included: the scope of ``peak_mem_gib``, beside the
batcher's own cache.  None where the program keeps no records."""
import sys


def read(ctx):
    tr = sys.modules.get("repro_torch.serving.tracing")
    if tr is None or not tr.TRACER.prefill:
        return None
    return max(r.cache_bytes for r in tr.TRACER.prefill) / 2 ** 30
