"""The recurrent state the batcher's slot cache holds, in GiB: the ``ssm``
bytes (SSM and RG-LRU states) of the program's ``cache`` record, made once
when the batcher is built (a set-up counter).  Beside ``peak_mem_gib`` it
shows how much of a replica's memory the slots' state takes.  None where
the program keeps no such record."""
import sys


def read(ctx):
    tr = sys.modules.get("repro_torch.serving.tracing")
    recs = getattr(getattr(tr, "TRACER", None), "cache", None)
    if not recs:
        return None
    return recs[-1].ssm / 2 ** 30
