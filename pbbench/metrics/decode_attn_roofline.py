"""The decode-attention kernel's share of its roofline in the traced
sub-window: the least time of every call its steps made (the frozen
``cost()`` of ``kernels/decode_attention.py`` at each step's live rows and
their cached lengths, one call a layer that attends, ``costs.attn_layers``;
rows of free slots count as no work) over the device time of the kernel's
two launches (split partials and their merge) in the trace."""
from pbb import costs, peaks

KERNELS = ("decode_partial", "decode_merge")


def read(ctx):
    if ctx.trace is None:
        return None
    took = ctx.trace.time_of(*KERNELS)
    m = ctx.m
    hd = m["head_dim"] or m["d_model"] // m["n_heads"]
    layers = costs.attn_layers(m)
    need = 0.0
    for s in ctx.traced_steps:
        if s.n_live:
            f, b, dt = costs.decode_attention_cost(
                batch=s.n_live, heads=m["n_heads"], kv_heads=m["n_kv_heads"],
                head_dim=hd, cache_len=m["serving"]["max_len"],
                valid_rows=s.cached_rows, dtype=m["dtype"])
            need += layers * peaks.least_s(f, b, dt)
    return 100.0 * need / took if took and need else None
