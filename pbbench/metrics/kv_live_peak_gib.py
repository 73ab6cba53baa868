"""The most cache the live requests held at once in the window, in GiB: over
the decode steps, the largest count of cached positions of the live rows
(their prompts and served tokens, the new row included) times one
position's K and V over every layer that holds them (``costs.attn_layers``)
in the served dtype. Beside ``peak_mem_gib`` it shows how much of the
replica's reserved cache the traffic fills."""
from pbb import costs


def read(ctx):
    m = ctx.m
    hd = m["head_dim"] or m["d_model"] // m["n_heads"]
    per_pos = (2 * costs.attn_layers(m) * m["n_kv_heads"] * hd
               * costs.itemsize(m["dtype"]))
    rows = [s.cached_rows + s.n_live for s in ctx.window.steps if s.n_live]
    return max(rows) * per_pos / 2 ** 30 if rows else None
