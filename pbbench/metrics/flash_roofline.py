"""The flash-attention kernel's share of its roofline in the traced
sub-window: the least time of the prefill attention of the real prompts
admitted there (the frozen ``cost()`` of ``kernels/flash_attention.py``,
one causal call a prompt at its own length in each layer that attends,
``costs.attn_layers``; the padded rows and tokens of a bucketed admission
count as no work) over the kernel's device time in the trace."""
from pbb import costs, peaks

KERNELS = ("flash_bf16_kernel", "flash_attention_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    took = ctx.trace.time_of(*KERNELS)
    m = ctx.m
    hd = m["head_dim"] or m["d_model"] // m["n_heads"]
    layers = costs.attn_layers(m)
    need = 0.0
    for s in ctx.traced_steps:
        for P in s.admitted:
            f, b, dt = costs.flash_attention_cost(
                batch=1, q_len=P, kv_len=P, heads=m["n_heads"],
                kv_heads=m["n_kv_heads"], head_dim=hd, dtype=m["dtype"])
            need += layers * peaks.least_s(f, b, dt)
    return 100.0 * need / took if took and need else None
