"""The SSD scan kernel's share of its roofline in the traced sub-window:
the least time of the scans the admission prefills there ran (``cost``
below, a frozen copy of ``kernels/ssd_scan.py``'s ``cost()``: one scan of
batch 1 from a zero state at each prompt's real length, the ``tokens`` of
the program's ``prefill`` records made in the traced steps, in every Mamba
layer kept) over the device time of the kernel's launches (chunk states,
state pass, chunk outputs) in the trace.  None where the program keeps no
records or the trace holds no scan."""
import sys

from pbb import peaks

KERNELS = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")
CHUNK = 64               # the kernel's chunk length


def cost(*, batch: int, seq: int, heads: int, head_dim: int, state: int,
         dtype: str = "bfloat16"):
    """(operations, bytes, peak dtype) of one scan from a zero state: x,
    dt, A, B and C read once (x, B, C in ``dtype``, dt and A float32), y
    written once in ``dtype`` and the float32 final state once; per chunk
    of ``CHUNK`` rows the causal pairs of C Bᵀ once, and per head the
    pairs' products with x, the state's read C h and its update xᵀ B, on
    the tensor cores (the bf16 peak)."""
    it = 2 if dtype in ("bfloat16", "float16") else 4
    x = batch * seq * heads * head_dim * it
    inputs = (x + batch * seq * heads * 4 + heads * 4
              + 2 * batch * seq * state * it)
    st = batch * heads * head_dim * state * 4
    flops = 0
    for t0 in range(0, seq, CHUNK):
        q = min(CHUNK, seq - t0)
        pairs = q * (q + 1) // 2
        flops += batch * (2 * state * pairs
                          + heads * (2 * head_dim * pairs
                                     + 4 * q * head_dim * state))
    return flops, inputs + x + st, "bfloat16"


def read(ctx):
    tr = sys.modules.get("repro_torch.serving.tracing")
    if ctx.trace is None or tr is None:
        return None
    took = ctx.trace.time_of(*KERNELS)
    m = ctx.m
    layers = list(m["layer_types"][:m["num_hidden_layers"]]).count("mamba")
    t0s = {s.t0 for s in ctx.traced_steps}
    need = 0.0
    for r in tr.TRACER.prefill:
        if r.clock in t0s:
            f, b, dt = cost(batch=1, seq=r.tokens, heads=m["mamba_n_heads"],
                            head_dim=m["mamba_d_head"],
                            state=m["mamba_d_state"], dtype=m["dtype"])
            need += layers * peaks.least_s(f, b, dt)
    return 100.0 * need / took if took and need else None
