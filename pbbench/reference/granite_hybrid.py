"""granite-4.0-h (``GraniteMoeHybridForCausalLM``) in plain float32
PyTorch: Mamba-2 and attention mixers, each followed by a mixture of
experts beside a shared MLP, as the configuration states them.

The equations (transformers' ``models/granitemoehybrid``), over the first
``num_hidden_layers`` entries of ``layer_types``:

* ``x = embed[ids] * embedding_multiplier``;
* each layer: ``x = x + residual_multiplier * mixer(rms_norm(x))``, then
  ``x = x + residual_multiplier * (moe(h) + shared_mlp(h))`` with ``h =
  rms_norm(x)`` (eps ``rms_norm_eps``);
* a Mamba-2 mixer (one group): ``[z | xBC | dt] = h in_proj``; ``xBC =
  silu(causal_conv(xBC) + conv_bias)``; ``[x | B | C] = xBC``; ``dt =
  softplus(dt + dt_bias)``, ``A = -exp(A_log)``; per head ``s_t =
  exp(dt_t A) s_{t-1} + dt_t x_t B_tᵀ`` from zeros, ``y_t = s_t C_t + D
  x_t``; ``out = (rms_norm(y * silu(z)) * w) out_proj`` over all
  ``d_inner`` channels.  The recurrence runs in its chunked dual form
  (chunks of ``mamba_chunk_size``), which is the same sum in another
  order;
* an attention mixer: no bias, no position embedding, ``softmax(q kᵀ *
  attention_multiplier)`` causal, query heads in groups over the KV heads;
* the MoE: router logits, the top ``num_experts_per_tok``, a softmax over
  those (ties to the lower expert index), each chosen SwiGLU expert times
  its weight; the shared SwiGLU MLP of ``shared_intermediate_size`` added
  with no gate;
* logits: ``rms_norm(x) embedᵀ / logits_scaling`` (tied).

Everything runs in float32 from the served (bf16) weights, TF32 off, one
layer at a time over all the sequences, so that only one layer's float32
weights (3.2 GB) are held beside the served ones.  The leaves are laid out
as the program reads them (``leaf_specs``), projections as (in, out).

``control=True`` is the correctness check's control: every projection,
expert, shared-MLP and vocabulary matrix rounded to fp8 (e4m3) with one
float32 scale per output channel, the step below the served bf16 (router,
norms, conv, A, dt_bias and D stay float32).

The layout hooks: ``leaf_specs``, ``decode_step_cost`` (weights, the
experts a uniform routing hits, the Mamba layers' state read and written,
the attention layers' K/V) and ``attn_layers`` (the attention entries
among the layers kept).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0              # largest finite float8_e4m3fn
# The embedding's std.  The head is the embedding, and the input is the
# embedding times 12: at the attention stack's 0.02 the current token's own
# logit would stand 12 sqrt(4096) 0.02 / rms(x), about 11 standard
# deviations, above the rest, and every step would repeat its input, which
# no check can tell from a fault.  At 0.002 it stands about one above.
EMBED_STD = 0.002
# wq's and wk's std over 1/sqrt(fan-in).  The scores are q kᵀ / 128 over
# head_dim 128: at 1/sqrt(fan-in) they spread with std 0.09 and every head
# averages its whole prefix, so that the attention layers add next to
# nothing and the order of the keys (a position embedding) goes unseen.
# At 6 they spread with std about 3 and a head picks a few keys.
QK_SCALE = 6.0


# --------------------------------------------------------------------------
# sizes
# --------------------------------------------------------------------------

def kinds(m: Dict) -> List[str]:
    """"mamba" or "attention" of each layer kept."""
    return list(m["layer_types"][:m["num_hidden_layers"]])


def _sizes(m: Dict) -> Dict[str, int]:
    D = m["hidden_size"]
    di = m["mamba_expand"] * D
    return dict(D=D, di=di, N=m["mamba_d_state"], H=m["mamba_n_heads"],
                P=m["mamba_d_head"], K=m["mamba_d_conv"],
                G=m["mamba_n_groups"], Hq=m["num_attention_heads"],
                Hkv=m["num_key_value_heads"],
                hd=D // m["num_attention_heads"], E=m["num_local_experts"],
                k=m["num_experts_per_tok"], F=m["intermediate_size"],
                Fs=m["shared_intermediate_size"],
                V=m["vocab_size"], Vp=-(-m["vocab_size"] // 256) * 256)


def attn_layers(m: Dict) -> int:
    """The layers that attend and hold K/V rows."""
    return kinds(m).count("attention")


# --------------------------------------------------------------------------
# the weight layout (the program's: per-layer leaves stacked by kind)
# --------------------------------------------------------------------------

def a_log(shape, device):
    """Mamba-2's A: 1..16 across the heads, as log."""
    L, H = shape
    return torch.log(torch.linspace(1.0, 16.0, H, device=device)).expand(
        L, H).clone()


def dt_bias(shape, device):
    """Mamba-2's dt_bias: the inverse softplus of dt log-spaced over
    0.001-0.1 across the heads."""
    L, H = shape
    dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), H,
                                  device=device))
    return (dt + torch.log(-torch.expm1(-dt))).expand(L, H).clone()


def _moe_specs(pre: Tuple[str, ...], L: int, s: Dict) -> List[Tuple]:
    D, E, Fe, Fs = s["D"], s["E"], s["F"], s["Fs"]
    mlp, sh = pre + ("mlp",), pre + ("mlp", "shared")
    return [(pre + ("ln2",), (L, D), "ones"),
            (mlp + ("router",), (L, D, E), D ** -0.5),
            (mlp + ("w_gate",), (L, E, D, Fe), D ** -0.5),
            (mlp + ("w_up",), (L, E, D, Fe), D ** -0.5),
            (mlp + ("w_down",), (L, E, Fe, D), Fe ** -0.5),
            (sh + ("w_gate",), (L, 1, D, Fs), D ** -0.5),
            (sh + ("w_up",), (L, 1, D, Fs), D ** -0.5),
            (sh + ("w_down",), (L, 1, Fs, D), Fs ** -0.5)]


def leaf_specs(m: Dict) -> List[Tuple]:
    """(path, shape, init[, dtype]) of every leaf, in the order of draws:
    the embedding, the Mamba layers (``blocks/ssm``), the attention layers
    (``blocks/moe``), the final norm."""
    s = _sizes(m)
    D, di, N, H, K = s["D"], s["di"], s["N"], s["H"], s["K"]
    Hq, Hkv, hd = s["Hq"], s["Hkv"], s["hd"]
    ks = kinds(m)
    Lm, La = ks.count("mamba"), ks.count("attention")
    ssm, att = ("blocks", "ssm"), ("blocks", "moe")
    specs = [(("embed",), (s["Vp"], D), EMBED_STD)]
    specs += [(ssm + ("norm",), (Lm, D), "ones"),
              (ssm + ("in_proj",), (Lm, D, 2 * di + 2 * N + H), D ** -0.5),
              (ssm + ("conv_w",), (Lm, K, di + 2 * N), 0.5),
              (ssm + ("conv_b",), (Lm, di + 2 * N), 0.1),
              (ssm + ("A_log",), (Lm, H), a_log, "float32"),
              (ssm + ("dt_bias",), (Lm, H), dt_bias, "float32"),
              (ssm + ("D_skip",), (Lm, H), "ones", "float32"),
              (ssm + ("gate_norm",), (Lm, di), "ones"),
              (ssm + ("out_proj",), (Lm, di, D), di ** -0.5)]
    specs += _moe_specs(ssm, Lm, s)
    specs += [(att + ("ln1",), (La, D), "ones"),
              (att + ("wq",), (La, D, Hq * hd), QK_SCALE * D ** -0.5),
              (att + ("wk",), (La, D, Hkv * hd), QK_SCALE * D ** -0.5),
              (att + ("wv",), (La, D, Hkv * hd), D ** -0.5),
              (att + ("wo",), (La, Hq * hd, D), (Hq * hd) ** -0.5)]
    specs += _moe_specs(att, La, s)
    specs.append((("final_norm",), (D,), "ones"))
    return specs


def expected_experts_hit(m: Dict, n_live: int) -> float:
    """Distinct experts ``n_live`` tokens reach under a uniform routing of
    ``num_experts_per_tok`` different experts each, in expectation."""
    s = _sizes(m)
    return s["E"] * (1.0 - (1.0 - s["k"] / s["E"]) ** n_live)


def decode_step_cost(m: Dict, n_live: int, cached_rows: int,
                     routed_read: Optional[float] = None
                     ) -> Tuple[float, float]:
    """(operations, bytes) one decode step of ``n_live`` rows needs at
    least, their attention caches holding ``cached_rows`` positions in all.
    Bytes: every weight read once, but of the routed experts only the
    ``routed_read`` each MoE reads (by default the experts a uniform
    routing hits in expectation, ``expected_experts_hit``); each live row's
    Mamba state (float32) and conv window read and written once in every
    Mamba layer; the live K/V rows read and the new ones written once in
    every attention layer; the embedding rows read and the float32 logits
    written once.  Operations: two per weight used and live row (the top
    k experts), the state's update and read, and the attention's two
    products per visible key."""
    s = _sizes(m)
    it = {"bfloat16": 2, "float16": 2, "float32": 4}[m["dtype"]]
    D, di, N, H, P, K = s["D"], s["di"], s["N"], s["H"], s["P"], s["K"]
    Hq, Hkv, hd, E, k = s["Hq"], s["Hkv"], s["hd"], s["E"], s["k"]
    ks = kinds(m)
    Lm, La = ks.count("mamba"), ks.count("attention")
    read = expected_experts_hit(m, n_live) if routed_read is None \
        else routed_read
    mixer = D * (2 * di + 2 * N + H) + K * (di + 2 * N) + (di + 2 * N) \
        + di + di * D
    attn = D * Hq * hd + 2 * D * Hkv * hd + Hq * hd * D
    expert = 3 * D * s["F"]
    ffn_fixed = D * E + 3 * D * s["Fs"] + 2 * D          # router, shared, 2 norms
    weights = (Lm * (mixer + ffn_fixed + read * expert)
               + La * (attn + ffn_fixed + read * expert) + D) * it
    state = H * P * N * 4 + (K - 1) * (di + 2 * N) * it   # a row's, a layer's
    kv_row = 2 * Hkv * hd * it
    nbytes = (weights + Lm * n_live * 2 * state
              + La * kv_row * (cached_rows + n_live)
              + n_live * D * it + 4 * n_live * s["V"])
    used = Lm * (mixer + ffn_fixed + k * expert) \
        + La * (attn + ffn_fixed + k * expert) + s["V"] * D
    flops = (2 * n_live * used + Lm * n_live * 6 * H * P * N
             + La * 4 * Hq * hd * (cached_rows + n_live))
    return float(flops), float(nbytes)


# --------------------------------------------------------------------------
# the forward
# --------------------------------------------------------------------------

def fp8_round(w: torch.Tensor, in_dim: int = -2) -> torch.Tensor:
    """``w`` (float32) rounded to e4m3 with one scale per output channel
    (the amax over ``in_dim`` maps to 448), returned in float32."""
    sc = w.abs().amax(dim=in_dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (w / sc).to(torch.float8_e4m3fn).float() * sc


def _f32(t, fp8: bool, in_dim: int = -2):
    t = t.float()
    return fp8_round(t, in_dim) if fp8 else t


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _layer(tree: Dict, l: int, fp8: bool, path: Tuple[str, ...] = ()
           ) -> Dict:
    """Layer ``l``'s leaves in float32, the matrices fp8-rounded for the
    control."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _layer(v, l, fp8, path + (k,))
        elif k in ("in_proj", "out_proj", "wq", "wk", "wv", "wo", "w_gate",
                   "w_up", "w_down"):
            out[k] = _f32(v[l], fp8)
        else:
            out[k] = v[l].float()
    return out


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """The SSM of one sequence from a zero state: x (S, H, P), dt (S, H), A
    (H,), B and C (S, N) -> y (S, H, P), as the chunked dual form (within
    a chunk the masked products, across chunks the carried state)."""
    S, H, P = x.shape
    N = B.shape[1]
    y = torch.empty_like(x)
    s = x.new_zeros(H, P, N)
    for t0 in range(0, S, chunk):
        t1 = min(S, t0 + chunk)
        q = t1 - t0
        a = dt[t0:t1] * A                                   # (q, H)
        cum = torch.cumsum(a, dim=0)                        # (q, H)
        # decay from j to i (i >= j): exp(cum_i - cum_j)
        seg = cum[:, None, :] - cum[None, :, :]             # (i, j, H)
        mask = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
        Lm = torch.exp(seg.masked_fill(~mask[..., None], float("-inf")))
        cb = C[t0:t1] @ B[t0:t1].T                          # (i, j)
        w = Lm * cb[..., None] * dt[t0:t1][None, :, :]      # (i, j, H)
        xc = x[t0:t1]
        y_in = torch.einsum("ijh,jhp->ihp", w, xc)
        y_st = torch.einsum("in,hpn->ihp", C[t0:t1], s) \
            * torch.exp(cum)[..., None]
        y[t0:t1] = y_in + y_st
        # the state after the chunk
        dec = torch.exp(cum[-1][None, :] - cum) * dt[t0:t1]   # (q, H)
        s = s * torch.exp(cum[-1])[:, None, None] + torch.einsum(
            "jh,jhp,jn->hpn", dec, xc, B[t0:t1])
    return y


def _mamba(m: Dict, w: Dict, h):
    s = _sizes(m)
    di, N, H, P, K = s["di"], s["N"], s["H"], s["P"], s["K"]
    S = h.shape[0]
    zxbcdt = h @ w["in_proj"]
    z, xbc, dt = zxbcdt[:, :di], zxbcdt[:, di:2 * di + 2 * N], \
        zxbcdt[:, 2 * di + 2 * N:]
    pad = torch.cat([xbc.new_zeros(K - 1, xbc.shape[1]), xbc])
    conv = w["conv_b"] + sum(pad[i:i + S] * w["conv_w"][i] for i in range(K))
    xbc = F.silu(conv)
    x = xbc[:, :di].reshape(S, H, P)
    B, C = xbc[:, di:di + N], xbc[:, di + N:]
    dt = F.softplus(dt + w["dt_bias"])
    y = ssd_chunked(x, dt, -torch.exp(w["A_log"]), B, C,
                    m["mamba_chunk_size"])
    y = (y + w["D_skip"][:, None] * x).reshape(S, di) * F.silu(z)
    return rms_norm(y, w["gate_norm"], m["rms_norm_eps"]) @ w["out_proj"]


def _attention(m: Dict, w: Dict, h, block: int = 512):
    s = _sizes(m)
    Hq, Hkv, hd = s["Hq"], s["Hkv"], s["hd"]
    S = h.shape[0]
    q = (h @ w["wq"]).view(S, Hq, hd).transpose(0, 1)
    k = (h @ w["wk"]).view(S, Hkv, hd).transpose(0, 1)
    v = (h @ w["wv"]).view(S, Hkv, hd).transpose(0, 1)
    k = k.repeat_interleave(Hq // Hkv, dim=0)
    v = v.repeat_interleave(Hq // Hkv, dim=0)
    out = torch.empty_like(q)
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        sc = (q[:, s0:s1] @ k[:, :s1].transpose(1, 2)) \
            * m["attention_multiplier"]
        qi = torch.arange(s0, s1, device=h.device)[:, None]
        kj = torch.arange(s1, device=h.device)[None, :]
        sc = sc.masked_fill(kj > qi, float("-inf"))
        out[:, s0:s1] = torch.softmax(sc, dim=-1) @ v[:, :s1]
    return out.transpose(0, 1).reshape(S, Hq * hd) @ w["wo"]


def _swiglu(h, wg, wu, wd):
    return (F.silu(h @ wg) * (h @ wu)) @ wd


def _moe(m: Dict, w: Dict, h):
    """h (T, D) of any tokens -> the routed experts plus the shared MLP."""
    k = m["num_experts_per_tok"]
    logits = h @ w["router"]
    srt, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates, top_e = torch.softmax(srt[:, :k], dim=-1), idx[:, :k]
    y = torch.zeros_like(h)
    for e in range(m["num_local_experts"]):
        rows, ks = (top_e == e).nonzero(as_tuple=True)
        if rows.numel():
            out = _swiglu(h[rows], w["w_gate"][e], w["w_up"][e],
                          w["w_down"][e])
            y.index_add_(0, rows, out * gates[rows, ks][:, None])
    sh = w["shared"]
    return y + _swiglu(h, sh["w_gate"][0], sh["w_up"][0], sh["w_down"][0])


def final_hidden(m: Dict, params: Dict, seqs: Sequence[Tuple[torch.Tensor,
                                                             int]],
                 lora: Optional[Dict] = None, control: bool = False
                 ) -> List[torch.Tensor]:
    """The final normed hidden states (S, D) float32 of each (tokens (S,),
    prompt length) in ``seqs``; ``lora`` must be None (the configuration
    serves the base model only)."""
    if lora is not None:
        raise ValueError("granite-4.0-h is served without adapters")
    eps, rm = m["rms_norm_eps"], m["residual_multiplier"]
    emb = params["embed"]
    xs = [(fp8_round(emb[t].float(), in_dim=-1) if control
           else emb[t].float()) * m["embedding_multiplier"] for t, _ in seqs]
    lens = [x.shape[0] for x in xs]
    at = {"mamba": 0, "attention": 0}
    for kind in kinds(m):
        blocks = params["blocks"]["ssm" if kind == "mamba" else "moe"]
        w = _layer(blocks, at[kind], control)
        at[kind] += 1
        if kind == "mamba":
            xs = [x + rm * _mamba(m, w, rms_norm(x, w["norm"], eps))
                  for x in xs]
        else:
            xs = [x + rm * _attention(m, w, rms_norm(x, w["ln1"], eps))
                  for x in xs]
        flat = torch.cat(xs)
        flat = flat + rm * _moe(m, w["mlp"], rms_norm(flat, w["ln2"], eps))
        xs = list(flat.split(lens))
        del w, flat
    fn = params["final_norm"].float()
    return [rms_norm(x, fn, eps) for x in xs]


def _head(m: Dict, params: Dict, fp8: bool):
    return _f32(params["embed"][:m["vocab_size"]], fp8, in_dim=-1).T


def top_tokens(m: Dict, params: Dict, hidden: Sequence[torch.Tensor],
               control: bool, block: int = 512) -> List[torch.Tensor]:
    """The token each position's logits put first."""
    head = _head(m, params, control)
    return [torch.cat([(h[s:s + block] @ head).argmax(-1)
                       for s in range(0, h.shape[0], block)])
            for h in hidden]


def gaps(m: Dict, params: Dict, hidden: Sequence[torch.Tensor],
         picks: Sequence[torch.Tensor], block: int = 512
         ) -> List[torch.Tensor]:
    """For each position, by how much the reference's logit (divided by
    ``logits_scaling``) of the picked token lies below its best (0 where
    it is the best; inf for a token outside the vocabulary)."""
    head = _head(m, params, False)
    V = head.shape[1]
    out = []
    for h, pick in zip(hidden, picks):
        parts = []
        for s in range(0, h.shape[0], block):
            lg = (h[s:s + block] @ head) / m["logits_scaling"]
            p = pick[s:s + block]
            ok = (p >= 0) & (p < V)
            got = lg.gather(1, p.clamp(0, V - 1)[:, None])[:, 0]
            parts.append(torch.where(ok, lg.amax(-1) - got,
                                     torch.full_like(got, float("inf"))))
        out.append(torch.cat(parts))
    return out


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """Float32 products in float32 (TF32 off) within the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
