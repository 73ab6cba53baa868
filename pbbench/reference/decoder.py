"""The served decoder in plain float32 PyTorch: pre-norm layers of RMSNorm,
attention with split-half RoPE, and a dense MLP or a mixture of experts,
then a final RMSNorm and the (tied or separate) vocabulary head.

It follows the equations the configuration states, as the program serves
them:

* dense MLP: ``act(x W_up) W_down``, or ``act(x W_gate) * (x W_up)
  W_down`` when gated; ``gelu`` is the tanh approximation;
* MoE: router softmax in float32, the top k by a stable descending sort
  (ties in expert order), renormalised over the k; the shared experts
  gated by ``sigmoid(x w_gate)``.  A prompt is prefilled alone, and its
  tokens are routed as one group with a capacity per expert of
  ``max(8, ceil8(ceil(cf * T * k / E)))`` slots, (token, choice) pairs
  taking their expert's slots in token order, then choice order, pairs
  past the capacity dropped; every generated token is routed without
  drops (exact top k);
* LoRA: ``W + (alpha / r) A B`` on wq, wk, wv and wo of every layer,
  worked out here in float32 from the factors.

Everything runs in float32 from the served (bf16) weights, with TF32 off,
one layer at a time over all the sequences of one adapter, so that only
one layer's float32 weights are held at a time.

``control=True`` is the control of the correctness check: the same
computation with every projection, expert and vocabulary matrix rounded
to fp8 (e4m3) with one float32 scale per output channel, the step below
the served bf16 (the router and the norms stay float32).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0              # largest finite float8_e4m3fn


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


ACTS = {"gelu": _gelu_tanh, "silu": F.silu}


def fp8_round(w: torch.Tensor, in_dim: int = -2) -> torch.Tensor:
    """``w`` (float32) rounded to e4m3 with one scale per output channel
    (the amax over ``in_dim`` maps to 448), returned in float32."""
    s = w.abs().amax(dim=in_dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (w / s).to(torch.float8_e4m3fn).float() * s


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """x (S, H, hd), positions 0..S-1, split-half rotation."""
    S, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                       dtype=torch.float32) / hd)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, block: int = 512):
    """q (S, Hq, hd), k/v (S, Hkv, hd) -> (S, Hq, hd), causal softmax."""
    S, Hq, hd = q.shape
    G = Hq // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)     # (H, S, hd)
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    q = q.transpose(0, 1) * hd ** -0.5
    out = torch.empty_like(q)
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        sc = q[:, s0:s1] @ k[:, :s1].transpose(1, 2)       # (H, b, s1)
        qi = torch.arange(s0, s1, device=q.device)[:, None]
        kj = torch.arange(s1, device=q.device)[None, :]
        sc = sc.masked_fill(kj > qi, float("-inf"))
        out[:, s0:s1] = torch.softmax(sc, dim=-1) @ v[:, :s1]
    return out.transpose(0, 1)


def capacity(m: Dict, T: int) -> int:
    cap = math.ceil(m["capacity_factor"] * T * m["top_k"] / m["n_experts"])
    return max(8, -(-cap // 8) * 8)


def route(m: Dict, router, h, n_prompt: int):
    """(top_p (S, k), top_e (S, k), keep (S, k)): the prompt's pairs past
    their expert's capacity are not kept."""
    probs = torch.softmax(h @ router, dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = m["top_k"]
    top_p = srt[:, :K] / srt[:, :K].sum(-1, keepdim=True)
    top_e = idx[:, :K]
    keep = torch.ones_like(top_e, dtype=torch.bool)
    P = n_prompt
    oh = F.one_hot(top_e[:P], m["n_experts"]).reshape(P * K, -1).float()
    slot = ((torch.cumsum(oh, 0) - oh) * oh).sum(-1).reshape(P, K)
    keep[:P] = slot < capacity(m, P)
    return top_p, top_e, keep


def _expert(act, x, wg, wu, wd):
    return (act(x @ wg) * (x @ wu)) @ wd


def moe_ffn(m: Dict, w: Dict, h, n_prompt: int):
    act = ACTS[m["act"]]
    top_p, top_e, keep = route(m, w["router"], h, n_prompt)
    y = torch.zeros_like(h)
    for e in range(m["n_experts"]):
        rows, ks = ((top_e == e) & keep).nonzero(as_tuple=True)
        if rows.numel():
            out = _expert(act, h[rows], w["w_gate"][e], w["w_up"][e],
                          w["w_down"][e])
            y.index_add_(0, rows, out * top_p[rows, ks][:, None])
    if "shared" in w:
        s = w["shared"]
        ys = sum(_expert(act, h, s["w_gate"][i], s["w_up"][i],
                         s["w_down"][i]) for i in range(s["w_gate"].shape[0]))
        y = y + ys * torch.sigmoid(h @ s["gate"])
    return y


def dense_ffn(m: Dict, w: Dict, h):
    act = ACTS[m["act"]]
    if "w_gate" in w:
        return (act(h @ w["w_gate"]) * (h @ w["w_up"])) @ w["w_down"]
    return act(h @ w["w_up"]) @ w["w_down"]


def _f32(t, fp8: bool, in_dim: int = -2):
    t = t.float()
    return fp8_round(t, in_dim) if fp8 else t


def layer_weights(m: Dict, blocks: Dict, l: int, lora: Optional[Dict],
                  fp8: bool) -> Dict:
    """Layer ``l``'s weights in float32, LoRA merged, fp8-rounded for the
    control."""
    w = {"ln1": blocks["ln1"][l].float(), "ln2": blocks["ln2"][l].float()}
    scale = None if lora is None else lora["alpha"] / lora["rank"]
    for t in ("wq", "wk", "wv", "wo"):
        x = blocks[t][l].float()
        if lora is not None:
            ab = lora["factors"][t]
            x = x + scale * (ab["A"][l].float() @ ab["B"][l].float())
        w[t] = fp8_round(x) if fp8 else x
    src = blocks["mlp"]
    mlp = {}
    for k, v in src.items():
        if k == "shared":
            mlp[k] = {kk: (vv[l].float() if kk == "gate"
                           else _f32(vv[l], fp8)) for kk, vv in v.items()}
        elif k == "router":
            mlp[k] = v[l].float()
        else:
            mlp[k] = _f32(v[l], fp8)
    w["mlp"] = mlp
    return w


def _layer(m: Dict, w: Dict, x, n_prompt: int):
    hd = m["head_dim"] or m["d_model"] // m["n_heads"]
    S = x.shape[0]
    h = rms_norm(x, w["ln1"], m["norm_eps"])
    q = rope((h @ w["wq"]).view(S, m["n_heads"], hd), m["rope_theta"])
    k = rope((h @ w["wk"]).view(S, m["n_kv_heads"], hd), m["rope_theta"])
    v = (h @ w["wv"]).view(S, m["n_kv_heads"], hd)
    x = x + causal_attention(q, k, v).reshape(S, -1) @ w["wo"]
    h = rms_norm(x, w["ln2"], m["norm_eps"])
    if m.get("n_experts", 0):
        return x + moe_ffn(m, w["mlp"], h, n_prompt)
    return x + dense_ffn(m, w["mlp"], h)


def _head(m: Dict, params: Dict, fp8: bool):
    V = m["vocab_size"]
    if m["tie_embeddings"]:
        return _f32(params["embed"][:V], fp8, in_dim=-1).T
    return _f32(params["lm_head"][:, :V], fp8)


def final_hidden(m: Dict, params: Dict, seqs: Sequence[Tuple[torch.Tensor,
                                                             int]],
                 lora: Optional[Dict] = None, control: bool = False
                 ) -> List[torch.Tensor]:
    """The final normed hidden states (S, D) float32 of each (tokens (S,),
    prompt length) in ``seqs``, all under one adapter (``lora``: {"rank",
    "alpha", "factors": {target: {"A", "B"}}}, or None)."""
    kind = "moe" if m.get("n_experts", 0) else "attn"
    blocks = params["blocks"][kind]
    emb = params["embed"]
    if control:
        xs = [fp8_round(emb[t].float(), in_dim=-1) for t, _ in seqs]
    else:
        xs = [emb[t].float() for t, _ in seqs]
    for l in range(m["n_layers"]):
        w = layer_weights(m, blocks, l, lora, control)
        xs = [_layer(m, w, x, p) for x, (_, p) in zip(xs, seqs)]
        del w
    fn = params["final_norm"].float()
    return [rms_norm(x, fn, m["norm_eps"]) for x in xs]


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
    """For each position, by how much the reference's logit of the picked
    token lies below the reference's best (0 where it is the best; inf for
    a token outside the vocabulary)."""
    head = _head(m, params, False)
    V = head.shape[1]
    out = []
    for h, pick in zip(hidden, picks):
        parts = []
        for s in range(0, h.shape[0], block):
            lg = h[s:s + block] @ head
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
