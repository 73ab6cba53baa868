"""The weights and LoRA factors of one run, made by the benchmark from
``--seed`` on the device and handed alike to the program and to the
reference.

The tree has the leaves the program's serving path reads (its parameter
layout: for the default attention stack, per-layer weights stacked on a
leading layer axis under ``blocks[kind]``; a configuration whose reference
module defines ``leaf_specs`` brings its own, ``manifest``).  Every random
leaf is a view of one flat buffer filled by a few large ``normal_`` calls
of a generator on the device, in the dtype the model is served in, then
scaled in place: std 1/sqrt(fan-in) for a projection, 0.02 for the
embedding and for LoRA's B; norms are ones.  The padded vocabulary rows
(the program pads it to a multiple of 256) are zero, so their logit is 0
and never the largest.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from pbb import manifest

CHUNK = 1 << 30              # elements a normal_ call fills at most
ALIGN = 64                   # elements: every leaf starts 128-byte aligned

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}
Path = Tuple[str, ...]


def padded_vocab(m: Dict) -> int:
    return ((m["vocab_size"] + 255) // 256) * 256


def layer_kind(m: Dict) -> str:
    return "moe" if m.get("n_experts", 0) else "attn"


def leaf_specs(m: Dict) -> List[Tuple]:
    """(path, shape, init[, dtype]) of every leaf: the reference module's
    ``leaf_specs(m)`` where it has one, else the attention stack's."""
    hook = manifest.layout_hook(m, "leaf_specs")
    return hook(m) if hook else attention_stack_specs(m)


def attention_stack_specs(m: Dict) -> List[Tuple[Path, Tuple[int, ...],
                                                 object]]:
    """(path, shape, init) of every leaf of the default attention stack;
    init is a std or "ones"."""
    D, L = m["d_model"], m["n_layers"]
    hd = m["head_dim"] or D // m["n_heads"]
    Hq, Hkv, V = m["n_heads"], m["n_kv_heads"], padded_vocab(m)
    kind = layer_kind(m)
    b = ("blocks", kind)
    specs = [(("embed",), (V, D), 0.02)]
    specs += [(b + ("ln1",), (L, D), "ones"),
              (b + ("wq",), (L, D, Hq * hd), D ** -0.5),
              (b + ("wk",), (L, D, Hkv * hd), D ** -0.5),
              (b + ("wv",), (L, D, Hkv * hd), D ** -0.5),
              (b + ("wo",), (L, Hq * hd, D), (Hq * hd) ** -0.5),
              (b + ("ln2",), (L, D), "ones")]
    mlp = b + ("mlp",)
    if kind == "moe":
        E, F, S = m["n_experts"], m["moe_d_ff"], m.get("n_shared_experts", 0)
        specs += [(mlp + ("router",), (L, D, E), D ** -0.5),
                  (mlp + ("w_gate",), (L, E, D, F), D ** -0.5),
                  (mlp + ("w_up",), (L, E, D, F), D ** -0.5),
                  (mlp + ("w_down",), (L, E, F, D), F ** -0.5)]
        if S:
            sh = mlp + ("shared",)
            specs += [(sh + ("w_gate",), (L, S, D, F), D ** -0.5),
                      (sh + ("w_up",), (L, S, D, F), D ** -0.5),
                      (sh + ("w_down",), (L, S, F, D), F ** -0.5),
                      (sh + ("gate",), (L, D, 1), D ** -0.5)]
    else:
        F = m["d_ff"]
        if m["gated_mlp"]:
            specs.append((mlp + ("w_gate",), (L, D, F), D ** -0.5))
        specs += [(mlp + ("w_up",), (L, D, F), D ** -0.5),
                  (mlp + ("w_down",), (L, F, D), F ** -0.5)]
    specs.append((("final_norm",), (D,), "ones"))
    if not m["tie_embeddings"]:
        specs.append((("lm_head",), (D, V), D ** -0.5))
    return specs


def _numel(shape) -> int:
    return math.prod(shape)


def _flat_normal(n: int, dtype, device, gen: torch.Generator):
    buf = torch.empty(n, dtype=dtype, device=device)
    for at in range(0, n, CHUNK):
        buf[at:at + CHUNK].normal_(generator=gen)
    return buf


def _set(tree: Dict, path: Path, t: torch.Tensor) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = t


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        seed & 0xFFFFFFFFFFFFFFFF)


def _drawn(init) -> bool:
    return not callable(init) and not isinstance(init, str)


def make_params(m: Dict, gen: torch.Generator, device) -> Dict:
    """The model's weights on ``device``, each leaf in its spec's dtype
    (by default the serving dtype).  An init is a std (the leaf drawn from
    the flat buffer in the serving dtype, in the order of the specs, and
    cast where its dtype differs), ``"ones"``, ``"zeros"``, or a function
    ``init(shape, device)`` that draws nothing (such as an SSM's
    ``A_log`` as a function of its shape)."""
    serving = DTYPES[m["dtype"]]
    specs = leaf_specs(m)
    sizes = [-(-_numel(s[1]) // ALIGN) * ALIGN if _drawn(s[2]) else 0
             for s in specs]
    buf = _flat_normal(sum(sizes), serving, device, gen)
    tree: Dict = {}
    at = 0
    V = m["vocab_size"]
    for spec, size in zip(specs, sizes):
        path, shape, init = spec[:3]
        dtype = DTYPES[spec[3]] if len(spec) > 3 else serving
        if callable(init):
            t = init(shape, device).to(device=device, dtype=dtype)
        elif init == "ones":
            t = torch.ones(shape, dtype=dtype, device=device)
        elif init == "zeros":
            t = torch.zeros(shape, dtype=dtype, device=device)
        elif isinstance(init, str):
            raise ValueError(f"leaf {path}: unknown init {init!r}")
        else:
            t = buf[at:at + _numel(shape)].view(shape).mul_(init).to(dtype)
            at += size
        if path == ("embed",):
            t[V:].zero_()
        elif path == ("lm_head",):
            t[:, V:].zero_()
        _set(tree, path, t)
    return tree


def make_loras(m: Dict, names: List[str], rank: int, gen: torch.Generator,
               device) -> Dict[str, Dict[str, Dict[str, torch.Tensor]]]:
    """For each adapter name, float32 factors {target: {"A": (L, d_in, r),
    "B": (L, r, d_out)}} on the attention projections of every layer: A of
    std 1/sqrt(d_in), B of std 0.02 (a trained adapter's B is not zero)."""
    D, L = m["d_model"], m["n_layers"]
    hd = m["head_dim"] or D // m["n_heads"]
    dims = {"wq": (D, m["n_heads"] * hd), "wk": (D, m["n_kv_heads"] * hd),
            "wv": (D, m["n_kv_heads"] * hd), "wo": (m["n_heads"] * hd, D)}
    per = sum(L * rank * (a + b) for a, b in dims.values())
    buf = _flat_normal(per * len(names), torch.float32, device, gen)
    out, at = {}, 0
    for name in names:
        out[name] = {}
        for t, (din, dout) in dims.items():
            a = buf[at:at + L * din * rank].view(L, din, rank)
            at += L * din * rank
            b = buf[at:at + L * rank * dout].view(L, rank, dout)
            at += L * rank * dout
            out[name][t] = {"A": a.mul_(din ** -0.5), "B": b.mul_(0.02)}
    return out
