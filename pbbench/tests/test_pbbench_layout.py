"""A configuration's own weight layout and layer counts.

The default attention stack (``reference/decoder.py``, which defines no
hook) keeps the leaves, the draws and the counts it had before a
configuration could bring its own: the leaf list at full size hashes to
what the harness listed before, the weights at reduced widths are those
of its ``make_params`` before, bit for bit, and the decode step's least
work and the readers' layer counts read as before.
A configuration whose layers are not that stack is added by new files
only: its reference module's ``leaf_specs``, ``decode_step_cost`` and
``attn_layers`` are found by name in a checkout where no other file
changed.
"""
import filecmp
import hashlib
import json
import math
import shutil
import sys
from types import SimpleNamespace

import pytest
import torch

from pbb import costs, manifest, weights

CONFIGS = ("pipeboost-opt-1.3b", "qwen2-moe-a2.7b")
SEEDS = (11, 2 ** 31 + 77)


def leaf_list_digest(m) -> str:
    """sha256 of each leaf's path, shape and init, in the order of draws."""
    rows = [[list(s[0]), list(s[1]), s[2]] + list(s[3:])
            for s in weights.leaf_specs(m)]
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def flat(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_digest(tree) -> str:
    """sha256 of every leaf's path, dtype, shape and bytes."""
    h = hashlib.sha256()
    for path, t in flat(tree):
        h.update(f"{'/'.join(path)} {t.dtype} {tuple(t.shape)}".encode())
        h.update(t.detach().cpu().contiguous().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def reduced(name):
    """The configuration at widths the CPU makes in a moment, in its own
    serving dtype, with padded vocabulary rows and leaves whose sizes are
    not multiples of the buffer's alignment."""
    m = manifest.config(name)
    m.update(n_layers=2, d_model=36, n_heads=3, n_kv_heads=1, head_dim=12,
             d_ff=84, vocab_size=300)
    if m.get("n_experts"):
        m.update(n_experts=6, top_k=2, n_shared_experts=2, moe_d_ff=24)
    return m


POINTS = ((1, 40), (7, 2613), (64, 98304))    # (n_live, cached_rows)


def reader_ctx(m):
    """Traced and untraced steps with live rows, cached rows and prompts
    admitted, over a trace whose kernels took 12.3 ms."""
    steps = [SimpleNamespace(n_live=n, cached_rows=c, admitted=[n * 31 + 5],
                             decode_s=1e-3 * (n + 1), traced=True)
             for n, c in POINTS]
    trace = SimpleNamespace(time_of=lambda *kernels: 0.0123)
    return SimpleNamespace(m=m, trace=trace, traced_steps=steps,
                           window_steps=steps,
                           window=SimpleNamespace(steps=steps))


READERS = ("decode_attn_roofline.chat", "flash_roofline.chat",
           "kv_live_peak_gib", "decode_mfu.chat")


def readings(name):
    """What the harness reads of ``name`` at full size: its decode step's
    least work at ``POINTS`` (for an MoE also with every expert read) and
    each reader that counts layers, on ``reader_ctx``."""
    m = manifest.config(name)
    got = {f"cost{p}": costs.decode_step_cost(m, *p) for p in POINTS}
    if m.get("n_experts"):
        got.update({f"cost{p}+all": costs.decode_step_cost(
            m, *p, routed_read=m["n_experts"]) for p in POINTS})
    ctx = reader_ctx(m)
    got.update({r: manifest.reader(r)(ctx) for r in READERS})
    return got


# Recorded from the harness before a configuration could bring its own
# layout (pure arithmetic: the same on every machine).
LEAF_LISTS = {
    "pipeboost-opt-1.3b":
        "c26d0d465d37ae95944b8a90af832e2184f8ee382d94dcefbae331dccb43465b",
    "qwen2-moe-a2.7b":
        "dfa8a2d4685bc61876d4074894b7367194e622d9aa327664fc939a802cd98065"}
READINGS = {
    "pipeboost-opt-1.3b": {
        "cost(1, 40)": (2629894144.0, 2630300032.0),
        "cost(7, 2613)": (18867945472.0, 3138583168.0),
        "cost(64, 98304)": (187137261568.0, 21975101440.0),
        "decode_attn_roofline.chat": 48.23995223880598,
        "flash_roofline.chat": 3.4447904825081723,
        "kv_live_peak_gib": 18.01171875,
        "decode_mfu.chat": 11.042381946268659},
    "qwen2-moe-a2.7b": {
        "cost(1, 40)": (4763582464.0, 4764395008.0),
        "cost(7, 2613)": (33803763712.0, 5275118080.0),
        "cost(64, 98304)": (323693314048.0, 24134815744.0),
        "cost(1, 40)+all": (4763582464.0, 28017616384.0),
        "cost(7, 2613)+all": (33803763712.0, 28528339456.0),
        "cost(64, 98304)+all": (323693314048.0, 47388037120.0),
        "decode_attn_roofline.chat": 48.23995223880598,
        "flash_roofline.chat": 3.4447904825081723,
        "kv_live_peak_gib": 18.01171875,
        "decode_mfu.chat": 13.601722918208957}}


@pytest.mark.parametrize("name", CONFIGS)
def test_the_full_size_leaf_list_is_the_one_before(name):
    assert leaf_list_digest(manifest.config(name)) == LEAF_LISTS[name]


def parent_make_params(m, gen, device):
    """``weights.make_params`` as it was before a configuration could bring
    its own layout, kept verbatim: the new one is held to it bit for bit.
    (Digests recorded on one machine do not carry to another: the CPU's
    ``normal_`` draws differ between torch builds.)"""
    dtype = weights.DTYPES[m["dtype"]]
    specs = weights.leaf_specs(m)
    sizes = [-(-math.prod(s) // 64) * 64 if isinstance(i, float) else 0
             for _, s, i in specs]
    buf = torch.empty(sum(sizes), dtype=dtype, device=device)
    for at in range(0, buf.numel(), 1 << 30):
        buf[at:at + (1 << 30)].normal_(generator=gen)
    tree = {}
    at = 0
    V = m["vocab_size"]
    for (path, shape, init), size in zip(specs, sizes):
        if init == "ones":
            t = torch.ones(shape, dtype=dtype, device=device)
        else:
            t = buf[at:at + math.prod(shape)].view(shape).mul_(init)
            at += size
        if path == ("embed",):
            t[V:].zero_()
        elif path == ("lm_head",):
            t[:, V:].zero_()
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CONFIGS)
def test_the_weights_are_bit_identical_to_those_before(name, seed):
    m = reduced(name)
    got = weights.make_params(m, weights.generator(seed, "cpu"), "cpu")
    want = parent_make_params(m, weights.generator(seed, "cpu"), "cpu")
    assert params_digest(got) == params_digest(want)


@pytest.mark.parametrize("name", CONFIGS)
def test_the_least_work_and_layer_counts_read_as_before(name):
    m = manifest.config(name)
    assert costs.attn_layers(m) == m["n_layers"]
    assert readings(name) == READINGS[name]


def test_the_default_stack_defines_no_hook():
    for name in CONFIGS:
        ref = manifest.reference(manifest.config(name))
        assert not [h for h in manifest.HOOKS if hasattr(ref, h)]


TOY_REFERENCE = '''"""A toy hybrid for the harness's tests: four layers, a state-space
mixer in layers 0 and 2, attention in layers 1 and 3."""
import torch


def attn_layers(m):
    return sum(k == "attention" for k in m["layer_types"])


def a_log(shape, device):
    """-A's log, 1..H over the heads of every layer: a function of the
    shape, drawing nothing."""
    h = torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=device)
    return torch.log(h).expand(shape).clone()


def leaf_specs(m):
    D, H = m["d_model"], m["ssm_heads"]
    V = (m["vocab_size"] + 255) // 256 * 256
    L = len(m["layer_types"])
    La = attn_layers(m)
    Ls = L - La
    s = ("blocks", "ssm")
    a = ("blocks", "attn")
    return [(("embed",), (V, D), 0.02),
            (s + ("in_proj",), (Ls, D, 2 * D), D ** -0.5),
            (s + ("conv_b",), (Ls, 2 * D), "zeros"),
            (s + ("A_log",), (Ls, H), a_log, "float32"),
            (s + ("dt_bias",), (Ls, H), 0.5, "float32"),
            (s + ("D_skip",), (Ls, H), "ones", "float32"),
            (s + ("out_proj",), (Ls, 2 * D, D), (2 * D) ** -0.5),
            (a + ("wq",), (La, D, D), D ** -0.5),
            (a + ("wo",), (La, D, D), D ** -0.5),
            (("final_norm",), (D,), "ones")]


def decode_step_cost(m, n_live, cached_rows, routed_read=None):
    D = m["d_model"]
    w = 6 * D * D
    return float(2 * n_live * w), float(2 * w + 4 * cached_rows * D)
'''


@pytest.fixture
def dropped_in(tmp_path, monkeypatch):
    """A checkout with a configuration and its reference module added as
    new files and nothing else changed; the harness finds them by name."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.BENCH_DIR, root / "pbbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = {"name": "toy-hybrid", "source": "https://arxiv.org/abs/2405.21060",
         "reference": "toy_hybrid", "dtype": "bfloat16", "d_model": 32,
         "ssm_heads": 4, "vocab_size": 300,
         "layer_types": ["mamba", "attention", "mamba", "attention"],
         "n_kv_heads": 2, "n_heads": 4, "head_dim": 8, "n_layers": 4}
    new = {root / "pbbench" / "configs" / "toy-hybrid.json": json.dumps(m),
           root / "pbbench" / "reference" / "toy_hybrid.py": TOY_REFERENCE}
    for path, text in new.items():
        path.write_text(text)
    monkeypatch.setattr(manifest, "BENCH_DIR", root / "pbbench")
    saved = {k: v for k, v in sys.modules.items()
             if k == "reference" or k.startswith("reference.")}
    for k in saved:
        del sys.modules[k]
    monkeypatch.syspath_prepend(str(root / "pbbench"))
    try:
        yield root, set(new)
    finally:
        for k in [k for k in sys.modules
                  if k == "reference" or k.startswith("reference.")]:
            del sys.modules[k]
        sys.modules.update(saved)


def test_a_dropped_in_layout_brings_its_weights_and_counts(dropped_in):
    root, new = dropped_in
    m = manifest.config("toy-hybrid")
    ref = manifest.reference(m)
    assert ref.__file__ == str(root / "pbbench" / "reference"
                               / "toy_hybrid.py")
    a, b = (weights.make_params(m, weights.generator(2 ** 31 + 5, "cpu"),
                                "cpu") for _ in range(2))
    assert params_digest(a) == params_digest(b)
    dtypes = {"/".join(p): t.dtype for p, t in flat(a)}
    assert dtypes == {
        "embed": torch.bfloat16, "final_norm": torch.bfloat16,
        "blocks/ssm/in_proj": torch.bfloat16,
        "blocks/ssm/conv_b": torch.bfloat16,
        "blocks/ssm/A_log": torch.float32,
        "blocks/ssm/dt_bias": torch.float32,
        "blocks/ssm/D_skip": torch.float32,
        "blocks/ssm/out_proj": torch.bfloat16,
        "blocks/attn/wq": torch.bfloat16, "blocks/attn/wo": torch.bfloat16}
    ssm = a["blocks"]["ssm"]
    assert ssm["in_proj"].shape == (2, 32, 64)
    assert a["blocks"]["attn"]["wq"].shape == (2, 32, 32)
    assert not ssm["conv_b"].any()
    assert torch.equal(ssm["A_log"], ref.a_log((2, 4), "cpu"))
    assert torch.equal(ssm["D_skip"], torch.ones(2, 4))
    assert not a["embed"][300:].any() and a["embed"][:300].any()
    # a std leaf in another dtype is drawn in the serving dtype, then cast
    assert torch.equal(ssm["dt_bias"], ssm["dt_bias"].bfloat16().float())
    assert ssm["dt_bias"].unique().numel() == 8
    assert costs.attn_layers(m) == 2
    for p in POINTS:
        assert costs.decode_step_cost(m, *p) == ref.decode_step_cost(m, *p)
    ctx = reader_ctx(m)
    kv = manifest.reader("kv_live_peak_gib")(ctx)
    assert kv == (98304 + 64) * 2 * 2 * 2 * 8 * 2 / 2 ** 30
    for path in (root / "pbbench").rglob("*"):
        if path.is_file() and path not in new \
                and "__pycache__" not in path.parts:
            rel = path.relative_to(root / "pbbench")
            assert filecmp.cmp(path, manifest.ROOT / "pbbench" / rel,
                               shallow=False), rel


def test_a_module_with_part_of_the_hooks_is_refused(dropped_in):
    root, _ = dropped_in
    path = root / "pbbench" / "reference" / "toy_hybrid.py"
    path.write_text(TOY_REFERENCE.replace("def attn_layers",
                                          "def layer_count"))
    m = manifest.config("toy-hybrid")
    with pytest.raises(SystemExit, match="attn_layers"):
        weights.leaf_specs(m)
