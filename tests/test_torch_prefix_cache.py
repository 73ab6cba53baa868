"""The port's cross-request prefix cache against the JAX package's: the
store (``serving/prefix_cache.py``) under one seeded sequence of
operations, entries crossing packages, and the batcher's prefix reuse
(``ContinuousBatcher.attach_prefix_cache``, the hit import and suffix
walk, the deposits) on a reduced qwen3-1.7b with weights converted by
``params_from_jax``.  Token streams under ``quantized_greedy`` must equal
the reference's, with equal hit and prefill-token counts.
"""
import functools

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.models import transformer as JT
from repro.serving import engine as jserve
from repro.serving import prefix_cache as jpc
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.serving import engine as tserve
from repro_torch.serving import prefix_cache as tpc

KEY = jax.random.PRNGKey(7)
ROW_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _setup(arch="qwen3-1.7b", layers=2, dtype=None, window=None):
    kw = {}
    if dtype is not None:
        kw["dtype"] = dtype
    if window is not None:
        kw["attn_window"] = window
    jcfg = jget_arch(arch).reduced(n_layers=layers, **kw)
    tcfg = get_arch(arch).reduced(n_layers=layers, **kw)
    jp = JT.init_params(jcfg, KEY)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


def _batcher(mod, cfg, params, cache=None, n_slots=4):
    cb = mod.ContinuousBatcher(cfg, params, n_slots, 96,
                               sampler=mod.quantized_greedy)
    if cache is not None:
        cb.attach_prefix_cache(cache)
    return cb


def _prompts(seed, pre_len=24, n=3, sfx=(4, 7, 2)):
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, 250, size=pre_len)
    return [np.concatenate([pre, rng.integers(0, 250, size=sfx[i % 3])])
            for i in range(n)]


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def _entries(pc):
    return [(key, e.tokens.tolist(), e.pos, e.nbytes, e.last_used, e.refs)
            for key, e in pc.export_entries()]


def test_store_matches_reference_under_seeded_ops():
    """One seeded sequence of insert / probe / release / match / covers
    operations (rows-less and with rows) drives both stores: every return
    value, the entries (tokens, pos, bytes, LRU stamps, pins), the
    evictions and the byte counts stay equal."""
    rng = np.random.default_rng(3)
    stores = [jpc.PrefixCache(4096), tpc.PrefixCache(4096)]
    pinned = [[], []]
    prefixes = [rng.integers(0, 9, size=int(rng.integers(4, 20)))
                for _ in range(5)]
    for _ in range(300):
        op = rng.choice(["insert", "insert_rows", "probe", "release",
                         "match", "covers"])
        base = prefixes[int(rng.integers(len(prefixes)))]
        cut = int(rng.integers(1, len(base) + 1))
        toks = np.concatenate([base[:cut],
                               rng.integers(0, 9, size=int(rng.integers(0,
                                                                        6)))])
        adapter = [None, "a"][int(rng.integers(2))]
        arch = ["m", "n"][int(rng.integers(2))]
        pos = int(rng.integers(0, len(toks) + 2))
        nbytes = int(rng.integers(64, 1500))
        if op == "insert":
            outs = [s.insert(arch, adapter, toks, pos, nbytes=nbytes)
                    for s in stores]
        elif op == "insert_rows":
            rows = {"attn": {"k": rng.standard_normal(
                (2, 16, 3)).astype(np.float32)}}
            outs = [s.insert(arch, adapter, toks, pos, rows=rows)
                    for s in stores]
        elif op == "probe":
            outs = []
            for s, pins in zip(stores, pinned):
                h = s.probe(arch, adapter, toks)
                if h is not None:
                    pins.append(h[0])
                outs.append(None if h is None else
                            (h[1], h[0].pos, h[0].tokens.tolist()))
        elif op == "release":
            if not pinned[0]:
                continue
            j = int(rng.integers(len(pinned[0])))
            for s, pins in zip(stores, pinned):
                s.release(pins.pop(j))
            outs = [0, 0]
        elif op == "match":
            outs = [s.match_len(arch, adapter, toks) for s in stores]
        else:
            outs = [s.covers(arch, adapter, toks, pos) for s in stores]
        assert outs[0] == outs[1], op
        assert stores[0].stats() == stores[1].stats()
        assert _entries(stores[0]) == _entries(stores[1])
    assert stores[1].evictions > 0 and stores[1].hits > 0


def test_entries_cross_packages():
    """``export_entries`` of either store imports into the other: the
    same entries, rows and byte counts (bf16 rows as ml_dtypes bits from
    the reference, uint16 bits from the port)."""
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 1 << 16, size=(2, 8, 4)).astype(np.uint16)
    ref = jpc.PrefixCache()
    ref.insert("m", None, np.arange(8), 8,
               rows={"attn": {"k": bits.view(ml_dtypes.bfloat16)}})
    ref.insert("m", "a", np.arange(5) + 3, 4,
               rows={"attn": {"k": rng.standard_normal((2, 8, 4))
                              .astype(np.float32)}})
    port = tpc.PrefixCache()
    assert port.import_entries(ref.export_entries()) == 2
    back = jpc.PrefixCache()
    assert back.import_entries(port.export_entries()) == 2
    for a, b in ((ref, port), (port, back)):
        assert a.stats()["prefix_bytes"] == b.stats()["prefix_bytes"]
        for (ka, ea), (kb, eb) in zip(a.export_entries(),
                                     b.export_entries()):
            assert ka == kb and ea.pos == eb.pos and ea.nbytes == eb.nbytes
            np.testing.assert_array_equal(ea.tokens, eb.tokens)
            ra, rb = ea.rows["attn"]["k"], eb.rows["attn"]["k"]
            np.testing.assert_array_equal(ra.view(np.uint8),
                                          rb.view(np.uint8))


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------

def _serve_both(script, dtype=None):
    """Run ``script(mod, batcher)`` on the reference's batcher and on the
    port's, each with and without a cache; return the four results."""
    jcfg, jp, tcfg, tp = _setup(dtype=dtype)
    out = {}
    for name, mod, cfg, params, store in (
            ("jax", jserve, jcfg, jp, jpc), ("torch", tserve, tcfg, tp, tpc)):
        for cached in (False, True):
            pc = store.PrefixCache(64 << 20) if cached else None
            cb = _batcher(mod, cfg, params, pc)
            out[name, cached] = (script(mod, cb), cb, pc)
    return out


def _script_waves(mod, cb):
    """A donor, then a batch of two hits admitted while a lone request is
    mid-decode, then a full-prompt replay."""
    ps = _prompts(11)
    lone = mod.ServeRequest(99, np.random.default_rng(5).integers(0, 250,
                                                                   size=11),
                            max_new_tokens=9)
    reqs = [mod.ServeRequest(i, p, max_new_tokens=5)
            for i, p in enumerate(ps)]
    cb.admit_batch([reqs[0]])
    while cb.n_active:
        cb.step()
    cb.admit_batch([lone])
    cb.step()
    cb.admit_batch(reqs[1:])                 # two hits, lone still decoding
    while cb.n_active:
        cb.step()
    again = mod.ServeRequest(7, ps[1].copy(), max_new_tokens=4)
    cb.admit_batch([again])
    while cb.n_active:
        cb.step()
    return {r.rid: [int(t) for t in r.generated]
            for r in reqs + [lone, again]}


@functools.lru_cache(maxsize=None)
def _waves():
    return _serve_both(_script_waves)


def test_batcher_hits_match_reference_and_cold():
    out = _waves()
    streams = {k: v[0] for k, v in out.items()}
    assert streams["torch", True] == streams["jax", True]
    assert streams["torch", True] == streams["torch", False]
    assert streams["torch", False] == streams["jax", False]
    tb, jb = out["torch", True][1], out["jax", True][1]
    keys = ("prefix_hits", "prefix_hit_tokens", "prefix_evictions",
            "n_prefill_tokens", "n_prefill_calls", "n_prefill_reqs",
            "n_decode_steps")
    th, jh = tb.hotpath_stats(), jb.hotpath_stats()
    assert {k: th[k] for k in keys} == {k: jh[k] for k in keys}
    assert th["prefix_hits"] == 3
    # two hits on the 24-token shared prefix, then the replay of prompt 1,
    # which reuses all but its last token
    assert th["prefix_hit_tokens"] == 24 + 24 + len(_prompts(11)[1]) - 1
    assert out["torch", True][2].stats() == out["jax", True][2].stats()
    assert th["decode_compiles"] == 0       # eager on the CPU


def test_deposited_rows_equal_reference():
    """The rows a finished request deposits equal the reference's
    (float32, within ROW_TOL), with equal tokens, pos and bytes."""
    out = _waves()
    te = out["torch", True][2].export_entries()
    je = out["jax", True][2].export_entries()
    assert len(te) == len(je) > 0
    for (tk, t), (jk, j) in zip(te, je):
        assert tk == jk and t.pos == j.pos and t.nbytes == j.nbytes
        np.testing.assert_array_equal(t.tokens, j.tokens)
        for leaf in ("k", "v"):
            np.testing.assert_allclose(t.rows["attn"][leaf][:, :t.pos],
                                       j.rows["attn"][leaf][:, :j.pos],
                                       atol=ROW_TOL, rtol=0)


def test_bf16_reference_entry_serves_and_redeposits_bit_for_bit():
    """A bf16 entry the reference deposited (ml_dtypes rows) imports into
    the port's store, lands in the port's cache bit for bit through the
    hit scatter, and the port's deposit of that slot gives the same bits
    back as uint16 (the wire format)."""
    jcfg, jp, tcfg, tp = _setup(dtype="bfloat16")
    ps = _prompts(12)
    jcache = jpc.PrefixCache()
    jb = _batcher(jserve, jcfg, jp, jcache)
    jb.admit_batch([jserve.ServeRequest(0, ps[0], max_new_tokens=3)])
    while jb.n_active:
        jb.step()
    [(key, jentry)] = jcache.export_entries()
    tcache = tpc.PrefixCache()
    assert tcache.import_entries([(key, jentry)]) == 1
    tb = _batcher(tserve, tcfg, tp, tcache)
    req = tserve.ServeRequest(1, ps[1], max_new_tokens=6)
    tb.admit_batch([req])
    assert tb.prefix_hits == 1 and tb.prefix_hit_tokens == 24
    slot = req.slot
    for leaf in ("k", "v"):
        got = tb.cache["attn"][leaf][:, slot, :24]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy().view(np.uint16),
            jentry.rows["attn"][leaf][:, :24].view(np.uint16))
    fresh = tpc.PrefixCache()
    tb.attach_prefix_cache(fresh)
    while tb.n_active:
        tb.step()
    [(_, dep)] = fresh.export_entries()
    assert dep.pos == len(ps[1]) and dep.nbytes == (
        dep.tokens.nbytes + 2 * jentry.rows["attn"]["k"].nbytes)
    for leaf in ("k", "v"):
        assert dep.rows["attn"][leaf].dtype == np.uint16
        np.testing.assert_array_equal(
            dep.rows["attn"][leaf][:, :24],
            jentry.rows["attn"][leaf][:, :24].view(np.uint16))


def test_drain_deposits_like_reference():
    """``drain`` deposits the in-flight prompts, as the reference's does."""
    def script(mod, cb):
        rs = [mod.ServeRequest(i, p, max_new_tokens=8)
              for i, p in enumerate(_prompts(13, n=2, sfx=(3, 5, 0)))]
        cb.admit_batch(rs)
        cb.step()
        cb.drain(export_state=True)
        return [r.snapshot.pos for r in rs]
    out = _serve_both(script)
    assert out["torch", True][0] == out["jax", True][0]
    assert _entries(out["torch", True][2]) == _entries(out["jax", True][2])
    assert out["torch", True][2].n_entries == 2


@pytest.mark.parametrize("arch,window", [("mamba2-780m", None),
                                         ("qwen3-1.7b", 8)],
                         ids=["ssm", "ring"])
def test_ssm_and_ring_models_skip_probing(arch, window):
    """SSM state integrates every token and a ring buffer evicts real K/V,
    so neither probes or deposits, as in the reference."""
    jcfg, jp, tcfg, tp = _setup(arch, window=window)
    ps = _prompts(14, pre_len=12, n=2)
    for mod, cfg, params, store in ((jserve, jcfg, jp, jpc),
                                    (tserve, tcfg, tp, tpc)):
        pc = store.PrefixCache()
        cb = _batcher(mod, cfg, params, pc)
        for i, p in enumerate(ps):
            cb.admit_batch([mod.ServeRequest(i, p, max_new_tokens=3)])
            while cb.n_active:
                cb.step()
        assert not cb._can_bucket
        assert pc.n_entries == 0 and pc.hits == 0 and cb.prefix_hits == 0
