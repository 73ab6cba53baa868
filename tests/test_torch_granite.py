"""granite-4.0-h-small on the port against its plain float32 reference
(``repro_torch/reference/granite_hybrid.py``), at one whole 10-layer period
(9 Mamba-2 layers and a NoPE attention layer at index 5) of tiny widths, 8
experts top 3, in float32 on the CPU.

Tolerance: every comparison allows 1e-4 of the largest |logit|.  Both
sides compute in float32; they differ only in the order of their sums (the
port's chunked SSD scan and batched experts against the reference's
step-by-step recurrence and per-expert loop), about 1e-6 of that scale
after ten layers, while each planted fault below moves the logits by more
than 1e-2 of it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.kv_reconstruct import reconstruct_cache
from repro_torch.models import moe, transformer
from repro_torch.reference import granite_hybrid as ref
from repro_torch.serving.engine import (ContinuousBatcher, ServeRequest,
                                        ServingEngine)
from repro_torch.serving.tracing import TRACER

TOL = 1e-4
V = 257


def small(**over):
    cfg = dataclasses.replace(
        get_arch("granite-4.0-h-small"), n_layers=10, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=24, moe_d_ff=24,
        shared_d_ff=40, n_experts=8, top_k=3, n_shared_experts=1,
        vocab_size=V, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
        dtype="float32")
    return dataclasses.replace(cfg, **over)


CFG = small()


def make_params(cfg, seed=0):
    """The port's init, then the leaves it sets to constants drawn too, so
    that every weight takes part; the padded vocabulary rows zero, as the
    benchmark has them."""
    gen = torch.Generator().manual_seed(seed)
    params = transformer.init_params(cfg, gen, device="cpu")
    params["embed"][V:].zero_()     # padded vocabulary: never the best
    for kind, blk in params["blocks"].items():
        for k in ("norm", "gate_norm", "ln1", "ln2"):
            if k in blk:
                blk[k].normal_(generator=gen).mul_(0.2).add_(1.0)
        if kind == "moe":
            # scores spread with std about 1 at the 1/128 scale, as the
            # benchmark's weights make them: at 1/sqrt(fan-in) every head
            # would average its prefix and no position embedding would show
            blk["wq"].mul_(6.0)
            blk["wk"].mul_(6.0)
        if kind == "ssm":
            blk["dt_bias"].normal_(generator=gen).mul_(0.5)
            blk["D_skip"].normal_(generator=gen)
            blk["conv_b"].normal_(generator=gen).mul_(0.3)
    return params


@pytest.fixture(scope="module")
def params():
    return make_params(CFG)


def ids(n, seed=1):
    return torch.randint(0, V, (n,), generator=torch.Generator()
                         .manual_seed(seed))


def port_logits(cfg, params, toks):
    logits, _ = transformer.forward(cfg, params, {"tokens": toks[None]},
                                    mode="train")
    return logits[0, :, :V]


def close(a, b):
    return float((a - b).abs().max()) <= TOL * float(b.abs().max())


def test_the_period_is_nine_mamba_layers_and_one_nope_attention_layer():
    assert CFG.layer_kinds() == ["ssm"] * 5 + ["moe"] + ["ssm"] * 4
    full = get_arch("granite-4.0-h-small")
    assert [i for i, k in enumerate(full.layer_kinds()) if k == "moe"] == \
        [5, 15, 25, 35]
    assert full.ssm_heads == 128 and full.d_inner == 8192


def test_prefill_then_decode_through_the_slot_cache_matches_the_forward(
        params):
    """Two prompts of other lengths prefilled one at a time into slots 2
    and 0 of a 3-slot batcher, then decoded together for 12 steps on the
    reference's next tokens: each step's logits of each live slot against
    the reference's full forward over prompt + those tokens."""
    b = ContinuousBatcher(CFG, params, n_slots=3, max_len=64)
    seqs = [ids(37, 3), ids(22, 4)]
    P = [21, 9]
    want = [ref.forward(CFG, params, s) for s in seqs]
    b.free = [0, 2]            # the admissions take slot 2, then slot 0
    reqs = [ServeRequest(i, s[:p].numpy(), 100) for i, (s, p) in
            enumerate(zip(seqs, P))]
    for r in reqs:
        b.admit(r)
    for r, w, p in zip(reqs, want, P):
        assert r.generated[0] == int(w[p - 1].argmax())
    for t in range(12):
        toks = torch.zeros(3, dtype=torch.long)
        for r, s, p in zip(reqs, seqs, P):
            toks[r.slot] = s[p + t]
        logits, _ = transformer.decode_step(CFG, b.params, {"tokens": toks},
                                            b.cache)
        for r, w, p in zip(reqs, want, P):
            assert close(logits[r.slot, :V], w[p + t]), (t, r.rid)


def test_the_engine_serves_the_reference_greedy_tokens(params):
    """ServingEngine over the batcher (exact-length admission, the decode
    step): each served token is the reference's best at its position, up
    to the tolerance."""
    eng = ServingEngine(CFG, params, n_slots=2, max_len=96)
    prompts = [ids(n, 10 + n).numpy() for n in (30, 17, 44)]
    for i, p in enumerate(prompts):
        eng.submit(ServeRequest(i, p, 10))
    done = eng.run()
    assert len(done) == 3 and not eng.batcher._can_bucket
    for r in done:
        seq = torch.from_numpy(np.concatenate([r.tokens, r.generated[:-1]]))
        lg = ref.forward(CFG, params, seq)[len(r.tokens) - 1:]
        picked = lg.gather(1, torch.tensor(r.generated)[:, None])[:, 0]
        assert float((lg.amax(-1) - picked).max()) <= TOL * float(
            lg.abs().max())


def _without_conv_bias(cfg, p):
    p["blocks"]["ssm"].pop("conv_b")
    return dataclasses.replace(cfg, ssm_conv_bias=False), p


def _roped(cfg, p):
    return dataclasses.replace(cfg, attention_multiplier=0.0,
                               use_rope=True), p


def _rope_on(cfg, p):
    return dataclasses.replace(cfg, use_rope=True), p


def _residual_one(cfg, p):
    return dataclasses.replace(cfg, residual_multiplier=1.0), p


def _unscaled_ends(cfg, p):
    return dataclasses.replace(cfg, embedding_multiplier=1.0,
                               logits_scaling=1.0), p


def _gated_shared(cfg, p):
    for blk in p["blocks"].values():
        blk["mlp"]["shared"]["gate"] = torch.full((blk["ln2"].shape[0],
                                                   cfg.d_model, 1), 0.3)
    return dataclasses.replace(cfg, shared_gate=True), p


def _no_shared(cfg, p):
    for blk in p["blocks"].values():
        blk["mlp"].pop("shared")
    return cfg, p


def _copy(params):
    return {k: (_copy(v) if isinstance(v, dict) else v)
            for k, v in params.items()}


# each mechanism: the model without it (on the port alone), which the
# published model's logits must differ from
MECHANISMS = {"conv bias": _without_conv_bias,
              "NoPE and the 1/128 scale": _roped,
              "0.22 residual": _residual_one,
              "x12 embedding, /16 logits": _unscaled_ends,
              "gate-free shared MLP": _gated_shared}


@pytest.mark.parametrize("name", MECHANISMS)
def test_each_mechanism_is_served_as_the_reference_has_it(params, name):
    """The port equals the reference with the mechanism, and the port
    without it lies outside the tolerance: the comparison sees it."""
    toks = ids(40, 5)
    want = ref.forward(CFG, params, toks)
    assert close(port_logits(CFG, params, toks), want)
    cfg2, p2 = MECHANISMS[name](CFG, _copy(params))
    assert not close(port_logits(cfg2, p2, toks), want)


# planted faults: the port served wrong where the reference is right
FAULTS = {"residual multiplier 1": _residual_one, "RoPE on": _rope_on,
          "shared MLP left out": _no_shared}


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_fails_the_comparison(params, fault):
    toks = ids(40, 6)
    want = ref.forward(CFG, params, toks)
    cfg2, p2 = FAULTS[fault](CFG, _copy(params))
    got, cache = transformer.forward(cfg2, p2, {"tokens": toks[None, :30]},
                                     mode="prefill", max_len=48)
    rows = [got[0, :V]]
    for t in range(30, 40):
        lg, cache = transformer.decode_step(cfg2, p2, {"tokens": toks[t:t + 1]},
                                            cache)
        rows.append(lg[0, :V])
    assert not close(torch.stack(rows), want[29:])


def test_top_k_then_softmax_is_the_renormalised_softmax():
    """Granite's router takes the top k logits and a softmax over them; the
    port renormalises the softmax over all experts over the same k."""
    h = torch.randn(50, 64, generator=torch.Generator().manual_seed(7))
    router = torch.randn(64, 8, generator=torch.Generator().manual_seed(8))
    _, top_p, top_e = moe._route(CFG, router, h)
    logits = h @ router
    srt, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    assert torch.equal(top_e, idx[:, :3])
    torch.testing.assert_close(top_p, torch.softmax(srt[:, :3], -1),
                               rtol=1e-6, atol=1e-7)


def test_no_assignment_is_dropped_at_an_uneven_routing(params):
    """A router biased so that one expert takes nearly every token (the
    capacity path would keep 8 of them): the no-capacity path computes
    every assignment, equal to the reference, and records none dropped."""
    p = _copy(params)
    ssm = p["blocks"]["ssm"]["mlp"]
    ssm["router"] = ssm["router"].clone()
    ssm["router"][:, :, 2] += 3.0
    toks = ids(48, 9)
    want = ref.forward(CFG, p, toks)
    with moe.record_routing() as routed:
        got = port_logits(CFG, p, toks)
    assert close(got, want)
    capped = dataclasses.replace(CFG, capacity_factor=1.25)
    hits = torch.cat([e.reshape(-1) for e, _ in routed])
    # expert 2's assignments over the 9 Mamba layers: many times its
    # capacity on the capacity path
    assert int((hits == 2).sum()) > 4 * moe.moe_capacity(48, capped)
    assert all(bool(keep.all()) for _, keep in routed)
    assert not close(port_logits(capped, p, toks), want)


def test_the_batcher_records_its_cache_and_each_prefill(params):
    """The set-up counter of the slot cache by kind, and each prefill's
    recurrent state written and dropped assignments."""
    TRACER.clear()
    b = ContinuousBatcher(CFG, params, n_slots=3, max_len=64)
    rec = TRACER.cache[-1]
    L_ssm, L_att = 9, 1
    assert rec.kv == 2 * L_att * 3 * 64 * 2 * 16 * 4
    assert rec.conv == L_ssm * 3 * 3 * (128 + 32) * 4
    assert rec.ssm == L_ssm * 3 * 8 * 16 * 16 * 4
    b.admit(ServeRequest(0, ids(20).numpy(), 4))
    pre = TRACER.prefill[-1]
    assert (pre.rows, pre.tokens, pre.dropped) == (1, 20, 0)
    assert pre.state_bytes == (rec.conv + rec.ssm) // 3
    TRACER.clear()


def _wiped(cache, lost):
    """A copy of ``cache`` with the state of the layers in ``lost``
    zeroed."""
    out = {k: ({leaf: t.clone() for leaf, t in v.items()}
               if isinstance(v, dict) else v.clone())
           for k, v in cache.items()}
    _wipe(out, lost)
    return out


def _wipe(cache, lost):
    """Zero, in place, the state of the layers in ``lost`` in every slot
    of ``cache``."""
    for gi, (kind, ki, ai) in enumerate(transformer.layers(CFG)):
        if gi in lost:
            for t in cache["attn" if ai >= 0 else kind].values():
                t[ai if ai >= 0 else ki] = 0


@pytest.mark.parametrize("lost", [{5}, {7}, {3, 5}],
                         ids=["5", "7", "3-5"])
def test_the_rebuild_of_lost_layers_equals_a_fresh_prefill(params, lost):
    """``reconstruct_cache`` after the state of the layers in ``lost`` is
    zeroed: every cache leaf within 1e-6 of a fresh prefill's.  The
    rebuild runs each layer as the prefill does: an SSM layer with its
    MoE FFN, the attention layer at its 1/128 score scale (in full when
    it is lost, Q alone against its surviving K/V when only a deeper
    layer is)."""
    toks = torch.stack([ids(24, 11), ids(24, 12)])
    _, fresh = transformer.forward(CFG, params, {"tokens": toks},
                                   mode="prefill", max_len=48)
    damaged = _wiped(fresh, lost)
    has = [i not in lost for i in range(CFG.n_layers)]
    _, stats = reconstruct_cache(CFG, params, {"tokens": toks}, damaged,
                                 has, max_len=48)
    assert stats["full_prefill"] == len(lost)
    assert stats["kv_reused"] == int(5 not in lost and max(lost) > 5)
    for kind in ("attn", "ssm"):
        for leaf, t in fresh[kind].items():
            diff = float((damaged[kind][leaf] - t).abs().max())
            assert diff <= 1e-6, (kind, leaf, diff)
    assert torch.equal(damaged["pos"], fresh["pos"])


def test_a_relay_after_a_wipe_decodes_on_as_an_uninterrupted_run(params):
    """Three live requests on a granite ServingEngine lose layers 3, 5 and
    7; ``relay_inflight`` rebuilds them for every slot.  The rebuilt slot
    cache is within 1e-5 of its largest entry of an uninterrupted twin's
    (whose rows the decode steps wrote, in another sum order), and after
    decoding on each stream equals the twin's."""
    prompts = [ids(n, 30 + i).numpy() for i, n in enumerate((14, 9, 14))]
    lost = {3, 5, 7}
    engines = []
    for _ in range(2):
        eng = ServingEngine(CFG, params, n_slots=3, max_len=64)
        reqs = [ServeRequest(i, p, 12) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        for _ in range(4):
            eng.step()
        assert eng.batcher.n_active == 3
        engines.append((eng, reqs))
    (twin, twin_reqs), (eng, reqs) = engines
    _wipe(eng.batcher.cache, lost)
    stats = eng.relay_inflight([i not in lost for i in range(CFG.n_layers)])
    assert stats["relayed_reqs"] == 3
    for kind in ("attn", "ssm"):
        for leaf, want in twin.batcher.cache[kind].items():
            got = eng.batcher.cache[kind][leaf]
            assert float((got - want).abs().max()) <= 1e-5 * float(
                want.abs().max()), (kind, leaf)
    twin.run()
    eng.run()
    assert all(len(r.generated) == 12 for r in twin_reqs)
    assert [r.generated for r in reqs] == [r.generated for r in twin_reqs]
