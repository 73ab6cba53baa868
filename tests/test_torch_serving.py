"""The port's serving path against the JAX package: the ``ServingEngine``
(continuous batching, bucketed prefill, merged-LoRA adapter epochs), the
``PipeBoostEngine`` cold-start state machine, and the ``launch.serve``
command on the CPU.

Weights and adapters come from the reference (converted with
``params_from_jax``), prompts from numpy.  Token streams under
``quantized_greedy`` must be equal; logits within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.core.adapter_scheduler import EpochSchedulerPolicy as JPolicy
from repro.core.engine import PipeBoostEngine as JEngine
from repro.lora import adapters as jlora
from repro.models import transformer as JT
from repro.serving import engine as jserve
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.core.adapter_scheduler import EpochSchedulerPolicy
from repro_torch.core.engine import PipeBoostEngine
from repro_torch.launch import serve
from repro_torch.lora import adapters as tlora
from repro_torch.serving import engine as tserve

LOGIT_TOL = 1e-4
KEY = jax.random.PRNGKey(5)


def _adapters(jcfg, jparams, n):
    """n randomized rank-4 adapters: (reference merged params, port
    adapters with the same A/B)."""
    jmerged, tads = {}, {}
    for i in range(n):
        lora = jlora.randomize_lora(
            jax.random.fold_in(KEY, 100 + i),
            jlora.init_lora(jax.random.fold_in(KEY, i), jcfg, rank=4,
                            name=f"lora{i}"))
        jmerged[f"lora{i}"] = jlora.merge_lora(jparams, lora)
        tads[f"lora{i}"] = tlora.LoRAAdapter(
            lora.name, lora.rank, lora.alpha,
            params_from_jax(jax.tree.map(np.asarray, lora.blocks), "cpu"))
    return jmerged, tads


@pytest.fixture(scope="module")
def opt_setup():
    jcfg = jget_arch("pipeboost-opt-1.3b").reduced(n_layers=4)
    jparams = JT.init_params(jcfg, KEY)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tcfg = get_arch("pipeboost-opt-1.3b").reduced(n_layers=4)
    return jcfg, jparams, tcfg, tparams


def test_merged_adapters_match(opt_setup):
    jcfg, jparams, tcfg, tparams = opt_setup
    jmerged, tads = _adapters(jcfg, jparams, 2)
    for name, ad in tads.items():
        tm = tlora.merge_lora(tparams, ad)
        for t in tlora.TARGETS:
            np.testing.assert_allclose(
                to_numpy(tm["blocks"]["attn"][t]),
                np.asarray(jmerged[name]["blocks"]["attn"][t]), atol=1e-6)
        back = tlora.unmerge_lora(tm, ad)
        np.testing.assert_allclose(to_numpy(back["blocks"]["attn"]["wq"]),
                                   to_numpy(tparams["blocks"]["attn"]["wq"]),
                                   atol=1e-6)
        assert tm["embed"] is tparams["embed"]          # untouched leaves


def _requests(module, rng_seed, n, adapters):
    rng = np.random.default_rng(rng_seed)
    reqs = []
    for i in range(n):
        # lengths straddle buckets (16 / 32 / 64) so same-bucket rows
        # prefill together and others pad
        L = int(rng.choice([5, 13, 14, 23, 40]))
        ad = adapters[i % len(adapters)]
        reqs.append(module.ServeRequest(i, rng.integers(0, 257, size=L),
                                        max_new_tokens=4 + i % 3,
                                        adapter=ad))
    return reqs


def test_serving_engine_matches_reference(opt_setup):
    """Staggered submissions over three adapter epochs (base + 2
    adapters), bucketed batched prefill and continuous decode: the same
    token streams, finishing order and adapter switches as the reference."""
    jcfg, jparams, tcfg, tparams = opt_setup
    jmerged, tads = _adapters(jcfg, jparams, 2)
    tmerged = {n: tlora.merge_lora(tparams, a) for n, a in tads.items()}
    adapters = [None, "lora0", "lora1"]
    engines = []
    for mod, cfg, params, merged, pol in (
            (jserve, jcfg, jparams, jmerged, JPolicy),
            (tserve, tcfg, tparams, tmerged, EpochSchedulerPolicy)):
        eng = mod.ServingEngine(cfg, params, n_slots=3, max_len=64,
                                policy=pol(epoch_budget=2, max_batch=3),
                                adapter_params=merged)
        eng.batcher.sampler = mod.quantized_greedy
        reqs = _requests(mod, 0, 9, adapters)
        for r in reqs[:4]:
            eng.submit(r)
        for _ in range(3):
            eng.step()
        for r in reqs[4:]:
            eng.submit(r)
        done = eng.run()
        engines.append((eng, reqs, done))
    (je, jreqs, jdone), (te, treqs, tdone) = engines
    assert len(tdone) == len(jdone) == 9
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for a, b in zip(treqs, jreqs):
        assert a.generated == [int(x) for x in b.generated], a.rid
        assert a.first_token_at == b.first_token_at
    assert te.n_adapter_switches == je.n_adapter_switches
    jh, th = je.hotpath_stats(), te.hotpath_stats()
    for k in ("n_decode_steps", "n_prefill_calls", "n_prefill_reqs",
              "n_prefill_tokens"):
        assert th[k] == jh[k], k


def test_continuous_batcher_matches_solo_reference(opt_setup):
    """Slot reuse and staggered admission in the port's batcher give the
    reference's solo (unbatched) token streams."""
    jcfg, jparams, tcfg, tparams = opt_setup
    cb = tserve.ContinuousBatcher(tcfg, tparams, n_slots=2, max_len=64,
                                  sampler=tserve.quantized_greedy)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 257, size=L) for L in (6, 19, 11)]
    reqs = [tserve.ServeRequest(i, p, max_new_tokens=5)
            for i, p in enumerate(prompts)]
    cb.admit(reqs[0])
    cb.step()
    cb.admit(reqs[1])
    while cb.n_active:
        cb.step()
    cb.admit(reqs[2])                      # reuses a freed slot
    while cb.n_active:
        cb.step()
    step = jax.jit(lambda p, t, c: JT.decode_step(jcfg, p, {"tokens": t}, c))
    for r, p in zip(reqs, prompts):
        lg, cache = JT.forward(jcfg, jparams, {"tokens": jnp.asarray(p)[None]},
                               mode="prefill", max_len=64)
        toks = [int(jserve.quantized_greedy(lg)[0])]
        for _ in range(4):
            lg, cache = step(jparams, jnp.asarray([toks[-1]], jnp.int32),
                             cache)
            toks.append(int(jserve.quantized_greedy(lg)[0]))
        assert r.generated == toks, r.rid


def test_pipeboost_engine_matches_reference(opt_setup):
    """Event log, chain, rounds_to_ready and cold-start accounting equal
    the reference's; prefill/decode logits agree with it, and are the same
    before and after the model is fully loaded."""
    jcfg, jparams, tcfg, tparams = opt_setup
    _, tads = _adapters(jcfg, jparams, 1)
    jad = {"lora0": jlora.randomize_lora(
        jax.random.fold_in(KEY, 100),
        jlora.init_lora(jax.random.fold_in(KEY, 0), jcfg, rank=4,
                        name="lora0"))}
    je = JEngine(jcfg, jparams, n_devices=4, max_len=32, adapters=jad)
    te = PipeBoostEngine(tcfg, tparams, n_devices=4, max_len=32,
                         adapters=tads)
    toks = np.random.default_rng(1).integers(0, 257, size=(1, 9))
    assert te.rounds_to_ready() == je.rounds_to_ready() == 1
    assert not te.ready
    with pytest.raises(RuntimeError):
        te.prefill({"tokens": torch.from_numpy(toks)})
    je.load_round()
    te.load_round()
    assert te.ready and te.chain() == je.chain()
    assert te.rounds_to_ready() == 0
    assert not te.fully_loaded

    def serve(e, tokens, to_dev, n=3):
        lg = [e.prefill({"tokens": to_dev(tokens)})]
        for _ in range(n):
            nxt = np.asarray(to_numpy(lg[-1])).argmax(-1).astype(np.int32)
            lg.append(e.decode(to_dev(nxt)))
        return [np.asarray(to_numpy(x)) for x in lg]

    t_partial = serve(te, toks, torch.from_numpy)
    j_partial = serve(je, toks, jnp.asarray)
    for a, b in zip(t_partial, j_partial):
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL)
    assert len(list(te.fill_steps())) == len(list(je.fill_steps())) == 3
    assert te.fully_loaded
    assert te.maybe_switch_strategy(1.0) and je.maybe_switch_strategy(1.0)
    t_full = serve(te, toks, torch.from_numpy)
    serve(je, toks, jnp.asarray)
    for a, b in zip(t_full, t_partial):
        np.testing.assert_array_equal(a, b)
    te.switch_adapter("lora0")
    je.switch_adapter("lora0")
    t_ad = serve(te, toks, torch.from_numpy, n=1)
    j_ad = serve(je, toks, jnp.asarray, n=1)
    for a, b in zip(t_ad, j_ad):
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL)
    assert te.events == je.events
    ts, js = te.cold_start_stats(), je.cold_start_stats()
    assert ts.keys() == js.keys()
    for k in ("loaded_bytes", "total_bytes", "n_rounds", "round_bytes"):
        assert ts[k] == js[k], k
    st = te.status()
    assert st.fully_loaded and st.strategy == "single" and st.n_rounds == 4


def test_background_fill_overlaps_serving(opt_setup):
    _, _, tcfg, tparams = opt_setup
    eng = PipeBoostEngine(tcfg, tparams, n_devices=4, max_len=32)
    eng.load_round()
    t = eng.start_fill(interval_s=0.001)
    eng.prefill({"tokens": torch.zeros((1, 4), dtype=torch.long)})
    t.join(timeout=30)
    assert not t.is_alive() and eng.fully_loaded
    eng.stop_fill()
    cs = eng.cold_start_stats()
    assert cs["time_to_fully_loaded"] >= cs["time_to_ready"]
    assert cs["loaded_bytes"] == cs["total_bytes"]


def test_serve_cli_cpu(capsys):
    res = serve.main(["--device", "cpu", "--requests", "5", "--adapters",
                      "2", "--new-tokens", "4", "--max-len", "96",
                      "--prompt-len", "8-40", "--seed", "1"])
    out = capsys.readouterr().out
    assert "served 5 requests" in out and "cold start" in out
    assert res.cfg.n_layers == 8 and res.cfg.d_model == 64
    assert [len(r.generated) for r in res.requests] == [4] * 5
    assert all(r.done for r in res.requests)
    assert sorted(res.ttft_s) == list(range(5))
    assert res.cold_start["loaded_bytes"] == res.cold_start["total_bytes"]
    assert res.n_adapter_switches >= 1
    vocab = res.cfg.padded_vocab
    assert all(0 <= t < vocab for r in res.requests for t in r.generated)
