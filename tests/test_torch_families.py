"""The model families the port took on last — MoE (qwen2-moe-a2.7b,
phi3.5-moe), the M-RoPE vision-language backbone (qwen2-vl-72b) and the
encoder-only audio backbone (hubert-xlarge) — against the JAX package,
from the model up to the serving engine and the launcher.

Reduced configs in float32, weights from the reference converted with
``params_from_jax``, inputs (tokens, embeddings, (t, h, w) positions) from
numpy.  Logits and caches within 1e-4 after a prefill and six decode
steps, as ``tests/test_torch_model.py`` holds the dense models; token
streams under ``quantized_greedy`` equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_arch as jget_arch
from repro.core.adapter_scheduler import EpochSchedulerPolicy as JPolicy
from repro.lora import adapters as jlora
from repro.models import transformer as JT
from repro.serving import engine as jserve
from repro_torch.configs.base import get_arch, shared_fields
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.core.adapter_scheduler import EpochSchedulerPolicy
from repro_torch.launch import serve
from repro_torch.lora import adapters as tlora
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as tserve
from test_torch_stable_init import stable_init

LOGIT_TOL = 1e-4
KEY = jax.random.PRNGKey(9)
DECODE_ARCHS = ("qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b", "qwen2-vl-72b")


def _close(a, b, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(to_numpy(a), np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=0)


def _pair(arch, **over):
    jcfg = jget_arch(arch).reduced(**over)
    tcfg = get_arch(arch).reduced(**over)
    assert shared_fields(tcfg) == jcfg.__dict__
    with stable_init():
        jparams = JT.init_params(jcfg, KEY)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _inputs(cfg, rng, B, S, pos0=0):
    """(numpy batch, with the same keys for both packages): tokens for
    text models, embeddings for the audio and vision stubs, and (t, h, w)
    positions that differ per stream for M-RoPE."""
    if cfg.family == "audio" or cfg.mrope:
        batch = {"embeds": rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                        size=(B, S)).astype(np.int32)}
    if cfg.mrope:
        t = pos0 + np.arange(S)
        pos = np.stack([t, 2 * t + 1, 3 * t + 2], axis=-1)   # t != h != w
        pos = np.broadcast_to(pos, (B, S, 3)) + np.arange(B)[:, None, None]
        batch["positions"] = pos.astype(np.int32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_and_decode_match(arch):
    """A prefill and six zero-copy decode steps: logits, the ``attn``
    cache (which MoE layers fill) and ``pos``.  MoE decode runs the
    dropless experts; qwen2-vl prefills and decodes from embeddings with
    (t, h, w) positions, t, h and w all different."""
    jcfg, jparams, tcfg, tparams = _pair(arch)
    rng = np.random.default_rng(11)
    B, S, max_len = 2, 19, 48
    batch = _inputs(tcfg, rng, B, S)
    jfwd = jax.jit(lambda p, b: JT.forward(jcfg, p, b, mode="prefill",
                                           max_len=max_len))
    jdec = jax.jit(lambda p, b, c: JT.decode_step(jcfg, p, b, c))
    lj, cj = jfwd(jparams, _j(batch))
    lt, ct = TT.forward(tcfg, tparams, _t(batch), mode="prefill",
                        max_len=max_len)
    assert lt.shape == (B, tcfg.padded_vocab) and lt.dtype == torch.float32
    _close(lt, lj)
    assert set(ct) == set(cj) == {"pos", "attn"}
    for step in range(6):
        if tcfg.mrope:
            sb = _inputs(tcfg, rng, B, 1, pos0=S + step)
        else:
            sb = {"tokens": rng.integers(0, tcfg.vocab_size,
                                         size=(B,)).astype(np.int32)}
        lj, cj = jdec(jparams, _j(sb), cj)
        lt, ct = TT.decode_step(tcfg, tparams, _t(sb), ct)
        _close(lt, lj)
    np.testing.assert_array_equal(to_numpy(ct["pos"]), np.asarray(cj["pos"]))
    for leaf in ("k", "v"):
        _close(ct["attn"][leaf], cj["attn"][leaf])


@pytest.mark.parametrize("arch", DECODE_ARCHS + ("hubert-xlarge",))
def test_train_forward_matches(arch):
    """Train mode: logits over every position and the aux loss (the MoE
    layers' load-balance losses summed over layers; 0 without MoE).
    hubert runs from frame embeddings, non-causally, with LayerNorm."""
    jcfg, jparams, tcfg, tparams = _pair(arch)
    batch = _inputs(tcfg, np.random.default_rng(12), 2, 17)
    lj, auxj = JT.forward(jcfg, jparams, _j(batch))
    lt, auxt = TT.forward(tcfg, tparams, _t(batch))
    _close(lt, lj)
    _close(auxt, auxj, 1e-5)
    assert (float(auxt) > 0) == (tcfg.family == "moe")


def test_audio_is_noncausal_and_has_no_decode():
    """hubert attends to later frames (changing the last frame moves the
    first frame's logits) and has no decode step: the port raises, as the
    reference asserts."""
    jcfg, jparams, tcfg, tparams = _pair("hubert-xlarge")
    assert not tcfg.causal and not tcfg.has_decode
    batch = _t(_inputs(tcfg, np.random.default_rng(13), 1, 9))
    lt, _ = TT.forward(tcfg, tparams, batch)
    batch["embeds"][:, -1] = torch.flip(batch["embeds"][:, -1], (-1,))
    lt2, _ = TT.forward(tcfg, tparams, batch)
    assert (lt2[:, 0] - lt[:, 0]).abs().max() > 1e-4
    _, cache = TT.forward(tcfg, tparams, batch, mode="prefill", max_len=16)
    with pytest.raises(ValueError, match="encoder-only"):
        TT.decode_step(tcfg, tparams, {"embeds": batch["embeds"][:, :1]},
                       cache)
    with pytest.raises(AssertionError):
        JT.decode_step(jcfg, jparams, {"embeds": jnp.zeros((1, 1, 64))},
                       {"pos": jnp.zeros((1,), jnp.int32)})


def test_mrope_matches_and_needs_three_streams():
    """``apply_mrope`` against the reference with distinct t/h/w streams;
    (B, S) positions are refused (the reference fails on them in a
    broadcast)."""
    from repro.models.layers import apply_mrope as japply
    from repro_torch.models.layers import apply_mrope as tapply
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 5, 3)).astype(np.int32)
    _close(tapply(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (2, 3, 3)),
           japply(jnp.asarray(x), jnp.asarray(pos), 1e6, (2, 3, 3)), 2e-5)
    with pytest.raises(ValueError, match="positions"):
        tapply(torch.from_numpy(x), torch.from_numpy(pos[..., 0]), 1e6,
               (2, 3, 3))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_from_jax_layout(arch):
    """Every family's reference params convert to the port's own init's
    tree, shapes and dtypes: the MoE ``router``, ``w_gate (L, E, D, F)``
    and ``shared.gate``, and the audio ``{scale, bias}`` norms among
    them."""
    jcfg = jget_arch(arch).reduced()
    conv = params_from_jax(jax.tree.map(
        np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0))), "cpu")
    own = TT.init_params(get_arch(arch).reduced(),
                         torch.Generator().manual_seed(0), device="cpu")
    flat_c = jax.tree_util.tree_flatten_with_path(to_numpy(conv))[0]
    flat_o = jax.tree_util.tree_flatten_with_path(to_numpy(own))[0]
    assert [p for p, _ in flat_c] == [p for p, _ in flat_o]
    for (_, a), (_, b) in zip(flat_c, flat_o):
        assert a.shape == b.shape and a.dtype == b.dtype
    if jcfg.family == "moe":
        mlp = conv["blocks"]["moe"]["mlp"]
        L, D, E, F = (jcfg.n_layers, jcfg.d_model, jcfg.n_experts,
                      jcfg.moe_d_ff)
        assert mlp["router"].shape == (L, D, E)
        assert mlp["w_gate"].shape == (L, E, D, F)
        assert ("shared" in mlp) == bool(jcfg.n_shared_experts)
        if jcfg.n_shared_experts:
            assert mlp["shared"]["gate"].shape == (L, D, 1)
    if jcfg.family == "audio":
        assert set(conv["final_norm"]) == {"scale", "bias"}
        assert conv["blocks"]["attn"]["ln1"]["bias"].shape == (
            jcfg.n_layers, jcfg.d_model)


def test_moe_lora_targets_the_moe_stack():
    """An MoE model's adapter holds its targets under ``blocks["moe"]``
    (not empty), merges into them like the reference's, and unmerges."""
    jcfg, jparams, tcfg, tparams = _pair("qwen2-moe-a2.7b")
    own = tlora.init_lora(torch.Generator().manual_seed(0), tcfg, 4,
                          device="cpu")
    assert set(own.blocks) == {"moe"}
    assert set(own.blocks["moe"]) == set(tlora.TARGETS)
    assert own.blocks["moe"]["wq"]["A"].shape == (tcfg.n_layers,
                                                  tcfg.d_model, 4)
    with stable_init():
        jad = jlora.randomize_lora(jax.random.PRNGKey(2), jlora.init_lora(
            jax.random.PRNGKey(1), jcfg, rank=4))
    tad = tlora.LoRAAdapter(jad.name, jad.rank, jad.alpha, params_from_jax(
        jax.tree.map(np.asarray, jad.blocks), "cpu"))
    jm, tm = jlora.merge_lora(jparams, jad), tlora.merge_lora(tparams, tad)
    for t in tlora.TARGETS:
        _close(tm["blocks"]["moe"][t], jm["blocks"]["moe"][t], 1e-6)
    _close(tlora.unmerge_lora(tm, tad)["blocks"]["moe"]["wq"],
           to_numpy(tparams["blocks"]["moe"]["wq"]), 1e-6)


def _requests(module, n, adapters):
    rng = np.random.default_rng(15)
    return [module.ServeRequest(i, rng.integers(0, 257, size=int(
        rng.integers(5, 30))), max_new_tokens=4 + i % 3,
        adapter=adapters[i % len(adapters)]) for i in range(n)]


def test_moe_serving_engine_matches_reference():
    """qwen2-moe-a2.7b with one merged adapter through both packages'
    ``ServingEngine`` under ``quantized_greedy``: prompts prefill one by
    one at exact length (capacity couples the rows, so no bucketing), the
    streams, finishing order, adapter switches and hot-path counts equal
    the reference's."""
    jcfg, jparams, tcfg, tparams = _pair("qwen2-moe-a2.7b", n_layers=4)
    with stable_init():
        jad = jlora.randomize_lora(jax.random.PRNGKey(4), jlora.init_lora(
            jax.random.PRNGKey(3), jcfg, rank=4, name="lora0"))
    tad = tlora.LoRAAdapter(jad.name, jad.rank, jad.alpha, params_from_jax(
        jax.tree.map(np.asarray, jad.blocks), "cpu"))
    runs = []
    for mod, cfg, params, merged, pol in (
            (jserve, jcfg, jparams, {"lora0": jlora.merge_lora(jparams,
                                                               jad)},
             JPolicy),
            (tserve, tcfg, tparams, {"lora0": tlora.merge_lora(tparams,
                                                               tad)},
             EpochSchedulerPolicy)):
        eng = mod.ServingEngine(cfg, params, n_slots=3, max_len=64,
                                policy=pol(epoch_budget=2, max_batch=3),
                                adapter_params=merged)
        eng.batcher.sampler = mod.quantized_greedy
        reqs = _requests(mod, 6, [None, "lora0"])
        for r in reqs[:3]:
            eng.submit(r)
        eng.step()
        for r in reqs[3:]:
            eng.submit(r)
        runs.append((eng, reqs, eng.run()))
    (je, jreqs, jdone), (te, treqs, tdone) = runs
    assert not te.batcher._can_bucket
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for a, b in zip(treqs, jreqs):
        assert a.generated == [int(x) for x in b.generated], a.rid
    assert te.n_adapter_switches == je.n_adapter_switches >= 1
    jh, th = je.hotpath_stats(), te.hotpath_stats()
    for k in ("n_decode_steps", "n_prefill_calls", "n_prefill_reqs",
              "n_prefill_tokens"):
        assert th[k] == jh[k], k
    assert th["n_prefill_calls"] == 6


def test_moe_serve_cli_cpu(capsys):
    """``launch.serve --arch qwen2-moe-a2.7b`` with an adapter and
    ``--crash-at``; then phi3.5-moe."""
    res = serve.main(["--device", "cpu", "--arch", "qwen2-moe-a2.7b",
                      "--requests", "4", "--adapters", "1", "--new-tokens",
                      "4", "--max-len", "96", "--prompt-len", "8-40",
                      "--crash-at", "2"])
    out = capsys.readouterr().out
    assert "served 4 requests of qwen2-moe-a2.7b" in out
    assert res.n_adapter_switches >= 1
    assert all(r.done and len(r.generated) == 4 for r in res.requests)
    assert res.crash is not None and res.crash["tokens"].shape == (1, 4)
    res = serve.main(["--device", "cpu", "--arch", "phi3.5-moe-42b-a6.6b",
                      "--requests", "2", "--new-tokens", "3", "--max-len",
                      "64", "--prompt-len", "8-20"])
    assert all(r.done for r in res.requests)


def test_moe_serve_cluster_cpu(capsys):
    serve.main(["--device", "cpu", "--arch", "qwen2-moe-a2.7b", "--cluster",
                "--servers", "2", "--requests", "6", "--crash-at", "2",
                "--adapters", "1", "--new-tokens", "4", "--max-len", "96",
                "--prompt-len", "8-24"])
    assert "cluster: 6/6 requests completed" in capsys.readouterr().out


@pytest.mark.parametrize("arch,msg", [("qwen2-vl-72b", "M-RoPE"),
                                      ("hubert-xlarge", "encoder-only")])
def test_serve_cli_refuses_with_a_message(arch, msg):
    with pytest.raises(SystemExit, match=msg):
        serve.main(["--device", "cpu", "--arch", arch])
