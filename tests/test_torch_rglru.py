"""The port's RG-LRU hybrid slice against the JAX package: the RG-LRU
scan's plain version, the recurrent block, the hybrid model (recurrent
layers and local-attention layers on a ring buffer), and the serving path
on recurrentgemma-2b reduced (6 layers ``rec, rec, attn``, d_model 64, 4
heads of 16 on one KV head, lru_width 64, window 32, float32).

Inputs are made with numpy from a seed; weights come from the reference
through ``params_from_jax``.  Tolerances: 1e-5 of the reference's largest
magnitude between the plain scan and the reference's Pallas kernel
(interpret mode; both float32, the kernel's log-space block sums against
the loop's products, so rounding only); 1e-4 against the sequential
oracle and the reference model's associative scan (the reference's own
allowance, ``tests/test_kernels.py``), and on block outputs, states,
caches and logits; token streams under ``quantized_greedy`` exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.core.engine import PipeBoostEngine as JEngine
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import rglru as jrg
from repro.models import transformer as JT
from repro.serving import engine as jserve
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.core.engine import PipeBoostEngine
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as trg
from repro_torch.launch import serve
from repro_torch.models import rglru as tr
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as tserve

KERNEL_TOL = 1e-5
TOL = 1e-4
ARCH = "recurrentgemma-2b"
KEY = jax.random.PRNGKey(11)

# the reference's own sweep (tests/test_kernels.py), pad path included
RGLRU_SHAPES = [
    (1, 64, 32, 32, 32),
    (2, 100, 48, 32, 16),        # pad both dims
    (1, 256, 128, 128, 128),
]


def _close(a, b, tol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(to_numpy(a), np.float32),
                               np.asarray(b, np.float32), atol=tol,
                               rtol=rtol)


def _close_scaled(a, b, tol):
    """Within ``tol`` of the reference's largest magnitude."""
    b = np.asarray(b, np.float32)
    _close(a, b, tol * float(np.abs(b).max()))


def _scan_inputs(seed, B, S, W):
    """log_a = -softplus(N(0, 1)) <= 0, as the reference's sweep draws it;
    bx and h0 standard normal."""
    rng = np.random.default_rng(seed)
    f = np.float32
    la = (-np.logaddexp(0.0, rng.standard_normal((B, S, W)))).astype(f)
    bx = rng.standard_normal((B, S, W)).astype(f)
    h0 = rng.standard_normal((B, W)).astype(f)
    return la, bx, h0


def _maybe(a, with_h0, to):
    return to(a) if with_h0 else None


# ---------------------------------------------------------------------------
# the RG-LRU scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,W,bt,bw", RGLRU_SHAPES)
def test_rglru_plain_matches_pallas(B, S, W, bt, bw, with_h0):
    la, bx, h0 = _scan_inputs(30, B, S, W)
    yj, hj = jops.rglru_scan(jnp.asarray(la), jnp.asarray(bx),
                             _maybe(h0, with_h0, jnp.asarray),
                             block_t=bt, block_w=bw)
    yt, ht = trg.rglru_scan_plain(torch.from_numpy(la), torch.from_numpy(bx),
                                  _maybe(h0, with_h0, torch.from_numpy))
    assert yt.shape == (B, S, W) and ht.shape == (B, W)
    assert yt.dtype == ht.dtype == torch.float32
    _close_scaled(yt, yj, KERNEL_TOL)
    _close_scaled(ht, hj, KERNEL_TOL)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_plain_matches_oracle_and_model_scan(with_h0):
    """The plain version against the port's sequential oracle (which
    matches the reference's) and the reference model's associative scan."""
    la, bx, h0 = _scan_inputs(31, 2, 80, 32)
    t_in = (torch.from_numpy(la), torch.from_numpy(bx),
            _maybe(h0, with_h0, torch.from_numpy))
    j_in = (jnp.asarray(la), jnp.asarray(bx), _maybe(h0, with_h0, jnp.asarray))
    yr, hr = tref.rglru_scan_ref(*t_in)
    yrj, hrj = jref.rglru_scan_ref(*j_in)
    _close_scaled(yr, yrj, KERNEL_TOL)
    _close_scaled(hr, hrj, KERNEL_TOL)
    yt, ht = trg.rglru_scan_plain(*t_in)
    ym, hm = jrg.rglru_scan(*j_in)
    for y, h in ((to_numpy(yr), to_numpy(hr)), (ym, hm)):
        _close(yt, y, TOL, TOL)
        _close(ht, h, TOL, TOL)


def test_rglru_padding_is_a_no_op():
    """log_a = 0, bx = 0 steps (a = 1) leave the state exactly as it was,
    as the reference's padding relies on."""
    la, bx, h0 = (torch.from_numpy(a) for a in _scan_inputs(32, 2, 9, 16))
    pad = torch.zeros((2, 3, 16))
    y, h = trg.rglru_scan_plain(la, bx, h0)
    yp, hp = trg.rglru_scan_plain(torch.cat([la, pad], 1),
                                  torch.cat([bx, pad], 1), h0)
    assert torch.equal(yp[:, :9], y) and torch.equal(hp, h)
    assert all(torch.equal(yp[:, 9 + i], h) for i in range(3))


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_op_runs_plain_on_cpu_and_counts_no_launch(with_h0):
    """On CPU tensors the op is the plain version, with and without
    ``plain_versions()``, and launches nothing."""
    la, bx, h0 = (torch.from_numpy(a) for a in _scan_inputs(33, 2, 40, 24))
    h0 = h0 if with_h0 else None
    tops.reset_launch_counts()
    y0, h_0 = trg.rglru_scan_plain(la, bx, h0)
    y1, h_1 = tops.rglru_scan(la, bx, h0)
    with tops.plain_versions():
        y2, h_2 = tops.rglru_scan(la, bx, h0)
    for y, h in ((y1, h_1), (y2, h_2)):
        assert torch.equal(y, y0) and torch.equal(h, h_0)
    assert tops.launch_counts() == {"decode_attention": 0,
                                    "flash_attention": 0, "lora_merge": 0,
                                    "ssd_scan": 0, "rglru_scan": 0,
                                    "rms_norm": 0, "rope": 0,
                                    "ssm_step": 0}


# ---------------------------------------------------------------------------
# block and model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hybrid_setup():
    jcfg = jget_arch(ARCH).reduced()
    jparams = JT.init_params(jcfg, KEY)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, get_arch(ARCH).reduced(), tparams


def test_reduced_config_is_the_hybrid_pattern(hybrid_setup):
    jcfg, _, tcfg, _ = hybrid_setup
    assert tcfg.layer_kinds() == jcfg.layer_kinds() == \
        ["rec", "rec", "attn"] * 2
    assert (tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim,
            tcfg.lru_width, tcfg.attn_window) == (64, 4, 1, 16, 64, 32)


def test_rec_block_matches_reference(hybrid_setup):
    """Prefill from zeros, a continued prefill from the conv state and h
    it left (both through the port's scan op), then one decode step."""
    jcfg, jparams, tcfg, tparams = hybrid_setup
    jp = jax.tree.map(lambda a: a[1], jparams["blocks"]["rec"]["rec"])
    tp = TT.layer_params(tparams["blocks"]["rec"]["rec"], 1)
    x = np.random.default_rng(34).standard_normal((2, 37, 64)).astype(
        np.float32)
    yj, (cj, hj) = jrg.rec_block_fwd(jcfg, jp, jnp.asarray(x[:, :20]))
    yt, (ct, ht) = tr.rec_block_fwd(tcfg, tp, torch.from_numpy(x[:, :20]))
    assert ht.dtype == torch.float32 and tuple(ct.shape) == cj.shape
    _close(yt, yj, TOL)
    _close(ct, cj, TOL)
    _close(ht, hj, TOL)
    yj, (cj, hj) = jrg.rec_block_fwd(jcfg, jp, jnp.asarray(x[:, 20:36]),
                                     conv_state=cj, h0=hj)
    yt, (ct, ht) = tr.rec_block_fwd(tcfg, tp, torch.from_numpy(x[:, 20:36]),
                                    conv_state=ct, h0=ht)
    _close(yt, yj, TOL)
    _close(ct, cj, TOL)
    _close(ht, hj, TOL)
    yj, (cj, hj) = jrg.rec_block_step(jcfg, jp, jnp.asarray(x[:, 36]), cj, hj)
    yt, (ct, ht) = tr.rec_block_step(tcfg, tp, torch.from_numpy(x[:, 36]),
                                     ct, ht)
    _close(yt, yj, TOL)
    _close(ct, cj, TOL)
    _close(ht, hj, TOL)


def test_rec_decay_init_matches_reference(hybrid_setup):
    """The port's own init keeps the reference's Lambda: a in (0.9,
    0.999) at r = 1, the same in every layer."""
    _, jparams, tcfg, _ = hybrid_setup
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    lam = tp["blocks"]["rec"]["rec"]["Lambda"]
    assert lam.shape == (4, 64) and lam.dtype == torch.float32
    # float32 linspace/log/expm1 of two libraries: a few ulp apart
    _close(lam, np.asarray(jparams["blocks"]["rec"]["rec"]["Lambda"]), 0.0,
           1e-5)
    a = torch.exp(-tr.C_CONST * torch.nn.functional.softplus(lam))
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6


def test_prefill_and_decode_match_reference(hybrid_setup):
    """Prefill of 26 tokens and 12 teacher-forced decode steps past the
    window of 32, so the attention layers' ring buffer wraps: logits and
    the ``rec`` and ``attn`` caches."""
    jcfg, jparams, tcfg, tparams = hybrid_setup
    rng = np.random.default_rng(35)
    toks = rng.integers(0, 257, size=(3, 26))
    steps = rng.integers(0, 257, size=(12, 3)).astype(np.int32)
    lj, cj = JT.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                        mode="prefill", max_len=64)
    lt, ct = TT.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                        mode="prefill", max_len=64)
    assert set(ct) == set(cj) == {"pos", "attn", "rec"}
    assert ct["attn"]["k"].shape[2] == 32            # the window
    _close(lt, lj, TOL)
    step = jax.jit(lambda p, t, c: JT.decode_step(jcfg, p, {"tokens": t}, c))
    for s in steps:
        lj, cj = step(jparams, jnp.asarray(s), cj)
        lt, ct = TT.decode_step(tcfg, tparams, {"tokens": torch.from_numpy(s)},
                                ct)
        _close(lt, lj, TOL)
    np.testing.assert_array_equal(to_numpy(ct["pos"]), np.asarray(cj["pos"]))
    assert int(ct["pos"][0]) == 38
    for kind, leaf in (("rec", "conv"), ("rec", "h"), ("attn", "k"),
                       ("attn", "v")):
        _close(ct[kind][leaf], cj[kind][leaf], TOL)
    # the reference's cache, converted, continues in the port
    cc = params_from_jax(jax.tree.map(np.asarray, cj), "cpu")
    assert cc["rec"]["h"].dtype == torch.float32
    lj, _ = step(jparams, jnp.asarray(steps[0]), cj)
    lt, _ = TT.decode_step(tcfg, tparams, {"tokens": torch.from_numpy(
        steps[0])}, cc)
    _close(lt, lj, TOL)
    tc = TT.init_cache(tcfg, 3, 64, device="cpu")
    jc = JT.init_cache(jcfg, 3, 64)
    assert set(tc) == set(jc)
    for kind in ("rec", "attn"):
        for leaf in jc[kind]:
            assert tuple(tc[kind][leaf].shape) == jc[kind][leaf].shape
            assert str(tc[kind][leaf].dtype).split(".")[1] == \
                str(jc[kind][leaf].dtype)


def test_prompt_longer_than_the_window_matches_reference(hybrid_setup):
    """A 45-token prefill rolls the attention tail into the ring; decode
    continues from it."""
    jcfg, jparams, tcfg, tparams = hybrid_setup
    rng = np.random.default_rng(36)
    toks = rng.integers(0, 257, size=(2, 45))
    steps = rng.integers(0, 257, size=(3, 2)).astype(np.int32)
    lj, cj = JT.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                        mode="prefill", max_len=64)
    lt, ct = TT.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                        mode="prefill", max_len=64)
    _close(lt, lj, TOL)
    _close(ct["attn"]["k"], cj["attn"]["k"], TOL)
    step = jax.jit(lambda p, t, c: JT.decode_step(jcfg, p, {"tokens": t}, c))
    for s in steps:
        lj, cj = step(jparams, jnp.asarray(s), cj)
        lt, ct = TT.decode_step(tcfg, tparams, {"tokens": torch.from_numpy(s)},
                                ct)
        _close(lt, lj, TOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_serving_engine_matches_reference(hybrid_setup):
    """Requests join and leave two slots at different times; one prompt
    (40 tokens) is longer than the window, and decode runs past it for the
    rest.  Each prompt prefills alone at its exact length and is written
    into its slot's ``rec`` and ``attn`` rows.  Token streams, finishing
    order and the hot-path counters equal the reference's."""
    jcfg, jparams, tcfg, tparams = hybrid_setup
    engines = []
    for mod, cfg, params in ((jserve, jcfg, jparams),
                             (tserve, tcfg, tparams)):
        eng = mod.ServingEngine(cfg, params, n_slots=2, max_len=64)
        eng.batcher.sampler = mod.quantized_greedy
        rng = np.random.default_rng(37)
        lens = (40, 12, 25, 7, 30)
        reqs = [mod.ServeRequest(i, rng.integers(0, 257, size=lens[i]),
                                 max_new_tokens=(4, 9, 6, 12, 3)[i])
                for i in range(5)]
        for r in reqs[:3]:
            eng.submit(r)
        for _ in range(2):
            eng.step()
        for r in reqs[3:]:
            eng.submit(r)
        engines.append((eng, reqs, eng.run()))
    (je, jreqs, jdone), (te, treqs, tdone) = engines
    assert not te.batcher._can_bucket
    assert len(tdone) == len(jdone) == 5
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for a, b in zip(treqs, jreqs):
        assert a.generated == [int(x) for x in b.generated], a.rid
        assert a.first_token_at == b.first_token_at
    jh, th = je.hotpath_stats(), te.hotpath_stats()
    for k in ("n_decode_steps", "n_prefill_calls", "n_prefill_reqs",
              "n_prefill_tokens"):
        assert th[k] == jh[k], k
    assert th["n_prefill_calls"] == 5


def test_pipeboost_engine_matches_reference(hybrid_setup):
    """Event log, chain and cold-start accounting equal the reference's;
    logits agree, and are the same before and after full load."""
    jcfg, jparams, tcfg, tparams = hybrid_setup
    je = JEngine(jcfg, jparams, n_devices=3, max_len=48)
    te = PipeBoostEngine(tcfg, tparams, n_devices=3, max_len=48)
    toks = np.random.default_rng(38).integers(0, 257, size=(2, 9))
    assert te.rounds_to_ready() == je.rounds_to_ready()
    je.load_round()
    te.load_round()
    assert te.ready == je.ready and te.chain() == je.chain()

    def run(e, to_dev, n=3):
        lg = [e.prefill({"tokens": to_dev(toks)})]
        for _ in range(n):
            nxt = np.asarray(to_numpy(lg[-1])).argmax(-1).astype(np.int32)
            lg.append(e.decode(to_dev(nxt)))
        return [np.asarray(to_numpy(x)) for x in lg]

    t_partial = run(te, torch.from_numpy)
    j_partial = run(je, jnp.asarray)
    for a, b in zip(t_partial, j_partial):
        np.testing.assert_allclose(a, b, atol=TOL)
    assert len(list(te.fill_steps())) == len(list(je.fill_steps()))
    assert te.maybe_switch_strategy(1.0) and je.maybe_switch_strategy(1.0)
    t_full = run(te, torch.from_numpy)
    run(je, jnp.asarray)
    for a, b in zip(t_full, t_partial):
        np.testing.assert_array_equal(a, b)
    assert te.events == je.events
    ts, js = te.cold_start_stats(), je.cold_start_stats()
    for k in ("loaded_bytes", "total_bytes", "n_rounds", "round_bytes"):
        assert ts[k] == js[k], k


@pytest.mark.parametrize("adapters", [0, 2])
def test_serve_cli_cpu_recurrentgemma(capsys, adapters):
    """``--arch recurrentgemma-2b`` on the CPU (reduced to 9 layers, three
    periods of ``rec, rec, attn``); adapters merge into its 3 attention
    layers."""
    res = serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "4",
                      "--adapters", str(adapters), "--new-tokens", "4",
                      "--max-len", "96", "--prompt-len", "8-40",
                      "--seed", "3"])
    out = capsys.readouterr().out
    assert "served 4 requests of recurrentgemma-2b" in out
    assert res.cfg.n_layers == 9 and res.cfg.d_model == 64
    assert res.cfg.layer_kinds() == ["rec", "rec", "attn"] * 3
    assert all(r.done and len(r.generated) == 4 for r in res.requests)
    assert res.hotpath["n_prefill_calls"] == 4
    assert res.cold_start["loaded_bytes"] == res.cold_start["total_bytes"]
    vocab = res.cfg.padded_vocab
    assert all(0 <= t < vocab for r in res.requests for t in r.generated)
