"""The port's Mamba-2 slice against the JAX package: the SSD scan's plain
version, the causal conv, the SSM block, the all-SSM model, and the
serving path on mamba2-780m reduced (d_model 64, 8 heads of 16, N = 16,
chunk 16, float32).

Inputs are made with numpy from a seed; weights come from the reference
through ``params_from_jax``.  Tolerances: 2e-5 of the reference's largest
magnitude between the plain SSD scan and the reference's Pallas kernel
(interpret mode; the same algorithm, so sum order only, and its rounding
scales with the summed terms, up to |y| ~ 200 at N = 128, not with the
result); 5e-4 against the sequential oracle (the reference's own
allowance for chunked against sequential); 1e-4 on SSM block outputs,
states and logits (the port's scan runs in chunks of 64 where the
reference's ``ssd_chunked`` uses the config's 16); token streams under
``quantized_greedy`` exactly equal.
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
from repro.lora import adapters as jlora
from repro.models import layers as jlayers
from repro.models import mamba2 as jm
from repro.models import transformer as JT
from repro.serving import engine as jserve
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.core.engine import PipeBoostEngine
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.launch import serve
from repro_torch.lora import adapters as tlora
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tm
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as tserve

KERNEL_TOL = 2e-5
ORACLE_TOL = 5e-4
TOL = 1e-4
ARCH = "mamba2-780m"
KEY = jax.random.PRNGKey(7)

# the reference's own sweep (tests/test_kernels.py), pad path included
SSD_SHAPES = [
    (1, 64, 2, 16, 8, 16),
    (2, 130, 4, 32, 16, 32),     # pad path
    (1, 256, 8, 64, 128, 64),    # mamba2-780m-like dims
]


def _close(a, b, tol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(to_numpy(a), np.float32),
                               np.asarray(b, np.float32), atol=tol,
                               rtol=rtol)


def _close_scaled(a, b, tol):
    """Within ``tol`` of the reference's largest magnitude."""
    b = np.asarray(b, np.float32)
    _close(a, b, tol * float(np.abs(b).max()))


def _ssd_inputs(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((B, S, H, P)).astype(f)
    dt = np.logaddexp(0.0, rng.standard_normal((B, S, H))).astype(f)
    A = (-np.exp(rng.standard_normal((H,)) * 0.3)).astype(f)
    Bm = rng.standard_normal((B, S, N)).astype(f)
    Cm = rng.standard_normal((B, S, N)).astype(f)
    return x, dt, A, Bm, Cm


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_plain_matches_pallas(B, S, H, P, N, chunk):
    inputs = _ssd_inputs(20, B, S, H, P, N)
    yj, sj = jops.ssd_scan(*_jax(*inputs), chunk=chunk)
    yt, st = tssd.ssd_scan_plain(*_torch(*inputs), chunk=chunk)
    assert yt.shape == (B, S, H, P) and st.shape == (B, H, P, N)
    assert st.dtype == torch.float32
    _close_scaled(yt, yj, KERNEL_TOL)
    _close_scaled(st, sj, KERNEL_TOL)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_plain_matches_sequential_oracle(B, S, H, P, N, chunk):
    """The plain version (at its own chunk and at the reference's) against
    the port's sequential oracle, which matches the reference's."""
    inputs = _ssd_inputs(21, B, S, H, P, N)
    yr, sr = tref.ssd_scan_ref(*_torch(*inputs))
    yj, sj = jref.ssd_scan_ref(*_jax(*inputs))
    _close_scaled(yr, yj, KERNEL_TOL)
    _close_scaled(sr, sj, KERNEL_TOL)
    for c in (chunk, tssd.CHUNK):
        y, s = tssd.ssd_scan_plain(*_torch(*inputs), chunk=c)
        _close(y, to_numpy(yr), ORACLE_TOL, ORACLE_TOL)
        _close(s, to_numpy(sr), ORACLE_TOL, ORACLE_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_op_runs_plain_on_cpu_and_counts_no_launch(with_state):
    """On CPU tensors the model-layout op is the plain version, with and
    without ``plain_versions()``, and launches nothing."""
    x, dt, A, Bm, Cm = _torch(*_ssd_inputs(22, 2, 70, 4, 16, 8))
    h0 = torch.randn((2, 4, 16, 8),
                     generator=torch.Generator().manual_seed(0)) \
        if with_state else None
    tops.reset_launch_counts()
    y0, s0 = tssd.ssd_scan_plain(x, dt, A, Bm, Cm, h0)
    y1, s1 = tops.ssd_scan(x, dt, A, Bm, Cm, h0)
    with tops.plain_versions():
        y2, s2 = tops.ssd_scan(x, dt, A, Bm, Cm, h0)
    for y in (y1, y2):
        assert torch.equal(y, y0)
    for s in (s1, s2):
        assert torch.equal(s, s0)
    assert tops.launch_counts() == {"decode_attention": 0,
                                    "flash_attention": 0, "lora_merge": 0,
                                    "ssd_scan": 0, "rglru_scan": 0,
                                    "rms_norm": 0, "rope": 0,
                                    "ssm_step": 0}


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(with_state):
    """The plain scan from a given initial state (or zeros), at the
    reference's chunk and at its own, against the reference's XLA-path
    ``ssd_chunked``."""
    B, S, H, P, N = 2, 70, 4, 16, 8
    x, dt, A, Bm, Cm = _ssd_inputs(23, B, S, H, P, N)
    s0 = (np.random.default_rng(24).standard_normal((B, H, P, N))
          .astype(np.float32)) if with_state else None
    yj, sj = jm.ssd_chunked(*_jax(x, dt, A, Bm, Cm), 16,
                            initial_state=None if s0 is None
                            else jnp.asarray(s0))
    for chunk in (16, tssd.CHUNK):
        yt, st = tssd.ssd_scan_plain(
            *_torch(x, dt, A, Bm, Cm),
            None if s0 is None else torch.from_numpy(s0), chunk=chunk)
        _close_scaled(yt, yj, KERNEL_TOL)
        _close_scaled(st, sj, KERNEL_TOL)


# ---------------------------------------------------------------------------
# conv, block, model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(with_state):
    rng = np.random.default_rng(25)
    w = rng.standard_normal((4, 40)).astype(np.float32)
    x = rng.standard_normal((2, 9, 40)).astype(np.float32)
    st = rng.standard_normal((2, 3, 40)).astype(np.float32)
    s_j = jnp.asarray(st) if with_state else None
    s_t = torch.from_numpy(st) if with_state else None
    yj, nj = jlayers.causal_conv1d(jnp.asarray(w), jnp.asarray(x), s_j)
    yt, nt = tlayers.causal_conv1d(torch.from_numpy(w), torch.from_numpy(x),
                                   s_t)
    _close(yt, yj, KERNEL_TOL)
    _close(nt, nj, 0.0)
    yj, nj = jlayers.causal_conv1d_step(jnp.asarray(w), jnp.asarray(x[:, 0]),
                                        jnp.asarray(st))
    yt, nt = tlayers.causal_conv1d_step(torch.from_numpy(w),
                                        torch.from_numpy(x[:, 0]),
                                        torch.from_numpy(st))
    _close(yt, yj, KERNEL_TOL)
    _close(nt, nj, 0.0)


@pytest.fixture(scope="module")
def ssm_setup():
    jcfg = jget_arch(ARCH).reduced()
    jparams = JT.init_params(jcfg, KEY)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, get_arch(ARCH).reduced(), tparams


def test_ssm_block_matches_reference(ssm_setup):
    """Prefill from an empty state, a continued prefill from that state
    (both through the port's scan op), then one decode step."""
    jcfg, jparams, tcfg, tparams = ssm_setup
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["ssm"])
    tp = TT.layer_params(tparams["blocks"]["ssm"], 0)
    x = np.random.default_rng(26).standard_normal((2, 37, 64)).astype(
        np.float32)
    yj, (cj, sj) = jm.ssm_block_fwd(jcfg, jp, jnp.asarray(x[:, :20]))
    yt, (ct, st) = tm.ssm_block_fwd(tcfg, tp, torch.from_numpy(x[:, :20]))
    _close(yt, yj, TOL)
    _close(ct, cj, TOL)
    _close(st, sj, TOL)
    yj, (cj, sj) = jm.ssm_block_fwd(jcfg, jp, jnp.asarray(x[:, 20:36]),
                                    conv_state=cj, ssm_state=sj)
    yt, (ct, st) = tm.ssm_block_fwd(tcfg, tp, torch.from_numpy(x[:, 20:36]),
                                    conv_state=ct, ssm_state=st)
    _close(yt, yj, TOL)
    _close(st, sj, TOL)
    yj, (cj, sj) = jm.ssm_block_step(jcfg, jp, jnp.asarray(x[:, 36]), cj, sj)
    yt, (ct, st) = tm.ssm_block_step(tcfg, tp, torch.from_numpy(x[:, 36]),
                                     ct, st)
    _close(yt, yj, TOL)
    _close(ct, cj, TOL)
    _close(st, sj, TOL)


def test_prefill_and_decode_match_reference(ssm_setup):
    """Prefill + 6 teacher-forced decode steps: logits and the ``ssm``
    conv and state caches (the port updates them in place)."""
    jcfg, jparams, tcfg, tparams = ssm_setup
    rng = np.random.default_rng(27)
    toks = rng.integers(0, 257, size=(3, 21))
    steps = rng.integers(0, 257, size=(6, 3)).astype(np.int32)
    lj, cj = JT.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                        mode="prefill", max_len=64)
    lt, ct = TT.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                        mode="prefill", max_len=64)
    assert set(ct) == set(cj) == {"pos", "ssm"}
    _close(lt, lj, TOL)
    step = jax.jit(lambda p, t, c: JT.decode_step(jcfg, p, {"tokens": t}, c))
    for s in steps:
        lj, cj = step(jparams, jnp.asarray(s), cj)
        lt, ct = TT.decode_step(tcfg, tparams, {"tokens": torch.from_numpy(s)},
                                ct)
        _close(lt, lj, TOL)
    np.testing.assert_array_equal(to_numpy(ct["pos"]), np.asarray(cj["pos"]))
    for leaf in ("conv", "state"):
        _close(ct["ssm"][leaf], cj["ssm"][leaf], TOL)
    # the reference's cache, converted, continues in the port
    cc = params_from_jax(jax.tree.map(np.asarray, cj), "cpu")
    assert cc["ssm"]["state"].dtype == torch.float32
    assert cc["pos"].dtype == torch.int32
    nxt = jnp.asarray(steps[0])
    lj, _ = step(jparams, nxt, cj)
    lt, _ = TT.decode_step(tcfg, tparams, {"tokens": torch.from_numpy(
        steps[0])}, cc)
    _close(lt, lj, TOL)
    tc = TT.init_cache(tcfg, 3, 64, device="cpu")
    jc = JT.init_cache(jcfg, 3, 64)
    for leaf in ("conv", "state"):
        assert tuple(tc["ssm"][leaf].shape) == jc["ssm"][leaf].shape
        assert str(tc["ssm"][leaf].dtype).split(".")[1] == \
            str(jc["ssm"][leaf].dtype)
    assert "attn" not in tc and "attn" not in jc


def test_lora_on_an_attention_free_model_is_empty(ssm_setup):
    """LoRA targets attention projections only: for mamba2 the adapter is
    empty and merging it is the identity, as in the reference."""
    jcfg, jparams, tcfg, tparams = ssm_setup
    ja = jlora.init_lora(KEY, jcfg, rank=4)
    ta = tlora.randomize_lora(torch.Generator().manual_seed(0),
                              tlora.init_lora(torch.Generator().manual_seed(0),
                                              tcfg, rank=4, device="cpu"))
    assert ja.blocks == {} and ta.blocks == {}
    merged = tlora.merge_lora(tparams, ta)
    for name, leaf in tparams["blocks"]["ssm"].items():
        assert merged["blocks"]["ssm"][name] is leaf
    assert merged["embed"] is tparams["embed"]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ssm4_setup():
    jcfg = jget_arch(ARCH).reduced(n_layers=4)
    jparams = JT.init_params(jcfg, KEY)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, get_arch(ARCH).reduced(n_layers=4), tparams


def test_serving_engine_matches_reference(ssm4_setup):
    """Requests join and leave two slots at different times; each prompt
    prefills alone at its exact length and is written into its slot's
    conv and state rows.  Token streams, finishing order and the hot-path
    counters equal the reference's."""
    jcfg, jparams, tcfg, tparams = ssm4_setup
    engines = []
    for mod, cfg, params in ((jserve, jcfg, jparams),
                             (tserve, tcfg, tparams)):
        eng = mod.ServingEngine(cfg, params, n_slots=2, max_len=48)
        eng.batcher.sampler = mod.quantized_greedy
        rng = np.random.default_rng(28)
        reqs = [mod.ServeRequest(i, rng.integers(0, 257,
                                                 size=(7, 12)[i % 2]),
                                 max_new_tokens=3 + i % 3)
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


def test_pipeboost_engine_matches_reference(ssm4_setup):
    """Event log, chain and cold-start accounting equal the reference's;
    logits agree, and are the same before and after full load."""
    jcfg, jparams, tcfg, tparams = ssm4_setup
    je = JEngine(jcfg, jparams, n_devices=4, max_len=32)
    te = PipeBoostEngine(tcfg, tparams, n_devices=4, max_len=32)
    toks = np.random.default_rng(29).integers(0, 257, size=(2, 9))
    assert te.rounds_to_ready() == je.rounds_to_ready() == 1
    je.load_round()
    te.load_round()
    assert te.ready and te.chain() == je.chain()

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
def test_serve_cli_cpu_mamba2(capsys, adapters):
    """``--arch mamba2-780m`` on the CPU (reduced, 8 layers); requested
    adapters are empty and merge as the identity."""
    res = serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "4",
                      "--adapters", str(adapters), "--new-tokens", "4",
                      "--max-len", "96", "--prompt-len", "8-40",
                      "--seed", "2"])
    out = capsys.readouterr().out
    assert "served 4 requests of mamba2-780m" in out
    assert res.cfg.n_layers == 8 and res.cfg.d_model == 64
    assert res.cfg.layer_kinds() == ["ssm"] * 8
    assert all(r.done and len(r.generated) == 4 for r in res.requests)
    assert res.hotpath["n_prefill_calls"] == 4
    assert res.cold_start["loaded_bytes"] == res.cold_start["total_bytes"]
    vocab = res.cfg.padded_vocab
    assert all(0 <= t < vocab for r in res.requests for t in r.generated)
