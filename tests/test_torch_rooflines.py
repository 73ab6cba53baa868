"""The port's rooflines (``repro_torch.launch.rooflines``) against the
reference's, and each kernel module's ``cost()`` against the counts
``chip_smoke.py`` phase 3 printed its bounds from (PERF.md §6): the
same work whatever implements it."""
import math

import pytest

from repro.launch import rooflines as jrf
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lora_merge as lm
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import rooflines as rf

POINTS = [(1e12, 1e9, 1e8), (3.3e14, 2e11, 0.0), (5e9, 7e10, 4e9),
          (2e13, 1e10, 3e10)]


def _scaled(flops, nbytes, coll):
    """The same terms on the H100 constants as the reference's on its."""
    return (flops * rf.PEAK_FLOPS["bfloat16"] / jrf.PEAK_FLOPS,
            nbytes * rf.HBM_BW / jrf.HBM_BW, coll * rf.LINK_BW / jrf.ICI_BW)


@pytest.mark.parametrize("point", POINTS, ids=[str(p) for p in POINTS])
def test_terms_equal_the_reference_once_scaled(point):
    want = jrf.make_terms(*point)
    got = rf.make_terms(*_scaled(*point))
    for k in ("compute_s", "memory_s", "collective_s"):
        assert math.isclose(getattr(got, k), getattr(want, k),
                            rel_tol=1e-12), k
    assert got.dominant == want.dominant
    assert math.isclose(got.total_s, want.total_s, rel_tol=1e-12)
    assert set(got.to_dict()) == set(want.to_dict())


def test_constants_are_the_h100s():
    assert rf.PEAK_FLOPS["bfloat16"] == 989e12
    assert rf.PEAK_FLOPS["float32"] == 67e12
    assert rf.HBM_BW == 3.35e12
    assert rf.LINK_BW == 450e9


def test_float32_share_runs_at_the_float32_peak():
    t = rf.make_terms(2e12, 0.0, 0.0, f32_flops=1e12)
    assert math.isclose(t.compute_s, 1e12 / 989e12 + 1e12 / 67e12,
                        rel_tol=1e-12)


@pytest.mark.parametrize("args", [(10.0, 20.0, 2, 4, 28),
                                  (5.0, 5.0, 6, 12, 26),
                                  (100.0, 50.0, 2, 4, 48)])
def test_extrapolate_equals_the_reference(args):
    assert rf.extrapolate(*args) == jrf.extrapolate(*args)


def test_bound_picks_the_larger_term():
    assert rf.bound(3.35e9, 1.0, "bfloat16") == (1.0, "bytes")
    ms, by = rf.bound(1.0, 989e9, "bfloat16")
    assert by == "operations" and math.isclose(ms, 1.0)


# phase 3's timed cases: (name, cost(), the counts phase 3 computed
# inline before cost() existed, the bound in PERF.md §6 to its digits)
def _decode(B, Hq, Hkv, d, C, lens, fold, mask):
    valid = sum(lens)
    nb = (B * Hq * d * 2 + (2 * B * Hkv * d * 2 if fold else 0) + 4 * B
          + (B * C if mask else 0) + 2 * valid * Hkv * d * 2 + B * Hq * d * 2)
    return (dec.cost(batch=B, heads=Hq, kv_heads=Hkv, head_dim=d,
                     cache_len=C, valid_rows=valid, fold=fold,
                     slot_mask=mask),
            (4 * Hq * d * (valid + (B if fold else 0)), nb))


def _flash(B, S, Hq, Hkv, d, causal):
    pairs = S * (S + 1) // 2 if causal else S * S
    q = B * S * Hq * d * 2
    return (fa.cost(batch=B, q_len=S, kv_len=S, heads=Hq, kv_heads=Hkv,
                    head_dim=d, causal=causal),
            (4 * B * Hq * d * pairs, 2 * q + 2 * B * S * Hkv * d * 2))


def _ssd(B, S, H=48, P=64, N=128):
    flops = 0
    for t0 in range(0, S, 64):
        q = min(64, S - t0)
        pairs = q * (q + 1) // 2
        flops += B * (2 * N * pairs + H * (2 * P * pairs + 4 * q * P * N))
    x = B * S * H * P * 2
    nb = 2 * x + B * S * H * 4 + H * 4 + 2 * B * S * N * 2 + B * H * P * N * 4
    return ssd.cost(batch=B, seq=S, heads=H, head_dim=P, state=N), (flops,
                                                                     nb)


def _rglru(B, S, W=2560):
    return (rg.cost(batch=B, seq=S, width=W),
            (3 * B * S * W, 2 * B * S * W * 4 + B * S * W * 4 + B * W * 4))


C = 1024
CASES = {
    "decode opt-1.3b": (_decode(4, 32, 32, 64, C, [C - 1] * 4, True, False),
                        0.0100),
    "decode recurrentgemma-2b": (_decode(4, 10, 1, 256, C,
                                         [0, 77, 600, C - 1], True, True),
                                 0.0005),
    "decode qwen2-moe-a2.7b": (_decode(4, 16, 16, 128, C, [C - 1] * 4, True,
                                       False), 0.0100),
    "flash opt-1.3b": (_flash(4, 512, 32, 32, 64, True), 0.0100),
    "flash recurrentgemma-2b": (_flash(1, 512, 10, 1, 256, True), 0.0017),
    "flash qwen2-moe-a2.7b": (_flash(1, 512, 16, 16, 128, True), 0.0025),
    "flash hubert-xlarge": (_flash(4, 512, 16, 16, 80, False), 0.0063),
    "lora opt-1.3b": ((lm.cost(layers=24, d_in=2048, d_out=2048, rank=16),
                       (24 * 2048 * 2048 * 33,
                        2 * 24 * 2048 * 2048 * 2 + 2 * 24 * 2048 * 16 * 4)),
                      0.122),
    "ssd S=512": (_ssd(1, 512), 0.00246),
    "ssd S=64": (_ssd(1, 64), 0.00072),
    "rglru S=512": (_rglru(1, 512), 0.0047),
    "rglru S=64": (_rglru(1, 64), 0.0006),
}


@pytest.mark.parametrize("name", list(CASES))
def test_cost_reproduces_phase3_counts_and_perf_bounds(name):
    ((flops, nbytes, dtype), (want_flops, want_bytes)), perf_ms = \
        CASES[name]
    assert (flops, nbytes) == (want_flops, want_bytes)
    ms, by = rf.bound(nbytes, flops, dtype)
    digits = len(repr(perf_ms).split(".")[1])
    assert round(ms, digits) == perf_ms, (ms, perf_ms)
    assert by == "bytes"


@pytest.mark.parametrize("case", [
    dict(q_len=7, kv_len=7, causal=True, window=0, q_offset=0),
    dict(q_len=5, kv_len=12, causal=True, window=4, q_offset=7),
    dict(q_len=9, kv_len=9, causal=False, window=3, q_offset=0),
    dict(q_len=6, kv_len=10, causal=False, window=0, q_offset=4)])
def test_visible_pairs_counts_the_mask(case):
    """``visible_pairs`` against the plain version's own mask."""
    import torch
    qp = case["q_offset"] + torch.arange(case["q_len"])
    kp = torch.arange(case["kv_len"])
    mask = fa._mask(qp, kp, causal=case["causal"], window=case["window"])
    assert fa.visible_pairs(**case) == int(mask.sum())


def test_grad_costs_exceed_the_forward():
    f = fa.cost(batch=1, q_len=64, kv_len=64, heads=2, kv_heads=2,
                head_dim=64)
    b = fa.cost(batch=1, q_len=64, kv_len=64, heads=2, kv_heads=2,
                head_dim=64, grad=True)
    assert b[0] == 2.5 * f[0] and b[1] > f[1]
    s, sg = (ssd.cost(batch=1, seq=128, heads=4, head_dim=64, state=128,
                      grad=g) for g in (False, True))
    assert sg[0] == 2 * s[0]
    r, rgd = (rg.cost(batch=1, seq=64, width=256, grad=g)
              for g in (False, True))
    assert rgd[0] > r[0] and rgd[1] > r[1]
