"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and needs an NVIDIA Hopper card and
``nvcc``; the ``card`` fixture skips them where there is none (decided
inside the fixture, never at import time).  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 kernels within 2e-5 of the plain version (sum order
only); bfloat16 attention within 2e-2 of the plain version computed in
float32 from the same bf16 inputs (sum order plus one bf16 rounding of the
output); a bf16 LoRA merge within one bf16 ulp of |W'|.  The SSD scan's
sums run over up to 128 terms of magnitude up to max|y|, so its float32 y
is held within 2e-5 of max|plain y|; its bf16 y element by element within
2^-8 |plain y| (half a bf16 ulp, the most one rounding moves it) plus
1e-2 mean|plain y| (float32 sum order); its float32 state within 1e-4 of
max|plain state|.  The RG-LRU scan runs in float32 on both sides and
differs by expf rounding and the kernel's carries across segments and
cluster ranks: y and h_T within 1e-5 of max|plain y| (and of max|plain
h_T|).
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.base import get_arch
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lora_merge as lm
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import transformer as T

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (an H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(shape, dtype, dev, gen, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,C,Hq,Hkv,d,fold,masked", [
    (4, 1024, 32, 32, 64, True, False),      # opt-1.3b decode
    (4, 1024, 16, 8, 128, True, False),      # qwen3-1.7b GQA decode
    (3, 300, 8, 2, 64, False, False),        # ragged C, no fold
    (3, 96, 28, 4, 128, True, True),         # group of 7, ring slot mask
    (2, 77, 8, 8, 64, False, True),          # slot mask, no fold
    (4, 1024, 10, 1, 256, True, True),       # recurrentgemma: G 10, ring
    (3, 300, 10, 1, 256, False, False),      # G 10 at hd 256, ragged C
    (2, 130, 20, 2, 256, True, False),       # two KV heads of 10
    (2, 200, 32, 2, 128, True, True),        # group of 16: a whole mma tile
])
def test_decode_kernel_matches_plain(card, dtype, B, C, Hq, Hkv, d, fold,
                                     masked):
    g = _gen(card)
    q = _rand((B, 1, Hq, d), dtype, card, g)
    k = _rand((B, C, Hkv, d), dtype, card, g)
    v = _rand((B, C, Hkv, d), dtype, card, g)
    kn = _rand((B, 1, Hkv, d), dtype, card, g) if fold else None
    vn = _rand((B, 1, Hkv, d), dtype, card, g) if fold else None
    lens = torch.randint(1, C - 1, (B,), generator=g, device=card,
                         dtype=torch.int32)
    lens[0] = 0
    lens[-1] = C - 1
    sm = (torch.rand((B, C), generator=g, device=card) > 0.3) \
        if masked else None
    n0 = dec.launches
    out = ops.decode_attention(q, k, v, lens, k_new=kn, v_new=vn,
                               slot_mask=sm)
    torch.cuda.synchronize()
    assert dec.launches == n0 + 1
    f = (lambda t: None if t is None else t.float())
    with ops.plain_versions():
        ref = ops.decode_attention(q.float(), k.float(), v.float(), lens,
                                   k_new=f(kn), v_new=f(vn), slot_mask=sm)
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref).abs().max().item() <= TOL[dtype]


def _decode_against_plain(card, dtype, q, k, v, lens, kn, vn, sm=None):
    n0 = dec.launches
    out = ops.decode_attention(q, k, v, lens, k_new=kn, v_new=vn,
                               slot_mask=sm)
    torch.cuda.synchronize()
    assert dec.launches == n0 + 1
    f = (lambda t: None if t is None else t.float())
    with ops.plain_versions():
        ref = ops.decode_attention(q.float(), k.float(), v.float(), lens,
                                   k_new=f(kn), v_new=f(vn), slot_mask=sm)
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref).abs().max().item() <= TOL[dtype]
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("B,C,Hq,Hkv,d", [
    (4, 1024, 32, 32, 64),       # opt-1.3b: 3 splits of 342 rows
    (4, 1000, 16, 8, 128),       # C not a multiple of the split width
    (4, 300, 10, 1, 256),        # recurrentgemma's group, C ragged
    (4, 77, 2, 1, 64),           # two splits, group of 2
])
def test_decode_kernel_split_edges(card, dtype, fold, B, C, Hq, Hkv, d):
    """lens at 1, exactly one split's width, one more than it and C - 1:
    the split boundaries of ``decode_splits``, where a CTA's range is cut
    by the valid length or empty."""
    g = _gen(card, 8)
    q = _rand((B, 1, Hq, d), dtype, card, g)
    k = _rand((B, C, Hkv, d), dtype, card, g)
    v = _rand((B, C, Hkv, d), dtype, card, g)
    kn = _rand((B, 1, Hkv, d), dtype, card, g) if fold else None
    vn = _rand((B, 1, Hkv, d), dtype, card, g) if fold else None
    width = -(-C // dec.decode_splits(B, Hkv, C, d))
    lens = torch.tensor([1, width, min(width + 1, C - 1), C - 1],
                        dtype=torch.int32, device=card)
    _decode_against_plain(card, dtype, q, k, v, lens, kn, vn)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("Hq,Hkv,d", [(32, 32, 64), (10, 1, 256)])
def test_decode_kernel_all_rows_empty(card, dtype, fold, Hq, Hkv, d):
    """Every row at lens 0, so every split is empty: zeros, or the new
    token's value alone where it is folded in."""
    B, C = 4, 1024
    g = _gen(card, 9)
    q = _rand((B, 1, Hq, d), dtype, card, g)
    k = _rand((B, C, Hkv, d), dtype, card, g)
    v = _rand((B, C, Hkv, d), dtype, card, g)
    kn = _rand((B, 1, Hkv, d), dtype, card, g) if fold else None
    vn = _rand((B, 1, Hkv, d), dtype, card, g) if fold else None
    lens = torch.zeros((B,), dtype=torch.int32, device=card)
    out = _decode_against_plain(card, dtype, q, k, v, lens, kn, vn)
    if fold:
        want = vn.repeat_interleave(Hq // Hkv, dim=2)
        assert torch.equal(out, want)
    else:
        assert torch.all(out == 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,Sk,Hq,Hkv,d,window,q_offset", [
    (4, 512, 512, 32, 32, 64, 0, 0),         # opt-1.3b prefill
    (4, 128, 128, 16, 8, 128, 0, 0),         # qwen3-1.7b GQA prefill
    (2, 300, 300, 16, 8, 128, 64, 0),        # window, ragged edge
    (2, 100, 612, 8, 2, 64, 0, 512),         # continued prefill
    (1, 512, 512, 10, 1, 256, 0, 0),         # recurrentgemma prefill
    (2, 600, 600, 10, 1, 256, 256, 0),       # hd 256, window < Sk
    (1, 100, 612, 10, 1, 256, 0, 512),       # hd 256 continued prefill
])
def test_flash_kernel_matches_plain(card, dtype, B, S, Sk, Hq, Hkv, d,
                                    window, q_offset):
    g = _gen(card, 1)
    q = _rand((B, S, Hq, d), dtype, card, g)
    k = _rand((B, Sk, Hkv, d), dtype, card, g)
    v = _rand((B, Sk, Hkv, d), dtype, card, g)
    n0 = fa.launches
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.launches == n0 + 1
    with ops.plain_versions():
        ref = ops.flash_attention(q.float(), k.float(), v.float(),
                                  causal=True, window=window,
                                  q_offset=q_offset)
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [65, 700])
@pytest.mark.parametrize("Hq,Hkv,d", [(8, 2, 64), (8, 4, 128), (10, 1, 256)])
def test_flash_kernel_ragged_tiles(card, dtype, S, Hq, Hkv, d):
    """Sq = Sk one past a 64-row tile (65) and ragged in the last of 11
    (700), at every head dim: the query and key tiles' ragged edges."""
    g = _gen(card, 10)
    q = _rand((2, S, Hq, d), dtype, card, g)
    k = _rand((2, S, Hkv, d), dtype, card, g)
    v = _rand((2, S, Hkv, d), dtype, card, g)
    n0 = fa.launches
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.launches == n0 + 1
    with ops.plain_versions():
        ref = ops.flash_attention(q.float(), k.float(), v.float(),
                                  causal=True)
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("L,Din,Dout,r", [
    (24, 2048, 2048, 16),        # opt-1.3b's attention projections
    (3, 300, 200, 8),
    (2, 700, 520, 1),            # rank 1; Din, Dout off the 64 x 128 tiles
    (2, 129, 1032, 32),          # the largest rank
    (4, 5, 136, 16),             # Din smaller than one tile
    (1, 64, 8, 8),               # one tile, Dout of one column group
])
def test_lora_kernel_matches_plain(card, dtype, L, Din, Dout, r):
    g = _gen(card, 2)
    W = _rand((L, Din, Dout), dtype, card, g, 0.05)
    A = _rand((L, Din, r), torch.float32, card, g, Din ** -0.5)
    B = _rand((L, r, Dout), torch.float32, card, g, 0.02)
    out = ops.lora_merge(W, A, B, 2.0)
    torch.cuda.synchronize()
    ref = lm.lora_merge_plain(W, A, B, 2.0)
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= TOL[dtype]
    else:
        _, e = torch.frexp(ref.float().abs())
        assert bool((diff <= torch.ldexp(torch.ones_like(diff), e - 8)).all())


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,P,N", [
    (1, 512, 48, 64, 128),       # mamba2-780m prefill
    (4, 300, 48, 64, 128),       # ragged S, B > 1
    (2, 64, 8, 32, 16),          # one whole chunk, small N
    (3, 1, 4, 64, 100),          # one row, N not a power of two
    (4, 300, 48, 64, 100),       # 64 columns of P a CTA, N % 8 != 0
    (2, 200, 48, 64, 99),        # odd N
    (2, 70, 4, 32, 7),           # odd N below one 16-column tile
])
def test_ssd_kernel_matches_plain(card, dtype, B, S, H, P, N, with_state):
    """x, Bm and Cm are strided slices of one conv_out-like tensor, as in
    the model; the scan starts from a given state or from zeros."""
    _check_ssd(card, dtype, B, S, H, P, N, with_state)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [0, 1, 63, 64, 65, 129, 1024])
def test_ssd_kernel_chunk_edges(card, dtype, S, with_state):
    """The edges of the kernel's 64-row chunks at mamba2-780m's heads, up
    to max_len: no row, one row, one short of a chunk, a chunk, one more,
    two chunks and one more, 16 chunks."""
    _check_ssd(card, dtype, 2, S, 48, 64, 128, with_state)


def _check_ssd(card, dtype, B, S, H, P, N, with_state):
    g = _gen(card, 6)
    di = H * P
    conv_out = _rand((B, S, di + 2 * N), dtype, card, g)
    x = conv_out[..., :di].reshape(B, S, H, P)
    Bm, Cm = conv_out[..., di:di + N], conv_out[..., di + N:]
    dt = F.softplus(torch.randn((B, S, H), generator=g, device=card))
    A = -torch.linspace(1.0, 16.0, H, device=card)
    h0 = torch.randn((B, H, P, N), generator=g, device=card) \
        if with_state else None
    n0 = ssd.launches
    y, st = ops.ssd_scan(x, dt, A, Bm, Cm, h0)
    torch.cuda.synchronize()
    assert ssd.launches == n0 + 1
    with ops.plain_versions():
        yr, sr = ops.ssd_scan(x.float(), dt, A, Bm.float(), Cm.float(), h0)
    assert y.dtype == dtype and y.shape == yr.shape
    assert st.dtype == torch.float32 and st.shape == sr.shape == (B, H, P, N)
    if S == 0:                   # no row: the final state is h0 or zeros
        assert torch.equal(st, sr)
        return
    assert bool(torch.isfinite(y.float()).all())
    diff = (y.float() - yr).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 2e-5 * yr.abs().max().item()
    else:
        limit = 2.0 ** -8 * yr.abs() + 1e-2 * yr.abs().mean()
        assert bool((diff <= limit).all())
    assert (st - sr).abs().max().item() <= 1e-4 * sr.abs().max().item()


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,S,W", [
    (1, 512, 2560),              # recurrentgemma-2b prefill: one window
    (4, 300, 2560),              # ragged S, B > 1
    (2, 77, 100),                # W not a multiple of the 32-channel block
    (2, 77, 33),                 # rows not 16-byte aligned: 4-byte loads
    (3, 5, 64),                  # fewer steps than the cluster's ranks
    (2, 1, 40),                  # one step
    (1, 64, 2560),               # a short serving prompt
    (2, 7, 40),                  # one step short of a step a rank
    (1, 511, 2560),              # one window, its last segment a step short
    (1, 513, 2560),              # a full window and one step
    (2, 2048, 2560),             # several full windows
    (1, 4097, 256),              # several windows, the last of one step
])
def test_rglru_kernel_matches_plain(card, B, S, W, with_state):
    """Decays as the model makes them (a in (0.9, 0.999) gated by r), the
    scan from zeros or from a given h0; a padded step (log_a = 0, bx = 0)
    repeats the state."""
    g = _gen(card, 7)
    lam = torch.log(torch.expm1(-torch.log(torch.linspace(
        0.9, 0.999, W, device=card)) / 8.0))
    r = torch.sigmoid(torch.randn((B, S, W), generator=g, device=card))
    log_a = -8.0 * F.softplus(lam) * r
    bx = torch.sqrt(1 - torch.exp(2 * log_a)) * torch.randn(
        (B, S, W), generator=g, device=card)
    h0 = torch.randn((B, W), generator=g, device=card) if with_state \
        else None
    n0 = rg.launches
    y, hT = ops.rglru_scan(log_a, bx, h0)
    torch.cuda.synchronize()
    assert rg.launches == n0 + 1
    with ops.plain_versions():
        yr, hr = ops.rglru_scan(log_a, bx, h0)
    assert y.dtype == hT.dtype == torch.float32
    assert y.shape == (B, S, W) and hT.shape == (B, W)
    tol = 1e-5 * yr.abs().max().item()
    assert (y - yr).abs().max().item() <= tol
    assert (hT - hr).abs().max().item() <= 1e-5 * hr.abs().max().item()
    assert torch.equal(y[:, -1], hT)
    pad = torch.zeros((B, 1, W), device=card)
    yp, hp = ops.rglru_scan(torch.cat([log_a, pad], 1),
                            torch.cat([bx, pad], 1), h0)
    assert torch.equal(yp[:, -1], hp)
    assert (yp[:, :-1] - yr).abs().max().item() <= tol
    assert (hp - hr).abs().max().item() <= 1e-5 * hr.abs().max().item()


@pytest.mark.parametrize("offset,S", [(0, 300), (1, 300), (1, 513)])
def test_rglru_kernel_reads_strided_views(card, offset, S):
    """log_a and bx as views into wider buffers (16-byte aligned rows, and
    rows one float off alignment), h_T bit for bit the last y."""
    g = _gen(card, 8)
    B, W = 2, 2560
    buf = torch.randn((2, B, S, W + 8), generator=g, device=card)
    log_a = buf[0, :, :, offset:offset + W]
    log_a.copy_(-F.softplus(log_a.clone()))
    bx = buf[1, :, :, offset:offset + W]
    h0 = torch.randn((B, W), generator=g, device=card)
    y, hT = ops.rglru_scan(log_a, bx, h0)
    torch.cuda.synchronize()
    with ops.plain_versions():
        yr, hr = ops.rglru_scan(log_a, bx, h0)
    assert (y - yr).abs().max().item() <= 1e-5 * yr.abs().max().item()
    assert (hT - hr).abs().max().item() <= 1e-5 * hr.abs().max().item()
    assert torch.equal(y[:, -1], hT)


def test_rglru_kernel_clusters_fit_the_card(card):
    """The card holds clusters of the kernel at recurrentgemma's width."""
    for B, S in ((1, 64), (1, 512), (4, 512), (1, 4097)):
        assert rg.max_active_clusters(card.index, B, S, 2560) >= 1


@pytest.mark.parametrize("what", ["bf16 log_a", "bf16 bx", "strided last dim",
                                  "h0 shape", "bf16 h0", "shape mismatch"])
def test_rglru_wrapper_rejects_what_the_kernel_does_not_take(card, what):
    B, S, W = 2, 16, 64
    log_a = torch.zeros((B, S, W), device=card)
    bx = torch.zeros((B, S, W), device=card)
    h0 = None
    if what == "bf16 log_a":
        log_a = log_a.to(torch.bfloat16)
    elif what == "bf16 bx":
        bx = bx.to(torch.bfloat16)
    elif what == "strided last dim":
        bx = torch.zeros((B, S, 2 * W), device=card)[..., ::2]
    elif what == "h0 shape":
        h0 = torch.zeros((B, 1, W), device=card)
    elif what == "bf16 h0":
        h0 = torch.zeros((B, W), device=card, dtype=torch.bfloat16)
    else:
        bx = bx[:, :-1]
    n0 = rg.launches
    with pytest.raises(ValueError):
        rg.rglru_scan(log_a, bx, h0)
    assert rg.launches == n0


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    q = torch.zeros((2, 4, 80), device=card, dtype=torch.bfloat16)
    k = torch.zeros((2, 4, 16, 80), device=card, dtype=torch.bfloat16)
    lens = torch.zeros((2,), device=card, dtype=torch.int32)
    with pytest.raises(ValueError):
        dec.decode_attention(q, k, k, lens)                 # head dim 80
    with pytest.raises(ValueError):
        dec.decode_attention(q[..., :64], k[..., :64].float(),
                             k[..., :64].float(), lens)      # mixed dtypes
    with pytest.raises(ValueError):                          # group of 17
        dec.decode_attention(torch.zeros((2, 17, 64), device=card,
                                         dtype=torch.bfloat16),
                             k[:, :1, :, :64], k[:, :1, :, :64], lens)
    with pytest.raises(ValueError):
        lm.lora_merge(torch.zeros((1, 8, 12), device=card),
                      torch.zeros((1, 8, 2), device=card),
                      torch.zeros((1, 2, 12), device=card), 1.0)  # Dout % 8


@pytest.mark.parametrize("what", ["P=48", "N=256", "mixed dtypes",
                                  "bf16 dt", "strided last dim",
                                  "state shape", "bf16 state"])
def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(card, what):
    B, S, H, P, N = 2, 16, 4, 64, 32
    bf = torch.bfloat16
    x = torch.zeros((B, S, H, P), device=card, dtype=bf)
    dt = torch.zeros((B, S, H), device=card)
    A = -torch.ones((H,), device=card)
    Bm = torch.zeros((B, S, N), device=card, dtype=bf)
    Cm = torch.zeros((B, S, N), device=card, dtype=bf)
    h0 = None
    if what == "P=48":
        x = x[..., :48]
    elif what == "N=256":
        Bm = Cm = torch.zeros((B, S, 256), device=card, dtype=bf)
    elif what == "mixed dtypes":
        Bm = Bm.float()
    elif what == "bf16 dt":
        dt = dt.to(bf)
    elif what == "strided last dim":
        Cm = torch.zeros((B, S, 2 * N), device=card, dtype=bf)[..., ::2]
    elif what == "state shape":
        h0 = torch.zeros((B, H, N, P), device=card)
    else:
        h0 = torch.zeros((B, H, P, N), device=card, dtype=bf)
    n0 = ssd.launches
    with pytest.raises(ValueError):
        ssd.ssd_scan(x, dt, A, Bm, Cm, h0)
    assert ssd.launches == n0


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-780m",
                                  "recurrentgemma-2b"])
def test_model_kernels_match_plain(card, arch):
    """A small bf16 model with kernel-sized heads: prefill + 4 zero-copy
    decode steps through the kernels against the plain versions (the
    recurrentgemma prompt of 40 tokens overflows its window of 32, so its
    ring buffer wraps)."""
    if arch == "qwen3-1.7b":
        cfg = get_arch(arch).reduced(n_layers=2, d_model=256, n_heads=4,
                                     n_kv_heads=2, head_dim=64,
                                     dtype="bfloat16")
        want = {"flash_attention": 2, "decode_attention": 8, "ssd_scan": 0,
                "rglru_scan": 0}
    elif arch == "mamba2-780m":
        cfg = get_arch(arch).reduced(n_layers=2, d_model=256,
                                     ssm_head_dim=64, ssm_state=128,
                                     dtype="bfloat16")
        want = {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 2,
                "rglru_scan": 0}
    else:
        cfg = get_arch(arch).reduced(n_layers=3, d_model=256, n_heads=10,
                                     n_kv_heads=1, head_dim=256,
                                     lru_width=256, dtype="bfloat16")
        want = {"flash_attention": 1, "decode_attention": 4, "ssd_scan": 0,
                "rglru_scan": 2}
    params = T.init_params(cfg, _gen(card, 3), device=card)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=_gen(card, 4),
                         device=card)
    steps = torch.randint(0, cfg.vocab_size, (4, 2), generator=_gen(card, 5),
                          device=card)

    def run():
        lg, cache = T.forward(cfg, params, {"tokens": toks}, mode="prefill",
                              max_len=64)
        out = [lg]
        for s in steps:
            lg, cache = T.decode_step(cfg, params, {"tokens": s}, cache)
            out.append(lg)
        return torch.stack(out)

    ops.reset_launch_counts()
    with_kernels = run()
    counts = ops.launch_counts()
    assert counts == dict(want, lora_merge=0)
    with ops.plain_versions():
        plain = run()
    assert ops.launch_counts() == counts
    assert (with_kernels - plain).abs().max().item() <= 5e-2


# ---------------------------------------------------------------------------
# the captured decode step and the recovery path on the card
# ---------------------------------------------------------------------------

def _small(arch, dtype="bfloat16"):
    """Kernel-sized heads at reduced depth (the model test's configs)."""
    if arch == "qwen3-1.7b":
        return get_arch(arch).reduced(n_layers=4, d_model=256, n_heads=4,
                                      n_kv_heads=2, head_dim=64, dtype=dtype)
    if arch == "mamba2-780m":
        return get_arch(arch).reduced(n_layers=4, d_model=256,
                                      ssm_head_dim=64, ssm_state=128,
                                      dtype=dtype)
    return get_arch(arch).reduced(n_layers=6, d_model=256, n_heads=10,
                                  n_kv_heads=1, head_dim=256, lru_width=256,
                                  attn_window=32, dtype=dtype)


def _serve(card, cfg, params, prompts, *, eager=False, adapter_params=None,
           n_new=12):
    from repro_torch.serving import engine as S
    srv = S.ServingEngine(cfg, params, n_slots=4, max_len=128,
                          adapter_params=adapter_params)
    srv.batcher.sampler = S.quantized_greedy
    if eager:     # the step uncaptured: what the graph must reproduce
        srv.batcher._decode = srv.batcher._decode_sample
    reqs = [S.ServeRequest(i, p, max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    return srv, reqs


def _prompts(cfg, n=4, seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=int(L))
            for L in rng.integers(20, 60, size=n)]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-780m",
                                  "recurrentgemma-2b"])
def test_captured_decode_matches_eager(card, arch):
    """Every step after the first replays one captured graph; the streams
    and the final cache equal the eager step's (the ring of 32 wraps under
    recurrentgemma's longer prompts)."""
    cfg = _small(arch)
    params = T.init_params(cfg, _gen(card, 3), device=card)
    prompts = _prompts(cfg)
    cap, creqs = _serve(card, cfg, params, prompts)
    cap.run()
    eag, ereqs = _serve(card, cfg, params, prompts, eager=True)
    eag.run()
    assert [r.generated for r in creqs] == [r.generated for r in ereqs]
    assert cap.batcher.compile_stats()["decode_compiles"] == 1
    assert eag.batcher.compile_stats()["decode_compiles"] == 0
    for kind in ("attn", "ssm", "rec"):
        for leaf, t in cap.batcher.cache.get(kind, {}).items():
            assert torch.equal(t, eag.batcher.cache[kind][leaf]), (kind, leaf)


def test_replays_count_their_launches(card):
    """A replay adds the captured kernels' launches; the capture itself
    counts none."""
    cfg = _small("qwen3-1.7b")
    params = T.init_params(cfg, _gen(card, 3), device=card)
    srv, reqs = _serve(card, cfg, params, _prompts(cfg, n=2))
    srv.step()                          # admission + eager step + capture
    ops.reset_launch_counts()
    srv.step()
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == cfg.n_layers
    srv.step()
    assert ops.launch_counts()["decode_attention"] == 2 * cfg.n_layers
    assert srv.batcher.compile_stats()["decode_compiles"] == 1


def test_decode_compiles_stays_one_through_recovery(card):
    """Two adapter switches, an import, a batched import, a reconstruct and
    a re-lay after the capture: still one graph, and the streams equal an
    eager run's (in float32: a rebuild recomputes the lost layers in
    another sum order than the decode steps that wrote them)."""
    import numpy as np
    from repro_torch.core.kv_reconstruct import _kind_indices
    from repro_torch.lora.adapters import init_lora, merge_lora, \
        randomize_lora
    cfg = _small("qwen3-1.7b", dtype="float32")
    params = T.init_params(cfg, _gen(card, 3), device=card)
    g = _gen(card, 9)
    merged = {f"l{i}": merge_lora(params, randomize_lora(
        g, init_lora(g, cfg, rank=16, name=f"l{i}", device=card)))
        for i in range(2)}
    prompts = _prompts(cfg, n=3, seed=1)
    ref, rreqs = _serve(card, cfg, params, prompts, eager=True)
    ref.run()
    srv, _ = _serve(card, cfg, params, [], adapter_params=merged)
    srv.batcher.warm_decode()
    assert srv.batcher.compile_stats()["decode_compiles"] == 1
    srv._switch_adapter("l0")
    srv._switch_adapter("l1")
    srv._switch_adapter(None)
    a, areqs = _serve(card, cfg, params, prompts)
    for _ in range(4):
        a.step()
    drained = a.drain_inflight()
    assert srv.admit_with_state(drained[0])
    assert len(srv.admit_with_state_batch(drained[1:])) == 2
    srv.step()
    lost = [False, True, True, False]
    for gi, (kind, ki, ai) in enumerate(_kind_indices(cfg)):
        if lost[gi]:
            for t in srv.batcher.cache[kind].values():
                t[ai].zero_()
    has = [not x for x in lost]
    assert srv.reconstruct_inflight(has)["reconstructed_reqs"] == 3
    srv.step()
    assert srv.relay_inflight(has)["relayed_reqs"] == 3
    srv.run()
    assert [r.generated for r in areqs] == [r.generated for r in rreqs]
    assert srv.batcher.compile_stats()["decode_compiles"] == 1
    assert srv.hotpath_stats()["n_prefill_tokens"] == 0
    assert np.all([r.done for r in areqs])


def test_windowed_q_only_on_flash_matches_ring(card):
    """The windowed Q-only recompute runs the flash kernel with the window
    over the cache's first S rows; its plain version is the ring form."""
    from repro_torch.core import kv_reconstruct as R
    cfg = _small("recurrentgemma-2b", dtype="float32")
    g = _gen(card, 11)
    S, cap, hd = 24, 32, cfg.resolved_head_dim
    q = torch.randn((2, S, cfg.n_heads, hd), generator=g, device=card)
    kc = torch.randn((2, cap, cfg.n_kv_heads, hd), generator=g, device=card)
    vc = torch.randn(kc.shape, generator=g, device=card)
    ring = R._windowed_ring_attention(cfg, q, kc, vc, S)
    ops.reset_launch_counts()
    flash = ops.flash_attention(q, kc[:, :S], vc[:, :S], causal=True,
                                window=cfg.attn_window)
    assert ops.launch_counts()["flash_attention"] == 1
    assert (flash - ring).abs().max().item() <= TOL[torch.float32]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-780m",
                                  "recurrentgemma-2b"])
def test_rebuild_on_the_card_matches_fresh_prefill(card, arch):
    """``reconstruct_cache`` through the kernels (flash on the surviving
    cache's strides, the scans) against a fresh prefill, in float32."""
    from repro_torch.core import kv_reconstruct as R
    cfg = _small(arch, dtype="float32")
    params = T.init_params(cfg, _gen(card, 3), device=card)
    toks = torch.randint(0, cfg.vocab_size, (2, 28), generator=_gen(card, 4),
                         device=card)
    _, fresh = T.forward(cfg, params, {"tokens": toks}, mode="prefill",
                         max_len=64)
    damaged = {k: ({l: t.clone() for l, t in v.items()}
                   if isinstance(v, dict) else v.clone())
               for k, v in fresh.items()}
    has = [True, False, True, False] + [True] * (cfg.n_layers - 4)
    for gi, (kind, ki, ai) in enumerate(R._kind_indices(cfg)):
        if not has[gi]:
            for t in damaged[kind].values():
                t[ai if kind == "attn" else ki].zero_()
    ops.reset_launch_counts()
    R.reconstruct_cache(cfg, params, {"tokens": toks}, damaged, has,
                        max_len=64)
    counts = ops.launch_counts()
    assert counts["flash_attention"] + counts["ssd_scan"] \
        + counts["rglru_scan"] > 0
    for kind in ("attn", "ssm", "rec"):
        for leaf, t in fresh.get(kind, {}).items():
            assert (damaged[kind][leaf] - t).abs().max().item() <= 2e-3


def test_unembed_bf16_product_writes_float32(card):
    """The card's logit product: bf16 operands, float32 output, against the
    upcast product (sum order only)."""
    cfg = _small("qwen3-1.7b")
    params = T.init_params(cfg, _gen(card, 3), device=card)
    x = torch.randn((3, 1, cfg.d_model), generator=_gen(card, 5),
                    device=card).to(torch.bfloat16)
    got = T.unembed(cfg, params, x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    want = x.float() @ head.float()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item()
