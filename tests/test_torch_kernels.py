"""Plain versions of the ported kernels against the JAX package's Pallas
kernels (interpret mode on the CPU) and its naive oracles.

The same inputs, made with numpy from a seed, go to both packages.  The
tolerance is the reference's own for float32 kernels (2e-5,
``tests/test_kernels.py``); a bfloat16 LoRA merge may differ by one bf16
ulp of the result, where a float32 sum taken in another order rounds the
other way.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import lora_merge as tlm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = 2e-5


def _rnd(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("splits", [None, 1, 3, "kernel"])
@pytest.mark.parametrize("B,C,Hq,Hkv,d,block_k,fold,masked", [
    (3, 256, 8, 8, 32, 128, False, False),   # MHA, lens 0 and C-1
    (3, 300, 8, 2, 32, 128, False, False),   # GQA, C not a block multiple
    (2, 130, 4, 1, 64, 64, True, False),     # MQA + new-token fold
    (3, 96, 4, 2, 16, 32, False, True),      # ring slot mask
    (3, 100, 4, 2, 16, 32, True, True),      # slot mask + fold, ragged C
    (2, 96, 10, 1, 256, 32, True, True),     # recurrentgemma: G 10, hd 256
    (3, 200, 10, 1, 256, 64, False, False),  # G 10, hd 256, ragged C
])
def test_decode_attention_plain_matches_pallas(B, C, Hq, Hkv, d, block_k,
                                               fold, masked, splits):
    """``splits``: None for the plain version's own blocking; otherwise
    the kernel's split of the cache (``"kernel"``: the count
    ``decode_splits`` picks for this shape), merged in the kernel's order."""
    rng = np.random.default_rng(11)
    q = _rnd(rng, (B, 1, Hq, d))
    k = _rnd(rng, (B, C, Hkv, d))
    v = _rnd(rng, (B, C, Hkv, d))
    kn = _rnd(rng, (B, 1, Hkv, d))
    vn = _rnd(rng, (B, 1, Hkv, d))
    lens = rng.integers(1, C - 1, size=B).astype(np.int32)
    lens[0] = 0
    lens[-1] = C - 1
    sm = rng.random((B, C)) > 0.3 if masked else None
    kw_j = dict(k_new=jnp.asarray(kn), v_new=jnp.asarray(vn)) if fold else {}
    o_j = jops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        slot_mask=None if sm is None else jnp.asarray(sm),
        block_k=block_k, interpret=True, **kw_j)
    kw_t = dict(k_new=torch.from_numpy(kn), v_new=torch.from_numpy(vn)) \
        if fold else {}
    sm_t = None if sm is None else torch.from_numpy(sm)
    if splits is None:
        o_t = tops.decode_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(lens), slot_mask=sm_t, **kw_t)
    else:
        n = tdec.decode_splits(B, Hkv, C, d) if splits == "kernel" \
            else splits
        kw_t = {name: t.transpose(1, 2) for name, t in kw_t.items()}
        o_t = tdec.decode_attention_plain(
            torch.from_numpy(q[:, 0]), torch.from_numpy(k).transpose(1, 2),
            torch.from_numpy(v).transpose(1, 2), torch.from_numpy(lens),
            slot_mask=sm_t, splits=n, **kw_t)[:, None]
    assert o_t.shape == (B, 1, Hq, d)
    _close(o_t, o_j)
    # the naive oracles agree too: with the fold, the new token is the
    # cache written at position lens, attended over lens + 1 entries
    kt, vt, lens_r, sm_r = k, v, lens, sm
    if fold:
        kt = np.concatenate([k, np.zeros_like(kn)], axis=1)
        vt = np.concatenate([v, np.zeros_like(vn)], axis=1)
        sm_r = None if sm is None else np.concatenate(
            [sm, np.zeros((B, 1), bool)], axis=1)
        for b in range(B):
            kt[b, lens[b]] = kn[b, 0]
            vt[b, lens[b]] = vn[b, 0]
            if sm_r is not None:
                sm_r[b, lens[b]] = True
        lens_r = lens + 1
    r_j = jref.decode_attention_ref(
        jnp.asarray(q[:, 0]), jnp.moveaxis(jnp.asarray(kt), 1, 2),
        jnp.moveaxis(jnp.asarray(vt), 1, 2), jnp.asarray(lens_r),
        slot_mask=None if sm_r is None else jnp.asarray(sm_r))
    r_t = tref.decode_attention_ref(
        torch.from_numpy(q[:, 0]), torch.from_numpy(kt).transpose(1, 2),
        torch.from_numpy(vt).transpose(1, 2), torch.from_numpy(lens_r),
        slot_mask=None if sm_r is None else torch.from_numpy(sm_r))
    _close(r_t, r_j)
    _close(o_t[:, 0], r_t)


@pytest.mark.parametrize("B,Hkv,C,d", [
    (4, 32, 1024, 64), (4, 8, 1024, 128), (4, 1, 1024, 256),   # serving
    (1, 1, 1, 64), (2, 1, 77, 64), (4, 8, 1000, 128), (3, 2, 4099, 256),
    (1, 1, 65536, 128), (64, 8, 1024, 64),
])
def test_decode_splits_partition_the_cache(B, Hkv, C, d):
    """Every cache row lies in exactly one split, no split is empty, and at
    the serving shapes (opt-1.3b, qwen3-1.7b, recurrentgemma-2b decode at
    4 slots of 1024) the splits give at least one CTA per SM."""
    n = tdec.decode_splits(B, Hkv, C, d)
    assert 1 <= n <= tdec.MAX_SPLITS
    ranges = tdec.split_ranges(C, n)
    assert ranges[0][0] == 0 and ranges[-1][1] == C
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(n - 1))
    if C == 1024 and B == 4:
        assert n * B * Hkv >= tdec.SMS


def test_decode_attention_split_emulation_merges_empty_splits():
    """Splits past a row's valid length (l = 0) are skipped in the merge:
    rows at lens 0 give zeros, or the new token alone where it is folded
    in; every split count agrees with the unsplit plain version."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(_rnd(rng, (3, 4, 16)))
    k = torch.from_numpy(_rnd(rng, (3, 2, 50, 16)))
    v = torch.from_numpy(_rnd(rng, (3, 2, 50, 16)))
    kn = torch.from_numpy(_rnd(rng, (3, 2, 1, 16)))
    vn = torch.from_numpy(_rnd(rng, (3, 2, 1, 16)))
    lens = torch.tensor([0, 1, 49], dtype=torch.int32)
    for fold in (False, True):
        kw = dict(k_new=kn, v_new=vn) if fold else {}
        ref = tdec.decode_attention_plain(q, k, v, lens, **kw)
        for n in (1, 2, 7, 50):
            out = tdec.decode_attention_plain(q, k, v, lens, splits=n, **kw)
            _close(out, ref)
        if fold:
            assert torch.equal(out[0], vn[0, :, 0].repeat_interleave(2, 0))
        else:
            assert torch.all(out[0] == 0)


def test_decode_attention_empty_rows_are_zero():
    """A row with no valid key and no new token gives zeros (the
    reference's l == 0 guard), not NaN."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_rnd(rng, (2, 4, 16)))
    k = torch.from_numpy(_rnd(rng, (2, 2, 40, 16)))
    out = tdec.decode_attention(q, k, k.clone(),
                                torch.tensor([0, 40], dtype=torch.int32))
    assert torch.all(out[0] == 0) and torch.isfinite(out).all()
    assert tdec.launches == 0            # CPU tensors never launch


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,d,causal,window,q_offset", [
    (1, 128, 128, 4, 4, 32, True, 0, 0),      # MHA causal
    (2, 100, 100, 8, 2, 32, True, 0, 0),      # GQA, ragged edges
    (2, 130, 130, 4, 2, 16, True, 48, 0),     # sliding window
    (1, 40, 104, 4, 1, 32, True, 0, 64),      # continued prefill (q_offset)
    (2, 33, 70, 2, 2, 16, False, 0, 0),       # non-causal cross lengths
    (1, 150, 150, 10, 1, 256, True, 0, 0),    # recurrentgemma: G 10, hd 256
    (1, 150, 150, 10, 1, 256, True, 40, 0),   # hd 256, window < Sk
])
def test_flash_attention_plain_matches_pallas(B, Sq, Sk, Hq, Hkv, d, causal,
                                              window, q_offset):
    rng = np.random.default_rng(5)
    q = _rnd(rng, (B, Sq, Hq, d))
    k = _rnd(rng, (B, Sk, Hkv, d))
    v = _rnd(rng, (B, Sk, Hkv, d))
    o_j = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, window=window,
                               q_offset=q_offset, block_q=64, block_k=64,
                               interpret=True)
    o_t = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               window=window, q_offset=q_offset)
    assert o_t.shape == (B, Sq, Hq, d)
    _close(o_t, o_j)
    r_j = jref.flash_attention_ref(
        jnp.moveaxis(jnp.asarray(q), 1, 2), jnp.moveaxis(jnp.asarray(k), 1, 2),
        jnp.moveaxis(jnp.asarray(v), 1, 2), causal=causal, window=window,
        q_offset=q_offset)
    r_t = tref.flash_attention_ref(
        torch.from_numpy(q).transpose(1, 2), torch.from_numpy(k).transpose(1, 2),
        torch.from_numpy(v).transpose(1, 2), causal=causal, window=window,
        q_offset=q_offset)
    _close(r_t, r_j)
    _close(o_t.transpose(1, 2), r_t)


@pytest.mark.parametrize("block_q,block_k", [(16, 16), (32, 64), (128, 32)])
def test_flash_attention_plain_block_sizes(block_q, block_k):
    """The skipped (fully masked) key blocks change nothing, whatever the
    tiling: every blocking gives the oracle's answer."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(_rnd(rng, (1, 4, 90, 16)))
    k = torch.from_numpy(_rnd(rng, (1, 2, 90, 16)))
    v = torch.from_numpy(_rnd(rng, (1, 2, 90, 16)))
    for window in (0, 20):
        o = tfa.flash_attention_plain(q, k, v, causal=True, window=window,
                                      block_q=block_q, block_k=block_k)
        _close(o, tref.flash_attention_ref(q, k, v, causal=True,
                                           window=window))


def test_visible_keys():
    assert tfa.visible_keys(100, 10, 20, causal=True, window=0) == (0, 20)
    assert tfa.visible_keys(100, 10, 20, causal=True, window=4) == (7, 20)
    assert tfa.visible_keys(100, 0, 8, causal=False, window=0) == (0, 100)


# ---------------------------------------------------------------------------
# LoRA merge
# ---------------------------------------------------------------------------

def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(np.float32(1.0), e - 8)


@pytest.mark.parametrize("L,Din,Dout,r,dtype", [
    (2, 64, 96, 4, "float32"),
    (3, 300, 200, 8, "float32"),      # ragged tiles of the Pallas kernel
    (2, 300, 200, 16, "bfloat16"),    # bf16 W, f32 A/B (init_lora default)
])
def test_lora_merge_plain_matches_pallas(L, Din, Dout, r, dtype):
    rng = np.random.default_rng(2)
    W = _rnd(rng, (L, Din, Dout), 0.05)
    A = _rnd(rng, (L, Din, r), Din ** -0.5)
    B = _rnd(rng, (L, r, Dout), 0.02)
    scale = 2.0
    Wj = jnp.asarray(W, jnp.dtype(dtype))
    o_j = np.asarray(jops.lora_merge(Wj, jnp.asarray(A), jnp.asarray(B),
                                     scale, block_i=128, block_j=128,
                                     interpret=True), np.float32)
    r_j = np.asarray(jref.lora_merge_ref(Wj, jnp.asarray(A), jnp.asarray(B),
                                         scale), np.float32)
    Wt = torch.from_numpy(np.array(Wj, np.float32)).to(getattr(torch,
                                                                 dtype))
    o_t = tops.lora_merge(Wt, torch.from_numpy(A), torch.from_numpy(B),
                          scale)
    assert o_t.dtype == Wt.dtype and o_t.shape == Wt.shape
    o_t = o_t.float().numpy()
    r_t = tref.lora_merge_ref(Wt, torch.from_numpy(A), torch.from_numpy(B),
                              scale).float().numpy()
    if dtype == "float32":
        for a, b in ((o_t, o_j), (r_t, r_j), (o_t, r_t)):
            _close(a, b)
    else:
        for a, b in ((o_t, o_j), (r_t, r_j), (o_t, r_t)):
            assert np.all(np.abs(a - b) <= _bf16_ulp(b))


def test_lora_merge_unmerge_round_trip():
    rng = np.random.default_rng(4)
    W = torch.from_numpy(_rnd(rng, (2, 48, 40), 0.05))
    A = torch.from_numpy(_rnd(rng, (2, 48, 4), 48 ** -0.5))
    B = torch.from_numpy(_rnd(rng, (2, 4, 40), 0.02))
    merged = tlm.lora_merge(W, A, B, 2.0)
    assert not torch.allclose(merged, W)
    _close(tlm.lora_merge(merged, A, B, -2.0), W)
    assert tlm.launches == 0
