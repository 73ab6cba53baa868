"""The RG-LRU scan kernel's decomposition, emulated on the CPU, against the
JAX package.

The kernel (``src/repro_torch/kernels/csrc/rglru_scan.cu``) splits time
across a thread-block cluster: windows of time, each cut into one chunk per
cluster rank and one segment per warp of a rank; each segment runs from
zero to its decay product and end state, the carries fold across the
ranks (through distributed shared memory) and the warps, and each segment
runs again from its carry.  ``rglru_scan_chunked`` runs the same
decomposition in PyTorch.  Inputs are made with numpy from a seed, as
``tests/test_torch_rglru.py`` makes them (log_a = -softplus(normal), bx and
h0 standard normal); outputs are held against the reference's Pallas
kernel (interpret mode, as ``tests/test_torch_rglru.py`` runs it) and the
reference model's associative scan within 1e-5 of the reference's largest
magnitude (float32 rounding of the products and sums only).

The cases sit at the decomposition's edges: one step, fewer steps than
ranks, one step a rank, one step a segment, one window, one window and a
step, several windows; at the kernel's geometry (8 ranks, 4 warps, up to
16 steps a segment: windows of up to 512 steps) and at a small one (2
ranks, 2 warps, up to 3 steps: windows of 12).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import rglru as jrg
from repro_torch.convert import to_numpy
from repro_torch.kernels import rglru_scan as trg

KERNEL_TOL = 1e-5
KERNEL = dict(cluster=trg.CLUSTER, warps=trg.WARPS, steps=trg.STEPS)
SMALL = dict(cluster=2, warps=2, steps=3)
WINDOW = trg.CLUSTER * trg.WARPS * trg.STEPS          # 512
SMALL_WINDOW = 2 * 2 * 3                              # 12

# (B, S, W): W = 40 is not a multiple of the kernel's 32 channels
KERNEL_CASES = [
    (1, 1, 40),                        # one step
    (2, trg.CLUSTER - 3, 40),          # fewer steps than ranks
    (2, trg.CLUSTER, 40),              # one step a rank (on rank 0's warps)
    (1, trg.CLUSTER * trg.WARPS, 33),  # one step a segment
    (2, WINDOW, 40),                   # one full window
    (2, WINDOW + 1, 40),               # a window and one step
    (3, 300, 40),                      # ragged windows, B > 1
    (1, 2 * WINDOW + 77, 40),          # several windows
]
SMALL_CASES = [
    (2, 1, 40), (2, 3, 40), (2, 4, 40), (2, SMALL_WINDOW, 40),
    (2, SMALL_WINDOW + 1, 40), (3, 5 * SMALL_WINDOW + 7, 33),
]


def _scan_inputs(seed, B, S, W):
    """log_a = -softplus(N(0, 1)) <= 0, as the reference's sweep draws it;
    bx and h0 standard normal."""
    rng = np.random.default_rng(seed)
    f = np.float32
    la = (-np.logaddexp(0.0, rng.standard_normal((B, S, W)))).astype(f)
    bx = rng.standard_normal((B, S, W)).astype(f)
    h0 = rng.standard_normal((B, W)).astype(f)
    return la, bx, h0


def _close_scaled(a, b, tol=KERNEL_TOL):
    b = np.asarray(b, np.float32)
    np.testing.assert_allclose(np.asarray(to_numpy(a), np.float32), b,
                               atol=tol * float(np.abs(b).max()), rtol=0.0)


def _check(B, S, W, with_h0, geometry, seed):
    la, bx, h0 = _scan_inputs(seed, B, S, W)
    h0 = h0 if with_h0 else None
    yt, ht = trg.rglru_scan_chunked(
        torch.from_numpy(la), torch.from_numpy(bx),
        None if h0 is None else torch.from_numpy(h0), **geometry)
    assert yt.shape == (B, S, W) and ht.shape == (B, W)
    assert yt.dtype == ht.dtype == torch.float32
    assert torch.equal(yt[:, -1], ht)
    j_in = (jnp.asarray(la), jnp.asarray(bx),
            None if h0 is None else jnp.asarray(h0))
    yp, hp = jops.rglru_scan(*j_in, block_t=128, block_w=128)
    ym, hm = jrg.rglru_scan(*j_in)
    for y, h in ((yp, hp), (ym, hm)):
        _close_scaled(yt, y)
        _close_scaled(ht, h)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,W", KERNEL_CASES)
def test_chunked_at_kernel_geometry_matches_pallas_and_scan(B, S, W,
                                                            with_h0):
    _check(B, S, W, with_h0, KERNEL, 40 + S)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,W", SMALL_CASES)
def test_chunked_over_many_windows_matches_pallas_and_scan(B, S, W,
                                                           with_h0):
    _check(B, S, W, with_h0, SMALL, 60 + S)


@pytest.mark.parametrize("geometry", [KERNEL, SMALL],
                         ids=["kernel", "small"])
def test_chunked_padding(geometry):
    """log_a = 0, bx = 0 steps (a = 1) appended as a new window: the state
    carries on within the tolerance and h_T stays the last y bit for
    bit."""
    S = SMALL_WINDOW if geometry is SMALL else WINDOW
    la, bx, h0 = (torch.from_numpy(a) for a in _scan_inputs(50, 2, S, 40))
    pad = torch.zeros((2, 5, 40))
    y, h = trg.rglru_scan_chunked(la, bx, h0, **geometry)
    yp, hp = trg.rglru_scan_chunked(torch.cat([la, pad], 1),
                                    torch.cat([bx, pad], 1), h0, **geometry)
    assert torch.equal(hp, yp[:, -1])
    _close_scaled(yp[:, :S], to_numpy(y))
    for i in range(5):
        _close_scaled(yp[:, S + i], to_numpy(h))


def test_geometry_is_the_kernels():
    """The emulation's defaults are the CUDA source's constants."""
    src = (Path(trg.__file__).parent / "csrc" / "rglru_scan.cu").read_text()
    found = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert found["kCluster"] == trg.CLUSTER
    assert found["kWarps"] == trg.WARPS
    assert found["kSegSteps"] == trg.STEPS
    assert found["kLanes"] == 32
