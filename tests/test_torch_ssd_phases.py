"""The SSD scan kernel's three phases, emulated on the CPU, against the JAX
package.

The kernel (``src/repro_torch/kernels/csrc/ssd_scan.cu``) runs the chunked
decomposition parallel over the chunks: (1) each chunk's state
contribution from a zero state, (2) a pass over the chunks that turns the
contributions into the state entering each chunk, (3) each chunk's
outputs from its entering state.  ``ssd_scan_plain(..., phases=True)``
runs the same three phases in PyTorch.  Inputs are made with numpy from a
seed (float32, x and B/C standard normal, dt = softplus(normal), A =
-exp(0.3 normal)); outputs are held against the reference's Pallas kernel
(interpret mode, as ``tests/test_torch_ssm.py`` runs it) and its
sequential oracle ``ref.ssd_scan_ref`` within 2e-5 of the reference's
largest magnitude (sum order only).

A scan from a given state h0 is checked without a state argument on the
reference's side: h0 is the reference's final state after a prefix, and
the scan from h0 must give the reference's outputs and final state over
the prefix and the sequence together.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import to_numpy
from repro_torch.kernels import ssd_scan as tssd

KERNEL_TOL = 2e-5
H, P, N = 3, 32, 16
CHUNK = tssd.CHUNK
PREFIX = 37                 # rows of the prefix that makes h0

# (B, S): one row, a chunk, a chunk and one row, ragged, B > 1
CASES = [(1, 1), (1, CHUNK), (1, CHUNK + 1), (1, 2 * CHUNK + 9),
         (2, 1), (2, CHUNK), (3, CHUNK + 1), (2, 150)]


def _inputs(seed, B, S):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((B, S, H, P)).astype(f)
    dt = np.logaddexp(0.0, rng.standard_normal((B, S, H))).astype(f)
    A = (-np.exp(np.random.default_rng(0).standard_normal((H,)) * 0.3)
         ).astype(f)
    Bm = rng.standard_normal((B, S, N)).astype(f)
    Cm = rng.standard_normal((B, S, N)).astype(f)
    return x, dt, A, Bm, Cm


def _cat(a, b):
    """Two input tuples joined along time (A is shared)."""
    return tuple(u if i == 2 else np.concatenate([u, v], axis=1)
                 for i, (u, v) in enumerate(zip(a, b)))


def _close_scaled(a, b, tol=KERNEL_TOL):
    b = np.asarray(b, np.float32)
    np.testing.assert_allclose(np.asarray(to_numpy(a), np.float32), b,
                               atol=tol * float(np.abs(b).max()), rtol=0.0)


def _references(inputs):
    """(y, final state) of the Pallas kernel and of the oracle."""
    arrays = [jnp.asarray(a) for a in inputs]
    return jops.ssd_scan(*arrays, chunk=CHUNK), jref.ssd_scan_ref(*arrays)


def _phases(inputs, h0=None):
    t = [torch.from_numpy(a) for a in inputs]
    return tssd.ssd_scan_plain(*t, None if h0 is None
                               else torch.from_numpy(np.array(h0)),
                               phases=True)


@pytest.mark.parametrize("B,S", CASES)
def test_ssd_phases_from_zeros_match_pallas_and_oracle(B, S):
    inputs = _inputs(30 + S, B, S)
    y, st = _phases(inputs)
    assert y.shape == (B, S, H, P) and st.shape == (B, H, P, N)
    assert st.dtype == torch.float32
    for yj, sj in _references(inputs):
        _close_scaled(y, yj)
        _close_scaled(st, sj)


@pytest.mark.parametrize("B,S", CASES)
def test_ssd_phases_from_h0_match_pallas_and_oracle(B, S):
    """h0 = the reference's state after a 37-row prefix; the scan from h0
    must continue the reference's scan of prefix + sequence."""
    pre, main = _inputs(40 + S, B, PREFIX), _inputs(50 + S, B, S)
    _, h0 = jref.ssd_scan_ref(*[jnp.asarray(a) for a in pre])
    y, st = _phases(main, h0)
    for yj, sj in _references(_cat(pre, main)):
        _close_scaled(y, np.asarray(yj)[:, PREFIX:])
        _close_scaled(st, sj)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,S", [(1, 3 * CHUNK), (2, 2 * CHUNK + 30)])
def test_ssd_entering_states_equal_oracle_at_chunk_boundaries(B, S,
                                                              with_state):
    """Phases 1 and 2 alone: the state entering chunk c is the sequential
    oracle's state after c chunks (after the prefix and c chunks, from
    h0)."""
    pre, main = _inputs(60, B, PREFIX), _inputs(61, B, S)
    h0 = None
    if with_state:
        _, h0 = jref.ssd_scan_ref(*[jnp.asarray(a) for a in pre])
        h0 = torch.from_numpy(np.array(h0))
    x, dt, A, Bm, _ = [torch.from_numpy(a) for a in main]
    s, decay = tssd.ssd_chunk_states(x, dt, A, Bm)
    entering, final = tssd.ssd_state_pass(s, decay, h0)
    nc = -(-S // CHUNK)
    assert entering.shape == (B, nc, H, P, N)
    assert torch.equal(entering[:, 0], torch.zeros_like(entering[:, 0])
                       if h0 is None else h0)
    for c in range(1, nc + 1):
        cut = tuple(a if i == 2 else a[:, :c * CHUNK]
                    for i, a in enumerate(main))
        seq = _cat(pre, cut) if with_state else cut
        _, want = jref.ssd_scan_ref(*[jnp.asarray(a) for a in seq])
        _close_scaled(entering[:, c] if c < nc else final, want)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_phases_match_chunk_loop_at_zero_length(with_state):
    """S = 0: no chunk, y is empty and the final state is h0 (or zeros),
    as the kernel's lone state pass writes it."""
    x, dt, A, Bm, Cm = [torch.from_numpy(a) for a in _inputs(70, 2, 0)]
    h0 = torch.randn((2, H, P, N),
                     generator=torch.Generator().manual_seed(1)) \
        if with_state else None
    y, st = tssd.ssd_scan_plain(x, dt, A, Bm, Cm, h0, phases=True)
    y0, s0 = tssd.ssd_scan_plain(x, dt, A, Bm, Cm, h0)
    assert y.shape == y0.shape == (2, 0, H, P)
    assert torch.equal(st, s0)
    assert torch.equal(st, h0 if with_state else torch.zeros_like(st))
