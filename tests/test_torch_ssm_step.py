"""The Mamba-2 decode step's state update (``kernels/ssm_step.py``,
``ops.ssm_step``), on the CPU.

Checked here: the plain version equals, bit for bit in bf16 and float32,
the composition ``models/mamba2.py``'s ``mixer_step`` ran before it (a new
state made, then copied over the old one), and so does the op on CPU
tensors, which launches nothing; both update the state in place (the same
storage); the op hands its calls to a tracer and runs the plain version on
DTensors; ``mixer_step`` returns the state it was given, updated;
``cost()`` counts the state read once and written once; the wrapper's
checks refuse what the kernel does not take and take the views
``mixer_step`` passes.  The kernel itself runs on the card
(``tests/test_torch_cuda.py``).
"""
import collections

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.base import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_step as ss
from repro_torch.models import mamba2
from repro_torch.models import transformer as T

DTYPES = [torch.bfloat16, torch.float32]
# (B, H, P, N): granite-4.0-h-small's and mamba2-780m's heads at a few
# rows, then N past 128 (two vectors a lane) and ragged P and H
SHAPES = [(3, 128, 64, 128), (2, 48, 64, 128), (2, 4, 16, 16),
          (3, 5, 7, 256), (1, 3, 33, 132)]


def _inputs(B, H, P, N, dtype, seed=0):
    """(state, x, dt, dt_bias, A_log, Bm, Cm, D_skip) with x, Bm and Cm
    views of one conv output and dt a view of one projection, as
    ``mixer_step`` makes them."""
    g = torch.Generator().manual_seed(seed)
    di = H * P
    conv_out = F.silu(torch.randn((B, di + 2 * N), generator=g)).to(dtype)
    proj = torch.randn((B, 2 * di + 2 * N + H), generator=g).to(dtype)
    state = torch.randn((B, H, P, N), generator=g)
    dt_bias = torch.randn((H,), generator=g) * 0.5
    A_log = torch.log(torch.linspace(1.0, 16.0, H))
    D_skip = torch.randn((H,), generator=g)
    return (state, conv_out[:, :di].reshape(B, H, P), proj[:, -H:], dt_bias,
            A_log, conv_out[:, di:di + N], conv_out[:, di + N:], D_skip)


def _composition(state, x, dt, dt_bias, A_log, Bm, Cm, D_skip):
    """``mixer_step``'s lines before ``ops.ssm_step``: (y, new state)."""
    B = Bm.float()
    C = Cm.float()
    dt = F.softplus(dt.float() + dt_bias)
    A = -torch.exp(A_log)
    dA = torch.exp(dt * A)
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt, B, x.float())
    new_state = state * dA[..., None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", C, new_state).to(x.dtype)
    y = y + D_skip.to(y.dtype)[:, None] * x
    return y, new_state


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,P,N", SHAPES)
def test_plain_and_op_are_the_composition_in_place(dtype, B, H, P, N):
    """Two chained steps through the plain version, the op and the op
    under ``plain_versions()``: y and the state bit for bit, the state
    written where it was."""
    args = _inputs(B, H, P, N, dtype)
    want_state = args[0].clone()
    runs = {"plain": ss.ssm_step_plain, "op": ops.ssm_step}
    states = {name: args[0].clone() for name in (*runs, "op, plain")}
    ptrs = {name: st.data_ptr() for name, st in states.items()}
    ops.reset_launch_counts()
    for step in range(2):
        x = args[1] if step == 0 else args[1].flip(0)   # another token
        rest = (x, *args[2:])
        want_y, want_state = _composition(want_state, *rest)
        for name, st in states.items():
            if name == "op, plain":
                with ops.plain_versions():
                    y = ops.ssm_step(st, *rest)
            else:
                y = runs[name](st, *rest)
            assert y.dtype == dtype and torch.equal(y, want_y), name
            assert torch.equal(st, want_state), name
            assert st.data_ptr() == ptrs[name]
    assert ops.launch_counts()["ssm_step"] == 0


def test_op_is_traced_and_takes_dtensors_plain():
    """Under ``traced`` the op is handed over as ``ssm_step`` with its
    operands; on DTensors it runs the plain version."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.launch.dryrun import fake_mesh
    from repro_torch.launch.mesh import Mesh
    args = _inputs(2, 4, 8, 16, torch.float32)
    seen = []

    def tracer(name, a, kw):
        seen.append((name, len(a), kw))
        return "traced"
    with ops.traced(tracer):
        assert ops.ssm_step(*args) == "traced"
    assert seen == [("ssm_step", 8, {})]

    want_state = args[0].clone()
    want_y, want_state = _composition(want_state, *args[1:])
    mesh = Mesh(("data",), (2,), (torch.device("cpu"),) * 2)
    with fake_mesh(mesh) as dmesh:
        dargs = [distribute_tensor(t.contiguous(), dmesh, [Replicate()],
                                   src_data_rank=None) for t in args]
        ops.reset_launch_counts()
        y = ops.ssm_step(*dargs)
        assert type(y).__name__ == "DTensor"
        assert torch.equal(y.to_local(), want_y)
        assert torch.equal(dargs[0].to_local(), want_state)
        assert ops.launch_counts()["ssm_step"] == 0


def test_mixer_step_updates_the_state_in_place():
    """``mixer_step`` returns the state tensor it was given, updated; one
    ``ssm_step`` call a step."""
    cfg = get_arch("mamba2-780m").reduced(n_layers=1)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    p = T.layer_params(params["blocks"]["ssm"], 0)
    g = torch.Generator().manual_seed(1)
    h = torch.randn((3, cfg.d_model), generator=g)
    conv = torch.randn((3, cfg.ssm_conv - 1,
                        cfg.d_inner + 2 * cfg.ssm_state), generator=g)
    state = torch.randn((3, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                        generator=g)
    before = state.clone()
    calls = collections.Counter()

    def tracer(name, a, kw):
        calls[name] += 1
        with ops.traced(None):
            return getattr(ops, name)(*a, **kw)
    with ops.traced(tracer):
        _, (conv_new, st) = mamba2.mixer_step(cfg, p, h, conv, state)
    assert st is state and not torch.equal(state, before)
    assert conv_new is not conv and dict(calls) == {"ssm_step": 1}


def test_cost_counts_the_state_once():
    """granite-4.0-h-small's decode step at 128 slots: the float32 state
    read once and written once (1 GiB a layer), x, dt, B and C read once,
    y written once, the three per-head vectors read once."""
    B, H, P, N = 128, 128, 64, 128
    flops, nbytes, dtype = ss.cost(batch=B, heads=H, head_dim=P, state=N)
    state = B * H * P * N * 4
    assert nbytes == (2 * state + 2 * B * H * P * 2 + B * H * 2
                      + 2 * B * N * 2 + 3 * H * 4)
    assert 2 * state == 2 ** 30 and nbytes - 2 * state < 2 ** 23
    assert flops == 5 * B * H * P * N and dtype == "float32"
    f32 = ss.cost(batch=B, heads=H, head_dim=P, state=N, dtype="float32")[1]
    assert f32 - nbytes == 2 * B * H * P * 2 + B * H * 2 + 2 * B * N * 2


def _case(what):
    args = list(_inputs(2, 4, 8, 16, torch.bfloat16))
    state, x, dt, dt_bias, A_log, Bm, Cm, D_skip = range(8)
    if what == "float16":
        for i in (x, dt, Bm, Cm):
            args[i] = args[i].half()
    elif what == "mixed dtypes":
        args[dt] = args[dt].float()
    elif what == "x not 3-d":
        args[x] = args[x].reshape(2, 32)
    elif what == "dt shape":
        args[dt] = args[dt][:, :3]
    elif what == "Cm shape":
        args[Cm] = args[Cm][:, :12]
    elif what == "N not a multiple of 4":
        args[Bm], args[Cm] = args[Bm][:, :14], args[Cm][:, :14]
        args[state] = args[state][..., :14].contiguous()
    elif what == "N too wide":
        args[Bm] = torch.zeros((2, 260), dtype=torch.bfloat16)
        args[Cm] = args[Bm].clone()
        args[state] = torch.zeros((2, 4, 8, 260))
    elif what == "bf16 dt_bias":
        args[dt_bias] = args[dt_bias].to(torch.bfloat16)
    elif what == "A_log shape":
        args[A_log] = torch.zeros((5,))
    elif what == "strided D_skip":
        args[D_skip] = torch.zeros((8,))[::2]
    elif what == "bf16 state":
        args[state] = args[state].to(torch.bfloat16)
    elif what == "state shape":
        args[state] = torch.zeros((2, 4, 16, 8))
    elif what == "strided state":
        args[state] = torch.zeros((2, 4, 8, 32))[..., :16]
    elif what == "misaligned state":
        args[state] = torch.zeros((2 * 4 * 8 * 16 + 1,))[1:].view(2, 4, 8,
                                                                  16)
    return args


@pytest.mark.parametrize("what", [
    "float16", "mixed dtypes", "x not 3-d", "dt shape", "Cm shape",
    "N not a multiple of 4", "N too wide", "bf16 dt_bias", "A_log shape",
    "strided D_skip", "bf16 state", "state shape", "strided state",
    "misaligned state"])
def test_ssm_step_kernel_refuses(what):
    with pytest.raises(ValueError, match="ssm_step kernel"):
        ss.check_args(*_case(what))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,P,N", SHAPES)
def test_ssm_step_kernel_takes_the_mixer_views(dtype, B, H, P, N):
    """x, Bm and Cm as views of one conv output, dt of one projection, the
    state a layer of a stacked cache: taken as they are."""
    args = list(_inputs(B, H, P, N, dtype))
    args[0] = torch.zeros((3, B, H, P, N))[1]
    ss.check_args(*args)
