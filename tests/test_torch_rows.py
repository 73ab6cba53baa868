"""Row folds of a sequence-split activation (``distributed/context.py``'s
``fold_rows``, ``unfold_rows`` and ``project``) over a 4-rank fake process
group on the CPU: one process, rank 0's shards, no communication.

The launcher's layout on a mesh with 'model' > 1 puts the batch over
'data' and the sequence over 'model': a (B, S, ...) activation is
``(Shard(0), Shard(1))``.  A projection folds (B, S) into rows.  Left to
DTensor, that fold is a ``view`` merging the split sequence into dim 0,
which torch 2.11's DTensor refuses and 2.13's lays out as
``_StridedShard``.  The helpers fold each rank's block in place instead.
Checked here: the helpers' round trips and placements, and each family's
reduced train forward and backward on (2, 2) with every DTensor ``view``
recorded: none merges a split dim past the first into dim 0, and no
DTensor carries ``_StridedShard``.  The values of a sharded step are held
on real ranks by ``tests/test_torch_fsdp.py``.
"""
import math

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import get_arch
from repro_torch.distributed import shardings as shd
from repro_torch.distributed.context import (ShardingPolicy, constrain,
                                             fold_rows, project, unfold_rows,
                                             use_policy)
from repro_torch.launch.dryrun import fake_mesh
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.training import train as TT

MESH = Mesh(("data", "model"), (2, 2), (torch.device("cpu"),) * 4)
_VIEWS = {torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default}


def _policy():
    return ShardingPolicy(MESH, dp_axes=("data",), seq_axis="model")


def _names(dt):
    return [repr(p) for p in dt.placements]


def _dtensor(dmesh, x, spec):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, dmesh, shd.placements(spec, MESH),
                             src_data_rank=None)


@pytest.mark.parametrize("contiguous", [False, True])
def test_fold_is_a_reshape_on_a_plain_tensor(contiguous):
    """On a plain tensor the fold is ``reshape(B·S, ...)`` and the unfold
    its inverse; ``project`` is the product as it is, bit for bit."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 6, 5, 3, generator=g)
    rows = fold_rows(x, contiguous=contiguous)
    assert torch.equal(rows, x.reshape(24, 5, 3))
    assert torch.equal(unfold_rows(rows, x, contiguous=contiguous), x)
    w = torch.randn(3, 7, generator=g)
    assert torch.equal(project(x, w), x @ w)
    last = x[:, -1:, :, :]          # leading dims not contiguous
    assert torch.equal(project(last, w), last @ w)


def test_fold_placements_on_a_split_sequence():
    """(4, 8, 16) placed (Shard(0), Shard(1)) on (2, 2): the fold keeps
    each rank's (2, 4) block as its own 8 rows, (Shard(0), Shard(0)) of
    (32, 16), and the unfold restores the layout and the block.  The
    contiguous fold gathers the sequence inside the data shard first:
    (Shard(0), Replicate()), which the 'tok' role splits over 'model'.
    With the sequence whole, DTensor's own rule folds."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 8, 16, generator=g)
    with fake_mesh(MESH) as dmesh, use_policy(_policy()):
        d = _dtensor(dmesh, x, shd.P("data", "model"))
        rows = fold_rows(d)
        assert _names(rows) == ["Shard(dim=0)", "Shard(dim=0)"]
        assert tuple(rows.shape) == (32, 16)
        assert torch.equal(rows.to_local(), d.to_local().reshape(8, 16))
        back = unfold_rows(rows, d)
        assert _names(back) == ["Shard(dim=0)", "Shard(dim=1)"]
        assert tuple(back.shape) == (4, 8, 16)
        assert torch.equal(back.to_local(), d.to_local())

        tok = fold_rows(d, contiguous=True)
        assert _names(tok) == ["Shard(dim=0)", "Replicate()"]
        assert tuple(tok.shape) == (32, 16)
        assert tuple(tok.to_local().shape) == (16, 16)
        tok = constrain(tok, "tok")
        assert _names(tok) == ["Shard(dim=0)", "Shard(dim=0)"]
        back = unfold_rows(tok, d, contiguous=True)
        assert _names(back) == ["Shard(dim=0)", "Shard(dim=1)"]
        assert tuple(back.to_local().shape) == (2, 4, 16)

        whole_seq = _dtensor(dmesh, x, shd.P("data"))
        rows = fold_rows(whole_seq)
        assert _names(rows) == ["Shard(dim=0)", "Replicate()"]
        assert tuple(rows.to_local().shape) == (16, 16)


class _Views(TorchDispatchMode):
    """Every DTensor ``view``: (input shape, its placements, output
    shape); and every DTensor output carrying ``_StridedShard``."""

    def __init__(self):
        super().__init__()
        self.views, self.strided = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        out = func(*args, **(kwargs or {}))
        if func in _VIEWS and isinstance(args[0], DTensor):
            self.views.append((tuple(args[0].shape),
                               tuple(args[0].placements), tuple(out.shape)))
        for o in tree_leaves(out):
            if isinstance(o, DTensor) and any(
                    "StridedShard" in type(p).__name__ for p in o.placements):
                self.strided.append((str(func), _names(o)))
        return out


def _merges_split_dims(shape, placements, size) -> bool:
    """Whether a view of ``shape`` to ``size`` merges x's dims [0, k), k
    >= 2, into dim 0 while one of dims 1..k-1 is split behind a dim of
    more than one element (size-1 dims merge into anything)."""
    from torch.distributed.tensor import Shard
    for k in range(2, len(shape) + 1):
        if math.prod(shape[:k]) == size[0] and len(size) < len(shape):
            return any(isinstance(p, Shard) and 1 <= p.dim < k
                       and any(n > 1 for n in shape[:p.dim])
                       for p in placements)
    return False


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-780m",
                                  "recurrentgemma-2b", "qwen2-moe-a2.7b"])
def test_sharded_train_step_never_merges_a_split_sequence(arch):
    """The reduced model's train forward and backward on (2, 2), the
    batch over 'data' and the sequence over 'model', the weights FSDP:
    no DTensor view merges the split sequence into rows, no DTensor
    carries ``_StridedShard``, and the step ran its projections on folded
    rows (views from (B, S, ...) did occur, none across the split)."""
    cfg = get_arch(arch).reduced()
    g = torch.Generator().manual_seed(2)
    params = T.init_params(cfg, g, torch.float32, "cpu")
    B, S = 4, 32
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g)
             for k in ("tokens", "labels")}
    mode = _Views()
    with fake_mesh(MESH) as dmesh:
        def place(tree, specs):
            return shd._map_with_path(
                lambda path, spec: _dtensor(dmesh, shd._get(tree, path),
                                            spec), specs)
        p = place(params, shd.param_specs(cfg, params, MESH, mode="fsdp"))
        b = place(batch, shd.batch_specs(cfg, batch, MESH))
        with use_policy(_policy()), mode:
            (loss, _), grads = TT.value_and_grad(
                TT.make_loss_fn(cfg, remat=False))(p, b)
        assert tuple(loss.shape) == ()
        assert len(tree_leaves(grads)) == len(tree_leaves(params))
    bad = [v for v in mode.views if _merges_split_dims(*v)]
    assert not bad, bad[:4]
    assert not mode.strided, mode.strided[:4]
    assert any(v[0][:2] == (B, S) for v in mode.views)
