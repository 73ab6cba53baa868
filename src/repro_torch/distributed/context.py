"""Activation-sharding policy (the port of ``repro/distributed/context.py``).

The model code calls ``constrain(x, role)`` at layer boundaries, where
the reference does, which pins an activation to the installed policy's
sharding, and its MoE routes tokens per device-local group, the number of
groups coming from that policy.  ``constrain`` returns a plain tensor (a
one-device run's) as it is, and redistributes a DTensor (a train step
sharded over a process group, ``launch/train.py``, or the dry run's meta
tensors, ``launch/dryrun.py``) to the policy's spec for its role.

Roles:
  act    (B, S, D)   — residual stream:      (dp, seq, None)
  ffh    (B, S, F)   — FFN/inner hidden:     (dp, seq, None)
  heads  (B, S, H, d)— per-head activations: (dp, seq, None, None)
  logits (B, S, V)   — unembedded logits:    (dp, seq, None)
  tok    (T, ...)    — token-major:          ((dp..., seq), None...)

A row-wise op (a projection, the MoE's token-major routing) takes a
(B, S, ...) activation as B·S rows: ``fold_rows`` and ``unfold_rows``
fold and unfold them, and ``project`` runs a projection on them.  On a
DTensor whose sequence is split, each rank's (B/dp, S/m) block becomes its
own rows in place, so no view ever merges a split sequence into rows (the
view torch 2.11's DTensor refuses and 2.13's lays out as ``_StridedShard``).
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

from repro_torch.distributed.shardings import P, placements
from repro_torch.launch.mesh import Mesh

_STATE = threading.local()


class ShardingPolicy:
    def __init__(self, mesh: Mesh, *, dp_axes: Tuple[str, ...] = ("data",),
                 seq_axis: Optional[str] = "model",
                 vocab_axis: Optional[str] = None,
                 ff_axis: Optional[str] = None):
        self.mesh = mesh
        dp = tuple(a for a in dp_axes if a in mesh.axis_names)
        self.dp = dp if len(dp) > 1 else (dp[0] if dp else None)
        self.seq = seq_axis if (seq_axis in mesh.axis_names) else None
        self.vocab = vocab_axis if (vocab_axis in mesh.axis_names) else None
        self.ff = ff_axis if (ff_axis in mesh.axis_names) else None

    def _dp_list(self):
        if self.dp is None:
            return []
        return list(self.dp) if isinstance(self.dp, tuple) else [self.dp]

    @property
    def token_groups(self) -> int:
        """Number of token shards (dp x seq): MoE routes per group, so
        capacity and dispatch stay local (GShard per-group semantics).
        Over a process group these are the ranks that hold distinct
        tokens, each routing its own group (``moe._device_groups``)."""
        n = 1
        for a in self._dp_list():
            n *= self.mesh.shape[a]
        if self.seq is not None:
            n *= self.mesh.shape[self.seq]
        return n

    def spec(self, role: str, ndim: int) -> P:
        if role == "tok":
            axes = self._dp_list() + ([self.seq] if self.seq else [])
            lead = tuple(axes) if len(axes) > 1 else (axes[0] if axes
                                                      else None)
            return P(lead, *([None] * (ndim - 1)))
        lead = [self.dp, self.seq]
        if role == "logits" and self.vocab is not None and ndim >= 3:
            return P(*(lead + [None] * (ndim - 3) + [self.vocab]))
        if role == "ffh" and self.ff is not None and ndim >= 3:
            return P(*(lead + [None] * (ndim - 3) + [self.ff]))
        return P(*(lead + [None] * (ndim - 2)))


def set_policy(policy: Optional[ShardingPolicy]) -> None:
    _STATE.policy = policy


def get_policy() -> Optional[ShardingPolicy]:
    return getattr(_STATE, "policy", None)


class use_policy:
    """Install ``policy`` for the block (per thread), then restore the
    previous one.  The block also takes every plain tensor the model
    makes (positions, masks, constants) as replicated on the mesh where it
    meets a DTensor (DTensor's ``implicit_replication``), as the
    reference's jitted program replicates its constants."""

    def __init__(self, policy: Optional[ShardingPolicy]):
        self.policy = policy
        self._implicit = None

    def __enter__(self):
        self.prev = get_policy()
        set_policy(self.policy)
        if self.policy is not None:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            self._implicit = implicit_replication()
            self._implicit.__enter__()
        return self.policy

    def __exit__(self, *exc):
        if self._implicit is not None:
            self._implicit.__exit__(None, None, None)
            self._implicit = None
        set_policy(self.prev)


def constrain(x, role: str = "act"):
    """``x`` pinned to the installed policy's sharding for ``role``: a
    DTensor is redistributed to it; a plain tensor, or any tensor with no
    policy installed, is returned as it is."""
    pol = get_policy()
    if pol is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    pl = placements(pol.spec(role, x.ndim), pol.mesh)
    if list(pl) == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def _splits_rows_locally(x) -> bool:
    """Whether ``x`` is a DTensor (B, S, ..., K) whose dim 1 is split on
    some mesh dim, every other mesh dim splitting dim 0 or nothing, both
    evenly: the layout whose blocks ``fold_rows`` folds in place."""
    from torch.distributed.tensor import Replicate, Shard
    if not _is_dtensor(x) or x.ndim < 3:
        return False
    if not all(isinstance(p, Replicate) or (isinstance(p, Shard)
                                            and p.dim < 2)
               for p in x.placements):
        return False
    ways = [1, 1]
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            ways[p.dim] *= x.device_mesh.size(i)
    return (ways[1] > 1 and x.shape[0] % ways[0] == 0
            and x.shape[1] % ways[1] == 0)


def _rows_layout(placements):
    """The rows' placements of a (B, S, ...) layout: ``Shard(0)`` on every
    mesh dim that splits dim 0 or dim 1."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(0) if isinstance(p, Shard) else p for p in placements)


def _seq_gathered(placements):
    """``placements`` with every mesh dim that splits dim 1 replicated."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                 for p in placements)


def _from_local(local, mesh, placements, shape):
    from torch.distributed.tensor import DTensor
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=tuple(shape), stride=tuple(stride))


def fold_rows(x, *, contiguous: bool = False):
    """``x`` (B, S, ...) as rows (B·S, ...), for row-wise ops only.

    A plain tensor, or a DTensor whose sequence is not split, is
    reshaped (DTensor's own rule then keeps the rows where they are).  A
    DTensor whose sequence is split (``(Shard(0), Shard(1))`` on ('data',
    'model')) folds each rank's (B/dp, S/m, ...) block into its own rows,
    through ``to_local``/``from_local`` (so autograd runs through it):
    the rows are ``Shard(0)`` on every mesh dim that split dim 0 or dim 1,
    and the global row order this claims is a permutation of the
    row-major one, which a row-wise op does not see.  ``unfold_rows``
    inverts it.

    ``contiguous=True`` gives the row-major order instead, as the
    reference's token-major ``P(('data', 'model'))`` lays it out: the
    sequence is gathered inside each data shard first, so the rows come
    back split over the data axes alone, contiguous chunks that the
    'tok' role then splits over 'model' (rank (i, j) holding chunk
    i·m + j)."""
    if not _splits_rows_locally(x):
        return x.reshape(-1, *x.shape[2:])
    mesh, pl = x.device_mesh, tuple(x.placements)
    if contiguous:
        pl = _seq_gathered(pl)
        x = x.redistribute(mesh, pl)
    local = x.to_local()
    return _from_local(local.reshape(-1, *local.shape[2:]), mesh,
                       _rows_layout(pl),
                       (x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def unfold_rows(y, like, *, contiguous: bool = False):
    """Rows ``y`` (B·S, ...) back to (B, S, ...) laid out as ``like``,
    the (B, S, ...) tensor they were folded from by ``fold_rows`` with
    the same ``contiguous``.  Rows that a DTensor op left in another
    layout are first redistributed to the fold's."""
    B, S = like.shape[:2]
    if not _splits_rows_locally(like):
        return y.reshape(B, S, *y.shape[1:])
    mesh, pl = like.device_mesh, tuple(like.placements)
    lead = _seq_gathered(pl) if contiguous else pl
    rows = _rows_layout(lead)
    if tuple(y.placements) != rows:
        y = y.redistribute(mesh, rows)
    b, s = B, S
    for i, p in enumerate(lead):
        if p.is_shard(0):
            b //= mesh.size(i)
        elif p.is_shard(1):
            s //= mesh.size(i)
    local = y.to_local()
    out = _from_local(local.reshape(b, s, *local.shape[1:]), mesh, lead,
                      (B, S) + tuple(y.shape[1:]))
    return out.redistribute(mesh, pl) if contiguous else out


def project(x, w):
    """``x @ w`` for an activation x (B, S, ..., K): a plain tensor's as
    it is; a DTensor's on its rows (``fold_rows``), unfolded back."""
    if not _splits_rows_locally(x):
        return x @ w
    return unfold_rows(fold_rows(x) @ w, x)
