"""Sharding rules (the port of ``repro/distributed/shardings.py``), as
metadata.

The rules are the reference's:

  * activations: batch over ('pod', 'data'), sequence over 'model';
  * weights: FSDP/ZeRO-3 style — each >= 2-D leaf shards its largest
    mesh-divisible dim over ('data', 'model'); embedding and LM head shard
    the vocab dim;
  * KV caches: batch over ('pod', 'data'), cache sequence over 'model';
  * SSM/LRU states: batch over ('pod', 'data'), heads/width over 'model';
  * optimizer state: as the parameter it tracks (ZeRO).

A spec is a ``P``: one entry per tensor dimension, each None (replicated),
an axis name or a tuple of axis names, as ``jax.sharding.PartitionSpec``
writes it.  Trees of specs mirror the trees they describe (nested dicts,
lists and tuples; a leaf is anything with a ``shape``), so the port's
params, caches and batches get the reference's specs leaf by leaf.

A spec becomes DTensor placements on a ``DeviceMesh`` of the mesh's names
(``placements``): one entry a mesh dim, ``Shard(d)`` where the spec puts
that axis on tensor dim d, ``Replicate()`` elsewhere.  ``named`` gives
every leaf's placements (or, on a one-device mesh, its device), as the
reference's ``named`` gives its ``NamedSharding``s, and ``distribute``
turns whole tensors into DTensors laid out by the specs, one rank a
device.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

from repro_torch.launch.mesh import Mesh, data_axes


class P(tuple):
    """A partition spec: ``P('data', None)``, ``P()`` for replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _is_leaf(x) -> bool:
    return hasattr(x, "shape") or isinstance(x, P)


def _map_with_path(fn: Callable, tree: Any, path: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts, lists, tuples and
    NamedTuples; ``path`` holds the dict keys and sequence indices."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_leaf(tree):
        vals = [_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*vals)
        return type(tree)(vals)
    return fn(path, tree)


def tree_map(fn: Callable, tree: Any) -> Any:
    return _map_with_path(lambda _path, leaf: fn(leaf), tree)


def _axsize(mesh: Mesh, names: Tuple[str, ...]) -> int:
    n = 1
    for a in names:
        n *= mesh.shape[a]
    return n


def shard_leaf_spec(shape: Tuple[int, ...], mesh: Mesh,
                    weight_axes: Tuple[str, ...],
                    skip_leading: int = 0) -> P:
    """Shard the largest dim (after ``skip_leading``) divisible by the
    weight-axis product; fall back to any dim divisible by 'model' alone;
    else replicate."""
    want = _axsize(mesh, weight_axes)
    dims = sorted(range(skip_leading, len(shape)), key=lambda i: -shape[i])
    for d in dims:
        if shape[d] % want == 0 and shape[d] >= want:
            spec = [None] * len(shape)
            spec[d] = weight_axes if len(weight_axes) > 1 else weight_axes[0]
            return P(*spec)
    if "model" in mesh.axis_names:
        m = mesh.shape["model"]
        for d in dims:
            if shape[d] % m == 0 and shape[d] >= m:
                spec = [None] * len(shape)
                spec[d] = "model"
                return P(*spec)
    return P()


def param_specs(cfg, params_shape, mesh: Mesh, mode: str = "fsdp") -> Any:
    """A tree of ``P`` matching ``params_shape`` (tensors, or anything with
    a ``shape``).

    mode='fsdp'       — weights over ('data', 'model') (training)
    mode='replicated' — weights replicated (per-replica serving)
    mode='model'      — weights over 'model' only
    mode='2dtp'       — block weights: input dim over 'data', output dim
                        over 'model' (2-D tensor-parallel serving)
    """
    if mode == "replicated":
        return tree_map(lambda a: P(), params_shape)

    if mode == "2dtp":
        d_ax, m_ax = "data", "model"

        def rule2d(names, leaf):
            shape, ndim = tuple(leaf.shape), len(leaf.shape)
            skip = 1 if "blocks" in names else 0
            if "embed" in names and ndim == 2:
                spec: list = [None, None]
                if shape[0] % mesh.shape[m_ax] == 0:
                    spec[0] = m_ax          # vocab over model
                if shape[1] % mesh.shape[d_ax] == 0:
                    spec[1] = d_ax          # d_model over data
                return P(*spec)
            if "lm_head" in names and ndim == 2:
                spec = [None, None]
                if shape[0] % mesh.shape[d_ax] == 0:
                    spec[0] = d_ax
                if shape[1] % mesh.shape[m_ax] == 0:
                    spec[1] = m_ax
                return P(*spec)
            if ndim < 2 + skip:
                return P()
            spec = [None] * ndim
            if shape[-2] % mesh.shape[d_ax] == 0:
                spec[-2] = d_ax
            if shape[-1] % mesh.shape[m_ax] == 0:
                spec[-1] = m_ax
            return P(*spec)

        return _map_with_path(rule2d, params_shape)

    waxes: Tuple[str, ...] = ("data", "model") if mode == "fsdp" else \
        ("model",)
    waxes = tuple(a for a in waxes if a in mesh.axis_names)

    def rule(names, leaf):
        shape, ndim = tuple(leaf.shape), len(leaf.shape)
        skip = 1 if "blocks" in names else 0   # the layer dim stays whole
        if "embed" in names or "lm_head" in names:
            vdim = 0 if "embed" in names else 1
            if shape[vdim] % _axsize(mesh, waxes) == 0:
                spec = [None] * ndim
                spec[vdim] = waxes if len(waxes) > 1 else waxes[0]
                return P(*spec)
        if ndim <= 1 + skip:                   # norms, biases, scalars
            return P()
        return shard_leaf_spec(shape, mesh, waxes, skip_leading=skip)

    return _map_with_path(rule, params_shape)


def _dp(mesh: Mesh, dp):
    if dp == "__auto__":
        dpa = data_axes(mesh)
        return dpa if len(dpa) > 1 else (dpa[0] if dpa else None)
    return dp


def batch_specs(cfg, batch_shape, mesh: Mesh, shard_seq: bool = True,
                dp="__auto__") -> Any:
    """tokens/labels (B, S) -> P(dp, 'model'); embeds (B, S, D); positions
    (B, S[, 3])."""
    dp = _dp(mesh, dp)
    seq = "model" if (shard_seq and "model" in mesh.axis_names) else None

    def rule(leaf):
        nd = len(leaf.shape)
        if nd == 1:
            return P(dp)
        if nd == 2:
            return P(dp, seq)
        return P(dp, seq, *([None] * (nd - 2)))

    return tree_map(rule, batch_shape)


def cache_specs(cfg, cache_shape, mesh: Mesh, dp="__auto__") -> Any:
    """KV/state cache specs: (L, B, C, kv, hd) -> batch over dp, C over
    'model'; SSM and RG-LRU states shard heads/width over 'model'."""
    dp = _dp(mesh, dp)
    m = "model" if "model" in mesh.axis_names else None
    msize = mesh.shape["model"] if m else 1

    def rule(names, leaf):
        if "pos" in names:
            return P()
        shape = tuple(leaf.shape)
        if "attn" in names:        # (L, B, C, kv, hd)
            cspec = m if (m and shape[2] % msize == 0) else None
            return P(None, dp, cspec, None, None)
        if "conv" in names:        # (L, B, K-1, ch)
            cspec = m if (m and shape[3] % msize == 0) else None
            return P(None, dp, None, cspec)
        if "state" in names:       # (L, B, H, P, N) SSM state
            hspec = m if (m and shape[2] % msize == 0) else None
            return P(None, dp, hspec, None, None)
        if "h" in names:           # (L, B, W) RG-LRU state
            wspec = m if (m and shape[2] % msize == 0) else None
            return P(None, dp, wspec)
        return P()

    return _map_with_path(rule, cache_shape)


def opt_specs(param_spec_tree) -> Any:
    """Optimizer m/v shard like their parameters (ZeRO)."""
    return param_spec_tree


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh: Mesh) -> Tuple:
    """The DTensor placements of ``spec`` on a ``DeviceMesh`` of
    ``mesh``'s names: ``Shard(d)`` on each mesh dim the spec puts on
    tensor dim d, ``Replicate()`` on the others.  Where a tuple entry puts
    several axes on one dim, the first axis splits it first (the
    reference's row-major order of a multi-axis entry).  A mesh dim of
    size 1 is ``Replicate()`` whatever the spec: its one shard is the
    whole dim, and DTensor's view rules refuse some reshapes of a dim
    "split" over it (torch 2.11 flattening (B, S) split over (1, 1))."""
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate()] * len(mesh.axis_names)
    for d, entry in enumerate(tuple(spec)):
        for a in spec_axes(entry):
            if mesh.shape[a] > 1:
                pl[mesh.axis_names.index(a)] = Shard(d)
    return tuple(pl)


def row_placements(placements):
    """(rows, whole, summed) for a call on each rank's batch rows of a
    DTensor laid out by ``placements``: the rows kept split over the mesh
    dims that split dim 0 (``Shard(0)``), every other mesh dim replicated;
    every mesh dim replicated (an input each rank takes whole); and the
    gradient of such a whole input, a partial sum over the dims that split
    the rows (each rank's rows give their share) and replicated on the
    others."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    def split(p):
        return isinstance(p, Shard) and p.dim == 0
    rows = tuple(p if split(p) else Replicate() for p in placements)
    whole = (Replicate(),) * len(rows)
    summed = tuple(Partial() if split(p) else Replicate()
                   for p in placements)
    return rows, whole, summed


def on_rows(fn, args, batched, given_back):
    """``fn(*args)`` on each rank's batch rows, through ``local_map``:
    each input's batch rows kept split over the mesh dims that split them
    and every other dim made whole on each rank (a sequence split over
    'model' is all-gathered, under autograd).  ``batched[i]``: whether
    args[i]'s dim 0 is the batch (else it is made whole on every rank,
    its gradient summed over the ranks, ``row_placements``);
    ``given_back[j]``: whether output j comes back laid out like
    ``args[0]`` (else it keeps the rows' split: a final state).  The
    first argument must be a DTensor."""
    from torch.distributed.tensor.experimental import local_map
    lead = args[0]
    mesh = lead.device_mesh
    rows, whole, summed = row_placements(lead.placements)
    run = local_map(
        fn, out_placements=tuple(rows for _ in given_back),
        in_placements=tuple((rows if b else whole) for b in batched),
        in_grad_placements=tuple((rows if b else summed) for b in batched),
        device_mesh=mesh, redistribute_inputs=True)
    outs = run(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    back = tuple(o.redistribute(mesh, lead.placements) if g else o
                 for o, g in zip(outs, given_back))
    return back if len(back) > 1 else back[0]


def named(mesh: Mesh, spec_tree) -> Any:
    """Where every spec's leaf goes: on a one-device mesh, that device;
    on a mesh of more devices, the leaf's DTensor placements
    (``placements``).  A mesh that names no device (a description, such
    as the production mesh on fewer cards) is refused."""
    if not mesh.devices:
        raise ValueError(f"mesh {mesh.shape} names no devices: it "
                         f"describes {mesh.size} devices, it places none")
    if mesh.size == 1:
        dev = mesh.devices[0]
        return _map_with_path(lambda _p, s: dev, spec_tree)
    return _map_with_path(lambda _p, s: placements(s, mesh), spec_tree)


def distribute(tree, specs, mesh: Mesh) -> Any:
    """Every whole tensor of ``tree`` as a DTensor on
    ``mesh.device_mesh()`` laid out by its spec in ``specs``: each rank
    keeps its own copy of its own shard, with no communication, and
    shares no memory with ``tree``.  So every rank must hold the same
    whole tensors: the weights are drawn on every rank from the same
    explicit generator seed, and every rank of a node reads the node's
    batch."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    device_mesh = mesh.device_mesh()

    def place(path, spec):
        t = _get(tree, path)
        pl = placements(spec, mesh)
        d = distribute_tensor(t, device_mesh, pl, src_data_rank=None)
        local = d.to_local()
        if local.untyped_storage().data_ptr() == \
                t.untyped_storage().data_ptr():
            # a replicated leaf is the tensor itself, a shard a view of it:
            # an in-place update would write through, a view keep it alive
            d = DTensor.from_local(local.clone(), device_mesh, pl,
                                   run_check=False, shape=d.shape,
                                   stride=d.stride())
        return d
    return _map_with_path(place, specs)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


_REGISTERED = [False]


def register_strategies() -> None:
    """Sharding strategies DTensor lacks for ops of the step, registered
    once a process: ``mm`` with an ``out_dtype`` (the unembedding's bf16
    product into float32 logits in ``transformer.unembed``) shards
    by rows or by columns, never whole or partial on a device (DTensor's
    choice does not weigh the output: whole or partial (T, V) float32
    logits would be tens of GB a device)."""
    if _REGISTERED[0]:
        return
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.mm.dtype)
    def _mm_dtype(x, y, out_dtype):
        return [([Shard(0)], [Shard(0), Replicate(), None]),
                ([Shard(1)], [Replicate(), Shard(1), None])]
    _REGISTERED[0] = True
