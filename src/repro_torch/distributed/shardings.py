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
params, caches and batches get the reference's specs leaf by leaf.  The
port runs on one card, so nothing here moves data across devices:
``named`` places every leaf on the mesh's one device and refuses a mesh
that would need another.
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


def named(mesh: Mesh, spec_tree) -> Any:
    """The device of every spec's leaf.  One card holds the whole tree:
    a mesh of more than one device, or one that names no device, would
    need the specs applied across cards, and is refused."""
    if mesh.size != 1 or not mesh.devices:
        raise ValueError(f"mesh {mesh.shape} would need {mesh.size} "
                         f"devices; the port places on one")
    dev = mesh.devices[0]
    return _map_with_path(lambda _p, s: dev, spec_tree)
