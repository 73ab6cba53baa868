"""Multi-pod dry run for the H100 port (the port of
``repro/launch/dryrun.py``).

For every (arch x shape x mesh) cell:
  1. build meta-tensor inputs (no allocation) and their partition specs
     (``distributed/shardings.py`` under the cell's ``ShardingPolicy``),
  2. place them as DTensors on a ``DeviceMesh`` of the mesh's shape over a
     fake process group of its size (one rank's shards, nothing on any
     device, no communication), and run the step once on them,
  3. record memory, operations, bytes and collectives per device from the
     local ops DTensor runs on the shards,
  4. derive the three roofline terms (depth-extrapolated; see
     ``rooflines.py``) from the H100's constants.

The reference lowers each cell with ``jit(...).lower().compile()`` on 512
forced host devices and reads XLA's analyses.  Here the step runs eagerly
on meta DTensors; a ``TorchDispatchMode`` under DTensor sees every local
op of rank 0:

  * operations: matmuls by ``torch.utils.flop_counter``'s formulas, by the
    dtype of their operands;
  * bytes: each op's tensor inputs and outputs (views move none), the
    eager program's HBM traffic;
  * collectives: the ``c10d_functional`` ops DTensor's redistributions
    issue, output bytes by kind, all-reduce charged twice;
  * memory: the live bytes of every tensor the step makes, from its
    allocation to its release, and their peak.

The kernels are charged by their modules' ``cost()`` at the call's shard
shapes, not by their plain bodies: ``kernels.ops.traced`` hands each call
to the dry run, which gathers the keys of a sequence-sharded attention
(the queries of one shard see every earlier key), charges a scan over a
sharded sequence one pass of its carried state to the next shard, and
makes the output's shape.  The plain flash's S x S float32 probabilities
never reach ``bytes``.  Where DTensor has no sharding strategy for an op
(or fails on one, as on a write into a sharded slice), every sharded
input is redistributed to replicated before it and the op runs on the
whole tensors; such ops are listed in the result's
``replicated_ops``.

Memory: argument bytes are the local shards of the inputs, computed from
the specs at full depth; output, alias (the donated train state or
decode cache, which the step updates in place) and temp (the peak of the
step's live bytes less the outputs it made) come from the same two
reduced-depth traces as the costs, extrapolated in depth.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import logging
import math
import os
import sys
import time
import traceback
import warnings
import weakref
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ArchConfig,
                                      ShapeConfig, cell_is_applicable,
                                      get_arch)
from repro_torch.core import analytic
from repro_torch.distributed import shardings as shd
from repro_torch.distributed.context import ShardingPolicy, use_policy
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lora_merge as _lm
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.launch import rooflines as rf
from repro_torch.launch.mesh import Mesh, data_axes, make_production_mesh
from repro_torch.models import transformer
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            init_opt_state)
from repro_torch.training.train import TrainState, make_train_step

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeConfig, *,
                batch_override: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of a cell."""
    B = batch_override or shape.global_batch
    S = shape.seq_len
    f, i32 = torch.bfloat16, torch.int32
    if shape.kind == "train":
        if cfg.family in ("audio", "vlm"):
            specs = {"embeds": _meta((B, S, cfg.d_model), f),
                     "labels": _meta((B, S), i32)}
            if cfg.mrope:
                specs["positions"] = _meta((B, S, 3), i32)
            return specs
        return {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}
    if shape.kind == "prefill":
        if cfg.family in ("audio", "vlm"):
            specs = {"embeds": _meta((B, S, cfg.d_model), f)}
            if cfg.mrope:
                specs["positions"] = _meta((B, S, 3), i32)
            return specs
        return {"tokens": _meta((B, S), i32)}
    # decode: one new token against a seq_len-deep cache
    if cfg.family == "vlm":
        return {"embeds": _meta((B, 1, cfg.d_model), f),
                "positions": _meta((B, 1, 3), i32)}
    return {"tokens": _meta((B,), i32)}


def cell_policy(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh,
                params_mode: str = "fsdp") -> ShardingPolicy:
    B = shape.global_batch
    dp = data_axes(mesh)
    dp_total = 1
    for a in dp:
        dp_total *= mesh.shape[a]
    dp_eff = dp if (dp_total and B % dp_total == 0) else ()
    if params_mode == "2dtp":
        dp_eff = ()   # 2-D TP: batch replicated, 'data' is a weight axis
    seq = "model" if shape.kind != "decode" else None
    vocab = "model" if shape.kind == "decode" else None
    ff = "model" if shape.kind == "decode" else None
    return ShardingPolicy(mesh, dp_axes=dp_eff, seq_axis=seq,
                          vocab_axis=vocab, ff_axis=ff)


class Cell(NamedTuple):
    """A step, its inputs as meta tensors, their specs, and which inputs
    it donates (updates in place), as the reference's ``donate_argnums``."""
    fn: Callable
    structs: tuple
    specs: tuple
    donate: Tuple[int, ...]


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh, *,
               params_mode: str = "fsdp",
               batch_override: Optional[int] = None) -> Cell:
    B = batch_override or shape.global_batch
    pol = cell_policy(cfg, shape, mesh, params_mode)
    batch_struct = input_specs(cfg, shape, batch_override=batch_override)
    batch_spec = shd.batch_specs(cfg, batch_struct, mesh,
                                 shard_seq=(shape.kind != "decode"),
                                 dp=pol.dp)
    gen = torch.Generator()

    if shape.kind == "train":
        params = transformer.init_params(cfg, gen, torch.bfloat16, META)
        state = TrainState(params, init_opt_state(params))
        pspec = shd.param_specs(cfg, params, mesh, mode="fsdp")
        ospec = shd.opt_specs(pspec)
        sspec = TrainState(pspec, OptState(shd.P(), ospec, ospec))
        step = make_train_step(cfg, AdamWConfig(), remat=True,
                               grad_compression=os.environ.get(
                                   "REPRO_GRAD_COMPRESSION", "none"))
        return Cell(step, (state, batch_struct), (sspec, batch_spec), (0,))

    params = transformer.init_params(cfg, gen, torch.bfloat16, META)
    pspec = shd.param_specs(cfg, params, mesh, mode=params_mode)

    if shape.kind == "prefill":
        def prefill(params, batch):
            return transformer.forward(cfg, params, batch, mode="prefill",
                                       max_len=shape.seq_len)
        return Cell(prefill, (params, batch_struct), (pspec, batch_spec),
                    ())

    # decode
    cache = transformer.init_cache(cfg, B, shape.seq_len, torch.bfloat16,
                                   META)
    cache["pos"] = _meta((B,), torch.int32)
    cspec = shd.cache_specs(cfg, cache, mesh, dp=pol.dp)

    def decode(params, batch, cache):
        return transformer.decode_step(cfg, params, batch, cache)
    return Cell(decode, (params, batch_struct, cache),
                (pspec, batch_spec, cspec), (2,))


def _reduced_depth_cfg(cfg: ArchConfig, mult: int) -> Tuple[ArchConfig, int]:
    """Depth-reduced config for cost extrapolation; depth = mult x period."""
    period = len(cfg.block_pattern) or 1
    L = mult * period
    return dataclasses.replace(cfg, n_layers=L), L


# ---------------------------------------------------------------------------
# shards
# ---------------------------------------------------------------------------

def _leaves(tree) -> List:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, shd.P):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _zip_map(fn: Callable, tree, spec):
    """``fn(leaf, spec)`` over a tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, spec[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, shd.P):
        vals = [_zip_map(fn, v, s) for v, s in zip(tree, spec)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else \
            type(tree)(vals)
    return fn(tree, spec)


def local_shape(shape, spec, mesh: Mesh) -> Tuple[int, ...]:
    """Rank 0's shard of a tensor of ``shape`` under ``spec``: each
    sharded dim split over the product of its axes, the first shard
    rounded up (as DTensor and XLA pad an uneven split)."""
    out = list(shape)
    for d, entry in enumerate(tuple(spec)[:len(shape)]):
        n = 1
        for a in shd.spec_axes(entry):
            n *= mesh.shape[a]
        out[d] = -(-out[d] // n)
    return tuple(out)


def local_bytes(tree, specs, mesh: Mesh) -> int:
    """Bytes of rank 0's shards of every leaf of ``tree``."""
    total = [0]

    def add(t, spec):
        total[0] += (math.prod(local_shape(t.shape, spec, mesh))
                     * t.element_size())
        return t
    _zip_map(add, tree, specs)
    return total[0]


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def _distribute(tree, specs, dmesh, mesh: Mesh):
    from torch.distributed.tensor import DTensor

    def place(t, spec):
        local = _meta(local_shape(t.shape, spec, mesh), t.dtype)
        return DTensor.from_local(local, dmesh, shd.placements(spec, mesh),
                                  run_check=False, shape=tuple(t.shape),
                                  stride=_contiguous_stride(t.shape))
    return _zip_map(place, tree, specs)


@contextlib.contextmanager
def fake_mesh(mesh: Mesh):
    """A ``DeviceMesh`` of ``mesh``'s shape over a fake process group of
    its size: rank 0's view, no device and no communication.  The group
    is torn down on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shd.register_strategies()
    if dist.is_initialized():
        dist.destroy_process_group()
    # DTensor warns of every two-step redistribution; the counts say it
    log = logging.getLogger("torch.distributed.tensor")
    level = log.level
    log.setLevel(logging.ERROR)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield init_device_mesh("cpu", mesh.axis_sizes,
                               mesh_dim_names=mesh.axis_names)
    finally:
        dist.destroy_process_group()
        log.setLevel(level)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

_COLL_KIND = {"all_gather_into_tensor": "all-gather",
              "all_gather_into_tensor_coalesced": "all-gather",
              "reduce_scatter_tensor": "reduce-scatter",
              "reduce_scatter_tensor_coalesced": "reduce-scatter",
              "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
              "all_to_all_single": "all-to-all",
              "shard_dim_alltoall": "all-to-all",
              "broadcast": "collective-permute"}
_WRAPPERS = {"wait_tensor", "_wrap_tensor_autograd", "_unsafe_view"}
_VIEWS = {torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default}
_NEW_FACTORIES = {torch.ops.aten.new_zeros.default,
                  torch.ops.aten.new_empty.default,
                  torch.ops.aten.new_ones.default,
                  torch.ops.aten.new_full.default}
_EMPTY = {"empty", "empty_strided", "empty_like", "new_empty",
          "new_empty_strided"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class Totals:
    """What one trace counted, per device."""
    flops: float = 0.0
    f32_flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in (
            "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute")})
    live: int = 0
    peak: int = 0
    kernels: Dict[str, int] = dataclasses.field(
        default_factory=collections.Counter)
    replicated_ops: Dict[str, int] = dataclasses.field(
        default_factory=collections.Counter)

    def add_flops(self, n: float, dtype: str) -> None:
        self.flops += n
        if dtype == "float32":
            self.f32_flops += n


class _Counter(TorchDispatchMode):
    """Counts rank 0's local ops (see the module docstring)."""

    def __init__(self, dmesh):
        super().__init__()
        self.t = Totals()
        self.dmesh = dmesh
        self._inner = False     # the next DTensor op passes through once
        self._quiet = False
        self._attempts = []     # the releases of what each attempt made

    @contextlib.contextmanager
    def quiet(self):
        """Ops within the block are not counted."""
        self._quiet = True
        try:
            yield
        finally:
            self._quiet = False

    # -- memory ----------------------------------------------------------
    def _alloc(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        self.t.live += n
        self.t.peak = max(self.t.peak, self.t.live)
        release = weakref.finalize(t, self._free, n)
        if self._attempts:
            self._attempts[-1].append(release)

    def _free(self, n: int) -> None:
        self.t.live -= n

    # -- dispatch --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.utils._pytree import tree_leaves
        kwargs = kwargs or {}
        flat = tree_leaves((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            if func in _NEW_FACTORIES and isinstance(args[0], DTensor):
                return self._new_like(func, args, kwargs)
            if func in _VIEWS and isinstance(args[0], DTensor):
                rows = self._merge_rows(args[0], args[1])
                if rows is None:
                    rows = self._split_rows(args[0], args[1])
                if rows is not None:
                    return rows
            if self._inner:
                self._inner = False
                return NotImplemented
            # let DTensor run it with this mode still installed, so its
            # local ops (and its redistributions' collectives) come back
            # here; where it cannot, replicate and run the op whole
            self._inner = True
            t = self.t
            before = (t.flops, t.f32_flops, t.bytes, dict(t.coll), t.peak)
            self._attempts.append([])
            try:
                with self:
                    out = func(*args, **kwargs)
            except (NotImplementedError, RuntimeError, AssertionError,
                    ValueError, IndexError):
                self._inner = False
            else:
                made = self._attempts.pop()
                if self._attempts:
                    self._attempts[-1].extend(made)
                return out
            # what the failed attempt counted and made is not the op's
            # work, whatever still holds its tensors
            for release in self._attempts.pop():
                release()
            t.flops, t.f32_flops, t.bytes, t.coll, t.peak = before
            return self._replicated(func, args, kwargs)
        out = func(*args, **kwargs)
        # DTensor's sharding propagation runs ops on fake tensors
        if not self._quiet and not any(isinstance(a, FakeTensor)
                                       for a in flat + tree_leaves(out)):
            self._count(func, args, kwargs, flat, out)
        return out

    def _count(self, func, args, kwargs, flat_in, out) -> None:
        from torch.utils._pytree import tree_leaves
        name = func._schema.name.split("::")[-1]
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        rets = func._schema.returns
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in rets)
        inplace = any(r.alias_info is not None and r.alias_info.is_write
                      for r in rets)
        if name in _COLL_KIND:
            b = sum(_nbytes(o) for o in outs)
            kind = _COLL_KIND[name]
            self.t.coll[kind] += 2 * b if kind == "all-reduce" else b
        elif name in _WRAPPERS:
            return      # an alias of its input: no bytes, no memory
        elif not view:
            ins = [a for a in flat_in if isinstance(a, torch.Tensor)]
            if name not in _EMPTY:
                self.t.bytes += (sum(_nbytes(a) for a in ins)
                                 + sum(_nbytes(o) for o in outs))
            packet = func._overloadpacket
            if packet in flop_registry:
                n = flop_registry[packet](*args, **kwargs, out_val=out)
                self.t.add_flops(n, "float32" if ins and ins[0].dtype
                                 == torch.float32 else "bfloat16")
        if not view and not inplace:
            for o in outs:
                self._alloc(o)

    def _merge_rows(self, x, size):
        """``x.view(size)`` where ``size`` merges x's leading dims into
        one and only those dims are sharded: each device's rows stay on
        it (a row-wise op after the merge does not care for their global
        order), sharded over the same mesh dims.  DTensor would gather
        every device's rows first.  None when the view is another."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        size = list(size)
        if -1 in size:
            i = size.index(-1)
            rest = math.prod(s for j, s in enumerate(size) if j != i)
            size[i] = x.numel() // max(rest, 1)
        shape = tuple(x.shape)
        k = len(shape) - len(size) + 1
        if (k < 2 or tuple(size[1:]) != shape[k:]
                or size[0] != math.prod(shape[:k])):
            return None
        if not all(isinstance(p, Replicate) or (isinstance(p, Shard)
                                                and p.dim < k)
                   for p in x.placements):
            return None
        if not any(isinstance(p, Shard) and p.dim > 0 for p in x.placements):
            return None     # DTensor's own rule keeps such a view local
        loc = x._local_tensor
        local = loc.view((math.prod(loc.shape[:k]),) + tuple(loc.shape[k:]))
        pl = [Shard(0) if isinstance(p, Shard) else p for p in x.placements]
        return DTensor.from_local(local, x.device_mesh, pl, run_check=False,
                                  shape=tuple(size),
                                  stride=_contiguous_stride(size))

    def _split_rows(self, x, size):
        """The inverse of ``_merge_rows``: ``x.view(size)`` splitting x's
        dim 0, sharded over some mesh dims, into leading dims; the mesh
        dims go to the new dims in order, each where it divides."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        size = [int(s) for s in size]
        if -1 in size:
            i = size.index(-1)
            rest = math.prod(s for j, s in enumerate(size) if j != i)
            size[i] = x.numel() // max(rest, 1)
        shape = tuple(x.shape)
        k = len(size) - len(shape) + 1
        if (k < 2 or tuple(size[k:]) != shape[1:]
                or math.prod(size[:k]) != shape[0]):
            return None
        sharded = [i for i, p in enumerate(x.placements)
                   if isinstance(p, Shard)]
        if (not sharded or any(x.placements[i].dim != 0 for i in sharded)
                or not all(isinstance(p, (Shard, Replicate))
                           for p in x.placements)):
            return None
        pl, local, d = list(x.placements), list(size), 0
        for i in sharded:
            n = x.device_mesh.size(i)
            while d < k and local[d] % n:
                d += 1
            if d == k:
                return None
            pl[i] = Shard(d)
            local[d] //= n
        loc = x._local_tensor
        if math.prod(local) != loc.numel():
            return None
        return DTensor.from_local(loc.view(local), x.device_mesh, pl,
                                  run_check=False, shape=tuple(size),
                                  stride=_contiguous_stride(size))

    def _new_like(self, func, args, kwargs):
        """``x.new_zeros(size)`` and its kin on a DTensor: sharded as ``x``
        along the dims where ``size`` equals ``x``'s shape, replicated
        along the others (DTensor replicates the whole result when the
        shapes differ: the backward of a gather from the (B, S, V)
        logits would make them whole on every device)."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        x, size = args[0], tuple(args[1])
        pl, local = [], list(size)
        for i, p in enumerate(x.placements):
            if (isinstance(p, Shard) and p.dim < len(size)
                    and size[p.dim] == x.shape[p.dim]):
                pl.append(p)
                local[p.dim] = -(-local[p.dim] // x.device_mesh.size(i))
            else:
                pl.append(Replicate())
        with self:
            out = func(x._local_tensor, local, *args[2:], **kwargs)
        return DTensor.from_local(out, x.device_mesh, pl, run_check=False,
                                  shape=size,
                                  stride=_contiguous_stride(size))

    def _replicated(self, func, args, kwargs):
        """An op DTensor has no strategy for, or fails on: every sharded
        input is redistributed to replicated and the op runs on the whole
        tensors.  An in-place write (into a sharded cache, say) keeps its
        target's shards and writes its local rows: the written values are
        laid out as the target where they match its shape, else made
        whole."""
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_leaves, tree_map
        inplace = any(r.alias_info is not None and r.alias_info.is_write
                      for r in func._schema.returns)
        if not inplace:
            local = self._shard_local(func, args, kwargs)
            if local is not None:
                return local
        self.t.replicated_ops[str(func)] += 1
        full = [Replicate()] * self.dmesh.ndim
        dst = args[0] if inplace and isinstance(args[0], DTensor) else None

        def local(a):
            if not isinstance(a, DTensor):
                return a
            if a is dst:
                return a._local_tensor
            if dst is not None and a.shape == dst.shape:
                return a.redistribute(self.dmesh, dst.placements)._local_tensor
            return a.redistribute(self.dmesh, full)._local_tensor
        with self:      # the redistributions' collectives and the op count
            largs, lkw = tree_map(local, args), tree_map(local, kwargs)
            if dst is None:
                out = func(*largs, **lkw)
            else:
                try:
                    func(*largs, **lkw)
                except (RuntimeError, IndexError, ValueError):
                    # shapes the local write cannot take: charge the
                    # written values, read and written once
                    self.t.bytes += 2 * sum(
                        _nbytes(a) for a in tree_leaves((largs[1:], lkw))
                        if isinstance(a, torch.Tensor))
                return dst

        def wrap(o):
            if isinstance(o, torch.Tensor):
                return DTensor.from_local(o, self.dmesh, full,
                                          run_check=False)
            return o
        return tree_map(wrap, out)

    def _shard_local(self, func, args, kwargs):
        """Where an op DTensor cannot run has an evident sharded form, run
        that on the shards (None where it has none):

        * a pointwise op whose DTensor inputs share their placements, and
          whose output keeps the sizes of their sharded dims, runs on the
          local shards (others broadcast against them);
        * ``table[idx]`` (one index tensor on dim 0) gathers from the
          whole table at the local indices, the output sharded as ``idx``;
        * ``index_put`` of sharded rows into a whole target scatters each
          device's rows, the result partial sums; into a sharded target
          it writes the target's shards;
        * ``roll`` along dims that are not sharded runs on the shards.
        """
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.utils._pytree import tree_leaves, tree_map
        flat = [a for a in tree_leaves((args, kwargs))
                if isinstance(a, DTensor)]
        if not flat or any(not isinstance(p, (Shard, Replicate))
                           for a in flat for p in a.placements):
            return None
        pl = tuple(flat[0].placements)
        sharded = {p.dim for p in pl if isinstance(p, Shard)}

        def run(largs, lkw, placements, shape):
            with self:
                out = func(*largs, **lkw)
            return DTensor.from_local(out, self.dmesh, placements,
                                      run_check=False, shape=shape,
                                      stride=_contiguous_stride(shape))

        def local(a):
            return a._local_tensor if isinstance(a, DTensor) else a
        name = func._schema.name.split("::")[-1]
        if torch.Tag.pointwise in func.tags and all(
                tuple(a.placements) == pl for a in flat):
            lead = flat[0]
            with self.quiet():      # the output's global shape
                out = func(*tree_map(
                    lambda a: torch.empty(a.shape, dtype=a.dtype,
                                          device=META)
                    if isinstance(a, DTensor) else a, args), **kwargs)
            if not isinstance(out, torch.Tensor) or any(
                    out.dim() != lead.dim() or out.shape[d] != lead.shape[d]
                    for d in sharded):
                return None
            return run(tree_map(local, args), tree_map(local, kwargs), pl,
                       tuple(out.shape))
        if name == "index" and func.overloadpacket is torch.ops.aten.index:
            table, idx = args[0], args[1]
            if len(idx) != 1 or not isinstance(idx[0], DTensor):
                return None
            i = idx[0]
            full = [Replicate()] * self.dmesh.ndim
            with self:
                whole = (table.redistribute(self.dmesh, full)._local_tensor
                         if isinstance(table, DTensor) else table)
            shape = tuple(i.shape) + tuple(table.shape[1:])
            return run((whole, [i._local_tensor]), {}, list(i.placements),
                       shape)
        if name == "index_put" and isinstance(args[0], DTensor) and all(
                isinstance(p, Replicate) for p in args[0].placements) \
                and isinstance(args[2], DTensor) and any(
                    isinstance(p, Shard) for p in args[2].placements):
            # a scatter of sharded rows into a whole target (the
            # embedding's gradient): each device scatters its rows, the
            # sums partial over the mesh dims that split the rows
            from torch.distributed.tensor import Partial
            vals = args[2]
            idx = [i.redistribute(self.dmesh, vals.placements)._local_tensor
                   if isinstance(i, DTensor) and i.shape == vals.shape[
                       :i.dim()] else local(i) for i in args[1]]
            out_pl = [Partial() if isinstance(p, Shard) else Replicate()
                      for p in vals.placements]
            return run((args[0]._local_tensor, idx, vals._local_tensor)
                       + tuple(args[3:]), kwargs, out_pl,
                       tuple(args[0].shape))
        if name == "index_put" and isinstance(args[0], DTensor):
            # rows written into a sharded target (a cache) land in the
            # target's shards; the indices and values are made whole
            full = [Replicate()] * self.dmesh.ndim

            def whole(a):
                if isinstance(a, DTensor) and a is not args[0]:
                    return a.redistribute(self.dmesh, full)._local_tensor
                return local(a)
            with self:
                largs = tree_map(whole, args)
            return run(largs, tree_map(whole, kwargs), pl,
                       tuple(args[0].shape))
        if name == "roll" and isinstance(args[0], DTensor):
            dims = args[2] if len(args) > 2 else kwargs.get("dims", ())
            dims = [dims] if isinstance(dims, int) else list(dims)
            if not dims or any(d % args[0].dim() in sharded for d in dims):
                return None
            return run(tree_map(local, args), tree_map(local, kwargs), pl,
                       tuple(args[0].shape))
        return None

    # -- kernels ---------------------------------------------------------
    def kernel(self, name: str, args, kwargs):
        self.t.kernels[name] += 1
        return getattr(self, "_" + name)(*args, **kwargs)

    def _settle(self, t, gather_dims=()):
        """``t`` without Partial placements, and replicated along
        ``gather_dims``."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard
        if not isinstance(t, DTensor):
            return t
        pl = [Replicate() if isinstance(p, Partial)
              or (isinstance(p, Shard) and p.dim in gather_dims) else p
              for p in t.placements]
        if list(pl) != list(t.placements):
            t = t.redistribute(t.device_mesh, pl)
        return t

    def _out(self, like, shape, dtype, dims):
        """A new output of global ``shape``: its dim j sharded as ``like``'s
        dim ``dims[j]`` (None: replicated)."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if not isinstance(like, DTensor):
            return torch.empty(shape, dtype=dtype, device=like.device)
        pl, lshape = [], list(shape)
        for i, p in enumerate(like.placements):
            if isinstance(p, Shard) and p.dim in dims:
                j = dims.index(p.dim)
                pl.append(Shard(j))
                lshape[j] = -(-lshape[j] // like.device_mesh.size(i))
            else:
                pl.append(Replicate())
        local = torch.empty(tuple(lshape), dtype=dtype, device=META)
        return DTensor.from_local(local, like.device_mesh, pl,
                                  run_check=False, shape=tuple(shape),
                                  stride=_contiguous_stride(shape))

    def _charge(self, c) -> None:
        flops, nbytes, dtype = c
        self.t.add_flops(flops, dtype)
        self.t.bytes += nbytes

    def _apply(self, inputs, make, grad_cost):
        """Run ``make()`` for the outputs; under autograd, through a
        Function whose backward charges ``grad_cost`` and returns empty
        gradients shaped as the inputs."""
        needs = torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in inputs)
        if not needs:
            return make()
        counter = self

        class Abstract(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *xs):
                ctx.like = [x if isinstance(x, torch.Tensor) else None
                            for x in xs]
                return make()

            @staticmethod
            def backward(ctx, *gs):
                counter._charge(grad_cost())
                return tuple(None if x is None or not x.requires_grad
                             else torch.empty_like(x) for x in ctx.like)
        return Abstract.apply(*inputs)

    def _flash_attention(self, q, k, v, *, causal, window, q_offset):
        q = self._settle(q)
        k, v = self._settle(k, (1,)), self._settle(v, (1,))
        lq = getattr(q, "_local_tensor", q)
        lk = getattr(k, "_local_tensor", k)
        nseq = q.shape[1] // lq.shape[1]
        dt = str(q.dtype).replace("torch.", "")

        def cost(grad=False):
            f, b, d = _fa.cost(batch=lq.shape[0], q_len=q.shape[1],
                               kv_len=k.shape[1], heads=lq.shape[2],
                               kv_heads=lk.shape[2], head_dim=lq.shape[3],
                               causal=causal, window=window,
                               q_offset=q_offset, dtype=dt, grad=grad)
            qb = 2 * math.prod(lq.shape) * nseq * lq.element_size()
            return f / nseq, b - qb + qb / nseq, d
        self._charge(cost())
        return self._apply((q, k, v),
                           lambda: self._out(q, q.shape, q.dtype,
                                             (0, 1, 2, 3)),
                           lambda: cost(True))

    def _decode_attention(self, q, k_cache, v_cache, lens, *, k_new, v_new,
                          slot_mask):
        q = self._settle(q)
        lq = getattr(q, "_local_tensor", q)
        lk = getattr(k_cache, "_local_tensor", k_cache)
        B, C, Hkv, d = lk.shape
        self._charge(_dec.cost(
            batch=B, heads=lq.shape[2], kv_heads=Hkv, head_dim=d,
            cache_len=C, fold=k_new is not None,
            slot_mask=slot_mask is not None,
            dtype=str(q.dtype).replace("torch.", "")))
        nsplit = k_cache.shape[1] // C
        if nsplit > 1:
            # the cache's shards each give a partial (acc, m, l) per
            # query head, merged across them
            self.t.coll["all-gather"] += (nsplit * B * lq.shape[2]
                                          * (d + 2) * 4)
        return self._out(q, q.shape, q.dtype, (0, 1, 2, 3))

    def _lora_merge(self, W, A, B):
        lw = getattr(W, "_local_tensor", W)
        self._charge(_lm.cost(layers=lw.shape[0], d_in=lw.shape[1],
                              d_out=lw.shape[2], rank=A.shape[-1],
                              dtype=str(W.dtype).replace("torch.", "")))
        return self._out(W, W.shape, W.dtype, (0, 1, 2))

    def _seq_pass(self, x, nbytes: int) -> None:
        """A scan over a sequence sharded n ways passes its carried state
        from each shard to the next."""
        lx = getattr(x, "_local_tensor", x)
        if x.shape[1] != lx.shape[1]:
            self.t.coll["collective-permute"] += nbytes

    def _ssd_scan(self, x, dt, A, Bm, Cm, *, initial_state):
        x, dt, A, Bm, Cm = (self._settle(t) for t in (x, dt, A, Bm, Cm))
        lx = getattr(x, "_local_tensor", x)
        Bl, Sl, Hl, P = lx.shape
        N = Bm.shape[-1]
        kw = dict(batch=Bl, seq=Sl, heads=Hl, head_dim=P, state=N,
                  dtype=str(x.dtype).replace("torch.", ""),
                  initial_state=initial_state is not None)
        self._charge(_ssd.cost(**kw))
        self._seq_pass(x, Bl * Hl * P * N * 4)
        B, S, H, _ = x.shape
        inputs = (x, dt, A, Bm, Cm) + ((initial_state,)
                                       if initial_state is not None else ())
        return self._apply(inputs,
            lambda: (self._out(x, x.shape, x.dtype, (0, 1, 2, 3)),
                     self._out(x, (B, H, P, N), torch.float32,
                               (0, 2, 3, None))),
            lambda: _ssd.cost(**kw, grad=True))

    def _rglru_scan(self, log_a, bx, *, h0):
        log_a, bx = self._settle(log_a), self._settle(bx)
        la = getattr(log_a, "_local_tensor", log_a)
        Bl, Sl, Wl = la.shape
        kw = dict(batch=Bl, seq=Sl, width=Wl, initial_state=h0 is not None)
        self._charge(_rg.cost(**kw))
        self._seq_pass(log_a, Bl * Wl * 4)
        B, S, W = log_a.shape
        inputs = (log_a, bx) + ((h0,) if h0 is not None else ())
        return self._apply(inputs,
            lambda: (self._out(log_a, log_a.shape, torch.float32,
                               (0, 1, 2)),
                     self._out(log_a, (B, W), torch.float32, (0, 2))),
            lambda: _rg.cost(**kw, grad=True))


@contextlib.contextmanager
def _alltoall_collective():
    """DTensor runs a shard-to-shard move on a "cpu" mesh as an all-gather
    and a chunk (Gloo has no all-to-all); the mesh here stands for cards,
    whose move is one all-to-all, so the dry run issues that op."""
    from torch.distributed.tensor import placement_types as pt
    orig = getattr(pt, "shard_dim_alltoall", None)
    if orig is None or not hasattr(torch.ops._dtensor, "shard_dim_alltoall"):
        yield                   # a torch without the op: DTensor's own way
        return

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = mesh._dim_group_names[mesh_dim]
        return torch.ops._dtensor.shard_dim_alltoall(
            input.contiguous(), gather_dim, shard_dim, group)
    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = orig


@contextlib.contextmanager
def _sharded_caches(mesh: Mesh, policy: ShardingPolicy, dmesh, counter):
    """The cache a prefill makes for itself (``transformer.init_cache``)
    laid out by ``cache_specs``, as the reference's ``out_shardings`` lay
    out its cache; a plain tensor would be whole on every device."""
    orig = transformer.init_cache

    def init_cache(cfg, batch, max_len, dtype=None, device="cuda"):
        with counter.quiet():   # the whole cache is never made
            cache = orig(cfg, batch, max_len, dtype, META)
        return _distribute(cache, shd.cache_specs(cfg, cache, mesh,
                                                  dp=policy.dp),
                           dmesh, mesh)
    transformer.init_cache = init_cache
    try:
        yield
    finally:
        transformer.init_cache = orig


class Trace(NamedTuple):
    totals: Totals
    out_bytes: int
    alias_bytes: int


def trace_cell(cell: Cell, mesh: Mesh, policy: ShardingPolicy,
               dmesh) -> Trace:
    """Run ``cell`` once on meta DTensors over ``dmesh`` and count."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    args = [_distribute(s, sp, dmesh, mesh)
            for s, sp in zip(cell.structs, cell.specs)]
    donated = {id(getattr(x, "_local_tensor", x))
               for i in cell.donate for x in _leaves(args[i])}
    counter = _Counter(dmesh)
    with contextlib.ExitStack() as stack:
        # DTensor warns where it makes a replicated DTensor of a plain
        # one-element tensor (implicit replication does so on purpose)
        stack.enter_context(warnings.catch_warnings())
        warnings.simplefilter("ignore", UserWarning)
        stack.enter_context(use_policy(policy))
        stack.enter_context(implicit_replication())
        stack.enter_context(_alltoall_collective())
        stack.enter_context(_sharded_caches(mesh, policy, dmesh, counter))
        stack.enter_context(ops.traced(counter.kernel))
        stack.enter_context(torch.no_grad())    # the train step enables
        stack.enter_context(counter)
        out = cell.fn(*args)
    outs = [getattr(o, "_local_tensor", o) for o in _leaves(out)
            if isinstance(o, torch.Tensor)]
    out_bytes = sum(_nbytes(o) for o in outs)
    alias = sum(_nbytes(o) for o in outs if id(o) in donated)
    del out, args, outs
    return Trace(counter.t, out_bytes, alias)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _depth_points(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh,
                  params_mode: str, dmesh) -> List[Dict]:
    points = []
    for mult in (2, 4):
        c_red, L = _reduced_depth_cfg(cfg, mult)
        pol = cell_policy(c_red, shape, mesh, params_mode)
        cell = build_cell(c_red, shape, mesh, params_mode=params_mode)
        tr = trace_cell(cell, mesh, pol, dmesh)
        t = tr.totals
        points.append({
            "L": L, "flops": t.flops, "f32_flops": t.f32_flops,
            "bytes": t.bytes, "coll": sum(t.coll.values()),
            "coll_by_kind": dict(t.coll),
            "peak_live": t.peak, "out": tr.out_bytes,
            "alias": tr.alias_bytes, "kernels": dict(t.kernels),
            "replicated_ops": dict(t.replicated_ops)})
    return points


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             skip_cost: bool = False, pipeline_mode: bool = False,
             params_mode: str = "fsdp",
             arch_cfg: Optional[ArchConfig] = None,
             mesh: Optional[Mesh] = None,
             shape: Optional[ShapeConfig] = None) -> Dict:
    """One cell's result.  ``mesh`` (default: the production mesh) and
    ``shape`` (default: ``SHAPES[shape_name]``) let a caller dry-run a
    cell of its own, such as a one-card mesh."""
    cfg = arch_cfg or get_arch(arch)
    shape = shape or SHAPES[shape_name]
    ok, reason = cell_is_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": reason}
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size
    t0 = time.time()
    if pipeline_mode:
        return _run_pipeline_cell(cfg, arch, shape_name, shape, n_chips,
                                  skip_cost, t0)

    full = build_cell(cfg, shape, mesh, params_mode=params_mode)
    arg_bytes = sum(local_bytes(s, sp, mesh)
                    for s, sp in zip(full.structs, full.specs))
    with fake_mesh(mesh) as dmesh:
        points = _depth_points(cfg, shape, mesh, params_mode, dmesh)
    L1, L2, Lf = points[0]["L"], points[1]["L"], cfg.n_layers

    def ex(key):
        return rf.extrapolate(points[0][key], points[1][key], L1, L2, Lf)
    out_b, alias_b = ex("out"), ex("alias")
    temp_b = max(0.0, ex("peak_live") - (out_b - alias_b))
    replicated = collections.Counter()
    for p in points:
        replicated.update(p["replicated_ops"])
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.axis_sizes),
        "axes": list(mesh.axis_names),
        "n_chips": n_chips,
        "compile_s": round(time.time() - t0, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_b,
            "temp_bytes": temp_b,
            "alias_bytes": alias_b,
            "peak_per_device": arg_bytes + temp_b + out_b - alias_b,
        },
        "replicated_ops": dict(replicated),
    }
    if not skip_cost:
        flops, bbytes, coll, f32 = (ex(k) for k in ("flops", "bytes", "coll",
                                                    "f32_flops"))
        terms = rf.make_terms(flops, bbytes, coll, f32_flops=f32)
        mf = analytic.model_flops(cfg, shape.global_batch,
                                  shape.seq_len if shape.kind != "decode"
                                  else 1, shape.kind)
        result["cost"] = {
            "per_layer_points": [{k: p[k] for k in ("L", "flops", "bytes",
                                                    "coll")}
                                 for p in points],
            "hlo_flops_per_device": flops,
            "hlo_bytes_per_device": bbytes,
            "coll_bytes_per_device": coll,
            "coll_bytes_by_kind": {k: rf.extrapolate(
                points[0]["coll_by_kind"][k], points[1]["coll_by_kind"][k],
                L1, L2, Lf) for k in points[0]["coll_by_kind"]},
            "roofline": terms.to_dict(),
            "model_flops_total": mf,
            "model_flops_per_device": mf / n_chips,
            "useful_flops_ratio": (mf / n_chips) / flops if flops else 0.0,
        }
    return result


def _run_pipeline_cell(cfg: ArchConfig, arch: str, shape_name: str,
                       shape: ShapeConfig, n_chips: int, skip_cost: bool,
                       t0: float) -> Dict:
    """The pipeline prefill (``build_pipeline_cell``): one stage's layers
    traced on one microbatch, scaled by the microbatches a stage runs;
    the belt hop, one (mb, S, D) block a microbatch and stage boundary,
    is its collective."""
    from repro_torch.distributed.pipeline import build_pipeline_cell
    from repro_torch.launch.mesh import pipeline_stages_for
    seqchunk = bool(os.environ.get("REPRO_PIPE_SEQCHUNK"))
    fn, (params, batch) = build_pipeline_cell(cfg, shape,
                                              total_chips=n_chips,
                                              seq_chunk=seqchunk)
    pmesh = fn.mesh
    n_stages = pipeline_stages_for(cfg.n_layers)
    n_data = pmesh.shape["data"]
    B, S = shape.global_batch, shape.seq_len
    n_micro = fn.n_micro
    per = cfg.n_layers // n_stages
    Bl = B // n_data
    # a data row's share of the batch may be smaller than n_micro (B 32
    # over 32 rows): its microbatch is then one row
    mb, rows = (Bl, S // n_micro) if seqchunk else (max(1, Bl // n_micro), S)
    n_ticks = n_micro + n_stages - 1
    # a stage holds its layers (blocks over 'stage'), embed and head whole
    stage_bytes = sum(_nbytes(t) for t in _leaves(params["blocks"])) \
        // n_stages + sum(_nbytes(t) for k, t in params.items()
                          if k != "blocks")
    batch_bytes = sum(_nbytes(t) for t in _leaves(batch)) // n_data
    hop = mb * rows * cfg.d_model * 2
    stage_cfg = dataclasses.replace(cfg, n_layers=per)
    stage_params = transformer.init_params(stage_cfg, torch.Generator(),
                                           torch.bfloat16, META)
    one = Mesh(("data", "model"), (1, 1))
    x = _meta((mb, rows, cfg.d_model), torch.bfloat16)

    def stage(params, x):
        return _stage_forward(stage_cfg, params, x)
    cell = Cell(stage, (stage_params, x),
                (shd.param_specs(stage_cfg, stage_params, one,
                                 mode="replicated"), shd.P()), ())
    with fake_mesh(one) as dmesh:
        tr = trace_cell(cell, one, cell_policy(stage_cfg, shape, one), dmesh)
    t = tr.totals
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in pmesh.axis_sizes),
        "axes": list(pmesh.axis_names), "n_chips": pmesh.size,
        "compile_s": round(time.time() - t0, 2),
        "memory": {
            "argument_bytes": stage_bytes + batch_bytes,
            "output_bytes": Bl * cfg.padded_vocab * 4,
            "temp_bytes": t.peak + (hop if n_stages > 1 else 0),
            "alias_bytes": 0,
            "peak_per_device": stage_bytes + batch_bytes + t.peak
            + (hop if n_stages > 1 else 0) + Bl * cfg.padded_vocab * 4,
        },
        "replicated_ops": dict(t.replicated_ops),
    }
    if not skip_cost:
        util = n_micro / n_ticks
        coll = float(hop * n_micro) if n_stages > 1 else 0.0
        mf = analytic.model_flops(cfg, B, S, shape.kind)
        # analytic per-device compute: useful work / chips / utilization
        comp_s = (mf / pmesh.size / rf.PEAK_FLOPS["bfloat16"]) / util
        terms = rf.make_terms(comp_s * rf.PEAK_FLOPS["bfloat16"],
                              t.bytes * n_micro, coll)
        result["cost"] = {
            "pipeline": {"n_stages": n_stages, "n_micro": n_micro,
                         "n_ticks": n_ticks, "utilization": util,
                         "seq_chunk": seqchunk},
            "stage_flops_per_device": t.flops * n_micro,
            "coll_bytes_per_device": coll,
            "roofline": terms.to_dict(),
            "model_flops_total": mf,
            "model_flops_per_device": mf / pmesh.size,
        }
    return result


def _stage_forward(cfg: ArchConfig, params, x):
    """One belt stage's work on one microbatch: its layers in order."""
    from repro_torch.models import mamba2
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :].expand(
        x.shape[0], S)
    for kind, i, a in transformer._layers(cfg):
        p = transformer.layer_params(params["blocks"][kind], i)
        if a >= 0:
            x = transformer.attn_layer_fwd(cfg, p, x, positions)[0]
        else:
            x = mamba2.ssm_block_fwd(cfg, p, x)[0]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-cost", action="store_true")
    ap.add_argument("--pipeline", action="store_true",
                    help="dry-run the PipeBoost pipeline-parallel prefill")
    ap.add_argument("--params-mode", default="fsdp",
                    choices=["fsdp", "model", "replicated", "2dtp"],
                    help="weight sharding strategy (serving TP = 'model')")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        from repro_torch.configs.base import cells as cell_list
        cells = [(a, s) for a, s, ok, _ in cell_list() if ok]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'multipod' if mp else 'singlepod'}" + \
                ("__pipeline" if args.pipeline else "") + \
                ("_seqchunk" if (args.pipeline and
                                 os.environ.get("REPRO_PIPE_SEQCHUNK"))
                 else "") + \
                (f"__{args.params_mode}" if args.params_mode != "fsdp" else "")
            try:
                res = run_cell(arch, shape, multi_pod=mp,
                               skip_cost=args.skip_cost,
                               pipeline_mode=args.pipeline,
                               params_mode=args.params_mode)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(res, f, indent=1)
                if "skipped" in res:
                    print(f"[SKIP] {tag}: {res['skipped']}")
                    continue
                peak = res["memory"]["peak_per_device"] / 2**30
                line = (f"[OK]   {tag}: trace={res['compile_s']}s "
                        f"peak/dev={peak:.2f}GiB")
                if "cost" in res:
                    r = res["cost"]["roofline"]
                    line += (f" dom={r['dominant']}"
                             f" c={r['compute_s']*1e3:.2f}ms"
                             f" m={r['memory_s']*1e3:.2f}ms"
                             f" n={r['collective_s']*1e3:.2f}ms")
                print(line, flush=True)
            except Exception as e:  # record failures, keep sweeping
                failures += 1
                print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
                with open(os.path.join(args.out, tag + ".err"), "w") as f:
                    f.write(traceback.format_exc())
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
