"""Serving engine: request lifecycle + continuous batching over a
slot-indexed KV cache, with epoch-based LoRA adapter scheduling and the
recovery surfaces of paper §4.4 (the port of ``repro/serving/engine.py``).

Slots: the batcher owns one cache of ``n_slots`` rows (attention K/V, and
each SSM or recurrent layer's conv window and state); a new request's
prefill is written into a free slot while the other slots keep decoding,
so requests join and leave the batch at token granularity.  Per-slot positions ride in
``cache["pos"]`` (n_slots,).

Hot path:
* **One captured decode step**: on the card the decode step and the
  sampler (``_decode_sample``) are captured once as a CUDA graph, at the
  first decode step after an eager warm-up on a side stream, and every
  later step replays it (``compile_stats()["decode_compiles"]``, the
  reference's one ``jax.jit`` of ``fused_decode``).  The graph reads and
  writes static storage only: the step's tokens and active mask, every
  cache leaf and ``pos``, and the parameter leaves.  So nothing the graph
  reads is ever rebound: admissions, snapshot imports, reconstructions and
  re-lays write the cache in place (``index_copy_``, ``copy_``), and an
  adapter switch copies the leaves that differ between parameter sets into
  the batcher's own storage for them (``owned``), never a second graph.
  Exactly one (n_slots,) device->host read per step (the sampled tokens).
  On the CPU the step runs eagerly.
* **Bucketed prefill**: prompts are right-padded to power-of-two buckets
  (``bucket_sizes``) and same-bucket requests prefill together; causal
  attention keeps trailing pads out of real positions, logits are gathered
  at the true prompt end (``forward(..., last_index=...)``) and
  ``cache["pos"]`` records the true length so decode masks the pad K/V.
  Bucketing needs a pure-attention model with a full-length cache
  (``_can_bucket``); an SSM or hybrid recurrent model prefills each prompt
  alone at its exact length, since pad tokens would enter its running
  state.  Prefill runs eagerly.
* **Free slots are frozen**: their ``pos`` does not advance and their
  token passes through, so inactive lanes never reach the bookkeeping.

Recovery: ``drain`` exports each in-flight request's slot as a
``KVSnapshot``; ``import_snapshot(s)`` lands snapshots in free slots with
no prefill (N requests in one scatter); ``reconstruct_inflight`` and
``relay_inflight`` rebuild the layers whose state died for the live batch
(``core.kv_reconstruct``).

Not ported yet (see ROADMAP.md): the prefix cache and the pipeline prefill
backend.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import (Callable, Dict, FrozenSet, Iterable, Iterator, List,
                    Optional, Sequence, Set, Tuple)

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.adapter_scheduler import EpochSchedulerPolicy
from repro_torch.core.kv_reconstruct import reconstruct_cache
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.serving.snapshot import (KINDS, KVSnapshot, export_slot,
                                          export_slots, leaf_tensor)

BUCKET_MIN = 16

LeafPath = Tuple[str, ...]


def quantized_greedy(logits):
    """Quantize-then-argmax greedy sampler: sub-1e-3 fp differences between
    batched and solo kernels land in the same bin, so the pick only flips
    where near-tied logits straddle a bin edge."""
    return torch.argmax(torch.round(logits.float() * 1e3), dim=-1)


def bucket_sizes(max_len: int, bmin: int = BUCKET_MIN) -> List[int]:
    """Prefill length buckets for ``max_len``: powers of two from ``bmin``
    up, with ``max_len`` itself as the final bucket."""
    out = []
    b = bmin
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return out


@dataclass
class ServeRequest:
    rid: int
    tokens: np.ndarray                   # prompt (S,)
    max_new_tokens: int
    adapter: Optional[str] = None
    arrival: Optional[float] = None      # stamped at submit if unset
    generated: List[int] = field(default_factory=list)
    slot: int = -1
    done: bool = False
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    eos_id: Optional[int] = None
    # decode state exported at drain time (crash migration), carried so a
    # survivor resumes without prefill; excluded from equality
    snapshot: Optional[KVSnapshot] = field(default=None, repr=False,
                                           compare=False)


def _argmax(logits):
    return torch.argmax(logits, dim=-1)


def _leaves(tree, path: LeafPath = ()) -> Iterator[Tuple[LeafPath,
                                                         torch.Tensor]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def varying_leaves(base, others: Iterable) -> FrozenSet[LeafPath]:
    """Paths of the parameter leaves that some tree of ``others`` holds as
    another tensor than ``base`` does (a merged adapter's targets:
    ``merge_lora`` shares every other leaf)."""
    base_leaves = dict(_leaves(base))
    return frozenset(path for tree in others for path, t in _leaves(tree)
                     if base_leaves.get(path) is not t)


def _own_copy(tree, owned: FrozenSet[LeafPath], path: LeafPath = ()):
    """A copy of the dict structure of ``tree`` whose ``owned`` leaves are
    cloned and whose other leaves are shared."""
    out = {}
    for k, v in tree.items():
        p = path + (k,)
        if isinstance(v, dict):
            out[k] = _own_copy(v, owned, p)
        else:
            out[k] = v.clone() if p in owned else v
    return out


class ContinuousBatcher:
    """Slot-based continuous batching over the stacked-cache model.

    ``owned``: paths of the parameter leaves that differ between the
    parameter sets this batcher will be given (``varying_leaves``); it
    keeps its own copy of each and a swap of ``params`` copies into them,
    so a captured decode step serves every set."""

    def __init__(self, cfg: ArchConfig, params, n_slots: int, max_len: int,
                 sampler: Optional[Callable] = None,
                 owned: Iterable[LeafPath] = ()):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.device = params["embed"].device
        self._owned = frozenset(owned)
        self._params = _own_copy(params, self._owned)
        self.cache = transformer.init_cache(
            cfg, n_slots, max_len, params["embed"].dtype, self.device)
        self.cache["pos"] = torch.zeros((n_slots,), dtype=torch.int32,
                                        device=self.device)
        self.active: Dict[int, ServeRequest] = {}     # slot -> request
        self.free: List[int] = list(range(n_slots))
        # padded prefill is exact only for pure attention with a
        # full-length cache: a ring buffer would evict real K/V
        self._can_bucket = (
            set(cfg.layer_kinds()) <= {"attn"}
            and transformer.attn_cache_capacity(cfg, max_len) == max_len)
        # static step I/O: refilled in place only when slot membership
        # changes; the step writes its sampled tokens back into _dev_tokens
        self._dev_tokens = torch.zeros((n_slots,), dtype=torch.int32,
                                       device=self.device)
        self._dev_active = torch.zeros((n_slots,), dtype=torch.bool,
                                       device=self.device)
        self._io_dirty = True
        # the captured decode step (card only) and the kernel launches one
        # replay makes
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_launches: Dict[str, int] = {}
        self.n_decode_captures = 0
        self._prefill_shapes: Set[Tuple[int, int]] = set()
        # hot-path counters
        self.n_decode_steps = 0
        self.decode_time_s = 0.0
        self.n_prefill_calls = 0
        self.n_prefill_reqs = 0
        self.n_prefill_tokens = 0        # real (unpadded) tokens prefilled
        # migration and rebuild counters (snapshot imports; tokens whose
        # prefill was skipped because their state arrived with them)
        self.n_migrated_in = 0
        self.migrated_tokens_in = 0
        self.n_batched_imports = 0       # import_snapshots scatters
        self.n_relay_scatters = 0        # relay_inflight scatters
        self._sampler: Callable = sampler or _argmax

    # ------------------------------------------------------------------
    # parameters and sampler
    # ------------------------------------------------------------------
    @property
    def params(self):
        """The parameter tree the decode step reads."""
        return self._params

    @params.setter
    def params(self, new) -> None:
        """Swap the parameter set: a leaf the batcher owns is copied into
        its storage in place and a leaf shared with the current set is
        kept.  Any other leaf that differs is rebound, which a captured
        decode step forbids (it would go on reading the old tensor), so
        then it raises."""
        self._swap(self._params, new, ())

    def _swap(self, dst: Dict, src: Dict, path: LeafPath) -> None:
        for k, v in src.items():
            p = path + (k,)
            if isinstance(v, dict):
                self._swap(dst[k], v, p)
            elif dst[k] is v:
                continue
            elif p in self._owned:
                dst[k].copy_(v)
            elif self._graph is not None:
                raise RuntimeError(
                    f"parameter {'/'.join(p)} is not the captured decode "
                    f"step's tensor and the batcher does not own it (pass "
                    f"it in ``owned``)")
            else:
                dst[k] = v

    @property
    def sampler(self) -> Callable:
        return self._sampler

    @sampler.setter
    def sampler(self, fn: Callable) -> None:
        # the sampler is part of the captured step, so a new one is
        # captured afresh (as the reference retraces), never on an adapter
        # switch
        self._sampler = fn
        self._graph = None
        self._graph_launches = {}
        self.n_decode_captures = 0

    # ------------------------------------------------------------------
    # the hot-path functions
    # ------------------------------------------------------------------
    def _decode_sample(self) -> None:
        """One decode step over the static step I/O: reads ``_dev_tokens``
        and ``_dev_active``, advances the cache in place and writes the
        sampled tokens back into ``_dev_tokens``."""
        toks, active = self._dev_tokens, self._dev_active
        logits, _ = transformer.decode_step(self.cfg, self._params,
                                            {"tokens": toks}, self.cache)
        # freeze free slots: their position must not advance (a wrapped
        # ring-buffer pos would corrupt a later admission) and their
        # garbage logits must not reach EOS bookkeeping
        self.cache["pos"].sub_((~active).to(torch.int32))
        nxt = self._sampler(logits).to(torch.int32)
        toks.copy_(torch.where(active, nxt, toks))

    def _decode(self) -> None:
        """Run the decode step: eagerly on the CPU; on the card the first
        step runs eagerly on a side stream (the warm-up that does every
        first-call's work: the kernel build, shared-memory attributes,
        workspaces) and is then captured as one CUDA graph, which every
        later step replays.  A failed capture raises."""
        if self.device.type != "cuda":
            self._decode_sample()
        elif self._graph is None:
            self._capture()
        else:
            self._graph.replay()
            ops.add_launch_counts(self._graph_launches)

    def _capture(self) -> None:
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._decode_sample()           # this step, eagerly
        cur.wait_stream(side)
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        # thread-local: another thread's CUDA calls (none are made by the
        # engine's fill thread) cannot invalidate the capture
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._decode_sample()
        # the wrappers counted while capturing, but nothing launched: keep
        # the counts for the replays
        delta = {k: n - before[k] for k, n in ops.launch_counts().items()}
        ops.add_launch_counts({k: -n for k, n in delta.items()})
        self._graph, self._graph_launches = graph, delta
        self.n_decode_captures += 1

    def _prefill_write(self, toks, last_idx, slots):
        """Prefill padded prompts (P, bucket) and write the first
        ``len(slots)`` rows into their slots in place (one ``index_copy_``
        per cache leaf); the remaining rows are padding."""
        self._prefill_shapes.add(tuple(toks.shape))
        logits, c1 = transformer.forward(
            self.cfg, self._params, {"tokens": toks}, mode="prefill",
            max_len=self.max_len, last_index=last_idx)
        n = slots.shape[0]
        self._scatter({kind: {leaf: rows[:, :n]
                              for leaf, rows in c1[kind].items()}
                       for kind in KINDS if kind in c1},
                      slots, c1["pos"][:n])
        return self._sampler(logits).to(torch.int32)

    def _scatter(self, rows: Dict[str, Dict[str, torch.Tensor]], slots,
                 pos) -> None:
        """Write per-request rows (kind -> leaf -> (L, n, ...)) and
        positions (n,) into ``slots`` in place: one ``index_copy_`` per
        cache leaf and one for ``pos``, for any number of requests."""
        dst = torch.as_tensor(slots, device=self.device).long()
        for kind, leaves in rows.items():
            for leaf, t in leaves.items():
                self.cache[kind][leaf].index_copy_(1, dst, t)
        self.cache["pos"].index_copy_(0, dst, torch.as_tensor(
            pos, dtype=torch.int32, device=self.device))

    # ------------------------------------------------------------------
    # prefill / admission
    # ------------------------------------------------------------------
    def _total_len(self, req: ServeRequest) -> int:
        return len(req.tokens) + len(req.generated)

    def bucket_for(self, req: ServeRequest) -> int:
        """Padded prefill length for ``req`` (exact length when the model
        can't be padded safely — see ``_can_bucket``)."""
        L = self._total_len(req)
        if not self._can_bucket:
            return L
        for b in bucket_sizes(self.max_len):
            if b >= L:
                return b
        return L        # out-of-contract (L > max_len): exact length

    def admit(self, req: ServeRequest) -> bool:
        """Prefill ``req`` into a free slot; False if the batch is full.
        A request that carries ``generated`` tokens is prefilled over
        prompt + generated, so greedy decoding continues where it left
        off."""
        if not self.free:
            return False
        self.admit_batch([req])
        return True

    def admit_batch(self, reqs: Sequence[ServeRequest]) -> None:
        """Prefill several requests in one batched, bucketed call (the
        caller guarantees ``len(reqs) <= len(self.free)``).  Models that
        can't pad safely are prefilled one by one at exact length."""
        if len(reqs) > len(self.free):
            raise ValueError(f"{len(reqs)} requests for {len(self.free)} "
                             "free slots")
        if not reqs:
            return
        if not self._can_bucket:
            for r in reqs:
                self._admit_rows([r])
        else:
            self._admit_rows(list(reqs))

    def _admit_rows(self, reqs: List[ServeRequest]) -> None:
        bucket = max(self.bucket_for(r) for r in reqs)
        # the bucketed path always prefills n_slots rows (pad rows are
        # masked by ``valid``), as the reference does for its compile cache
        P = self.n_slots if self._can_bucket else len(reqs)
        toks = np.zeros((P, bucket), np.int64)
        last_idx = np.zeros((P,), np.int32)
        slots = np.zeros((len(reqs),), np.int32)
        assigned: List[Tuple[int, int, ServeRequest]] = []
        for i, req in enumerate(reqs):
            t = np.asarray(req.tokens, np.int64)
            if req.generated:
                t = np.concatenate([t, np.asarray(req.generated, np.int64)])
            L = len(t)
            self.n_prefill_tokens += L
            toks[i, :L] = t
            last_idx[i] = L - 1
            slot = self.free.pop()
            req.slot = slot
            slots[i] = slot
            assigned.append((i, slot, req))
        dev = self.device
        first = self._prefill_write(torch.from_numpy(toks).to(dev),
                                    torch.from_numpy(last_idx).to(dev),
                                    torch.from_numpy(slots).to(dev))
        first_host = first.cpu().numpy()   # admission reads first tokens
        self.n_prefill_calls += 1
        self.n_prefill_reqs += len(reqs)
        for i, slot, req in assigned:
            tok = int(first_host[i])
            req.generated.append(tok)
            at_eos = req.eos_id is not None and tok == req.eos_id
            if len(req.generated) >= req.max_new_tokens or at_eos:
                req.done = True       # satisfied at admission
                self.free.append(slot)
                req.slot = -1
            else:
                self.active[slot] = req
        self._io_dirty = True

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _load_io(self) -> None:
        """Refill the static step I/O from the active slots, in place."""
        toks = np.zeros((self.n_slots,), np.int32)
        act = np.zeros((self.n_slots,), bool)
        for slot, req in self.active.items():
            toks[slot] = req.generated[-1]
            act[slot] = True
        self._dev_tokens.copy_(torch.from_numpy(toks))
        self._dev_active.copy_(torch.from_numpy(act))
        self._io_dirty = False

    def step(self) -> List[ServeRequest]:
        """One decode step for all active slots; returns finished requests."""
        if not self.active:
            return []
        t0 = time.perf_counter()
        if self._io_dirty:
            self._load_io()
        self._decode()
        nxt_host = self._dev_tokens.cpu().numpy()  # THE one host read a step
        self.n_decode_steps += 1
        finished = []
        for slot, req in list(self.active.items()):
            tok = int(nxt_host[slot])
            req.generated.append(tok)
            at_eos = req.eos_id is not None and tok == req.eos_id
            if len(req.generated) >= req.max_new_tokens or at_eos:
                req.done = True
                finished.append(req)
                del self.active[slot]
                self.free.append(slot)
        if finished:
            self._io_dirty = True        # active mask changed
        self.decode_time_s += time.perf_counter() - t0
        return finished

    def warm_decode(self) -> None:
        """Capture the decode step now, on an idle batch (a server's
        start): a step with every slot frozen changes no live state, so the
        first real step after an admission or an import replays instead of
        capturing."""
        if self.active:
            raise ValueError("warm_decode needs an idle batch")
        self._load_io()
        self._decode()

    # ------------------------------------------------------------------
    # migration: drain, export, import
    # ------------------------------------------------------------------
    def drain(self, export_state: bool = True) -> List[ServeRequest]:
        """Pull every in-flight request out of the batch (server crash /
        re-route): slots are freed, requests keep their generated prefix so
        ``admit`` elsewhere resumes them exactly.  With ``export_state``
        each also carries a ``KVSnapshot`` of its slot, so a survivor can
        import it and decode on with zero prefilled tokens."""
        items = sorted(self.active.items())
        if export_state and items:
            # batched export: one host copy per kind leaf in all
            snaps = export_slots(self.cache, [s for s, _ in items],
                                 arch=self.cfg.name, max_len=self.max_len)
            for (_, req), snap in zip(items, snaps):
                req.snapshot = snap
        drained = []
        for slot, req in items:
            req.slot = -1
            self.free.append(slot)
            drained.append(req)
        self.active.clear()
        self._io_dirty = True
        return drained

    def export_snapshot(self, slot: int) -> KVSnapshot:
        """Snapshot ``slot``'s state to host memory (see serving.snapshot)."""
        return export_slot(self.cache, slot, arch=self.cfg.name,
                           max_len=self.max_len)

    def _upload(self, snaps: Sequence[KVSnapshot]
                ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Stack the snapshots' rows of each leaf (L, n, ...) on the host
        and copy them to the device, one copy per leaf."""
        rows: Dict[str, Dict[str, torch.Tensor]] = {}
        for kind, leaves in snaps[0].rows.items():
            rows[kind] = {}
            for leaf in leaves:
                name = snaps[0].leaf_dtype(kind, leaf)
                parts = [s.rows[kind][leaf] for s in snaps]
                if name == "bfloat16":      # uint16 or ml_dtypes bits
                    parts = [np.ascontiguousarray(a).view(np.int16)
                             for a in parts]
                rows[kind][leaf] = leaf_tensor(np.stack(parts, axis=1),
                                               name, self.device)
        return rows

    def import_snapshot(self, req: ServeRequest, snap: KVSnapshot) -> bool:
        """Resume ``req`` from a migrated snapshot in a free slot: its rows
        are written into the cache in place and the request decodes from
        its last sampled token on the next ``step``, with no prefill.
        False if the batch is full or the snapshot does not fit this
        batcher."""
        if not self.free:
            return False
        if not snap.compatible_with(self.cache, self.cfg.name, self.max_len):
            return False
        slot = self.free.pop()
        self._scatter(self._upload([snap]), [slot], [snap.pos])
        req.slot = slot
        self.active[slot] = req
        self._io_dirty = True
        self.n_migrated_in += 1
        self.migrated_tokens_in += snap.pos
        return True

    def import_snapshots(self, pairs: Sequence[Tuple[ServeRequest,
                                                     KVSnapshot]]
                         ) -> List[ServeRequest]:
        """Batched migration import: the snapshots of N displaced requests
        land in ONE scatter (one host-to-device copy and one
        ``index_copy_`` per leaf) instead of N ``import_snapshot`` calls.
        Imports as many pairs as there are free slots and compatible
        snapshots (in order) and returns the requests admitted; the caller
        re-routes the rest."""
        usable: List[Tuple[ServeRequest, KVSnapshot]] = []
        for req, snap in pairs:
            if len(usable) >= len(self.free):
                break
            if snap is not None and snap.compatible_with(
                    self.cache, self.cfg.name, self.max_len):
                usable.append((req, snap))
        if not usable:
            return []
        slots: List[int] = []
        out: List[ServeRequest] = []
        for req, snap in usable:
            slot = self.free.pop()
            slots.append(slot)
            req.slot = slot
            self.active[slot] = req
            self.n_migrated_in += 1
            self.migrated_tokens_in += snap.pos
            out.append(req)
        snaps = [s for _, s in usable]
        self._scatter(self._upload(snaps), slots, [s.pos for s in snaps])
        self.n_batched_imports += 1
        self._io_dirty = True
        return out

    def warm_import(self) -> None:
        """Run the import path once as a semantic no-op — slot 0's own rows
        written back to itself — so the first real migration pays no
        first-call work inside the post-crash window."""
        rows = {kind: {leaf: arr[:, :1].clone()
                       for leaf, arr in self.cache[kind].items()}
                for kind in KINDS if kind in self.cache}
        self._scatter(rows, [0], self.cache["pos"][:1].clone())

    # ------------------------------------------------------------------
    # in-flight rebuild (partial crash, repartition)
    # ------------------------------------------------------------------
    @staticmethod
    def _state_tokens(req: ServeRequest) -> np.ndarray:
        """The tokens whose state a slot holds: prompt plus generated
        prefix, less the last sampled token (the next step's input)."""
        seq = np.asarray(req.tokens, np.int64)
        tail = req.generated[:-1]
        if tail:
            seq = np.concatenate([seq, np.asarray(tail, np.int64)])
        return seq

    def reconstruct_inflight(self, has_state: Sequence[bool]
                             ) -> Dict[str, float]:
        """Partial-crash recovery (paper §4.4.2) for the live batch:
        rebuild only the layers whose state died, slot by slot, with
        ``core.kv_reconstruct.reconstruct_cache`` on a view of the slot,
        so the rebuilt rows land in the cache in place.  Requests stay in
        their slots; decode resumes exactly.  Returns the summed per-layer
        work stats."""
        totals: Dict[str, float] = {}
        if not self.active or all(has_state):
            return totals
        for slot, req in sorted(self.active.items()):
            seq = torch.from_numpy(self._state_tokens(req))[None]
            view = {"pos": self.cache["pos"][slot:slot + 1]}
            for kind in KINDS:
                if kind in self.cache:
                    view[kind] = {leaf: arr[:, slot:slot + 1]
                                  for leaf, arr in self.cache[kind].items()}
            _, stats = reconstruct_cache(
                self.cfg, self._params, {"tokens": seq.to(self.device)},
                view, has_state, max_len=self.max_len)
            for k, v in stats.items():
                totals[k] = totals.get(k, 0.0) + float(v)
            totals["reconstructed_reqs"] = \
                totals.get("reconstructed_reqs", 0.0) + 1.0
        return totals

    def relay_inflight(self, has_state: Sequence[bool]) -> Dict[str, float]:
        """Repartition re-lay of the live batch onto a changed partition:
        rebuild the layers whose state died for EVERY active slot and land
        all rebuilt rows in ONE in-place scatter.  Slots with equal
        sequence length share one batched ``reconstruct_cache`` call
        (exact, no padding), so the recompute scales with the number of
        distinct lengths.  Requests keep their slots and their sampled
        prefix; decode resumes with zero prefilled tokens.  Returns the
        work stats summed over requests, under ``relayed_reqs``."""
        totals: Dict[str, float] = {}
        if not self.active or all(has_state):
            return totals
        groups: Dict[int, List[Tuple[int, np.ndarray]]] = {}
        for slot, req in sorted(self.active.items()):
            seq = self._state_tokens(req)
            groups.setdefault(len(seq), []).append((slot, seq))
        rows: Dict[str, Dict[str, List[torch.Tensor]]] = {}
        slots: List[int] = []
        pos: List[int] = []
        for S, members in sorted(groups.items()):
            idx = torch.tensor([s for s, _ in members], dtype=torch.long,
                               device=self.device)
            view = {"pos": self.cache["pos"].index_select(0, idx)}
            for kind in KINDS:
                if kind in self.cache:
                    view[kind] = {leaf: arr.index_select(1, idx)
                                  for leaf, arr in self.cache[kind].items()}
            tokens = torch.from_numpy(np.stack([q for _, q in members]))
            _, stats = reconstruct_cache(
                self.cfg, self._params, {"tokens": tokens.to(self.device)},
                view, has_state, max_len=self.max_len)
            for kind in KINDS:
                for leaf, t in view.get(kind, {}).items():
                    rows.setdefault(kind, {}).setdefault(leaf, []).append(t)
            slots += [s for s, _ in members]
            pos += [S] * len(members)
            # the work counts are per request: scale by the group's size
            for k, v in stats.items():
                totals[k] = totals.get(k, 0.0) + float(v) * len(members)
            totals["relayed_reqs"] = totals.get("relayed_reqs", 0.0) \
                + float(len(members))
        self._scatter({kind: {leaf: torch.cat(ts, dim=1)
                              for leaf, ts in leaves.items()}
                       for kind, leaves in rows.items()}, slots, pos)
        self.n_relay_scatters += 1
        self._io_dirty = True
        return totals

    @property
    def n_active(self) -> int:
        return len(self.active)

    # ------------------------------------------------------------------
    # instrumentation
    # ------------------------------------------------------------------
    def compile_stats(self) -> Dict[str, int]:
        """The reference's compile counts: ``decode_compiles`` counts
        captures of the decode step (1 for the batcher's life on the card,
        0 on the CPU, where the step runs eagerly; a new sampler captures
        afresh), ``prefill_compiles`` the distinct prefill shapes run,
        which the bucket ladder bounds."""
        return {"decode_compiles": self.n_decode_captures,
                "prefill_compiles": len(self._prefill_shapes)}

    def hotpath_stats(self) -> Dict[str, float]:
        s = {
            "n_decode_steps": float(self.n_decode_steps),
            "decode_time_s": self.decode_time_s,
            "decode_steps_per_s": (self.n_decode_steps / self.decode_time_s
                                   if self.decode_time_s > 0 else 0.0),
            "n_prefill_calls": float(self.n_prefill_calls),
            "n_prefill_reqs": float(self.n_prefill_reqs),
            "n_batched_imports": float(self.n_batched_imports),
            "n_relay_scatters": float(self.n_relay_scatters),
            "n_prefill_tokens": float(self.n_prefill_tokens),
        }
        s.update({k: float(v) for k, v in self.compile_stats().items()})
        return s


class ServingEngine:
    """Request dispatcher + continuous batcher + adapter epochs.

    ``adapter_params`` maps an adapter name to its merged params (the
    LoRA-merge kernel's output); an epoch switch copies the leaves that
    differ from the base (the batcher owns its copy of each) into the
    batcher's parameters."""

    def __init__(self, cfg: ArchConfig, params, *, n_slots: int = 4,
                 max_len: int = 256,
                 policy: Optional[EpochSchedulerPolicy] = None,
                 adapter_params: Optional[Dict[str, object]] = None):
        self.cfg = cfg
        self.adapter_params = adapter_params or {}
        self.batcher = ContinuousBatcher(
            cfg, params, n_slots, max_len,
            owned=varying_leaves(params, self.adapter_params.values()))
        self.policy = policy or EpochSchedulerPolicy()
        self.policy_state = self.policy.make_state()
        self.base_params = params
        self.active_adapter: Optional[str] = None
        self.clock = 0.0
        self.completed: List[ServeRequest] = []
        self.n_adapter_switches = 0

    def submit(self, req: ServeRequest):
        if req.arrival is None:
            req.arrival = self.clock
        self.policy.enqueue(self.policy_state, _PolicyItem(req))

    def _switch_adapter(self, name: Optional[str]):
        if name == self.active_adapter:
            return
        self.batcher.params = self.base_params if name is None \
            else self.adapter_params[name]
        self.active_adapter = name
        self.n_adapter_switches += 1

    def _admit_pending(self) -> List[ServeRequest]:
        """Admit queued requests per the adapter policy into free slots.

        Epoch barrier: merged-LoRA swaps the weights for every active slot,
        so a different adapter is admitted only once the batch has drained
        (the paper's epoch semantics, Fig. 5).  Same-bucket requests within
        a policy batch prefill together.  Returns requests already
        satisfied at admission."""
        satisfied: List[ServeRequest] = []
        while self.batcher.free:
            nxt = self.policy.peek_adapter(self.policy_state)
            if nxt is None:
                break
            nxt_name = None if nxt == "__base__" else nxt
            if self.batcher.active and nxt_name != self.active_adapter:
                break  # drain before switching (epoch barrier)
            adapter, batch = self.policy.next_batch(self.policy_state)
            if adapter is None:
                break
            self._switch_adapter(adapter if adapter != "__base__" else None)
            n_free = len(self.batcher.free)
            if len(batch) > n_free:
                self.policy.requeue_front(self.policy_state, batch[n_free:])
                batch = batch[:n_free]
            groups: Dict[int, List[_PolicyItem]] = {}
            for item in batch:
                groups.setdefault(self.batcher.bucket_for(item.req),
                                  []).append(item)
            for _, items in sorted(groups.items()):
                self.batcher.admit_batch([it.req for it in items])
                for it in items:
                    if it.req.first_token_at is None:
                        it.req.first_token_at = self.clock
                    if it.req.done:
                        it.req.finished_at = self.clock
                        self.completed.append(it.req)
                        satisfied.append(it.req)
        return satisfied

    def step(self, now: Optional[float] = None) -> List[ServeRequest]:
        """One scheduling + decode tick; returns requests finished this
        tick.  With ``now`` the caller owns the clock; without it the
        engine advances a logical step clock by 1 per decode."""
        if now is not None:
            self.clock = now
        finished = self._admit_pending()
        if not self.batcher.active:
            return finished
        done = self.batcher.step()
        if now is None:
            self.clock += 1.0
        for r in done:
            r.finished_at = self.clock
            self.completed.append(r)
        return finished + done

    def _epoch_admits(self, name: Optional[str]) -> bool:
        """Whether requests of adapter ``name`` may enter the batch now:
        the adapter must be loaded, and a busy batch must be on it
        (merged-LoRA weights apply to every slot).  An idle batch switches
        to it."""
        if name is not None and name not in self.adapter_params:
            return False
        if self.batcher.active:
            return name == self.active_adapter
        self._switch_adapter(name)
        return True

    def admit_with_state(self, req: ServeRequest) -> bool:
        """Admit a migrated request by importing its ``KVSnapshot`` into a
        free slot — the state-preserving alternative to ``submit`` for
        requests drained off a crashed server: zero prompt tokens are
        prefilled, decode continues from its last sampled token.

        Returns False (snapshot kept, for the re-prefill fallback) when
        there is no free slot, the snapshot does not fit, the request needs
        an adapter this engine lacks, or the batch is mid-epoch on another
        adapter."""
        snap = req.snapshot
        if snap is None or not self.batcher.free:
            return False
        if not self._epoch_admits(req.adapter):
            return False
        if not self.batcher.import_snapshot(req, snap):
            return False
        if req.arrival is None:
            req.arrival = self.clock
        req.snapshot = None
        return True

    def admit_with_state_batch(self, reqs: Sequence[ServeRequest]
                               ) -> List[ServeRequest]:
        """Batched ``admit_with_state``: displaced requests sharing an
        adapter import their snapshots in ONE scatter.  The same guards
        apply; returns the requests admitted (the caller re-prefills the
        rest)."""
        accepted: List[ServeRequest] = []
        groups: Dict[Optional[str], List[ServeRequest]] = {}
        for r in reqs:
            if r.snapshot is not None:
                groups.setdefault(r.adapter, []).append(r)
        for name, group in groups.items():
            if not self._epoch_admits(name):
                continue
            for r in self.batcher.import_snapshots(
                    [(r, r.snapshot) for r in group]):
                if r.arrival is None:
                    r.arrival = self.clock
                r.snapshot = None
                accepted.append(r)
        return accepted

    def drain_inflight(self, export_state: bool = True) -> List[ServeRequest]:
        """Remove every in-flight AND queued request (crash re-route);
        in-flight requests keep their generated prefix and, with
        ``export_state``, their KV snapshot."""
        out = self.batcher.drain(export_state=export_state)
        while True:
            adapter, batch = self.policy.next_batch(self.policy_state)
            if adapter is None:
                break
            out.extend(item.req for item in batch)
        return out

    def reconstruct_inflight(self, has_state) -> Dict[str, float]:
        """Partial-crash in-place rebuild of the live batch's lost layers
        (see ContinuousBatcher.reconstruct_inflight)."""
        return self.batcher.reconstruct_inflight(has_state)

    def relay_inflight(self, has_state) -> Dict[str, float]:
        """Repartition re-lay: rebuild lost layers for the whole live batch
        and land them in one scatter (see ContinuousBatcher.relay_inflight)."""
        return self.batcher.relay_inflight(has_state)

    @property
    def idle(self) -> bool:
        """Nothing in flight and nothing queued."""
        return (not self.batcher.active
                and self.policy.peek_adapter(self.policy_state) is None)

    def hotpath_stats(self) -> Dict[str, float]:
        return self.batcher.hotpath_stats()

    def run(self, max_steps: int = 10_000) -> List[ServeRequest]:
        """Drain all queues: admit per the adapter policy, decode until done."""
        for _ in range(max_steps):
            self.step()
            if self.idle:
                break
        return self.completed


class _PolicyItem:
    """Adapter-scheduler item wrapping a ServeRequest."""

    def __init__(self, req: ServeRequest):
        self.req = req
        self.adapter = req.adapter or "__base__"
        self.arrival = req.arrival
        self.service = 0.0
