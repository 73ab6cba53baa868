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

Prefix reuse (``serving/prefix_cache.py``): with a ``PrefixCache``
attached, an admission whose prompt shares a cached prefix imports the
cached rows in the one scatter the imports use and walks only its uncached
suffix through the decode step (the captured graph on the card, replayed);
finished and drained prompts deposit their rows through ``export_slots``.

Pipeline prefill (``set_pipeline_prefill``): while the host engine is
mid-load in pipeline strategy, bucketed admissions run the engine's belt
(``distributed/pipeline.py``) over the partial stage chain; its cache has
the single prefill's layout and lands through the same ``_scatter``, so
the captured decode step serves either.

Tracing (``serving/tracing.py``): every admission prefill and decode step
appends a record to ``tracing.TRACER``, timed by the clock reads the step
takes anyway; with tracing on, each phase of the step (an adapter switch
too) is also a span, and a ``torch.profiler`` range while a profiler
records.
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
from repro_torch.models import moe, transformer
from repro_torch.serving.prefix_cache import PrefixCache, PrefixEntry
from repro_torch.serving.snapshot import (KINDS, KVSnapshot, dtype_name,
                                          export_slot, export_slots,
                                          leaf_tensor)
from repro_torch.serving.tracing import (TRACER, CacheRec, DecodeRec,
                                         PrefillRec)

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
    model: Optional[str] = None          # fleet pool name (multi-model)
    deadline: Optional[float] = None     # absolute TTFT deadline (clock s);
                                         # None = no SLO attached
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


_WARMUP_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _warmup_stream(device: torch.device) -> "torch.cuda.Stream":
    """One side stream a device for every capture's eager warm-up: cuBLAS
    keeps a workspace (32 MiB on Hopper) for each stream it has run on, for
    the life of the process, so a stream per capture would leak one per
    server spawned."""
    if device not in _WARMUP_STREAMS:
        _WARMUP_STREAMS[device] = torch.cuda.Stream(device)
    return _WARMUP_STREAMS[device]


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


def _cache_rec(cache) -> CacheRec:
    """The bytes of a slot cache by kind: attention K/V, conv windows, and
    SSM or RG-LRU states."""
    by = {"kv": 0, "conv": 0, "ssm": 0}
    for path, t in _leaves({k: v for k, v in cache.items() if k != "pos"}):
        by["kv" if path[0] == "attn" else
           "conv" if path[-1] == "conv" else "ssm"] += t.nbytes
    return CacheRec(TRACER.clock, by["kv"], by["conv"], by["ssm"])


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
        TRACER.cache.append(_cache_rec(self.cache))
        self.active: Dict[int, ServeRequest] = {}     # slot -> request
        self.free: List[int] = list(range(n_slots))
        # padded prefill is exact only for pure attention with a
        # full-length cache: a ring buffer would evict real K/V
        self._can_bucket = (
            set(cfg.layer_kinds()) <= {"attn"}
            and transformer.attn_cache_capacity(cfg, max_len) == max_len)
        # prefill backend dispatch (overlapped cold start): while the host
        # engine is mid-load in pipeline strategy, admission prefills run
        # the injected belt; after the strategy switch, or when nothing was
        # injected, the single prefill
        self.prefill_backend: Callable[[], str] = lambda: "single"
        self._pipe_prefill: Optional[Callable] = None
        self._pipe_fits: Callable[[int, int], bool] = lambda P, S: True
        # static step I/O: refilled in place only when slot membership
        # changes; the step writes its sampled tokens back into _dev_tokens
        self._dev_tokens = torch.zeros((n_slots,), dtype=torch.int32,
                                       device=self.device)
        self._dev_active = torch.zeros((n_slots,), dtype=torch.bool,
                                       device=self.device)
        self._io_dirty = True
        # the captured decode step (card only) and the kernel launches one
        # replay makes, as ``ops.count_replay`` takes them
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_launches: Tuple[Tuple[str, int], ...] = ()
        self.n_decode_captures = 0
        self._prefill_shapes: Set[Tuple[int, int]] = set()
        # hot-path counters
        self.n_decode_steps = 0
        self.decode_time_s = 0.0
        self.n_prefill_calls = 0
        self.n_prefill_reqs = 0
        self.n_prefill_tokens = 0        # real (unpadded) tokens prefilled
        self.n_prefill_pipeline = 0      # requests prefilled by the belt
        # migration and rebuild counters (snapshot imports; tokens whose
        # prefill was skipped because their state arrived with them)
        self.n_migrated_in = 0
        self.migrated_tokens_in = 0
        self.n_batched_imports = 0       # import_snapshots scatters
        self.n_relay_scatters = 0        # relay_inflight scatters
        # cross-request prefix reuse (serving/prefix_cache.py): admission
        # probes an attached store per request, imports hits in one scatter
        # and walks only the uncached suffix; finished and drained prompts
        # deposit their rows
        self.prefix_cache: Optional[PrefixCache] = None
        self._prefix_evict_base = 0      # evictions before attach (delta)
        self.prefix_hits = 0             # admissions served from the cache
        self.prefix_hit_tokens = 0       # prompt tokens NOT prefilled again
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
        self._graph_launches = ()
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
            ops.count_replay(self._graph_launches)

    def _capture(self) -> None:
        cur = torch.cuda.current_stream(self.device)
        side = _warmup_stream(self.device)
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
        self._graph = graph
        self._graph_launches = tuple(sorted((k, n) for k, n in delta.items()
                                            if n))
        self.n_decode_captures += 1

    def _prefill_write(self, toks, last_idx, slots, backend: str):
        """Prefill padded prompts (P, bucket) through ``backend`` (the
        single prefill or the injected belt) and write the first
        ``len(slots)`` rows into their slots in place (one ``index_copy_``
        per cache leaf); the remaining rows are padding.  Returns the
        sampled first tokens, the bytes of the transient cache the prefill
        built, the bytes of recurrent state written into the slots and, for
        a model with experts on the single prefill, the count of dropped
        (token, choice) assignments as a device scalar (else None)."""
        dropped = None
        if backend == "pipeline":
            logits, c1 = self._pipe_prefill(
                self._params, {"tokens": toks, "last_index": last_idx})
        else:
            self._prefill_shapes.add(tuple(toks.shape))
            with moe.record_routing() as routed:
                logits, c1 = transformer.forward(
                    self.cfg, self._params, {"tokens": toks}, mode="prefill",
                    max_len=self.max_len, last_index=last_idx)
            if routed:
                dropped = sum((~keep).sum() for _, keep in routed)
        n = slots.shape[0]
        rows = {kind: {leaf: t[:, :n] for leaf, t in c1[kind].items()}
                for kind in KINDS if kind in c1}
        self._scatter(rows, slots, c1["pos"][:n])
        state = sum(t.nbytes for kind in ("ssm", "rec") if kind in rows
                    for t in rows[kind].values())
        return (self._sampler(logits).to(torch.int32),
                sum(t.nbytes for _, t in _leaves(c1)), state, dropped)

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
    def set_pipeline_prefill(self, fn: Callable,
                             fits: Optional[Callable[[int, int], bool]]
                             = None) -> None:
        """Inject the pipeline prefill for cold-start admissions.

        ``fn(params, {"tokens": (P, S), "last_index": (P,)})`` returns
        (logits (P, V), cache) in ``forward(mode="prefill")``'s layout with
        ``pos`` at ``last_index + 1``: ``build_pipeline_prefill`` with
        ``return_cache=True`` (``PipeBoostEngine.serving_pipeline_prefill``).
        ``fits(P, S)`` pre-checks that the rows split over the belt's grid;
        unfit shapes take the single prefill.  Admission uses it only while
        ``prefill_backend()`` says "pipeline" (mid-load, before the
        strategy switch)."""
        self._pipe_prefill = fn
        if fits is not None:
            self._pipe_fits = fits

    def _choose_prefill_backend(self, P: int, bucket: int) -> str:
        if (self._pipe_prefill is not None and self._can_bucket
                and self.prefill_backend() == "pipeline"
                and self._pipe_fits(P, bucket)):
            return "pipeline"
        return "single"

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

    def attach_prefix_cache(self, cache: Optional[PrefixCache]) -> None:
        """Attach (or detach with ``None``) a ``PrefixCache``.  Eviction
        accounting counts from this moment, so a store that moves between
        servers through the cluster's ``StateTier`` is not counted twice.
        Prefix reuse needs the bucketed-attention cache (``_can_bucket``):
        SSM and recurrent state integrates every token and a ring buffer
        evicts real K/V, so those models skip probing."""
        self.prefix_cache = cache
        self._prefix_evict_base = 0 if cache is None else cache.evictions

    def admit_batch(self, reqs: Sequence[ServeRequest]) -> None:
        """Prefill several requests in one batched, bucketed call (the
        caller guarantees ``len(reqs) <= len(self.free)``).  Models that
        can't pad safely are prefilled one by one at exact length.

        With a prefix cache attached, each fresh request first probes it:
        hits import their cached rows and walk only the uncached suffix
        (``_admit_prefix_hits``); misses, and re-submits that carry a
        generated prefix, take the prefill path."""
        if len(reqs) > len(self.free):
            raise ValueError(f"{len(reqs)} requests for {len(self.free)} "
                             "free slots")
        hits: List[Tuple[ServeRequest, Tuple[PrefixEntry, int]]] = []
        misses: List[ServeRequest] = []
        for r in reqs:
            h = None
            if (self.prefix_cache is not None and self._can_bucket
                    and not r.generated):
                h = self.prefix_cache.probe(self.cfg.name, r.adapter,
                                            np.asarray(r.tokens, np.int64))
            if h is None:
                misses.append(r)
            else:
                hits.append((r, h))
        if hits:
            self._admit_prefix_hits(hits)
        if not misses:
            return
        if not self._can_bucket:
            for r in misses:
                self._admit_rows([r])
        else:
            self._admit_rows(misses)

    def _admit_prefix_hits(self, hits: Sequence[Tuple[
            ServeRequest, Tuple[PrefixEntry, int]]]) -> None:
        """Admit prefix-cache hits: import the cached rows, walk the suffix.

        The rows of every hit cross to the device in one copy per leaf
        (``_upload``) and land in ONE in-place scatter (``_scatter``), each
        hit's ``pos`` set to its usable prefix length k.  The uncached
        suffix then walks through the decode step (on the card the captured
        graph, replayed; never a second capture): walk step i copies suffix
        token i of every hit still walking, and the walk's active mask,
        into the step's static inputs in place.  Finished hits and
        unrelated live slots are frozen by the mask: their ``pos`` is
        restored, and the write at their uncommitted index is overwritten
        by their next real step.  Each step's sampled row is copied on the
        device before the next replay overwrites it, and one host read at
        the end picks each hit's first generated token (the sample after
        its last prompt token), so a hit emits one token at admission, as
        a cold prefill does.  ``_io_dirty`` makes the next real step reload
        the live slots' tokens and mask."""
        slots: List[int] = []
        walks: List[Tuple[int, ServeRequest, int, np.ndarray]] = []
        for req, (entry, k) in hits:
            slot = self.free.pop()
            req.slot = slot
            slots.append(slot)
            walks.append((slot, req, k, np.asarray(req.tokens, np.int64)[k:]))
        self._scatter(self._upload([e.rows for _, (e, _k) in hits]), slots,
                      [k for _, (_e, k) in hits])
        for _, (entry, _k) in hits:
            self.prefix_cache.release(entry)
        W = max(len(sfx) for _, _, _, sfx in walks)
        toks = np.zeros((W, self.n_slots), np.int32)
        act = np.zeros((W, self.n_slots), bool)
        for slot, _req, _k, sfx in walks:
            toks[:len(sfx), slot] = sfx
            act[:len(sfx), slot] = True
        dev_toks = torch.from_numpy(toks).to(self.device)
        dev_act = torch.from_numpy(act).to(self.device)
        walked = torch.empty_like(dev_toks)
        for i in range(W):
            self._dev_tokens.copy_(dev_toks[i])
            self._dev_active.copy_(dev_act[i])
            self._decode()
            walked[i].copy_(self._dev_tokens)
        # pbcheck: disable=R2 (designed sync: ONE host read for the whole suffix walk; admission needs the hits' first tokens)
        walked_host = walked.cpu().numpy()
        for slot, req, k, sfx in walks:
            self.prefix_hits += 1
            self.prefix_hit_tokens += k
            self.n_prefill_tokens += len(sfx)
            tok = int(walked_host[len(sfx) - 1, slot])
            req.generated.append(tok)
            at_eos = req.eos_id is not None and tok == req.eos_id
            if len(req.generated) >= req.max_new_tokens or at_eos:
                req.done = True
                self.free.append(slot)
                req.slot = -1
            else:
                self.active[slot] = req
        self._io_dirty = True

    def _admit_rows(self, reqs: List[ServeRequest]) -> None:
        bucket = max(self.bucket_for(r) for r in reqs)
        # the bucketed path always prefills n_slots rows (pad rows are
        # masked by ``valid``), as the reference does for its compile cache
        P = self.n_slots if self._can_bucket else len(reqs)
        toks = np.zeros((P, bucket), np.int64)
        last_idx = np.zeros((P,), np.int32)
        slots = np.zeros((len(reqs),), np.int32)
        assigned: List[Tuple[int, int, ServeRequest]] = []
        real = 0
        for i, req in enumerate(reqs):
            t = np.asarray(req.tokens, np.int64)
            if req.generated:
                t = np.concatenate([t, np.asarray(req.generated, np.int64)])
            L = len(t)
            real += L
            toks[i, :L] = t
            last_idx[i] = L - 1
            slot = self.free.pop()
            req.slot = slot
            slots[i] = slot
            assigned.append((i, slot, req))
        self.n_prefill_tokens += real
        dev = self.device
        backend = self._choose_prefill_backend(P, bucket)
        tr = TRACER
        with tr.span("batcher.prefill", rows=P, bucket=bucket, tokens=real,
                     requests=len(reqs), backend=backend):
            t0 = time.perf_counter_ns()
            first, cache_bytes, state_bytes, dropped = self._prefill_write(
                torch.from_numpy(toks).to(dev),
                torch.from_numpy(last_idx).to(dev),
                torch.from_numpy(slots).to(dev), backend)
            # pbcheck: disable=R2 (designed sync: admission reads first tokens to catch immediate EOS before slot commit)
            first_host = first.cpu().numpy()
            t1 = time.perf_counter_ns()
        # pbcheck: disable=R2 (the device is idle once the first tokens are on the host: the count is read after the timed prefill)
        n_dropped = 0 if dropped is None else int(dropped)
        tr.prefill.append(PrefillRec(tr.clock, P, bucket, real, len(reqs),
                                     backend, cache_bytes, (t1 - t0) * 1e-9,
                                     state_bytes, n_dropped))
        if backend == "pipeline":
            self.n_prefill_pipeline += len(reqs)
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
        tr = TRACER
        live = len(self.active)
        with tr.span("batcher.decode", live=live):
            t0 = time.perf_counter_ns()
            with tr.span("batcher.decode.io"):
                if self._io_dirty:
                    self._load_io()
            t1 = time.perf_counter_ns()
            with tr.span("batcher.decode.launch"):
                self._decode()
            t2 = time.perf_counter_ns()
            with tr.span("batcher.decode.wait"):
                # pbcheck: disable=R2 (designed sync: THE one host transfer per decode step; EOS checks need the token ids)
                nxt_host = self._dev_tokens.cpu().numpy()
            t3 = time.perf_counter_ns()
            with tr.span("batcher.decode.book"):
                finished = self._book(nxt_host)
            t4 = time.perf_counter_ns()
        self.decode_time_s += (t4 - t0) * 1e-9
        tr.decode.append(DecodeRec(tr.clock, live, (t1 - t0) * 1e-9,
                                   (t2 - t1) * 1e-9, (t3 - t2) * 1e-9,
                                   (t4 - t3) * 1e-9))
        return finished

    def _book(self, nxt_host: np.ndarray) -> List[ServeRequest]:
        """A decode step's bookkeeping on the host: append each live slot's
        sampled token, retire the finished requests (depositing their
        prompts' rows in an attached prefix cache); returns them."""
        self.n_decode_steps += 1
        finished = []
        done_slots: List[Tuple[int, ServeRequest]] = []
        for slot, req in list(self.active.items()):
            tok = int(nxt_host[slot])
            req.generated.append(tok)
            at_eos = req.eos_id is not None and tok == req.eos_id
            if len(req.generated) >= req.max_new_tokens or at_eos:
                req.done = True
                finished.append(req)
                done_slots.append((slot, req))
                del self.active[slot]
                self.free.append(slot)
        if finished:
            self._io_dirty = True        # active mask changed
            if self.prefix_cache is not None and self._can_bucket:
                # deposit finished prompts before their slots are reused
                self._deposit_prefixes(done_slots)
        return finished

    def _deposit(self, req: ServeRequest, snap: KVSnapshot) -> None:
        """Insert ``req``'s prompt prefix, whose rows ``snap`` holds, into
        the attached prefix cache."""
        toks = np.asarray(req.tokens, np.int64)
        self.prefix_cache.insert(self.cfg.name, req.adapter, toks,
                                 min(toks.shape[0], snap.pos),
                                 rows=snap.rows)

    def _wants_deposit(self, req: ServeRequest) -> bool:
        """A prompt of 2+ tokens that the store does not cover yet."""
        toks = np.asarray(req.tokens, np.int64)
        return toks.shape[0] >= 2 and not self.prefix_cache.covers(
            self.cfg.name, req.adapter, toks)

    def _deposit_prefixes(self, pairs: Sequence[Tuple[int, ServeRequest]]
                          ) -> None:
        """Insert finished requests' prompt-prefix rows into the attached
        prefix cache.  Prompts the store already covers are skipped before
        the export, so only new prefixes cross to the host, in one batched
        ``export_slots`` (one copy per leaf)."""
        todo = [(slot, req) for slot, req in pairs if self._wants_deposit(req)]
        if not todo:
            return
        snaps = export_slots(self.cache, [s for s, _ in todo],
                             arch=self.cfg.name, max_len=self.max_len)
        for (_, req), snap in zip(todo, snaps):
            self._deposit(req, snap)

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
                # the rows are on the host already: deposit the prompt
                # prefix for free (the other half of the completion deposit)
                if (self.prefix_cache is not None and self._can_bucket
                        and self._wants_deposit(req)):
                    self._deposit(req, snap)
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

    def _upload(self, host_rows: Sequence[Dict[str, Dict[str, np.ndarray]]]
                ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Stack several slots' host rows (kind -> leaf -> (L, ...), the
        ``KVSnapshot`` wire layout) per leaf into (L, n, ...) and copy them
        to the device, one copy per leaf, in the cache leaf's dtype (bf16
        rows arrive as uint16 or ml_dtypes bits)."""
        rows: Dict[str, Dict[str, torch.Tensor]] = {}
        for kind, leaves in host_rows[0].items():
            rows[kind] = {}
            for leaf in leaves:
                name = dtype_name(self.cache[kind][leaf].dtype)
                parts = [r[kind][leaf] for r in host_rows]
                if name == "bfloat16":
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
        self._scatter(self._upload([snap.rows]), [slot], [snap.pos])
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
        self._scatter(self._upload([s.rows for s in snaps]), slots,
                      [s.pos for s in snaps])
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
            "n_prefill_pipeline": float(self.n_prefill_pipeline),
            "n_batched_imports": float(self.n_batched_imports),
            "n_relay_scatters": float(self.n_relay_scatters),
            "n_prefill_tokens": float(self.n_prefill_tokens),
            "prefix_hits": float(self.prefix_hits),
            "prefix_hit_tokens": float(self.prefix_hit_tokens),
            "prefix_evictions": (
                0.0 if self.prefix_cache is None
                else float(self.prefix_cache.evictions
                           - self._prefix_evict_base)),
        }
        s.update({k: float(v) for k, v in self.compile_stats().items()})
        return s

    def release(self) -> None:
        """Free the batcher's device state for good: the cache, the step
        I/O, the owned parameter leaves and the captured decode step (a
        retired cluster server keeps only its records).  Counters stay
        readable."""
        if self.active:
            raise ValueError("release needs an idle batch")
        self.cache = self._params = self._graph = None
        self._dev_tokens = self._dev_active = None


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
        with TRACER.span("engine.switch", src=self.active_adapter, dst=name):
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
        with TRACER.step(now):
            with TRACER.span("engine.admit"):
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

    def attach_prefix_cache(self, cache: Optional[PrefixCache]) -> None:
        """Attach a cross-request ``PrefixCache`` to the batcher (see
        ContinuousBatcher.attach_prefix_cache)."""
        self.batcher.attach_prefix_cache(cache)

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

    # ---- scheduling surface (read by cluster/scheduler.py's policies) ----
    def resident_adapters(self) -> set:
        """Adapters admittable now without an epoch-switch stall: while the
        batch is busy only the active adapter's weights are merged in; an
        idle batch switches to any loaded adapter.  ``None`` names the base
        model."""
        if self.batcher.active:
            return {self.active_adapter}
        return set(self.adapter_params) | {None, self.active_adapter}

    def predicted_step_cost_s(self, default: float = 0.05) -> float:
        """Measured mean wall-clock cost of one decode step (the SLO-aware
        dispatch's unit of predicted work); ``default`` until this engine
        has decoded anything."""
        b = self.batcher
        if b.n_decode_steps > 0 and b.decode_time_s > 0:
            return b.decode_time_s / b.n_decode_steps
        return default

    def queued_requests(self) -> List[ServeRequest]:
        """Requests enqueued but not yet admitted (no first token yet)."""
        out: List[ServeRequest] = []
        for q in self.policy_state.get("queues", {}).values():
            out.extend(it.req for it in q)
        out.extend(it.req for it in self.policy_state.get("fifo", ()))
        return out

    @property
    def n_pending(self) -> int:
        """Queued (not yet admitted) + in-flight requests."""
        return len(self.queued_requests()) + self.batcher.n_active

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
