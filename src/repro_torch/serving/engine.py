"""Serving engine: request lifecycle + continuous batching over a
slot-indexed KV cache, with epoch-based LoRA adapter scheduling (the port
of ``repro/serving/engine.py``).

Slots: the batcher owns one cache of ``n_slots`` rows (attention K/V, and
each SSM or recurrent layer's conv window and state); a new request's
prefill is written into a free slot while the other slots keep decoding,
so requests join and leave the batch at token granularity.  Per-slot positions ride in
``cache["pos"]`` (n_slots,).

Hot path:
* **Zero-copy decode + sample**: one step runs ``decode_step`` (which
  writes each layer's new K/V row into the cache in place) and the
  sampler; exactly one (n_slots,) device->host read per step (the sampled
  tokens), and the token array stays on the device between steps.
* **Bucketed prefill**: prompts are right-padded to power-of-two buckets
  (``bucket_sizes``) and same-bucket requests prefill together; causal
  attention keeps trailing pads out of real positions, logits are gathered
  at the true prompt end (``forward(..., last_index=...)``) and
  ``cache["pos"]`` records the true length so decode masks the pad K/V.
  Bucketing needs a pure-attention model with a full-length cache
  (``_can_bucket``); an SSM or hybrid recurrent model prefills each prompt
  alone at its exact length, since pad tokens would enter its running
  state.
* **Free slots are frozen**: their ``pos`` does not advance and their
  token passes through, so inactive lanes never reach the bookkeeping.

Not ported yet (see ROADMAP.md): snapshots and migration, the prefix
cache, in-flight reconstruction and the pipeline prefill backend.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.adapter_scheduler import EpochSchedulerPolicy
from repro_torch.models import transformer

BUCKET_MIN = 16


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


def _argmax(logits):
    return torch.argmax(logits, dim=-1)


class ContinuousBatcher:
    """Slot-based continuous batching over the stacked-cache model."""

    def __init__(self, cfg: ArchConfig, params, n_slots: int, max_len: int,
                 sampler: Optional[Callable] = None):
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.device = params["embed"].device
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
        # device-resident step I/O, rebuilt only when slot membership
        # changes
        self._dev_tokens = torch.zeros((n_slots,), dtype=torch.int32,
                                       device=self.device)
        self._dev_active = torch.zeros((n_slots,), dtype=torch.bool,
                                       device=self.device)
        self._io_dirty = True
        # hot-path counters
        self.n_decode_steps = 0
        self.decode_time_s = 0.0
        self.n_prefill_calls = 0
        self.n_prefill_reqs = 0
        self.n_prefill_tokens = 0        # real (unpadded) tokens prefilled
        self.sampler: Callable = sampler or _argmax

    # ------------------------------------------------------------------
    # the two fused hot-path functions
    # ------------------------------------------------------------------
    def _decode_sample(self, toks, active_mask):
        old_pos = self.cache["pos"]
        logits, cache = transformer.decode_step(self.cfg, self.params,
                                                {"tokens": toks}, self.cache)
        # freeze free slots: their position must not advance (a wrapped
        # ring-buffer pos would corrupt a later admission) and their
        # garbage logits must not reach EOS bookkeeping
        cache["pos"] = torch.where(active_mask, cache["pos"], old_pos)
        self.cache = cache
        nxt = self.sampler(logits).to(torch.int32)
        return torch.where(active_mask, nxt, toks)

    def _prefill_write(self, toks, last_idx, slots):
        """Prefill padded prompts (P, bucket) and write the first
        ``len(slots)`` rows into their slots in place (one ``index_copy_``
        per cache leaf); the remaining rows are padding."""
        logits, c1 = transformer.forward(
            self.cfg, self.params, {"tokens": toks}, mode="prefill",
            max_len=self.max_len, last_index=last_idx)
        n = slots.shape[0]
        dst = slots.long()
        for kind in ("attn", "ssm", "rec"):
            for leaf, rows in c1.get(kind, {}).items():
                self.cache[kind][leaf].index_copy_(1, dst, rows[:, :n])
        self.cache["pos"].index_copy_(0, dst, c1["pos"][:n])
        return self.sampler(logits).to(torch.int32)

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
    def step(self) -> List[ServeRequest]:
        """One decode step for all active slots; returns finished requests."""
        if not self.active:
            return []
        t0 = time.perf_counter()
        if self._io_dirty:
            toks = np.zeros((self.n_slots,), np.int32)
            act = np.zeros((self.n_slots,), bool)
            for slot, req in self.active.items():
                toks[slot] = req.generated[-1]
                act[slot] = True
            self._dev_tokens = torch.from_numpy(toks).to(self.device)
            self._dev_active = torch.from_numpy(act).to(self.device)
            self._io_dirty = False
        nxt = self._decode_sample(self._dev_tokens, self._dev_active)
        self._dev_tokens = nxt
        nxt_host = nxt.cpu().numpy()       # THE one host read per step
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

    @property
    def n_active(self) -> int:
        return len(self.active)

    def hotpath_stats(self) -> Dict[str, float]:
        return {
            "n_decode_steps": float(self.n_decode_steps),
            "decode_time_s": self.decode_time_s,
            "decode_steps_per_s": (self.n_decode_steps / self.decode_time_s
                                   if self.decode_time_s > 0 else 0.0),
            "n_prefill_calls": float(self.n_prefill_calls),
            "n_prefill_reqs": float(self.n_prefill_reqs),
            "n_prefill_tokens": float(self.n_prefill_tokens),
        }


class ServingEngine:
    """Request dispatcher + continuous batcher + adapter epochs.

    ``adapter_params`` maps an adapter name to its merged params (the
    LoRA-merge kernel's output); an epoch switch swaps the batcher's
    params."""

    def __init__(self, cfg: ArchConfig, params, *, n_slots: int = 4,
                 max_len: int = 256,
                 policy: Optional[EpochSchedulerPolicy] = None,
                 adapter_params: Optional[Dict[str, object]] = None):
        self.cfg = cfg
        self.batcher = ContinuousBatcher(cfg, params, n_slots, max_len)
        self.policy = policy or EpochSchedulerPolicy()
        self.policy_state = self.policy.make_state()
        self.adapter_params = adapter_params or {}
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
