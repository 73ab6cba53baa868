"""Cross-request prefix cache: fleet-wide KV reuse for shared prompts.

PipeBoost's thesis — serverless replicas share almost all of their state,
so move/reuse it instead of recomputing — applies to KV state too:
system prompts and few-shot templates are shared by huge request
populations, yet a vanilla serving stack re-prefills every admission from
token zero.  This module is the host-side store behind the serving
engine's prefix reuse: completed (or drained) requests deposit the KV
rows of their prompt; a later admission whose prompt shares a token
prefix imports those rows through the batcher's existing donated-scatter
path and prefills ONLY the uncached suffix.

Design
------
* **Entries keyed by (arch, adapter)** and matched by *longest common
  prefix* over the stored full token arrays — NOT by a per-length hash.
  LCP matching is what makes the shared-prefix/different-suffix case
  work: a donor prompt of length 388 serves a new prompt that shares
  only its first 384 tokens, with no entry ever having been inserted at
  length 384.
* **Rows are host numpy in ``KVSnapshot`` layout** (kind -> leaf ->
  ``(L, ...)``), i.e. exactly what ``export_slots`` produces and what the
  batcher's shared ``fused_scatter`` consumes — import costs one donated
  dispatch, zero new compiles.  Rows past the usable prefix are stale
  but harmless: attention masks beyond ``pos`` and the suffix walk
  overwrites them in place.
* **Rows-less entries** (``rows=None`` with an explicit ``nbytes``)
  support the modeled cluster backend (``cluster/simserver.py``), which
  tracks hit/byte accounting without holding real KV.
* **Deterministic LRU + byte budget**: recency is a logical counter (no
  wall clock), so fleet replays are bit-reproducible under both the tick
  and the event engine.  Eviction skips **ref-counted (pinned)** entries:
  ``probe`` acquires a reference that the importer releases only after
  the scatter has consumed the rows, so eviction can never race an
  in-flight import.
* **Spill/resurrect**: ``export_entries``/``import_entries`` move the
  whole store through the cluster's host-side ``StateTier``
  (``cluster/state_tier.py``) when an idle server retires, so a later
  spawn for the same pool starts warm.

See ``docs/ARCHITECTURE.md`` § "Fleet state tier".

The port's own copy of ``repro/serving/prefix_cache.py``
(plain Python and numpy: the port imports nothing of the JAX package).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

GroupKey = Tuple[str, Optional[str]]      # (arch name, adapter name|None)


def _lcp(a: np.ndarray, b: np.ndarray) -> int:
    """Longest common prefix length of two 1-D token arrays."""
    n = min(a.shape[0], b.shape[0])
    if n == 0:
        return 0
    m = a[:n] == b[:n]
    return n if m.all() else int(np.argmin(m))


@dataclass(eq=False)
class PrefixEntry:
    """One cached prompt prefix: the full token array it was deposited
    under, the number of leading tokens with valid KV state (``pos``),
    and the per-layer rows in ``KVSnapshot`` wire layout (host numpy;
    ``None`` for modeled/accounting-only entries).

    ``eq=False``: entries are identity-compared — the generated ``__eq__``
    would compare token *arrays* and break ``list.remove`` on eviction."""
    tokens: np.ndarray                    # full prompt tokens (S,)
    pos: int                              # leading tokens with cached state
    rows: Optional[Dict[str, Dict[str, np.ndarray]]]
    nbytes: int
    last_used: int = 0                    # logical LRU stamp
    refs: int = 0                         # pinned by in-flight imports


class PrefixCache:
    """LRU + byte-budget store of prompt-prefix KV rows.

    One instance serves one server's batcher (the cluster attaches a
    fresh cache per spawned server and moves its contents through the
    ``StateTier`` on retirement), but nothing prevents sharing: all
    state is host-side and keyed by (arch, adapter).
    """

    def __init__(self, capacity_bytes: int = 64 << 20):
        self.capacity_bytes = capacity_bytes
        self._groups: Dict[GroupKey, List[PrefixEntry]] = {}
        self._tick = 0                    # deterministic recency counter
        self.bytes_used = 0
        self.hits = 0
        self.hit_tokens = 0
        self.evictions = 0
        self.insertions = 0

    # ------------------------------------------------------------------
    # lookup
    # ------------------------------------------------------------------
    def _best(self, arch: str, adapter: Optional[str],
              tokens: np.ndarray) -> Tuple[Optional[PrefixEntry], int]:
        """Entry with the longest usable cached prefix for ``tokens``.

        Usable length is ``min(lcp, len(tokens) - 1, entry.pos)``: at
        least one suffix token must remain to produce the first sampled
        logits, and only positions the entry actually holds state for
        count.  Returns ``(None, 0)`` when nothing matches.
        """
        toks = np.asarray(tokens).ravel()
        cap = toks.shape[0] - 1
        best: Optional[PrefixEntry] = None
        best_k = 0
        for e in self._groups.get((arch, adapter), ()):
            k = min(_lcp(toks, e.tokens), cap, e.pos)
            if k > best_k:
                best, best_k = e, k
        return best, best_k

    def match_len(self, arch: str, adapter: Optional[str],
                  tokens: np.ndarray) -> int:
        """Longest usable cached prefix length for ``tokens`` — a pure
        read (no LRU bump, no ref, no hit accounting).  Dispatch pricing
        (``SloAware.prefix_bonus_s_per_token``) uses this."""
        _, k = self._best(arch, adapter, tokens)
        return k

    def probe(self, arch: str, adapter: Optional[str], tokens: np.ndarray
              ) -> Optional[Tuple[PrefixEntry, int]]:
        """Look up the best prefix match for an admission.

        On a hit (usable prefix >= 1 token) the entry is **pinned**
        (``refs += 1``) and its recency bumped; the caller MUST call
        :meth:`release` once the import has consumed the rows.  Hit
        counters accrue here.  Returns ``(entry, k)`` or ``None``.
        """
        e, k = self._best(arch, adapter, tokens)
        if e is None or k < 1:
            return None
        self._tick += 1
        e.last_used = self._tick
        e.refs += 1
        self.hits += 1
        self.hit_tokens += k
        return e, k

    def release(self, entry: PrefixEntry) -> None:
        """Unpin an entry acquired by :meth:`probe` (import landed)."""
        entry.refs = max(0, entry.refs - 1)

    def covers(self, arch: str, adapter: Optional[str], tokens: np.ndarray,
               pos: Optional[int] = None) -> bool:
        """True when an existing entry already holds state for the first
        ``pos`` tokens (default: all) of ``tokens`` — insertion would be
        a no-op, so callers can skip the device->host export entirely."""
        toks = np.asarray(tokens).ravel()
        want = toks.shape[0] if pos is None else min(pos, toks.shape[0])
        for e in self._groups.get((arch, adapter), ()):
            if e.pos >= want and _lcp(toks, e.tokens) >= want:
                return True
        return False

    # ------------------------------------------------------------------
    # insertion / eviction
    # ------------------------------------------------------------------
    def insert(self, arch: str, adapter: Optional[str], tokens: np.ndarray,
               pos: int, rows: Optional[Dict[str, Dict[str, np.ndarray]]]
               = None, nbytes: Optional[int] = None) -> bool:
        """Deposit a prompt's prefix state; True if it was admitted.

        Skips exact/covering duplicates, drops entries the new one
        strictly dominates (their tokens are a prefix of ours and their
        ``pos`` no larger), then evicts LRU-first to the byte budget —
        never touching pinned entries.  ``nbytes`` is derived from
        ``rows`` when omitted (rows-less entries must pass it).
        """
        toks = np.asarray(tokens).ravel()
        pos = int(min(pos, toks.shape[0]))
        if pos < 1:
            return False
        if nbytes is None:
            if rows is None:
                raise ValueError("rows-less insert needs an explicit nbytes")
            nbytes = int(toks.nbytes
                         + sum(a.nbytes for leaves in rows.values()
                               for a in leaves.values()))
        if nbytes > self.capacity_bytes:
            return False                  # larger than the whole budget
        group = self._groups.setdefault((arch, adapter), [])
        dominated: List[PrefixEntry] = []
        for e in group:
            k = _lcp(toks, e.tokens)
            if k >= pos and e.pos >= pos:
                return False              # already covered: keep theirs
            if (k == e.tokens.shape[0] and e.pos <= pos and e.refs == 0):
                dominated.append(e)       # ours strictly covers e
        for e in dominated:
            group.remove(e)
            self.bytes_used -= e.nbytes
            self.evictions += 1
        self._tick += 1
        group.append(PrefixEntry(tokens=toks.copy(), pos=pos, rows=rows,
                                 nbytes=int(nbytes), last_used=self._tick))
        self.bytes_used += int(nbytes)
        self.insertions += 1
        self._evict_to_budget()
        return True

    def _evict_to_budget(self) -> None:
        """LRU eviction down to ``capacity_bytes``; pinned entries are
        skipped (an in-flight import may still be reading their rows),
        so the store can transiently overshoot while refs are held."""
        while self.bytes_used > self.capacity_bytes:
            victim_key = None
            victim = None
            for key, group in self._groups.items():
                for e in group:
                    if e.refs > 0:
                        continue
                    if victim is None or e.last_used < victim.last_used:
                        victim_key, victim = key, e
            if victim is None:
                return                    # everything left is pinned
            self._groups[victim_key].remove(victim)
            self.bytes_used -= victim.nbytes
            self.evictions += 1

    # ------------------------------------------------------------------
    # spill / resurrect
    # ------------------------------------------------------------------
    def export_entries(self) -> List[Tuple[GroupKey, PrefixEntry]]:
        """Flat ``(key, entry)`` list of the whole store, deterministic
        order — what an idle retirement spills to the ``StateTier``."""
        out: List[Tuple[GroupKey, PrefixEntry]] = []
        for key in sorted(self._groups, key=lambda k: (k[0], k[1] or "")):
            for e in self._groups[key]:
                out.append((key, e))
        return out

    def import_entries(self, items) -> int:
        """Merge spilled ``(key, entry)`` pairs back in (resurrection on
        a fresh spawn); returns how many entries were admitted."""
        n = 0
        for (arch, adapter), e in items:
            if self.insert(arch, adapter, e.tokens, e.pos, rows=e.rows,
                           nbytes=e.nbytes):
                n += 1
        return n

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------
    @property
    def n_entries(self) -> int:
        """Total entries across all (arch, adapter) groups."""
        return sum(len(g) for g in self._groups.values())

    def stats(self) -> Dict[str, float]:
        """Counter snapshot (hits/tokens/evictions/insertions/bytes)."""
        return {
            "prefix_hits": float(self.hits),
            "prefix_hit_tokens": float(self.hit_tokens),
            "prefix_evictions": float(self.evictions),
            "prefix_insertions": float(self.insertions),
            "prefix_bytes": float(self.bytes_used),
            "prefix_entries": float(self.n_entries),
        }
