"""Host-side state tier: warm-state spill on retire, resurrect on spawn.

Idle retirement used to throw a fully-warm server's state away: its
prefix-cache KV rows (serving/prefix_cache.py) and resident-adapter set
vanished with the replica, and the next scale-up for the same pool
started stone cold.  The ``StateTier`` keeps that state host-side
instead — the λScale/HydraServe view that inference state is a fast
migrating resource, applied to the scale-DOWN direction:

* ``ClusterRouter`` **spills** on autoscaler retirement: the retiring
  server's prefix-cache entries and adapter params land in the pool's
  bundle (``spill``), merged with whatever earlier retirements left.
* A later **spawn for the same pool resurrects** (``take``): the new
  server's prefix cache is pre-seeded and the spilled adapters are
  preloaded, so post-scale-up admissions hit warm prefixes instead of
  re-prefilling from token zero.  The pull is priced with
  ``core.simulator.state_resurrect_time`` (host-aggregate-shared
  bandwidth + fixed transfer cost), surfaced in the router's
  ``resurrect`` event and in ``SloAware``'s ready-time estimate.

Everything here is deterministic pure-Python host state (no wall clock,
no RNG, no device arrays — prefix rows are already host numpy), so tick
and event engine replays stay bit-identical.  One tier instance is
shared fleet-wide; bundles are keyed by pool name.

See ``docs/ARCHITECTURE.md`` § "Fleet state tier".

The port's own copy of ``repro/cluster/state_tier.py``
(plain Python and numpy: the port imports nothing of the JAX package).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional


class StateTier:
    """Per-pool host-side store of spilled warm server state.

    A bundle is a plain dict::

        {"prefix_entries": [(key, PrefixEntry), ...],   # cache contents
         "adapters": {name: params, ...},               # resident set
         "nbytes": int}                                 # payload size

    ``spill`` merges into the pool's bundle (later spills extend/replace
    earlier ones); ``take`` hands the whole bundle to a resurrecting
    spawn and removes it — exactly one spawn resurrects each spill
    generation, so concurrent spawns don't double-import the same rows.
    """

    def __init__(self) -> None:
        self._bundles: Dict[str, Dict[str, Any]] = {}
        self.spill_count = 0
        self.spilled_bytes = 0
        self.resurrections = 0
        self.resurrected_bytes = 0

    def spill(self, pool: Optional[str], bundle: Dict[str, Any]) -> None:
        """Merge a retiring server's bundle into the pool's stored one."""
        key = pool or "__pool__"
        dst = self._bundles.setdefault(
            key, {"prefix_entries": [], "adapters": {}, "nbytes": 0})
        dst["prefix_entries"] = (list(dst["prefix_entries"])
                                 + list(bundle.get("prefix_entries", ())))
        dst["adapters"].update(bundle.get("adapters", {}))
        nb = int(bundle.get("nbytes", 0))
        dst["nbytes"] += nb
        self.spill_count += 1
        self.spilled_bytes += nb

    def take(self, pool: Optional[str]) -> Optional[Dict[str, Any]]:
        """Pop the pool's bundle for a resurrecting spawn (None = cold)."""
        out = self._bundles.pop(pool or "__pool__", None)
        if out is not None:
            self.resurrections += 1
            self.resurrected_bytes += int(out.get("nbytes", 0))
        return out

    def peek_nbytes(self, pool: Optional[str]) -> int:
        """Stored bundle size for ``pool`` (0 when nothing is spilled) —
        what a prospective resurrect would have to transfer."""
        b = self._bundles.get(pool or "__pool__")
        return 0 if b is None else int(b.get("nbytes", 0))

    @property
    def pools(self) -> List[str]:
        """Pool keys currently holding a spilled bundle (sorted)."""
        return sorted(self._bundles)

    def stats(self) -> Dict[str, float]:
        """Lifetime counters, in the key shape ``ClusterMetrics``
        forwards into its always-present summary fields."""
        return {
            "spilled_bytes": float(self.spilled_bytes),
            "spill_count": float(self.spill_count),
            "spill_resurrections": float(self.resurrections),
            "resurrected_bytes": float(self.resurrected_bytes),
        }
