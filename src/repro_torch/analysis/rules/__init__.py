"""Rule registry: maps rule ids to their check entry points.

Per-module rules expose ``check(module, config) -> List[Finding]``;
project rules (R5, which reasons across files) expose
``check_project(modules, config)``.  The walker dispatches on which
attribute a rule module defines.
"""
from repro_torch.analysis.rules import (capture, chaos, docstrings,
                                        hostsync, locks, replay)

RULES = {
    "R1": replay,
    "R2": hostsync,
    "R3": locks,
    "R4": capture,
    "R5": chaos,
    "R6": docstrings,
}

DESCRIPTIONS = {
    "R1": "static buffers: no alias of a graph's output read after a "
          "later replay",
    "R2": "host-sync-in-hot-path: no device->host syncs in hot modules",
    "R3": "lock discipline: fill-thread-shared state under _load_lock",
    "R4": "graph-capture hazards in captured code",
    "R5": "chaos kind / recovery mode exhaustiveness",
    "R6": "docstring coverage in the documented layers",
}
