"""``pbcheck`` for the PyTorch port: stdlib-``ast`` static analysis
enforcing the PipeBoost invariants that only fail at runtime — and
usually late (the port's own copy of ``repro/analysis``, retargeted to
torch and CUDA graphs).

The latency wins live or die on properties nothing type-checks: the
decode step is captured once as a CUDA graph and replayed, so nothing
in it may sync the host or allocate memory that outlives the capture,
and a captured graph's static output is overwritten by the next replay;
the hot path crosses to the host only at its designed transfer points;
and the background-fill thread must touch shared engine state only
under ``_load_lock``.

==== =======================================================
rule invariant
==== =======================================================
R1   a graph's static output is not read through an alias
     taken before a later replay
R2   no host syncs inside the decode/prefill hot-path modules
R3   fill-thread-shared engine state accessed under the lock
R4   no host syncs, outliving allocations or data-dependent
     shapes in captured code; no capture rebuilt in a loop
R5   chaos kinds / recovery modes handled exhaustively
R6   public APIs in the documented layers carry docstrings
==== =======================================================

Run it as ``python -m repro_torch.analysis`` (or
``tools/pbcheck_torch.py``); findings can be silenced inline with
``# pbcheck: disable=R2 (reason)`` or accepted into a checked-in
baseline file.  The run fails on any NEW finding.
"""
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.cli import main, run_check

__all__ = ["Finding", "main", "run_check"]
