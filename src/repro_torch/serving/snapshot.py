"""Portable per-request KV/recurrent state snapshots for crash migration
(the port of ``repro/serving/snapshot.py``).

A ``KVSnapshot`` is one batch slot's slice of every cache leaf — the
per-layer K/V rows (ring buffers unrotated), SSM and RG-LRU states — plus
the slot's position and the config identity needed to refuse an
incompatible import.  A survivor scatters it into a free slot and decodes
on with no prefill (paper §4.4).

Rows are host numpy, the reference's wire format, so a snapshot can cross
processes and packages.  numpy has no bfloat16: the reference's bf16 rows
carry the ``ml_dtypes`` dtype named ``"bfloat16"``, and the port writes a
bf16 leaf as its uint16 bit view with ``"bfloat16"`` in ``dtypes``.  Both
are read back through the same 16-bit view (``leaf_tensor``), bits
unchanged.

Ring-buffer caches need no special case: slot j holds the position p with
p % C == j, a function of ``pos``, which travels with the rows.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np
import torch

KINDS = ("attn", "ssm", "rec")


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: numpy's and ml_dtypes' names."""
    return str(dtype).rsplit(".", 1)[-1]


@dataclass
class KVSnapshot:
    """One in-flight request's decode state, detached from its slot.

    ``pos`` is the number of tokens whose state the snapshot holds (prompt
    plus generated prefix, less the last sampled token, which is the next
    step's input) — the tokens a survivor does not prefill again."""
    arch: str                                   # cfg.name of the producer
    max_len: int                                # producer cache max_len
    pos: int                                    # tokens with state
    rows: Dict[str, Dict[str, np.ndarray]] = field(default_factory=dict)
    # kind -> leaf -> (L, ...) one slot's rows
    dtypes: Dict[str, Dict[str, str]] = field(default_factory=dict)
    # kind -> leaf -> dtype name, where the rows hold another dtype's bits

    @property
    def n_state_tokens(self) -> int:
        return self.pos

    def nbytes(self) -> int:
        return sum(a.nbytes for leaves in self.rows.values()
                   for a in leaves.values())

    def leaf_dtype(self, kind: str, leaf: str) -> str:
        return self.dtypes.get(kind, {}).get(leaf,
                                             self.rows[kind][leaf].dtype.name)

    def compatible_with(self, cache: Dict, arch: str, max_len: int) -> bool:
        """True iff this snapshot can be scattered into ``cache``: the same
        arch and max_len, and every leaf's per-slot shape and dtype equal
        to the cache's."""
        if self.arch != arch or self.max_len != max_len:
            return False
        for kind, leaves in self.rows.items():
            if kind not in cache:
                return False
            for leaf, a in leaves.items():
                if leaf not in cache[kind]:
                    return False
                dst = cache[kind][leaf]
                if a.shape != tuple(dst.shape[:1] + dst.shape[2:]):
                    return False
                if self.leaf_dtype(kind, leaf) != dtype_name(dst.dtype):
                    return False
        return True


def leaf_tensor(a: np.ndarray, name: str, device) -> torch.Tensor:
    """Host rows -> a tensor of dtype ``name`` on ``device`` (one
    host-to-device copy).  A bfloat16 leaf is read through its 16-bit view,
    whether it arrives as uint16 bits or as ml_dtypes bfloat16."""
    a = np.ascontiguousarray(a)
    if name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """One device-to-host copy; a bf16 tensor comes back as its uint16
    bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtypes(cache: Dict) -> Dict[str, Dict[str, str]]:
    return {kind: {leaf: "bfloat16" for leaf, arr in cache[kind].items()
                   if arr.dtype == torch.bfloat16}
            for kind in KINDS if kind in cache}


def export_slot(cache: Dict, slot: int, *, arch: str,
                max_len: int) -> KVSnapshot:
    """Snapshot one slot of a slot-stacked cache to host memory: one
    device-to-host copy per kind leaf (leaves are stacked across layers)."""
    rows = {kind: {leaf: _to_host(arr[:, slot])
                   for leaf, arr in cache[kind].items()}
            for kind in KINDS if kind in cache}
    return KVSnapshot(arch=arch, max_len=max_len,
                      pos=int(cache["pos"][slot]), rows=rows,
                      dtypes=_dtypes(cache))


def export_slots(cache: Dict, slots: Sequence[int], *, arch: str,
                 max_len: int) -> List[KVSnapshot]:
    """Batched export (the whole-server drain): the requested slots of each
    kind leaf are gathered on the device and cross to the host in one copy
    per leaf, then split on the host (each snapshot owns its rows).
    Returns snapshots in the order of ``slots``."""
    slots = list(slots)
    if not slots:
        return []
    dev = cache["pos"].device
    idx = torch.tensor(slots, dtype=torch.long, device=dev)
    host = {kind: {leaf: _to_host(arr.index_select(1, idx))
                   for leaf, arr in cache[kind].items()}
            for kind in KINDS if kind in cache}
    pos = _to_host(cache["pos"].index_select(0, idx))
    dtypes = _dtypes(cache)
    return [KVSnapshot(arch=arch, max_len=max_len, pos=int(pos[j]),
                       rows={kind: {leaf: a[:, j].copy()
                                    for leaf, a in leaves.items()}
                             for kind, leaves in host.items()},
                       dtypes={k: dict(v) for k, v in dtypes.items()})
            for j in range(len(slots))]
