"""Activation-sharding policy (the port of ``repro/distributed/context.py``).

The reference's model code calls ``constrain(x, role)`` at layer
boundaries, which pins an activation to the installed policy's sharding,
and its MoE routes tokens per device-local group, the number of groups
coming from that policy.  The port runs on one card: ``constrain`` is a
no-op here, and only the policy's metadata (its token groups and the spec
of each role) is applied.

Roles:
  act    (B, S, D)   — residual stream:      (dp, seq, None)
  ffh    (B, S, F)   — FFN/inner hidden:     (dp, seq, None)
  heads  (B, S, H, d)— per-head activations: (dp, seq, None, None)
  logits (B, S, V)   — unembedded logits:    (dp, seq, None)
  tok    (T, ...)    — token-major:          ((dp..., seq), None...)
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

from repro_torch.distributed.shardings import P
from repro_torch.launch.mesh import Mesh

_STATE = threading.local()


class ShardingPolicy:
    def __init__(self, mesh: Mesh, *, dp_axes: Tuple[str, ...] = ("data",),
                 seq_axis: Optional[str] = "model",
                 vocab_axis: Optional[str] = None,
                 ff_axis: Optional[str] = None):
        self.mesh = mesh
        dp = tuple(a for a in dp_axes if a in mesh.axis_names)
        self.dp = dp if len(dp) > 1 else (dp[0] if dp else None)
        self.seq = seq_axis if (seq_axis in mesh.axis_names) else None
        self.vocab = vocab_axis if (vocab_axis in mesh.axis_names) else None
        self.ff = ff_axis if (ff_axis in mesh.axis_names) else None

    def _dp_list(self):
        if self.dp is None:
            return []
        return list(self.dp) if isinstance(self.dp, tuple) else [self.dp]

    @property
    def token_groups(self) -> int:
        """Number of token shards (dp x seq): MoE routes per group, so
        capacity and dispatch stay local (GShard per-group semantics)."""
        n = 1
        for a in self._dp_list():
            n *= self.mesh.shape[a]
        if self.seq is not None:
            n *= self.mesh.shape[self.seq]
        return n

    def spec(self, role: str, ndim: int) -> P:
        if role == "tok":
            axes = self._dp_list() + ([self.seq] if self.seq else [])
            lead = tuple(axes) if len(axes) > 1 else (axes[0] if axes
                                                      else None)
            return P(lead, *([None] * (ndim - 1)))
        lead = [self.dp, self.seq]
        if role == "logits" and self.vocab is not None and ndim >= 3:
            return P(*(lead + [None] * (ndim - 3) + [self.vocab]))
        if role == "ffh" and self.ff is not None and ndim >= 3:
            return P(*(lead + [None] * (ndim - 3) + [self.ff]))
        return P(*(lead + [None] * (ndim - 2)))


def set_policy(policy: Optional[ShardingPolicy]) -> None:
    _STATE.policy = policy


def get_policy() -> Optional[ShardingPolicy]:
    return getattr(_STATE, "policy", None)


class use_policy:
    """Install ``policy`` for the block (per thread), then restore the
    previous one."""

    def __init__(self, policy: Optional[ShardingPolicy]):
        self.policy = policy

    def __enter__(self):
        self.prev = get_policy()
        set_policy(self.policy)
        return self.policy

    def __exit__(self, *exc):
        set_policy(self.prev)


def constrain(x, role: str = "act"):
    """The reference pins ``x`` to the policy's sharding for ``role``.  On
    one device there is nothing to pin: ``x`` is returned as it is, with a
    policy installed or not."""
    return x
