"""Deterministic, resumable, shardable data pipeline (the port's own copy
of ``repro/training/data.py``: numpy only, batch for batch the
reference's).

Two sources:
  * ``SyntheticLM``  — seeded synthetic token stream with learnable structure
                       (a fixed random bigram table) so small models visibly
                       learn; used by benches/dry-runs/examples.
  * ``CorpusLM``     — byte-level corpus batcher for the quickstart demo.

Both expose ``state()`` / ``restore(state)`` so a restart from a checkpoint
resumes the exact stream position (fault-tolerance requirement), and
``shard(rank, world)`` for data parallelism.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    batch_size: int           # per-host batch
    seed: int = 0
    rank: int = 0
    world: int = 1
    step: int = 0
    structured: bool = True   # sample from a fixed bigram chain

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        if self.structured:
            # sparse-ish bigram transition: each token has 8 likely successors
            succ = rng.integers(0, self.vocab_size,
                                size=(self.vocab_size, 8))
            self._succ = succ
        else:
            self._succ = None

    def _rng_for(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + step) * self.world + self.rank)

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = self._rng_for(self.step)
        B, S, V = self.batch_size, self.seq_len, self.vocab_size
        if self._succ is not None:
            toks = np.empty((B, S + 1), np.int32)
            toks[:, 0] = rng.integers(0, V, size=B)
            choices = rng.integers(0, 8, size=(B, S))
            for t in range(S):
                toks[:, t + 1] = self._succ[toks[:, t], choices[:, t]]
        else:
            toks = rng.integers(0, V, size=(B, S + 1)).astype(np.int32)
        self.step += 1
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def state(self) -> Dict:
        return {"step": self.step, "seed": self.seed, "rank": self.rank,
                "world": self.world}

    def restore(self, state: Dict):
        if state["seed"] != self.seed:
            raise ValueError(f"data state of seed {state['seed']} restored "
                             f"into a stream of seed {self.seed}")
        self.step = state["step"]

    def shard(self, rank: int, world: int) -> "SyntheticLM":
        return dataclasses.replace(self, rank=rank, world=world)


@dataclass
class CorpusLM:
    """Byte-level batches over a text corpus (quickstart demo)."""
    text: str
    seq_len: int
    batch_size: int
    seed: int = 0
    step: int = 0

    def __post_init__(self):
        self._data = np.frombuffer(self.text.encode("utf-8"),
                                   dtype=np.uint8).astype(np.int32)

    @property
    def vocab_size(self) -> int:
        return 256

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 7_777_777 + self.step)
        n = len(self._data) - self.seq_len - 1
        starts = rng.integers(0, n, size=self.batch_size)
        toks = np.stack([self._data[s:s + self.seq_len + 1] for s in starts])
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def state(self) -> Dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: Dict):
        self.step = state["step"]
