"""Records and spans of the serving step: what ``ServingEngine.step`` and
its ``ContinuousBatcher`` spent their host time on.

One module-level ``TRACER`` takes what every engine and batcher in the
process records.

Records are always on.  Each is a tuple appended once per event to a
bounded ring (``RING`` entries a kind, the oldest dropped), stamped with
``clock``: the ``now`` of the ``ServingEngine.step`` it happened in, None
outside a step or in a step called without ``now``.  Their times come
from the ``time.perf_counter_ns`` reads the step takes anyway.

* ``prefill`` (``PrefillRec``): one per admission prefill
  (``ContinuousBatcher._admit_rows``): rows P, bucket, real tokens,
  requests, backend, the bytes of the transient cache the prefill built,
  and host seconds from the padded tokens' upload to the first tokens on
  the host (synchronous: it ends in the admission's read of them); then
  the bytes of recurrent state (SSM and RG-LRU conv windows and states)
  it wrote into the slots, and the (token, choice) assignments its MoE
  layers dropped over their capacity.
* ``cache`` (``CacheRec``): one per ``ContinuousBatcher`` built (a
  set-up counter): the bytes of its slot cache by kind, attention K/V
  (``kv``), conv windows (``conv``) and SSM or RG-LRU states (``ssm``).
* ``decode`` (``DecodeRec``): one per ``ContinuousBatcher.step``: live
  rows and host seconds in four parts that sum to the step's share of
  ``decode_time_s``: ``io`` (the step inputs' upload when slots changed),
  ``launch`` (the captured graph's replay call, or the eager step on the
  CPU), ``wait`` (the read of the sampled tokens: the card's time left
  after the launch returns) and ``book`` (the per-slot loop and the
  prefix deposit).

Spans are recorded only while tracing is on: after ``enable()``, or in an
engine step during which a ``torch.profiler`` records in the process.
Each holds name, id, parent id, start and end (``perf_counter_ns``) and
attributes.  While a profiler records, each span also enters a profiler
range of its name, so the trace holds the program's phases on its own
clock: ``engine.step`` > ``engine.admit`` > (``engine.switch``,
``batcher.prefill`` > ``model.ssm_prefill``, one a Mamba-2 mixer's scan),
and ``engine.step`` > ``batcher.decode`` >
(``batcher.decode.io``, ``.launch``, ``.wait``, ``.book``).  The range is
a function-scope one (``torch._C._profiler._RecordFunctionFast``), which
the trace shows as a host op: ``torch.profiler.record_function``'s
user-scope range would also make a device-side annotation over the
kernels launched inside it, which a reduction summing the device's
activities takes for device work.  With tracing off a span site costs
one flag test and returns a shared no-op context.
"""
from __future__ import annotations

import collections
import itertools
import time
from typing import Deque, Dict, List, NamedTuple, Optional

import torch

RING = 1 << 16          # entries kept of each kind of record, and of spans


class PrefillRec(NamedTuple):
    clock: Optional[float]
    rows: int               # P: rows prefilled (pad rows included)
    bucket: int             # padded length of each row
    tokens: int             # real (unpadded) tokens
    requests: int
    backend: str            # "single" or "pipeline"
    cache_bytes: int        # the transient cache the prefill built
    seconds: float
    state_bytes: int = 0    # recurrent state written into the slots
    dropped: int = 0        # MoE assignments dropped over capacity


class CacheRec(NamedTuple):
    clock: Optional[float]
    kv: int                 # attention K and V
    conv: int               # SSM and RG-LRU conv windows
    ssm: int                # SSM and RG-LRU states


class DecodeRec(NamedTuple):
    clock: Optional[float]
    live: int               # rows of the step
    io: float
    launch: float
    wait: float
    book: float


class Span:
    """One timed range of the serving step (tracing on only)."""
    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "attrs")

    def __init__(self, name: str, sid: int, attrs: Dict):
        self.name, self.id, self.attrs = name, sid, attrs
        self.parent: Optional[int] = None
        self.start_ns = self.end_ns = 0


class _NoSpan:
    """The shared context of a span site while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Open:
    """The context of one span while tracing is on."""
    __slots__ = ("tracer", "span", "range")

    def __init__(self, tracer: "Tracer", span: Span):
        self.tracer, self.span, self.range = tracer, span, None

    def __enter__(self) -> Span:
        t, s = self.tracer, self.span
        s.parent = t._stack[-1] if t._stack else None
        t._stack.append(s.id)
        if t._profiling:
            self.range = torch._C._profiler._RecordFunctionFast(s.name)
            self.range.__enter__()
        s.start_ns = time.perf_counter_ns()
        return s

    def __exit__(self, *exc):
        t, s = self.tracer, self.span
        s.end_ns = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        t._stack.pop()
        t.spans.append(s)
        return False


class _Step:
    """An engine step's scope: its ``now`` stamps the records, the tracing
    flag is read once, and an ``engine.step`` span opens if it is on."""
    __slots__ = ("tracer", "now", "prev", "span")

    def __init__(self, tracer: "Tracer", now: Optional[float]):
        self.tracer, self.now = tracer, now

    def __enter__(self):
        t = self.tracer
        self.prev = (t.clock, t.on, t._profiling)
        t.clock = self.now
        # whether a torch.profiler records in this process
        t._profiling = torch._C._autograd._profiler_enabled()
        t.on = t.enabled or t._profiling
        self.span = t.span("engine.step", clock=self.now)
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        t = self.tracer
        self.span.__exit__(*exc)
        t.clock, t.on, t._profiling = self.prev
        return False


class Tracer:
    """The rings of records and spans (see the module's docstring)."""

    def __init__(self, maxlen: int = RING):
        self.prefill: Deque[PrefillRec] = collections.deque(maxlen=maxlen)
        self.cache: Deque[CacheRec] = collections.deque(maxlen=maxlen)
        self.decode: Deque[DecodeRec] = collections.deque(maxlen=maxlen)
        self.spans: Deque[Span] = collections.deque(maxlen=maxlen)
        self.clock: Optional[float] = None
        self.enabled = False        # enable(): spans on every step
        self.on = False             # spans recorded now
        self._profiling = False     # a torch.profiler records this step
        self._stack: List[int] = []
        self._ids = itertools.count(1)

    def span(self, name: str, **attrs):
        """A context that records span ``name`` while tracing is on."""
        if not self.on:
            return NO_SPAN
        return _Open(self, Span(name, next(self._ids), attrs))

    def step(self, now: Optional[float]) -> _Step:
        """The scope of one ``ServingEngine.step`` at ``now``."""
        return _Step(self, now)

    def clear(self) -> None:
        """Drop every record and span kept so far."""
        for ring in (self.prefill, self.cache, self.decode, self.spans):
            ring.clear()


TRACER = Tracer()


def enable() -> None:
    """Record spans in every engine step from now on."""
    TRACER.enabled = TRACER.on = True


def disable() -> None:
    """Record spans only in steps during which a profiler records."""
    TRACER.enabled = TRACER.on = False
