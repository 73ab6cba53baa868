"""One run of a serving cell: the program built as its serving launcher
builds one replica, warmed on this cell's shapes, then driven for
``seconds`` by the benchmark's open-loop front end.

The system under test is ``repro_torch.serving.engine.ServingEngine``
over the base weights, with the cell's adapters merged by the program's
``lora.adapters.merge_lora`` (the LoRA-merge kernel) and an
``EpochSchedulerPolicy``, as ``launch/serve.py`` ``run()`` builds it.
The loop: submit each request when it falls due, call
``ServingEngine.step(now=...)``, read every live request's ``generated``
after the step.  A step ends in the program's one host read of the
sampled tokens, so the clock read after it is synchronous; the benchmark
stamps every token itself (the program's ``first_token_at`` is stamped
before the prefill runs).  With nothing live and nothing due the loop
sleeps until the next arrival.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from pbb import manifest, traffic, weights
from pbb.stats import Stamps

SRC = manifest.ROOT / "src"


def _program():
    """The program's modules (imported here, never by the reference)."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.configs.base import ArchConfig, get_arch
    from repro_torch.core.adapter_scheduler import EpochSchedulerPolicy
    from repro_torch.lora.adapters import LoRAAdapter, merge_lora
    from repro_torch.serving import engine
    return dict(ArchConfig=ArchConfig, get_arch=get_arch,
                EpochSchedulerPolicy=EpochSchedulerPolicy,
                LoRAAdapter=LoRAAdapter, merge_lora=merge_lora,
                engine=engine)


def program_config(m: Dict):
    """The program's ``ArchConfig`` of ``arch``, with every size the
    configuration file states."""
    p = _program()
    names = {f.name for f in dataclasses.fields(p["ArchConfig"])}
    over = {k: v for k, v in m.items()
            if k in names and k not in ("name", "source")}
    return dataclasses.replace(p["get_arch"](m["arch"]), **over)


@dataclass
class StepRec:
    """One ``ServingEngine.step`` inside the window."""
    t0: float
    t1: float
    decode_s: float                # the program's decode_time_s delta
    admitted: List[int] = field(default_factory=list)   # prompt lengths
    n_live: int = 0                # rows of the decode step
    cached_rows: int = 0           # their cached positions, in all
    n_queued: int = 0              # requests waiting after the step
    traced: bool = False


@dataclass
class Server:
    """The program's replica and what it was built from."""
    m: Dict                        # the configuration file
    params: Dict                   # the benchmark's weights
    loras: Dict                    # the benchmark's LoRA factors
    engine: object                 # the program's ServingEngine
    device: torch.device


def build(m: Dict, spec: Dict, seed: int, device) -> Server:
    """Weights and adapters from the seed, then the program's replica."""
    p = _program()
    device = torch.device(device)
    cfg = program_config(m)
    gen = weights.generator(seed, device)
    params = weights.make_params(m, gen, device)
    names = sorted(a for a in spec.get("adapters", {}) if a != "base")
    loras = weights.make_loras(m, names, m["lora"]["rank"], gen, device) \
        if names else {}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    kind = weights.layer_kind(m)
    merged = {name: p["merge_lora"](params, p["LoRAAdapter"](
        name, m["lora"]["rank"], float(m["lora"]["alpha"]), {kind: f}))
        for name, f in loras.items()}
    srv = m["serving"]
    eng = p["engine"].ServingEngine(
        cfg, params, n_slots=srv["n_slots"], max_len=srv["max_len"],
        policy=p["EpochSchedulerPolicy"](**srv["policy"]),
        adapter_params=merged)
    return Server(m, params, loras, eng, device)


def _serve_request(srv: Server, rid: int, prompt, out_len: int,
                   adapter: Optional[str]):
    return _program()["engine"].ServeRequest(rid, prompt,
                                             max_new_tokens=out_len,
                                             adapter=adapter)


def warm(srv: Server, reqs: List[traffic.Request], seed: int) -> None:
    """Capture the decode step and run one admission prefill of each
    prefill shape this traffic makes (its buckets; where prompts prefill
    at their exact length, one prefill at the median length)."""
    eng = srv.engine
    eng.batcher.warm_decode()
    shapes = sorted({eng.batcher.bucket_for(_serve_request(
        srv, 0, r.prompt, 1, None)) for r in reqs})
    buckets = _program()["engine"].bucket_sizes(srv.m["serving"]["max_len"])
    if not set(shapes) <= set(buckets):
        shapes = [int(np.median([len(r.prompt) for r in reqs]))]
    rng = traffic.stream(seed, 7)
    for i, n in enumerate(shapes):
        eng.submit(_serve_request(srv, -1 - i, rng.integers(
            0, srv.m["vocab_size"], size=n), 1, None))
        eng.step()
    eng.completed.clear()
    _sync(srv.device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    seconds: float
    stamps: Dict[int, Stamps]
    steps: List[StepRec]
    finished: List                  # (traffic.Request, served tokens)
    attempted: int
    late_s: float                   # the front end's largest lateness
    switches: int                   # adapter switches in the window
    trace: Optional[object] = None  # trace.TraceSummary


def submit_backlog(srv: Server, reqs: List[traffic.Request]) -> List:
    """An offline batch: every request queued at once, and one step run so
    that as many as there are slots are admitted (prefilled) before the
    window opens.  Returns the (request, program request) pairs for
    ``run_window``."""
    queued = []
    for r in reqs:
        s = _serve_request(srv, r.rid, r.prompt, r.out_len, r.adapter)
        s.arrival = 0.0
        srv.engine.submit(s)
        queued.append((r, s))
    srv.engine.step(now=0.0)
    _sync(srv.device)
    return queued


def prepare(m: Dict, spec: Dict, seed: int, seconds: float, device):
    """Everything before the window: the requests from the seed, the
    replica built and warmed on their shapes and, for an offline batch,
    the backlog queued with its first admissions made.  Returns the server
    and ``run_window``'s ``due`` and ``queued``."""
    reqs = traffic.make(spec, seed, seconds, m["vocab_size"])
    srv = build(m, spec, seed, device)
    warm(srv, reqs, seed)
    if spec["arrivals"]["kind"] == "backlog":
        return srv, [], submit_backlog(srv, reqs)
    return srv, reqs, None


TRACE_SEARCH_S = 8.0     # seconds a traced tail may wait for an admission


def _admits_now(eng) -> bool:
    """Whether the next step admits: a free slot and a queued request of an
    adapter admittable without an epoch switch."""
    if not eng.batcher.free:
        return False
    ok = eng.resident_adapters()
    return any(r.adapter in ok for r in eng.queued_requests())


def run_window(srv: Server, due: List[traffic.Request], seconds: float,
               queued: Optional[List] = None,
               trace_at: Optional[float] = None,
               trace_seconds: float = 0.0) -> Window:
    """Drive the replica for ``seconds``: each request of ``due`` is
    submitted when it falls due (open loop); ``queued`` holds (request,
    program request) pairs submitted before the window (a backlog).
    ``trace_at``: profile the card for ``trace_seconds`` from the first
    step at or after that time that admits a request (at most
    ``TRACE_SEARCH_S`` later), so that a traced tail holds an admission
    prefill."""
    eng, b = srv.engine, srv.engine.batcher
    pending = sorted(due, key=lambda r: r.due, reverse=True)
    live = list(queued or [])
    seen = {r.rid: len(s.generated) for r, s in live}
    stamps = {r.rid: Stamps(r.due) for r, _ in live}
    steps: List[StepRec] = []
    finished: List = []
    attempted = len(live)
    late = 0.0
    sw0 = eng.n_adapter_switches
    prof = window_range = None
    tracing = False
    stop_s = 0.0
    if trace_at is not None:
        from torch.profiler import ProfilerActivity, profile, record_function
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if srv.device.type == "cuda" else []))
    t_start = time.perf_counter()

    def clock() -> float:
        return time.perf_counter() - t_start

    def scope(name: str):
        return record_function(name) if tracing else contextlib.nullcontext()

    while True:
        now = clock()
        if now >= seconds:
            break
        if prof is not None and window_range is None and now >= trace_at \
                and (now >= trace_at + TRACE_SEARCH_S or _admits_now(eng)):
            prof.start()
            tracing = True
            window_range = record_function("pbb.window")
            window_range.__enter__()
            trace_end = clock() + trace_seconds
        elif tracing and now >= trace_end:
            window_range.__exit__(None, None, None)
            prof.stop()
            tracing = False
            stop_s = clock() - now
        while pending and pending[-1].due <= now:
            r = pending.pop()
            s = _serve_request(srv, r.rid, r.prompt, r.out_len, r.adapter)
            s.arrival = r.due
            eng.submit(s)
            live.append((r, s))
            seen[r.rid] = 0
            stamps[r.rid] = Stamps(r.due)
            attempted += 1
            late = max(late, now - r.due)
        if eng.idle:
            nxt = pending[-1].due if pending else seconds
            with scope("pbb.idle"):
                time.sleep(max(0.0, min(nxt, seconds) - now))
            continue
        d0 = b.decode_time_s
        t0 = clock()
        with scope("pbb.step"):
            eng.step(now=t0)
        t1 = clock()
        with scope("pbb.stamp"):
            rec = StepRec(t0, t1, b.decode_time_s - d0, traced=tracing)
            keep = []
            for r, s in live:
                n, k = len(s.generated), seen[r.rid]
                if n > k:
                    if k == 0:
                        rec.admitted.append(len(r.prompt))
                    if k > 0 or n - k >= 2:     # it was in the decode step
                        rec.n_live += 1
                        rec.cached_rows += len(r.prompt) + n - 2
                    if t1 <= seconds:
                        stamps[r.rid].token_at.extend([t1] * (n - k))
                    seen[r.rid] = n
                if s.done:
                    stamps[r.rid].finished_at = t1
                    if t1 <= seconds:
                        finished.append((r, list(s.generated)))
                else:
                    keep.append((r, s))
            live = keep
            rec.n_queued = len(eng.queued_requests())
            steps.append(rec)
    if tracing:
        window_range.__exit__(None, None, None)
        prof.stop()
    _sync(srv.device)
    if window_range is not None:
        print(f"traced from {trace_end - trace_seconds:.3f} s of the window "
              f"for {trace_seconds} s; the profiler's stop took "
              f"{stop_s:.3f} s", file=sys.stderr)
    summary = None
    if prof is not None and window_range is not None:
        from pbb import trace
        summary = trace.reduce(prof)
    return Window(seconds, stamps, steps, finished, attempted, late,
                  eng.n_adapter_switches - sw0, summary)


def release(srv: Server) -> None:
    """Free the program's state (its cache, captured step, owned and merged
    weights); the benchmark's weights and factors stay for the check."""
    srv.engine = None
    gc.collect()
    if srv.device.type == "cuda":
        torch.cuda.empty_cache()
