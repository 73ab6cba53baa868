"""One run of one cell, from the manifest's data to the result line."""
from __future__ import annotations

import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from pbb import check, manifest, serve, stats
from pbb.serve import Window
from pbb.trace import TraceSummary


@dataclass
class Ctx:
    """What a metric's reader reads."""
    m: Dict                         # the configuration file
    spec: Dict                      # the traffic mix
    seconds: float
    window: Window
    setup_s: float
    peak_bytes: int
    trace: Optional[TraceSummary]

    @property
    def slots(self) -> int:
        return self.m["serving"]["n_slots"]

    @property
    def window_steps(self) -> List[serve.StepRec]:
        """The steps outside the traced sub-window (the profiler slows
        those inside it)."""
        return [s for s in self.window.steps if not s.traced]

    @property
    def traced_steps(self) -> List[serve.StepRec]:
        return [s for s in self.window.steps if s.traced]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _warm_profiler(device: torch.device) -> None:
    """Start and stop the profiler once, so its first start (CUPTI's set-up)
    falls in set-up and not in the window."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device.type == "cuda" else [])
    with profile(activities=acts):
        torch.ones(8, device=device).sum().item()


def run_cell(cell: str, m: Dict, spec: Dict, metrics: List[Dict], seed: int,
             seconds: float, trace: bool, device, t_proc: float,
             log=sys.stderr) -> Dict:
    """Set up, drive the window, read the metrics, check the served tokens;
    returns the result line's object (``checks`` last)."""
    device = torch.device(device)
    srv, due, queued = serve.prepare(m, spec, seed, seconds, device)
    trace_at = None
    if trace:
        _warm_profiler(device)
        # near the window's end, where the replica is in its steady state
        trace_at = max(0.0, seconds - spec["trace"]["seconds"]
                       - serve.TRACE_SEARCH_S)
    setup_s = time.perf_counter() - t_proc
    win = serve.run_window(srv, due, seconds, queued, trace_at,
                           spec["trace"]["seconds"])
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    ctx = Ctx(m, spec, seconds, win, setup_s, peak, win.trace)
    out: Dict[str, Dict] = {}
    for met in metrics:
        v = manifest.reader(met["name"])(ctx)
        if v is not None:
            out[met["name"]] = {"value": float(v), "unit": met["unit"]}
    # the tails the end-to-end metrics stand in for, for the record
    st = list(win.stamps.values())
    tt, tp = stats.ttft_s(st, seconds), stats.tpot_s(st)
    for name, xs in (("ttft_s", tt), ("tpot_s", tp)):
        if xs:
            print(f"{name} over {len(xs)} requests: " + ", ".join(
                f"p{q} {stats.percentile(xs, q)!r}"
                for q in (50, 90, 95, 99)), file=log)
    if tt:
        print(f"ttft_s mean {sum(tt) / len(tt)!r}, slowest 5% mean "
              f"{stats.tail_mean(tt, 0.05)!r}; tpot_s over tokens mean "
              f"{stats.tpot_mean_s(st)!r}", file=log)
    print(f"{cell} window: {win.attempted} requests attempted, "
          f"{len(win.finished)} finished, {len(win.steps)} steps, "
          f"front end at most {win.late_s * 1e3:.3f} ms late; set-up "
          f"{setup_s:.3f} s", file=log)
    serve.release(srv)
    t_check = time.perf_counter()
    got = check.judge_run(srv, win.finished, seed, spec)
    checks, correct = check.verdict(got, spec)
    print(f"check: {int(got['requests_checked'])} requests, "
          f"{int(got['tokens_checked'])} served tokens, "
          f"{time.perf_counter() - t_check:.3f} s; widest gap "
          f"{got['gap_max']!r} at {got['widest_at']}, mean gap "
          f"{got['gap_mean']!r}, largest of a request's mean gaps "
          f"{got['request_gap_mean_max']!r}, {got['off_best_share']!r} of the "
          f"tokens off the reference's best", file=log)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    res = {"correct": bool(correct), "attempted": int(win.attempted),
           "failed": 0, "metrics": out, "device": dev}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    if win.trace is not None:
        dev["busy_s"] = win.trace.busy_s
        dev["window_s"] = win.trace.window_s
        res["breakdown"] = win.trace.breakdown()
    for name, c in checks.items():
        bound = c.get("limit", c.get("least"))
        rel = "limit" if "limit" in c else "at least"
        print(f"{name} {c['value']!r} {rel} {bound!r}", file=log)
    res["checks"] = checks
    return res
