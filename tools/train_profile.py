#!/usr/bin/env python3
"""One train step of pipeboost-opt-1.3b on the card, split and profiled:
full width and depth (24 layers, 1.31 B parameters), bf16, every layer
rematerialised, batch 8 x 512 from ``SyntheticLM``, as ``chip_smoke.py``
phase 10b runs it through ``launch.train``.

It prints:

- the wall time of the step and of its two halves, the loss and gradients
  (``value_and_grad`` of the loss: forward, the recomputed forwards and
  the backward) and the AdamW update (global norm, clip, moments,
  parameters), each the median of 5 (host clock, device synchronised);
- a ``torch.profiler`` trace of one step: the device's busy time (the
  union of the kernels' intervals) against the step's span, and the
  kernels that take most device time, summed by name and grouped into
  GEMMs, the flash kernel, and the rest.

Run from the root of a checkout, on a machine with the card:

    python3 tools/train_profile.py [--trace-dir DIR]
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

ARCH = "pipeboost-opt-1.3b"
B, S = 8, 512


def _group(name: str) -> str:
    n = name.lower()
    if "flash" in n:
        return "flash kernel"
    if any(w in n for w in ("gemm", "nvjet", "cutlass", "sm90_xmma",
                            "ampere", "cublas")):
        return "GEMM"
    return "other"


def main(argv=None) -> int:
    import subprocess
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from decode_profile import _busy
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace-dir", default=str(ROOT / "build" /
                                               "train_profile"),
                    help="where the Chrome trace is written")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile: no CUDA card visible", file=sys.stderr)
        return 2
    from repro_torch.configs.base import get_arch
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, adamw_update
    from repro_torch.training.train import (init_train_state, make_loss_fn,
                                            make_train_step, value_and_grad)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"torch {torch.__version__}")
    dev = torch.device("cuda", 0)
    cfg = get_arch(ARCH)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             torch.bfloat16, dev)
    ds = SyntheticLM(cfg.vocab_size, S, B, seed=0)

    def batch():
        return {k: torch.from_numpy(v).to(dev)
                for k, v in ds.next_batch().items()}

    step = make_train_step(cfg, opt, remat=True)
    grad_fn = value_and_grad(make_loss_fn(cfg, remat=True))
    for _ in range(2):                                   # warm
        state, _ = step(state, batch())
    torch.cuda.synchronize()

    def timed(fn, n=5):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    b = batch()
    step_ms = timed(lambda: step(state, b))
    grads = {}

    def loss_and_grads():
        grads["g"] = grad_fn(state.params, b)[1]
    grad_ms = timed(loss_and_grads)
    adamw_ms = timed(lambda: adamw_update(opt, state.params, grads["g"],
                                          state.opt))
    del grads["g"]
    print(f"  {ARCH} {B} x {S}, bf16, remat: step {step_ms:.1f} ms = loss "
          f"and gradients {grad_ms:.1f} ms + AdamW {adamw_ms:.1f} ms "
          f"(medians of 5, host clock, device synchronised)")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("step"):
            step(state, b)
            torch.cuda.synchronize()
    busy, span, n_kernels, _ = _busy(prof, torch)
    by_name, by_group = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                e.name != "step":
            us = e.time_range.end - e.time_range.start
            by_name[e.name] = by_name.get(e.name, 0.0) + us
            g = _group(e.name)
            by_group[g] = by_group.get(g, 0.0) + us
    print(f"  profiler, one step: {n_kernels} device activities, device "
          f"busy {busy / 1e3:.1f} ms: {100 * busy / span:.1f}% of the "
          f"profiled step's {span / 1e3:.1f} ms")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"    {g:12s} {us / 1e3:9.2f} ms")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"      {us / 1e3:8.2f} ms  {name[:110]}")
    trace_dir = Path(args.trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_dir / f"{ARCH}_train_step.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
