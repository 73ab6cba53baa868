#!/usr/bin/env python3
"""One serving decode step on the card, run eagerly and replayed from its
captured CUDA graph, for pipeboost-opt-1.3b, mamba2-780m,
recurrentgemma-2b and qwen2-moe-a2.7b (its dropless experts) at full width
(bf16, 4 slots, max_len 1024, the 4 live requests of 64-512 prompt tokens
that ``chip_smoke.py``'s recovery phase serves).

For each model it prints:

- the wall time of one step (host clock around the step, the device
  synchronised on both sides), eager and replayed, the median of 20;
- a ``torch.profiler`` trace of one eager step and one replay: the
  device's busy time (the union of the kernels' intervals), its share of
  the profiled step's span and of the unprofiled step's wall time, and the
  kernels that take most device time;
- whether the replay reproduces the eager step bit for bit: the logits,
  the sampled tokens and every cache leaf, from the same state.

Run from the root of a checkout, on a machine with the card:

    python3 tools/decode_profile.py [--arch NAME ...] [--trace-dir DIR]
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCHS = ("pipeboost-opt-1.3b", "mamba2-780m", "recurrentgemma-2b",
         "qwen2-moe-a2.7b")


def _state(b):
    """Every tensor a decode step writes, cloned."""
    import torch
    out = {"tokens": b._dev_tokens.clone(), "pos": b.cache["pos"].clone()}
    for kind in ("attn", "ssm", "rec"):
        for leaf, t in b.cache.get(kind, {}).items():
            out[f"{kind}.{leaf}"] = t.clone()
    return out


def _restore(b, st) -> None:
    b._dev_tokens.copy_(st["tokens"])
    b.cache["pos"].copy_(st["pos"])
    for kind in ("attn", "ssm", "rec"):
        for leaf, t in b.cache.get(kind, {}).items():
            t.copy_(st[f"{kind}.{leaf}"])


def _busy(prof, torch):
    """(device busy us, profiled span us, kernel count, [(kernel, device
    us)]): the union of the device activities' intervals (the "step"
    annotation's own device-side range left out) within the CPU-side
    "step" range."""
    spans, names = [], {}
    lo, hi = float("inf"), 0.0
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.name == "step":
            if e.device_type != torch.autograd.DeviceType.CUDA:
                lo, hi = start, end
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((start, end))
            names[e.name] = names.get(e.name, 0.0) + (end - start)
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        hi = max(hi, cur_e)
    top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
    return busy, hi - lo, len(spans), top


def profile(arch: str, trace_dir: Path) -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile, \
        record_function
    from repro_torch.configs.base import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as S
    dev = torch.device("cuda", 0)
    cfg = get_arch(arch)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(7),
                           device=dev)
    logits = {}

    def sampler(lg):            # keeps the decode step's logits
        if lg.shape[0] == 4:
            logits.setdefault("buf", torch.empty_like(lg)).copy_(lg)
        return S.quantized_greedy(lg)

    srv = S.ServingEngine(cfg, params, n_slots=4, max_len=1024)
    b = srv.batcher
    b.sampler = sampler
    rng = np.random.default_rng(7)
    for i, L in enumerate(rng.integers(64, 513, size=4)):
        srv.submit(S.ServeRequest(i, rng.integers(0, cfg.vocab_size,
                                                  size=int(L)),
                                  max_new_tokens=1000))
    for _ in range(3):
        srv.step()                # admission, eager step + capture, replay
    assert b.compile_stats()["decode_compiles"] == 1

    def timed(fn, n=20):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    st = _state(b)
    eager_ms = timed(b._decode_sample)
    _restore(b, st)
    replay_ms = timed(b._graph.replay)
    _restore(b, st)
    print(f"  {arch}: one decode step, 4 live slots: eager "
          f"{eager_ms:.3f} ms, replayed {replay_ms:.3f} ms (median of 20, "
          f"host clock, device synchronised)")
    # the replay against the eager step, bit for bit, from one state
    b._decode_sample()
    torch.cuda.synchronize()
    eager = _state(b)
    eager["logits"] = logits["buf"].clone()
    _restore(b, st)
    b._graph.replay()
    torch.cuda.synchronize()
    replay = _state(b)
    replay["logits"] = logits["buf"].clone()
    diff = {k: (eager[k].float() - replay[k].float()).abs().max().item()
            for k in eager if not torch.equal(eager[k], replay[k])}
    print(f"    replay against eager from one state: "
          + ("bit-equal logits, tokens and cache" if not diff else
             f"differs in {diff}"))
    for label, fn, wall in (("eager", b._decode_sample, eager_ms),
                            ("replayed", b._graph.replay, replay_ms)):
        _restore(b, st)
        fn()                                  # warm
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            with record_function("step"):
                fn()
                torch.cuda.synchronize()
        busy, span, n_kernels, top = _busy(prof, torch)
        print(f"    profiler, {label} step: {n_kernels} device activities, "
              f"device busy {busy:.1f} us: {100 * busy / span:.1f}% of the "
              f"profiled step's {span:.1f} us, "
              f"{100 * busy / (wall * 1e3):.1f}% of the unprofiled "
              f"{wall:.3f} ms")
        for name, us in top:
            print(f"      {us:9.1f} us  {name[:100]}")
        trace_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_dir / f"{arch}_{label}.json"))
    del srv, b, params
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    import subprocess
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", choices=ARCHS)
    ap.add_argument("--trace-dir", default=str(ROOT / "build" /
                                               "decode_profile"),
                    help="where the Chrome traces are written")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_profile: no CUDA card visible", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"torch {torch.__version__}")
    for arch in args.arch or ARCHS:
        profile(arch, Path(args.trace_dir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
