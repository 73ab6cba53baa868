#!/usr/bin/env python3
"""The SSD scan kernel at serving prompt lengths, and how its time splits
over its launches, measured on the card.

Runs ``ops.ssd_scan`` in bf16 at mamba2-780m's heads (H 48, P 64, N 128;
x, B and C strided slices of one ``conv_out``, as in the model) for one
prompt of S = 64, 512 and 1024 tokens (B 1).  Each length is checked
against the plain version under ``chip_smoke.py``'s bf16 limit, timed with
``chip_smoke.py``'s timing twice (the second round in reverse order, so
drift on the card shows as a gap between the two columns), and traced
over 50 calls with ``torch.profiler``, which gives each kernel's device
time a call and what each launch adds to a call (a dependent launch's
span overlaps the one before it).  ``--src DIR`` imports ``repro_torch``
from another checkout's ``src`` (its kernels built into that checkout's
``build/``), so two versions can be timed in one call on one card, in
turns; ``--p-block 32`` makes the chunk kernels take 32 columns of P a CTA
instead of the wrapper's choice.  Run from the root of a checkout, on a
machine with the card and the CUDA toolkit:

    python3 tools/ssd_phases.py [--src OTHER_CHECKOUT/src] [--p-block 32]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LENGTHS = (64, 512, 1024)
H, P, N = 48, 64, 128


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch to time")
    ap.add_argument("--p-block", type=int, default=None,
                    help="columns of P a CTA of the chunk kernels takes")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("ssd_phases: no CUDA card visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, ops   # before chip_smoke, which
    import chip_smoke as cs                      # puts ROOT/src on the path
    from repro_torch.kernels import ssd_scan
    if args.p_block is not None:
        ssd_scan.p_block = lambda *_: args.p_block
        print(f"chunk kernels at {args.p_block} columns of P a CTA")
    F = torch.nn.functional
    dev = torch.device("cuda", 0)
    print(f"nvidia-smi: {cs.nvidia_smi()}")
    print(f"repro_torch from {Path(build.__file__).resolve().parents[2]}")
    build.load()
    g = torch.Generator(device=dev).manual_seed(17)
    di = H * P
    A = -torch.linspace(1.0, 16.0, H, device=dev)

    def make(S):
        conv_out = F.silu(torch.randn((1, S, di + 2 * N), generator=g,
                                      device=dev)).to(torch.bfloat16)
        dt = F.softplus(torch.randn((1, S, H), generator=g, device=dev))
        return (conv_out[..., :di].reshape(1, S, H, P), dt, A,
                conv_out[..., di:di + N], conv_out[..., di + N:])

    sets = {}
    for S in LENGTHS:
        x = make(S)
        y, _ = ops.ssd_scan(*x)
        with ops.plain_versions():
            yr, _ = ops.ssd_scan(*[t.float() if t.dtype == torch.bfloat16
                                   else t for t in x])
        limit = cs.SSD_BF16_REL * yr.abs() + cs.SSD_BF16_MEAN * yr.abs().mean()
        ratio = ((y.float() - yr).abs() / limit).max().item()
        cs.require(ratio <= 1.0, f"S={S}: bf16 y at {ratio} of its limit")
        sets[S] = [x] + [make(S) for _ in range(
            cs.n_copies(cs.nbytes(x[0], x[1], x[3], x[4])) - 1)]
    times = {S: [] for S in LENGTHS}
    for order in (LENGTHS, LENGTHS[::-1]):
        for S in order:
            ms, _ = cs.time_ms(torch, f"ssd S={S}", [
                lambda s=s: ops.ssd_scan(*s) for s in sets[S]], 200)
            times[S].append(ms)
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    for S in LENGTHS:
        a, b = times[S]
        print(f"ssd B=1 S={S}: {a:.4f} ms, {b:.4f} ms")
        with torch.profiler.profile(activities=act) as prof:
            for i in range(50):
                ops.ssd_scan(*sets[S][i % len(sets[S])])
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0)
            if "ssd" in ev.key and t and ev.count:
                print(f"    profiler: {ev.key[:70]}: {t / ev.count / 1e3:.4f}"
                      f" ms a launch ({ev.count} launches)")
        increments(prof)
    return 0


def increments(prof) -> None:
    """What each launch adds to a call: a dependent launch starts before
    the one it waits on has ended, so its span overlaps the one before;
    from the trace, the first launch's span, then each later launch's end
    minus the end of the launch before it, averaged over the calls."""
    kernels = sorted((ev for ev in prof.events()
                      if "ssd" in ev.name and ev.device_type.name == "CUDA"),
                     key=lambda ev: ev.time_range.start)
    names = []
    for ev in kernels:
        if ev.name in names:
            break
        names.append(ev.name)
    n = len(names)
    calls = [kernels[i:i + n] for i in range(0, len(kernels) - n + 1, n)]
    if not calls or any([ev.name for ev in c] != names for c in calls):
        print("    increments: the trace does not split into calls")
        return
    add = [0.0] * n
    for c in calls:
        add[0] += c[0].time_range.end - c[0].time_range.start
        for j in range(1, n):
            add[j] += c[j].time_range.end - c[j - 1].time_range.end
    for name, t in zip(names, add):
        print(f"    adds {t / len(calls) / 1e3:.4f} ms a call: {name[:70]}")


if __name__ == "__main__":
    sys.exit(main())
