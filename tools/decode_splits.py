#!/usr/bin/env python3
"""What the decode-attention kernel's cache splits buy, measured on the card.

Calls the built kernel library (``pb_decode_attention``, both launches)
with a given split count at the two shapes that ``chip_smoke.py`` times:
opt-1.3b's decode (4 rows, C 1024, 32 heads of 64, full cache, new-token
fold) and recurrentgemma-2b's (4 rows, C 1024, 10 query heads of 256 on
one KV head, lens 0/77/600/1023, ring slot mask, fold).  Each split count
is checked against the plain version, then timed with ``chip_smoke.py``'s
timing twice, the second round in reverse order, so drift on the card
shows as a gap between the two columns.  A ``torch.profiler`` trace of the
split count ``decode_splits`` picks gives each launch's device time.  Run
from the root of a checkout, on a machine with the card and the CUDA
toolkit:

    python3 tools/decode_splits.py
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

C = 1024
SHAPES = {
    # name: (B, Hq, Hkv, d, lens, ring mask, split counts)
    "opt-1.3b": (4, 32, 32, 64, [C - 1] * 4, False,
                 (1, 2, 3, 4, 6, 8, 16)),
    "recurrentgemma-2b": (4, 10, 1, 256, [0, 77, 600, C - 1], True,
                          (4, 8, 16, 32, 64)),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_splits: no CUDA card visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dec
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    print(f"nvidia-smi: {cs.nvidia_smi()}")
    lib = build.load()
    g = torch.Generator(device=dev).manual_seed(16)

    def make(B, Hq, Hkv, d, lens, ring):
        x = dict(q=torch.randn((B, Hq, d), generator=g, device=dev).to(bf),
                 k=torch.randn((B, C, Hkv, d), generator=g,
                               device=dev).to(bf).transpose(1, 2),
                 v=torch.randn((B, C, Hkv, d), generator=g,
                               device=dev).to(bf).transpose(1, 2),
                 kn=torch.randn((B, Hkv, 1, d), generator=g,
                                device=dev).to(bf),
                 vn=torch.randn((B, Hkv, 1, d), generator=g,
                                device=dev).to(bf),
                 lens=torch.tensor(lens, dtype=torch.int32, device=dev),
                 sm=None)
        if ring:
            j = torch.arange(C, device=dev)[None, :]
            p = x["lens"][:, None]
            x["sm"] = (j < p) & ((p < C) | (j != p % C))
        return x

    def call(x, splits):
        B, Hq, d = x["q"].shape
        Hkv = x["k"].shape[1]
        out = torch.empty((B, Hq, d), dtype=bf, device=dev)
        ws = torch.empty((B * Hq * splits * (d + 2),), dtype=torch.float32,
                         device=dev)
        st = build.strides((x["q"], (0, 1)), (x["k"], (0, 1, 2)),
                           (x["v"], (0, 1, 2)), (x["kn"], (0, 1)),
                           (x["vn"], (0, 1)),
                           (x["sm"], (0,)) if x["sm"] is not None
                           else (None, 1), (out, (0, 1)))
        build.check(lib.pb_decode_attention(
            build.DTYPE_BF16, dev.index, x["q"].data_ptr(),
            x["k"].data_ptr(), x["v"].data_ptr(), x["lens"].data_ptr(),
            x["kn"].data_ptr(), x["vn"].data_ptr(), build.ptr(x["sm"]),
            out.data_ptr(), ws.data_ptr(), st, B, Hq, Hkv, C, d, splits,
            d ** -0.5, build.stream_of(x["q"])), "pb_decode_attention")
        return out

    for name, (B, Hq, Hkv, d, lens, ring, counts) in SHAPES.items():
        x = make(B, Hq, Hkv, d, lens, ring)
        sets = [x] + [make(B, Hq, Hkv, d, lens, ring) for _ in range(
            cs.n_copies(cs.nbytes(x["k"], x["v"])) - 1)]
        f = (lambda t: None if t is None else t.float())
        ref = dec.decode_attention_plain(
            f(x["q"]), f(x["k"]), f(x["v"]), x["lens"], k_new=f(x["kn"]),
            v_new=f(x["vn"]), slot_mask=x["sm"])
        for n in counts:
            err = (call(x, n).float() - ref).abs().max().item()
            cs.require(err <= cs.ATTN_TOL, f"{name}, {n} splits: {err}")
        times = {n: [] for n in counts}
        for order in (counts, counts[::-1]):
            for n in order:
                ms, _ = cs.time_ms(torch, f"decode {name} {n} splits", [
                    lambda s=s, n=n: call(s, n) for s in sets], 200)
                times[n].append(ms)
        pick = dec.decode_splits(B, Hkv, C, d)
        print(f"{name} (B {B}, C {C}, {Hq} query heads of {d} on {Hkv} KV "
              f"heads, lens {lens}); decode_splits picks {pick}:")
        for n in counts:
            a, b = times[n]
            print(f"  {n:3d} splits of {-(-C // n):4d} rows "
                  f"({n * Hkv * B:4d} CTAs): {a:.4f} ms, {b:.4f} ms")
        # per-launch device time at the picked count
        act = [torch.profiler.ProfilerActivity.CPU,
               torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=act) as prof:
            for i in range(50):
                call(sets[i % len(sets)], pick)
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            dt = getattr(ev, "device_time_total", None)
            if dt is None:
                dt = getattr(ev, "cuda_time_total", 0)
            if "decode" in ev.key and dt:
                print(f"    profiler, {pick} splits: {ev.key[:60]}: "
                      f"{dt / ev.count / 1e3:.4f} ms a launch "
                      f"({ev.count} launches)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
