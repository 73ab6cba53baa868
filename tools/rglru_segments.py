#!/usr/bin/env python3
"""What the RG-LRU scan kernel's time segments buy, measured on the card.

Builds ``src/repro_torch/kernels/csrc/rglru_scan.cu`` once per segment
count (``-DPB_RGLRU_SEGS=n``, one ``nvcc`` each, all started together) into
``build/rglru_segments/``, checks each build against the plain version and
times it with ``chip_smoke.py``'s timing, on recurrentgemma-2b's prefill
shapes (W 2560, S 512, B 1 and 4) with the model's decays.  Each build is
timed twice, the second round in reverse order, so drift on the card shows
as a gap between the two columns.  Run from the root of a checkout, on a
machine with the card and the CUDA toolkit:

    python3 tools/rglru_segments.py
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SEGMENTS = (1, 2, 4, 8, 16, 32)
W, S = 2560, 512


def build_all(out_dir: Path):
    from repro_torch.kernels import build
    out_dir.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "rglru_scan.cu"
    procs = {n: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, f"-DPB_RGLRU_SEGS={n}",
         "-shared", "-o", str(out_dir / f"librglru_{n}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in SEGMENTS}
    libs = {}
    for n, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n} segments:\n{out}")
        regs = [line.strip() for line in out.splitlines()
                if "registers" in line]
        print(f"  {n} segments: {regs[0] if regs else out.strip()}")
        lib = ctypes.CDLL(str(out_dir / f"librglru_{n}.so"))
        lib.pb_rglru_scan.argtypes = build._SIGNATURES["pb_rglru_scan"]
        lib.pb_rglru_scan.restype = ctypes.c_int
        libs[n] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("rglru_segments: no CUDA card visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import rglru_scan as rg
    F = torch.nn.functional
    dev = torch.device("cuda", 0)
    print(f"nvidia-smi: {cs.nvidia_smi()}")
    libs = build_all(ROOT / "build" / "rglru_segments")
    g = torch.Generator(device=dev).manual_seed(15)
    lam = torch.log(torch.expm1(-torch.log(torch.linspace(
        0.9, 0.999, W, device=dev)) / 8.0))

    def make(B):
        r = torch.sigmoid(torch.randn((B, S, W), generator=g, device=dev))
        log_a = -8.0 * F.softplus(lam) * r
        bx = torch.sqrt(1 - torch.exp(2 * log_a)) * torch.randn(
            (B, S, W), generator=g, device=dev)
        return log_a, bx

    def call(lib, log_a, bx):
        B = log_a.shape[0]
        y = torch.empty_like(log_a)
        h_T = torch.empty((B, W), dtype=torch.float32, device=dev)
        st = build.strides((log_a, (0, 1)), (bx, (0, 1)), (y, (0, 1)))
        err = lib.pb_rglru_scan(dev.index, log_a.data_ptr(), bx.data_ptr(),
                                None, y.data_ptr(), h_T.data_ptr(), st, B,
                                S, W, build.stream_of(log_a))
        if err:
            raise RuntimeError(f"pb_rglru_scan: CUDA error {err}")
        return y, h_T

    for B in (1, 4):
        x = make(B)
        sets = [x] + [make(B)
                      for _ in range(cs.n_copies(cs.nbytes(*x)) - 1)]
        yr, hr = rg.rglru_scan_plain(*x)
        for n, lib in libs.items():
            y, h_T = call(lib, *x)
            torch.cuda.synchronize()
            err = max((y - yr).abs().max().item() / yr.abs().max().item(),
                      (h_T - hr).abs().max().item() / hr.abs().max().item())
            cs.require(err <= cs.RGLRU_TOL, f"{n} segments: error {err}")
        moved = cs.nbytes(*x) + B * S * W * 4 + B * W * 4
        b_ms, _ = cs.bound(moved, 3 * B * S * W, "float32")
        times = {n: [] for n in libs}
        for order in (SEGMENTS, SEGMENTS[::-1]):
            for n in order:
                ms, _ = cs.time_ms(torch, f"rglru {n} segments", [
                    lambda s=s, lib=libs[n]: call(lib, *s) for s in sets],
                    200)
                times[n].append(ms)
        print(f"B={B} S={S} W={W}: bound {b_ms:.4f} ms (bytes)")
        for n in SEGMENTS:
            a, b = times[n]
            print(f"  {n:2d} segments ({(W + 31) // 32 * B} CTAs of "
                  f"{32 * n} threads): {a:.4f} ms, {b:.4f} ms "
                  f"({min(a, b) / b_ms:.2f}x bound)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
