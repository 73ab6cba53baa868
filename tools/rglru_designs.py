#!/usr/bin/env python3
"""Designs of the RG-LRU scan kernel timed against each other on the card:
this checkout's and other checkouts' (for example the parent commit,
unpacked with ``git archive``).

Builds each checkout's ``repro_torch/kernels/csrc/rglru_scan.cu`` alone
into a shared library (one ``nvcc`` each, all started together) under
``build/rglru_designs/``, prints each build's ``ptxas`` lines and, where the
source exports it, how many of its clusters the card holds at once
(``cudaOccupancyMaxActiveClusters``).  Each is checked against the plain
version under ``chip_smoke.py``'s ``RGLRU_TOL`` and timed with
``chip_smoke.py``'s timing (device time and host-paced time of one call)
in turns, the others, this, this, the others in reverse, so drift on the
card shows as a gap between a design's two columns.  Beside them,
``torch.add`` of log_a and bx into y moves the same bytes in one
elementwise launch: what a streaming kernel takes for them on this card.
Shapes: recurrentgemma-2b's width (W
2560) with the model's decays, B 1 and 4, S 64, 300, 512 and 1024.  Run
from the root of a checkout, on a machine with the card and the CUDA
toolkit:

    python3 tools/rglru_designs.py [--src OTHER_CHECKOUT/src ...]
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

W = 2560
BATCHES = (1, 4)
LENGTHS = (64, 300, 512, 1024)


def build_all(sources: dict, out_dir: Path) -> dict:
    """{name: source .cu} -> {name: ctypes library}, all built at once."""
    from repro_torch.kernels import build
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o",
         str(out_dir / f"librglru_{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        for line in out.splitlines():
            if any(w in line for w in ("registers", "spill", "smem")):
                print(f"  {name}: {line.strip()}")
        lib = ctypes.CDLL(str(out_dir / f"librglru_{name}.so"))
        lib.pb_rglru_scan.argtypes = build._SIGNATURES["pb_rglru_scan"]
        lib.pb_rglru_scan.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[],
                    help="the src directory of a checkout to time against "
                         "(repeatable)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("rglru_designs: no CUDA card visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import rglru_scan as rg
    F = torch.nn.functional
    dev = torch.device("cuda", 0)
    print(f"nvidia-smi: {cs.nvidia_smi()}")
    rel = Path("repro_torch") / "kernels" / "csrc" / "rglru_scan.cu"
    sources = {}
    for i, src in enumerate(args.src):
        sources[f"other{i}" if len(args.src) > 1 else "other"] = \
            Path(src).resolve() / rel
    sources["this"] = ROOT / "src" / rel
    for name, src in sources.items():
        print(f"{name}: {src}")
    libs = build_all(sources, ROOT / "build" / "rglru_designs")
    for name, lib in libs.items():
        if hasattr(lib, "pb_rglru_max_active_clusters"):
            fn = lib.pb_rglru_max_active_clusters
            fn.argtypes = build._SIGNATURES["pb_rglru_max_active_clusters"]
            fn.restype = ctypes.c_int
            for B in BATCHES:
                for S in LENGTHS:
                    n = ctypes.c_int(0)
                    err = fn(dev.index, B, S, W, ctypes.byref(n))
                    cs.require(err == 0, f"{name}: occupancy error {err}")
                    print(f"  {name}: B={B} S={S}: at most {n.value} "
                          f"clusters at once ({-(-W // 32) * B} a call)")

    g = torch.Generator(device=dev).manual_seed(16)
    lam = torch.log(torch.expm1(-torch.log(torch.linspace(
        0.9, 0.999, W, device=dev)) / 8.0))

    def make(B, S):
        r = torch.sigmoid(torch.randn((B, S, W), generator=g, device=dev))
        log_a = -8.0 * F.softplus(lam) * r
        bx = torch.sqrt(1 - torch.exp(2 * log_a)) * torch.randn(
            (B, S, W), generator=g, device=dev)
        return log_a, bx

    def call(lib, log_a, bx):
        B, S, _ = log_a.shape
        y = torch.empty_like(log_a)
        h_T = torch.empty((B, W), dtype=torch.float32, device=dev)
        st = build.strides((log_a, (0, 1)), (bx, (0, 1)), (y, (0, 1)))
        err = lib.pb_rglru_scan(dev.index, log_a.data_ptr(), bx.data_ptr(),
                                None, y.data_ptr(), h_T.data_ptr(), st, B,
                                S, W, build.stream_of(log_a))
        if err:
            raise RuntimeError(f"pb_rglru_scan: CUDA error {err}")
        return y, h_T

    order = list(libs)
    for B in BATCHES:
        for S in LENGTHS:
            x = make(B, S)
            sets = [x] + [make(B, S)
                          for _ in range(cs.n_copies(cs.nbytes(*x)) - 1)]
            yr, hr = rg.rglru_scan_plain(*x)
            for name, lib in libs.items():
                y, h_T = call(lib, *x)
                torch.cuda.synchronize()
                err = max((y - yr).abs().max().item()
                          / yr.abs().max().item(),
                          (h_T - hr).abs().max().item()
                          / hr.abs().max().item())
                cs.require(err <= cs.RGLRU_TOL and torch.equal(y[:, -1], h_T),
                           f"{name} B={B} S={S}: error {err}")
            moved = cs.nbytes(*x) + B * S * W * 4 + B * W * 4
            b_ms, b_by = cs.bound(moved, 3 * B * S * W, "float32")
            times = {name: [] for name in libs}
            for name in order + order[::-1]:
                ms, paced = cs.time_ms(torch, f"rglru {name} B={B} S={S}", [
                    lambda s=s, lib=libs[name]: call(lib, *s) for s in sets],
                    200)
                times[name].append((ms, paced))
            outs = [torch.empty_like(s[0]) for s in sets]
            add_ms, _ = cs.time_ms(torch, f"add B={B} S={S}", [
                lambda s=s, o=o: torch.add(s[0], s[1], out=o)
                for s, o in zip(sets, outs)], 200)
            del outs
            print(f"B={B} S={S} W={W}: bound {b_ms:.4f} ms ({b_by}; "
                  f"{moved / 1e6:.2f} MB); torch.add of the same bytes "
                  f"{add_ms:.4f} ms")
            for name in order:
                (a, pa), (b, pb) = times[name]
                print(f"  {name}: {a:.4f} ms, {b:.4f} ms (host-paced "
                      f"{pa:.4f}, {pb:.4f} ms; {min(a, b) / b_ms:.2f}x "
                      f"bound)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
