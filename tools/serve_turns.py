#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 5 serve runs for two checkouts in turns on one
card: this checkout's ``src`` and another's (for example the parent commit,
unpacked with ``git archive``), in the order other, this, this, other, so
drift on the card shows as the gap between a checkout's two runs.

Each run is ``python -m repro_torch.launch.serve`` in its own process with
that checkout's ``src`` first on the path (each checkout builds its own
kernels), at phase 5's arguments: 8 requests of 64-512 prompt tokens and
32 new tokens, 4 slots, max_len 1024, seed 0; pipeboost-opt-1.3b with 2
adapters, mamba2-780m and recurrentgemma-2b with none.  Printed per run:
decode tokens/s, median and max wall TTFT, the serve's wall time and the
peak device memory, as the launcher reports them.  Run from the root of a
checkout, on a machine with the card:

    python3 tools/serve_turns.py --src OTHER_CHECKOUT/src
"""
from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUNS = (("pipeboost-opt-1.3b", 2), ("mamba2-780m", 0),
        ("recurrentgemma-2b", 0))


def serve(src: Path, arch: str, adapters: int) -> dict:
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
            "--devices", "4", "--requests", "8", "--adapters", str(adapters),
            "--new-tokens", "32", "--prompt-len", "64-512", "--max-len",
            "1024", "--slots", "4", "--seed", "0"]
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run(argv, cwd=src.parent, env=env, capture_output=True,
                         text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"{src} {arch} failed:\n{out.stdout[-3000:]}\n"
                           f"{out.stderr[-3000:]}")
    text = out.stdout
    ttft = [float(x) for x in re.findall(r"ttft=([0-9.]+)s", text)]
    return {
        "tokens_per_s": float(re.search(r"decode: ([0-9.]+) tokens/s",
                                        text).group(1)),
        "ttft_median_s": statistics.median(ttft),
        "ttft_max_s": max(ttft),
        "wall_s": float(re.search(r"requests of .*? in ([0-9.]+)s",
                                  text).group(1)),
        "peak_gib": int(re.search(r"peak device memory: (\d+) B",
                                  text).group(1)) / 2 ** 30,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="the other checkout's src directory")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        print("serve_turns: no card (nvidia-smi failed)", file=sys.stderr)
        return 2
    print(f"nvidia-smi: {smi.stdout.strip()}")
    other, this = Path(args.src).resolve(), ROOT / "src"
    for arch, adapters in RUNS:
        for label, src in (("other", other), ("this", this), ("this", this),
                           ("other", other)):
            r = serve(src, arch, adapters)
            print(f"  {arch:20s} {label:5s} decode {r['tokens_per_s']:7.1f} "
                  f"tokens/s  TTFT median {r['ttft_median_s']:.4f} s max "
                  f"{r['ttft_max_s']:.4f} s  wall {r['wall_s']:.3f} s  "
                  f"peak {r['peak_gib']:.2f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
