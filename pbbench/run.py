"""The benchmark of the port (``src/repro_torch``): one run of one cell.

    python3 pbbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

prints, as the last line of its standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` and, traced, ``breakdown``; last, ``checks``: each number the
correctness check compared, beside its limit.  The same numbers end its
standard error.  It exits non-zero and prints no result without a CUDA
card, or if the JAX package or JAX was loaded.
"""
import os
import time


def _process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return now - max(0.0, up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_PROC = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache inside the checkout, at a fixed path
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from pbb import manifest, runner

    bench = manifest.load_benchmark()
    cell = manifest.cell(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    res = runner.run_cell(
        args.workload, manifest.config(cell["config"]),
        manifest.traffic(cell["traffic"]),
        manifest.cell_metrics(bench, args.workload, bool(args.trace)),
        args.seed, args.seconds, bool(args.trace), "cuda:0", T_PROC)
    bad = loaded_forbidden()
    if bad:
        print(f"the run loaded {bad}: the benchmark and the port may load "
              f"neither JAX nor the JAX package", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
