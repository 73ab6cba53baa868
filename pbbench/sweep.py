"""The knee of an open-loop cell: one sweep of arrival rates on the card,
made once when the cell is defined.

    python3 pbbench/sweep.py --workload opt-lora-chat --seed 1 \\
        --seconds 120 --rates 2.2,2.6,3,3.5,4

builds the cell's replica once (weights, adapters, warm-up, as a run does),
then for each rate drives the cell's traffic at that rate for
``--seconds``, and drains the replica before the next rate.  For each
rate it prints one JSON line: the waiting queue's growth over the window
(the least-squares slope of the requests waiting after each step, in
requests per second, and its mean over the window's first and last
thirds), the TTFT median, 95th percentile and mean of the slowest 5%,
the TPOT 95th percentile, output tokens per second and the requests
finished.  The sweep's window may be longer than a run's: with bursty
arrivals one burst near the end of a short window lifts the queue's
slope at any rate.  A rate's queue grows when its slope is over
``GROWS`` requests per second and its last third's mean is above its
first third's.  The knee is the highest rate below the first (in
ascending order) whose queue grows; the last line gives it and four
fifths of it, the cell's rate, to be written as a number in the cell's
traffic file.
"""
import argparse
import json
import sys
import time

import numpy as np

GROWS = 0.1          # requests/s of the waiting queue's slope


def queue_growth(steps, seconds: float):
    """(slope in requests/s, mean of the first third, of the last third)."""
    if len(steps) < 3:
        return 0.0, 0.0, 0.0
    t = np.array([s.t1 for s in steps])
    q = np.array([s.n_queued for s in steps], dtype=float)
    slope = float(np.polyfit(t, q, 1)[0])
    first = q[t < seconds / 3]
    last = q[t >= 2 * seconds / 3]
    return (slope, float(first.mean()) if first.size else 0.0,
            float(last.mean()) if last.size else 0.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", required=True,
                    help="comma-separated arrival rates (requests/s)")
    args = ap.parse_args(argv)

    import torch
    from pbb import manifest, serve, stats, traffic

    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        return 2
    bench = manifest.load_benchmark()
    cell = manifest.cell(bench, args.workload)
    m = manifest.config(cell["config"])
    spec = manifest.traffic(cell["traffic"])
    if spec["arrivals"]["kind"] != "gamma":
        print("the sweep is for an open-loop cell", file=sys.stderr)
        return 2
    rates = sorted(float(r) for r in args.rates.split(","))
    # warmed on the highest rate's requests, which take every bucket
    srv, _, _ = serve.prepare(m, dict(spec, arrivals=dict(
        spec["arrivals"], rate=rates[-1])), args.seed, args.seconds, "cuda:0")
    knee = None
    for i, rate in enumerate(rates):
        sp = dict(spec, arrivals=dict(spec["arrivals"], rate=rate))
        reqs = traffic.make(sp, args.seed + i, args.seconds, m["vocab_size"])
        win = serve.run_window(srv, reqs, args.seconds)
        t0 = time.perf_counter()
        while not srv.engine.idle and time.perf_counter() - t0 < 120:
            srv.engine.step()
        slope, q_first, q_last = queue_growth(win.steps, args.seconds)
        st = list(win.stamps.values())
        ttft = stats.ttft_s(st, args.seconds)
        tpot = stats.tpot_s(st)
        print(json.dumps({
            "rate": rate, "attempted": win.attempted,
            "finished": len(win.finished),
            "queue_slope_per_s": slope, "queue_first_third": q_first,
            "queue_last_third": q_last,
            "ttft_p50_s": stats.percentile(ttft, 50) if ttft else None,
            "ttft_p95_s": stats.percentile(ttft, 95) if ttft else None,
            "ttft_tail5_s": stats.tail_mean(ttft, 0.05) if ttft else None,
            "tpot_p95_ms": 1e3 * stats.percentile(tpot, 95) if tpot
            else None,
            "out_tok_s": stats.tokens_in_window(st) / args.seconds,
            "switches": win.switches,
            "drain_s": time.perf_counter() - t0}), flush=True)
        if knee is None and slope > GROWS and q_last > q_first:
            knee = rates[i - 1] if i else 0.0
    if knee is None:
        print(json.dumps({"knee": None, "note": "no rate's queue grew: "
                          "sweep higher rates"}))
        return 1
    print(json.dumps({"knee": knee, "rate": round(0.8 * knee, 2)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
