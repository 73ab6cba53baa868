"""Quickstart on the PyTorch port: PipeBoost cold start,
serving-during-loading, crash recovery (the port of
``examples/quickstart.py``).

Shows the paper's three headline behaviours end-to-end through the
port's public API:

  1. the server is ready to infer after each device loads only 1/N of the
     model (pipeline-parallel loading);
  2. tokens served during background loading are identical to a fully
     loaded server;
  3. a 2-device crash mid-decode recovers exactly (layer reassignment +
     KV reconstruction).

Runs on the card by default: qwen3-1.7b at its full width, cut to the
reference example's 8 layers, in float32 (the exact-recovery check needs
float32, as the port's other recovery checks on the card do; the kernels
take only the published head dims, so the reduced width cannot run
there).  ``--device cpu`` runs the reference's reduced config in about a
minute.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs.base import get_arch
from repro_torch.core import simulator as sim
from repro_torch.core.engine import PipeBoostEngine, generate
from repro_torch.models import transformer as T


def example_config(arch: str, layers: int, device: torch.device):
    """The reference example's reduced config on the CPU; on the card the
    full width at the same depth, in float32."""
    if device.type == "cpu":
        return get_arch(arch).reduced(n_layers=layers)
    return dataclasses.replace(get_arch(arch), n_layers=layers,
                               dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cfg = example_config("qwen3-1.7b", 8, device)
    print(f"model: {cfg.name} ({cfg.n_layers}L d={cfg.d_model}, "
          f"{cfg.dtype}) on {device}")
    params = T.init_params(cfg, torch.Generator(device).manual_seed(0),
                           device=device)
    gen = torch.Generator(device).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=gen, device=device)}

    # --- 1. pipeline-parallel cold start --------------------------------
    eng = PipeBoostEngine(cfg, params, n_devices=4, max_len=64)
    print(f"before loading: ready={eng.ready}")
    eng.load_round()                      # ONE segment per device (1/N each)
    print(f"after 1 round : ready={eng.ready}  "
          f"loaded={eng.loaded_map()}  chain={eng.chain()}")

    t0 = time.perf_counter()
    logits = eng.prefill(batch)
    tok = torch.argmax(logits, -1).to(torch.int32).cpu()
    print(f"first token in {time.perf_counter() - t0:.2f}s ({device}): "
          f"{tok.numpy()}")

    # --- 2. serve during background loading == fully loaded -------------
    e_early = PipeBoostEngine(cfg, params, 4, max_len=64)
    e_early.load_round()
    early = generate(e_early, batch, 8)
    e_full = PipeBoostEngine(cfg, params, 4, max_len=64)
    while e_full.load_round():
        pass
    full = generate(e_full, batch, 8)
    print(f"partial-load tokens == full-load tokens: "
          f"{torch.equal(early, full)}")

    # --- 3. crash mid-decode + pipeline-parallel recovery ---------------
    e_crash = PipeBoostEngine(cfg, params, 4, max_len=64)
    e_crash.load_round()
    out = generate(e_crash, batch, 8, crash_at=4, crash_devices=[1, 2])
    print(f"crash@token4 (devices 1,2) tokens still equal: "
          f"{torch.equal(out, full)}")
    print(f"engine events: {[e for e, _ in e_crash.events]}")

    # --- what this buys at real scale (byte-accurate simulator) ---------
    print("\ncold-start TTFT on the paper's 2xA100 testbed (simulated):")
    for strat in ("transformers", "serverlessllm", "pipeboost"):
        r = sim.simulate_cold_start(get_arch("pipeboost-opt-1.3b"),
                                    sim.GPU_PAPER, 2, strat)
        print(f"  {strat:14s} TTFT={r.ttft:.2f}s  (ready@{r.t_ready:.2f}s, "
              f"fully loaded@{r.t_full:.2f}s)")


if __name__ == "__main__":
    main()
