"""Serve a base model + two LoRA adapters on the PyTorch port with
continuous batching and epoch-based adapter switching (paper §4.3.2 /
Fig. 14) — the port of ``examples/serve_lora.py``.

Runs on the card by default: qwen3-1.7b at its full width, cut to the
reference example's 4 layers, in float32 (the kernels take only the
published head dims; on the card the adapters merge through the LoRA
kernel and the batcher replays its captured decode step).  ``--device
cpu`` runs the reference's reduced config.  The adapters' weights are
drawn from a seed of a CRC-32 of their names, the same in every process.

    PYTHONPATH=src python examples/torch_serve_lora.py [--device cpu]
"""
import argparse
import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.adapter_scheduler import (EagerPolicy,
                                                EpochSchedulerPolicy,
                                                simulate_adapter_serving)
from repro_torch.lora.adapters import init_lora, merge_lora, randomize_lora
from repro_torch.models import transformer as T
from repro_torch.serving.engine import ServeRequest, ServingEngine


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
    cfg = example_config("qwen3-1.7b", 4, device)
    params = T.init_params(cfg, torch.Generator(device).manual_seed(0),
                           device=device)

    adapters = {}
    for name in ("math", "code"):
        lora = init_lora(torch.Generator(device).manual_seed(0), cfg,
                         rank=4, name=name, device=device)
        seed = zlib.crc32(name.encode()) % 1000
        lora = randomize_lora(torch.Generator(device).manual_seed(seed),
                              lora)
        adapters[name] = merge_lora(params, lora)

    eng = ServingEngine(cfg, params, n_slots=3, max_len=96,
                        policy=EpochSchedulerPolicy(epoch_budget=3,
                                                    max_batch=3),
                        adapter_params=adapters)
    rng = np.random.default_rng(0)
    lanes = [None, "math", "code"]
    for i in range(9):
        eng.submit(ServeRequest(i, rng.integers(0, 250, size=8),
                                max_new_tokens=5, adapter=lanes[i % 3]))
    done = eng.run()
    print(f"served {len(done)} requests with "
          f"{eng.n_adapter_switches} adapter switches (epoch-batched) "
          f"on {device}")
    for r in done[:6]:
        print(f"  req{r.rid} adapter={r.adapter or 'base':5s} "
              f"tokens={r.generated}")
    print(f"every request served its 5 tokens: "
          f"{len(done) == 9 and all(len(r.generated) == 5 for r in done)}")

    print("\nFig.14-style comparison (simulated, 20 RPS, 20% switch prob):")
    ep = simulate_adapter_serving(EpochSchedulerPolicy(epoch_budget=8),
                                  rps=20, horizon=30, switch_prob=0.2)
    eg = simulate_adapter_serving(EagerPolicy(), rps=20, horizon=30,
                                  switch_prob=0.2)
    print(f"  epoch-based: mean={ep['mean']*1e3:.0f}ms "
          f"var={ep['var']:.3f} merges={ep['merges']:.0f}")
    print(f"  eager      : mean={eg['mean']*1e3:.0f}ms "
          f"var={eg['var']:.3f} merges={eg['merges']:.0f}")
    print(f"  latency cut: {100*(1-ep['mean']/eg['mean']):.1f}% "
          f"(paper reports 63.1% at 25 RPS)")


if __name__ == "__main__":
    main()
