"""Fault-tolerance drill on the PyTorch port across every architecture
family: crash 2 of 4 devices mid-decode and verify exact recovery (paper
§4.4), then show the recovery-time story on the simulator (paper Figs.
15-17).  The port of ``examples/recovery_drill.py``.

Runs on the card by default: each family at its full width, cut to the
reference drill's depth, in float32 (exact recovery needs float32 on the
card), the MoE with capacity for every routed token (the reduced
config's dropless routing at full width), so the rebuilt layers route as
the original ones did.  ``--device cpu`` runs the reference's reduced
configs.

    PYTHONPATH=src python examples/torch_recovery_drill.py [--device cpu]
"""
import argparse
import dataclasses

import torch

from repro_torch.configs.base import get_arch
from repro_torch.core import simulator as sim
from repro_torch.core.engine import PipeBoostEngine, generate
from repro_torch.models import transformer as T


def example_config(arch: str, layers: int, device: torch.device):
    """The reference drill's reduced config on the CPU; on the card the
    full width at the same depth, in float32, an MoE dropless."""
    base = get_arch(arch)
    if device.type == "cpu":
        return base.reduced(n_layers=layers)
    kw = dict(n_layers=layers, dtype="float32")
    if base.family == "moe":
        kw["capacity_factor"] = base.n_experts / base.top_k
    return dataclasses.replace(base, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    print(f"functional drill (4 logical devices, {device}):")
    for arch, layers in [("qwen3-1.7b", 8), ("mamba2-780m", 8),
                         ("recurrentgemma-2b", 6), ("qwen2-moe-a2.7b", 4)]:
        cfg = example_config(arch, layers, device)
        params = T.init_params(cfg, torch.Generator(device).manual_seed(0),
                               device=device)
        gen = torch.Generator(device).manual_seed(0)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                         generator=gen, device=device)}
        ref_eng = PipeBoostEngine(cfg, params, 4, max_len=64)
        ref_eng.load_round()
        ref = generate(ref_eng, batch, 8)
        eng = PipeBoostEngine(cfg, params, 4, max_len=64)
        eng.load_round()
        out = generate(eng, batch, 8, crash_at=4, crash_devices=[1, 2])
        ok = torch.equal(ref, out)
        st = [s for e, s in eng.events if e == "recover"][0]
        detail = st.get("reconstruct", {})
        print(f"  {arch:22s} exact={ok}  kv_reused={detail.get('kv_reused', 0)}"
              f" full_prefill={detail.get('full_prefill', 0)}"
              f" skipped={detail.get('layers_skipped', 0)}")
        del ref_eng, eng, params

    print("\nsimulated recovery (paper testbed, Mistral-7B, 4 devices):")
    pp = sim.simulate_loading_failure(
        get_arch("qwen3-1.7b"), sim.GPU_PAPER, 4, failed=[1, 2], mode="pp")
    fl = sim.simulate_loading_failure(
        get_arch("qwen3-1.7b"), sim.GPU_PAPER, 4, failed=[1, 2], mode="full")
    print(f"  loading-stage recovery: PP={pp.recovery_time:.2f}s "
          f"full-restart={fl.recovery_time:.2f}s "
          f"(cut {100*(1-pp.recovery_time/fl.recovery_time):.0f}%)")
    tl_pp = sim.simulate_inference_failure(get_arch("qwen3-1.7b"),
                                           sim.GPU_PAPER, 4, mode="pp")
    tl_fl = sim.simulate_inference_failure(get_arch("qwen3-1.7b"),
                                           sim.GPU_PAPER, 4, mode="full")
    halt = sum(1 for _, thr in tl_fl if thr == 0.0) * 0.25
    dip = min(thr for t, thr in tl_pp if t > 6.0)
    peak = tl_pp[0][1]
    print(f"  inference-stage crash : PP dips to {dip:.0f} tok/s "
          f"(from {peak:.0f}) with NO halt; full restart halts {halt:.1f}s")


if __name__ == "__main__":
    main()
