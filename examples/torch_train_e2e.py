"""End-to-end training driver on the PyTorch port: data pipeline ->
train loop -> async checkpointing -> simulated crash ->
restart-and-resume (exact).  The port of ``examples/train_e2e.py``.

On the CPU the default is the reference's CPU size (~0.8M params, 120
steps).  On the card, the default, it is the reference's
``--model-100m`` config (a ~100M-parameter qwen3-family model, head dim
64: the attention kernel takes only the published head dims, so the
CPU size's head dim 16 cannot run there); ``--model-100m`` picks it on
the CPU too.  Training runs in float32, as the reference's.  The resumed
run is held to an uninterrupted one: every loss after the restart equal
(within 1e-5 relative; whether bit-equal is printed too).

    PYTHONPATH=src python examples/torch_train_e2e.py [--steps N] \
        [--model-100m] [--device cpu]
"""
import argparse
import math
import shutil
import tempfile

import torch

from repro_torch.configs.base import get_arch
from repro_torch.training.checkpoint import Checkpointer
from repro_torch.training.data import SyntheticLM
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train import init_train_state, make_train_step


def _batch(ds, device):
    return {k: torch.from_numpy(v).to(device)
            for k, v in ds.next_batch().items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--model-100m", action="store_true")
    ap.add_argument("--ckpt-every", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    if args.model_100m or device.type != "cpu":
        cfg = get_arch("qwen3-1.7b").reduced(
            n_layers=12, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
            d_ff=2048, vocab_size=32768)
    else:
        cfg = get_arch("qwen3-1.7b").reduced(n_layers=4, d_model=128,
                                             n_heads=4, n_kv_heads=2,
                                             d_ff=512, vocab_size=2048)
    n_params = cfg.param_count()
    print(f"training {cfg.name}-reduced: {n_params/1e6:.1f}M params on "
          f"{device}")

    opt = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps,
                      grad_clip=1.0)

    def fresh_state():
        return init_train_state(cfg, torch.Generator(device).manual_seed(0),
                                torch.float32, device)
    state = fresh_state()
    step_fn = make_train_step(cfg, opt, remat=False)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=64, batch_size=8,
                     seed=7)
    ckdir = tempfile.mkdtemp(prefix="pipeboost_ckpt_")
    ck = Checkpointer(ckdir, keep=2)

    crash_at = args.steps // 2
    losses = []
    step = 0
    while step < crash_at:
        state, m = step_fn(state, _batch(ds, device))
        step += 1
        losses.append(float(m["loss"]))
        if step % args.ckpt_every == 0:
            ck.save(step, state, extra={"data": ds.state()}, async_=True)
        if step % 20 == 0:
            print(f"  step {step:4d} loss {float(m['loss']):.3f} "
                  f"lr {float(m['lr']):.2e} "
                  f"gnorm {float(m['grad_norm']):.2f}")
    ck.save(step, state, extra={"data": ds.state()}, async_=True)
    ck.wait()

    # the uninterrupted run the resumed one is held to
    ref_state, _ = ck.restore(fresh_state())
    ref_ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=64,
                         batch_size=8, seed=7)
    ref_ds.restore(ds.state())
    ref_losses = []
    for _ in range(step, args.steps):
        ref_state, m = step_fn(ref_state, _batch(ref_ds, device))
        ref_losses.append(float(m["loss"]))
    del ref_state

    print(f"-- simulated crash at step {step}; "
          f"restarting from {ckdir} --")
    del state, ds
    state, extra = ck.restore(fresh_state())
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=64, batch_size=8,
                     seed=7)
    ds.restore(extra["data"])
    print(f"   resumed at data step {ds.step}, opt step "
          f"{int(state.opt.step)}")

    while step < args.steps:
        state, m = step_fn(state, _batch(ds, device))
        step += 1
        losses.append(float(m["loss"]))
        if step % 20 == 0:
            print(f"  step {step:4d} loss {float(m['loss']):.3f}")

    # equal to the last bits on the card; the CPU's matmuls may round
    # differently for differently aligned buffers (the restored ones)
    same = all(math.isclose(a, b, rel_tol=1e-5)
               for a, b in zip(losses[crash_at:], ref_losses))
    print(f"resumed losses == uninterrupted losses (rel 1e-5): {same}; "
          f"bit-equal: {losses[crash_at:] == ref_losses}")
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'DECREASED' if losses[-1] < losses[0] else 'FLAT'})")
    shutil.rmtree(ckdir, ignore_errors=True)


if __name__ == "__main__":
    main()
