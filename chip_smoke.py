#!/usr/bin/env python3
"""Smoke run of the PyTorch port of PipeBoost on one NVIDIA card (H100).

Run from the root of a checkout, on a machine with the card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Card: name, device count, ``nvidia-smi`` name and power limit.
2. Build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together) and print the
   ``ptxas -v`` register, shared-memory and spill lines of every kernel;
   read the library's SASS (``cuobjdump -sass``) and print the product
   instructions of each attention, SSD and LoRA kernel (the bf16 flash
   kernels must hold ``HGMMA``, Hopper's warpgroup tensor-core product,
   and the bf16 decode kernels and the bf16 SSD kernels of chunk states
   and chunk outputs ``HMMA``, the warp-level one).
3. Kernels against their plain PyTorch versions at the serving path's
   shapes (bf16), each output held against the plain version computed in
   float32 from the same bf16 inputs: attention within 2e-2 absolute (sum
   order plus one bf16 rounding of the output; recurrentgemma's group of
   10 query heads of 256 on one KV head among the cases, with its ring
   slot mask and a window shorter than the keys; decode at the edges of
   its cache splits and with every row empty; flash at 65 and 700 query
   rows, ragged 64-row tiles, at every head dim), the LoRA merge within
   one bf16 ulp of |W'|.  The SSD scan runs from zeros and from a given
   state; its bf16 y is held element by element within 2^-8 |plain y|
   (half a bf16 ulp, the most one rounding moves it) plus 1e-2 mean |plain
   y| (float32 sum order), the same inputs through its float32 build
   within 2e-5 of max |plain y| (sum order only), and its float32 state
   within 1e-4 of max |plain state|.  The RG-LRU scan (float32, W 2560)
   runs from zeros and from a given h0, y and h_T within 1e-5 of max
   |plain y| and max |plain h_T| (expf rounding and the kernel's carries
   across segments and cluster ranks); the most of its clusters the card
   holds at once is printed.  Each kernel is timed with CUDA events over
   many launches on inputs rotated through more than the 50 MB L2 cache,
   beside its plain version, one PyTorch library call where one computes
   the same function (``library_ms``, a yardstick the port never calls;
   none does for the two scans) and its bound: the larger of the bytes it
   must move over 3.35 TB/s and its operations over the peak rate of their
   type (989 TFLOP/s bf16, 67 TFLOP/s float32), both counted by the kernel
   module's ``cost()`` (``launch/rooflines.py`` holds the peaks).  Decode and flash attention are
   timed at opt-1.3b's shapes and again at recurrentgemma-2b's (decode
   with its split count printed); the SSD and RG-LRU scans at one
   512-token prefill and again at a 64-token one (a short serving prompt).
   Last, ``check_norm_rope``: the decode step's RMSNorm kernel (with and
   without the residual add) and RoPE kernel at pipeboost-opt-1.3b's (32
   slots, d_model 2048, 32 heads of 64), qwen2-moe-a2.7b's (64 slots, 16
   heads of 128) and recurrentgemma-2b's (d_model 2560, 10 query heads of
   256 on one KV head) decode shapes in bf16: the residual sum bit for bit,
   both outputs within one bf16 ulp of the plain version (the elements that
   differ at all printed), each timed beside its plain version and its
   bytes bound, the norm also beside ``torch.nn.functional.rms_norm``.
   Every decode step of phases 4-12 runs them in its attention layers (two
   norms and one RoPE a layer, the final norm; M-RoPE stays plain), and
   the launch checks count them.  Then ``check_ssm_step``: the Mamba-2
   decode step's in-place state update at granite-4.0-h-small's (128
   slots, 128 heads of 64, state 128) and mamba2-780m's (4 slots, 48
   heads) decode shapes, bf16 and float32, 4 chained steps: each step's
   state within four float32 ulps of |s dA| + |dt x B| of the plain
   version run from the kernel's previous state, y within the float32 sum
   bound of its readout (and one bf16 ulp of the readout and of y), the
   elements that differ printed; timed beside the plain version and the
   bytes bound (the state read and written once).  Every SSM decode step
   of phases 4-12 runs it, one launch a layer.
4. Model: the same weights and teacher-forced tokens through prefill and 4
   zero-copy decode steps, once through the kernels and once through the
   plain versions, for pipeboost-opt-1.3b at full width (24 layers),
   qwen3-1.7b at full width with depth cut to 4 layers, and, each in
   float32 and in bf16 at full width and depth, mamba2-780m (48 layers)
   and recurrentgemma-2b (26 layers: 18 RG-LRU, 8 local attention).  The
   rows of a model with a recurrent state prefill at one exact length,
   since pad tokens would enter the state.  Logits are held within 2.5% of
   max |plain logit|; for a model with a recurrent state the limit is the
   larger of that and twice the noise floor, the largest change that the
   plain versions alone make when only a sum order changes (the SSD
   scan's chunk, or the plain attention's key blocks for the hybrid):
   random weights through dozens of recurrent layers amplify a one-ulp
   change of one layer's output, and in bf16 that floor can itself be far
   above 2.5%.  For the bf16 runs of those two models, both the kernel
   run and the plain run are also held against the plain run in float32
   of the same weights upcast, and both distances printed (no limit: they
   say which bf16 run is further from float32).
5. End to end: ``repro_torch.launch.serve`` (PipeBoostEngine over 4
   logical devices + ServingEngine, 4 slots, max_len 1024) serves 8
   requests of 64-512 prompt tokens and 32 new tokens each, at full width:
   pipeboost-opt-1.3b with 2 rank-16 adapters, then mamba2-780m and
   recurrentgemma-2b with none.  Launch counts are reset just before and
   read just after each run; every kernel of that run's path must have
   run and no other (a model with a recurrent state: one scan per prefill
   and layer of its kind, one flash launch per prefill and attention
   layer).  Every serving batcher replays one captured decode step
   (``decode_compiles`` 1).
6. Recovery, for pipeboost-opt-1.3b, mamba2-780m and recurrentgemma-2b at
   full width and depth (launch counts reset just before each model's
   run and read just after):
   - migration (bf16, the serving dtype): server A serves 4 requests of
     64-512 prompt tokens to token 8 of 32 and drains them with
     snapshots; server B, which shares A's parameter tensors and has
     captured its decode step on an idle batch (for opt-1.3b, then
     switched to each of 2 merged adapters and back, the switch's copy
     timed), imports all four in one scatter and finishes them.  Every
     stream must equal an uninterrupted run's, B prefills no token and
     captures no second graph.  Snapshot bytes, export and import times and
     the peak device memory are printed;
   - partial crash (float32, see below): a ``PipeBoostEngine`` over 4
     devices after one loading round prefills 4 rows of 256 tokens,
     decodes 8, crashes device 1 and ``recover()``s, and decodes on to 32;
     the stream must equal an uncrashed run's.  ``lost_state_layers``, the
     reconstruct stats and ``recover()``'s wall time are printed;
   - re-lay (float32): 4 live requests at token 8 lose the layers device 1
     held (their state zeroed), ``relay_inflight`` rebuilds them in one
     scatter, and every stream must equal an uninterrupted run's.  The
     same re-lay in bf16 prints how many streams stayed equal (no limit).
   Both rebuilds must launch flash (opt-1.3b, recurrentgemma-2b), the SSD
   scan (mamba2-780m) and the RG-LRU scan (recurrentgemma-2b).  A rebuild
   recomputes the lost layers through the prefill path, another sum order
   than the decode steps that wrote them, and random bf16 weights amplify
   such a change far past the quantized sampler's bins (phase 4's bf16
   greedy agreements), so the exact-stream checks of a rebuild run in
   float32.
7. The cluster, pipeboost-opt-1.3b at full width and depth, servers of 2
   logical devices, 4 slots and max_len 1024, prompts of 64-512 tokens and
   32 new tokens (launch counts reset just before each part and read just
   after):
   - 7a, exactness (float32, logical clock): a ``ClusterRouter`` with 2
     rank-16 adapters merged by the LoRA kernel, a prefix cache of 4
     entries per server and a ``StateTier`` replays a
     ``repeated_prefix_trace`` (448 shared tokens, 16 own) merged with a
     ``burst_wave_trace``; server 1 crashes after 3 completions, its
     in-flight requests migrate, and it rejoins 20 ticks later.  Every
     request must complete with the stream the same request gets served
     alone by one cold ``ServingEngine`` without a cache; prefix hits
     must occur; every server that decoded captured its step once;
     decode, flash and the LoRA merge must launch;
   - 7b, the normal entry point (bf16, wall clock): ``python -m
     repro_torch.launch.serve --cluster --wall-clock`` on a burst wave of
     16 base-model requests with ``--crash-at 3``; every request must
     complete and some must be re-routed (with adapters, an epoch barrier
     can leave the crashed server holding only queued requests on the
     wall clock, which re-route without counting).  TTFT and TBT
     percentiles, throughput, servers and scale-ups, GPU-seconds and
     device memory are printed;
   - 7c, a prefix hit against a cold prefill (bf16): one batcher, a
     prompt of 448 shared and 16 own tokens, then 448 and 64; for each,
     the cold admission's TTFT, the hit's import, suffix walk and total,
     and the deposit's export time and bytes are printed (no limit; an
     entry holds max_len rows, so a hit can be slower than a cold
     prefill), with the hit stream's agreement with a cold one.

8. The pipeline prefill (``distributed/pipeline.py``), each belt's 4
   stages on 4 streams of the one card (``stage_mesh(4, 1, devices=[card]
   * 4)``), launch counts reset just before each part and read just
   after:
   - 8a (float32, pipeboost-opt-1.3b at full width and depth): a
     ``PipeBoostEngine`` over 4 devices with ``enable_pipeline_prefill``
     (2 microbatches) after one loading round prefills 4 prompts of 512
     tokens through the belt; its logits and every cache leaf are held
     within 2.5% of the max of ``forward(mode="prefill")``'s (phase 4's
     tolerance), and its ``generate`` stream of 32 tokens must equal a
     fully loaded single engine's; then the same with 2 rank-16 adapters,
     one switched on (the LoRA kernel merges it);
   - 8b: the same for mamba2-780m (48 layers, float32): the SSD scan runs
     once a layer and microbatch;
   - 8c: the sequence-chunk belt (8 chunks of 64; each chunk's flash
     launch reads a prefix of its stage's K/V with ``q_offset``) against
     ``forward`` (float32, opt-1.3b);
   - 8d: a ``ServingEngine`` whose batcher is wired to a mid-load engine's
     belt, as ``ClusterServer`` wires it on several cards, serves 4
     requests of 64-512 tokens, 32 new each, through the belt; the engine
     fills and switches, 4 more take the single prefill; one captured
     decode step throughout, every stream equal to an unwired server's
     (float32);
   - 8e: a mid-load belt engine decodes 4 prompts of 256 tokens to token
     8, ``repartition(dead=[3])`` must report 3 stages, the continued
     streams and a new prefill through the 3-stage belt must equal a
     single engine's (float32);
   - timings (bf16, B 4, S 512, no limit): the GPipe belt and, for
     opt-1.3b, the belt with one microbatch and the sequence-chunk belt
     against the single eager
     ``forward`` for opt-1.3b and mamba2-780m: wall and CUDA-event times,
     the device span, busy time and kernel sum from ``torch.profiler``,
     and the flash and SSD launches a call (printed as one JSON line
     before the kernels line).
   The kernels line adds phase 8's launches (``pipeline_launches`` and
   ``pipeline_launches_by_part``).
9. The remaining model families (launch counts reset just before each
   part and read just after):
   - 9a: ``launch.serve --arch qwen2-moe-a2.7b --adapters 2`` as phase 5
     runs it (bf16, full width and depth: 24 layers, 60 routed experts
     top-4 and 4 shared, 14.3 B parameters); each prompt prefills alone
     (capacity couples the rows), decode runs the dropless experts in the
     captured step (``decode_compiles`` 1); TTFT, decode tokens/s and
     peak memory printed, then 4 new live requests and the median of 20
     replays of the captured step against its bound (every block weight,
     the LM head and the live cache rows read once);
   - 9b: qwen2-moe-a2.7b at full width, depth cut to 4 layers, one rank-16
     adapter merged: a prefill of 4 x 192 and 8 decode steps through the
     kernels and the plain versions; in bf16 the share of (token, choice)
     pairs routed alike and both runs' distances to the float32 plain run
     of the same weights (printed, no limit: a flipped top-k amplifies a
     small attention difference); in float32 the logits within 2.5% of
     max |logit| and the greedy stream equal; a float32 prefill at
     capacity factor 0.5 whose dropped pairs must be equal in both runs;
   - 9c: the MoE belts, float32, 8 layers, capacity factor E/K (nothing
     can drop): the GPipe belt (4 stage streams, 2 microbatches) and the
     sequence-chunk belt (8 chunks) against ``forward`` within 1e-5 of max
     |x| (logits and cache), then a mid-load belt engine's crash of device
     1 at decode step 8 and ``recover()``, its 4 streams of 32 tokens
     equal to an uncrashed single engine's;
   - 9d: hubert-xlarge at full width and depth (48 layers, 16 heads of
     80, non-causal, LayerNorm), ``forward`` from embeddings 4 x 512
     through the kernels and the plain versions in bf16 (printed) and
     float32 (within 2.5% of max |logit|); flash at head dim 80 alone
     (non-causal, causal, windows, GQA, ``q_offset``; bf16 within 2e-2,
     float32 within 2e-5 of the plain version) and timed at hubert's
     shape beside SDPA and its bound (``at_hubert`` in the flash entry);
   - 9e: qwen2-vl-72b at full width, depth cut to 4 layers, float32: a
     prefill of 2 x 256 embeddings with (t, h, w) M-RoPE positions that
     all differ and 8 decode steps of embeddings, within 2.5% of max
     |logit| of the plain run, every step's argmax equal.
   The kernels line counts 9a among the serve runs (``launches``,
   ``launches_by_arch``) and every part in ``families_launches_by_part``;
   a ``{"moe_decode_step": ...}`` line before it holds 9a's step.
10. Training (launch counts reset just before each part and read just
   after):
   - 10a: each kernel on the train path through its autograd Function
     (the launch, then the backward: flash by the plain formulas, the SSD
     scan by autograd of the plain version run again, the RG-LRU scan by
     the kernel on the reversed recurrence) against the plain version
     differentiated by autograd: flash at opt-1.3b's, recurrentgemma-2b's
     (window 128), hubert-xlarge's (head dim 80, non-causal) and
     qwen2-moe-a2.7b's shapes, the SSD scan at mamba2-780m's width (from
     zeros and from a state, x, B and C strided views of one conv_out),
     the RG-LRU scan at W 2560 (from zeros and from h0); float32 within
     1e-4 of max |plain gradient|, bf16 printed against the float32 plain
     gradients; then each kernel's forward and backward timed beside the
     plain version's backward and, for flash, SDPA's forward and
     backward;
   - 10b: ``launch.train --arch pipeboost-opt-1.3b --steps 10 --batch 8
     --seq 512`` at full width and depth in bf16 with every layer
     rematerialised: every loss finite, the last below the first, 48
     flash launches a step (each of the 24 layers' forward runs twice
     under remat) and no other kernel; the step time (median of steps
     3-10), tokens/s, peak memory and model FLOPs a step
     (``core/analytic.py``'s ``train_step_flops``) against the 989
     TFLOP/s bf16 peak, printed as a ``{"train_step": ...}`` line before
     the kernels line;
   - 10c: one loss and gradient evaluation through the kernels and
     through the plain versions, float32 at full width with depth cut:
     mamba2-780m at 8 of 48 layers (2 x 512), recurrentgemma-2b at 6 of 26
     (1 x 2176, so the 2048-token window binds), qwen2-moe-a2.7b at 4 of 24
     (2 x 256, capacity path and aux loss); the loss within 1e-5
     relative and every gradient leaf within 1e-3 of its max |g|; the
     same draws in bf16, their loss printed;
   - 10d: ``launch.train`` at opt-1.3b's full width, 2 layers, 6 steps
     with a checkpoint every 3, then resumed from step 3 after step 6's
     checkpoint is set aside: steps 4-6 bit-equal to the uninterrupted
     run's losses, and the two step-6 checkpoints equal leaf by leaf
     (params, step, m and v); the checkpoint's bytes and its save and
     restore times printed.
   The kernels line gains ``train_launches`` (10b-10d) and
   ``train_launches_by_part`` for every kernel, and ``backward_ms``,
   ``backward_route`` and ``train_timing`` (10a's times) for the three
   on the train path.
11. The dry run and rooflines (``launch/dryrun.py``,
   ``launch/rooflines.py``), ``build_pipeline_cell`` and the examples:
   - 11a: ``dryrun --all --skip-cost`` over both production meshes, then
     the cost of pipeboost-opt-1.3b, qwen3-1.7b and recurrentgemma-2b at
     train_4k, prefill_32k and decode_32k and one ``--pipeline`` cell
     (qwen3-1.7b prefill_32k), on a pool of worker processes (meta
     DTensors over a fake process group: nothing on the card); every
     applicable cell must pass; each production cell's peak per device
     and the ops it ran replicated, and the wall time, are printed;
   - 11b: the dry run on a one-card mesh held against the card, at phase
     10b's train step (opt-1.3b, 8 x 512, bf16, remat) and at a replayed
     decode step (opt-1.3b, 4 slots, max_len 1024; the peak statistics
     reset after the capture and read around 20 replays): its argument
     bytes within 1% of the real state's, its peak per device within
     0.5-2x of ``torch.cuda.max_memory_allocated``, its roofline time at
     most 105% of the measured step (a bound above the measurement is a
     counting error), each printed with the card's name and power limit;
   - 11c: ``build_pipeline_cell`` at opt-1.3b's full width and depth (24
     layers, 8 stages as 8 streams of one card, B 8, S 512) against
     ``forward``: float32 within 1e-4 of max |logit|, bf16 within 2.5%,
     its flash launches counted (24 layers x 2 microbatches);
   - 11d: the four ``examples/torch_*.py`` on the card, in this process:
     each prints its equalities as true; each one's wall time printed.
   The kernels line gains ``phase11_launches`` and
   ``phase11_launches_by_part`` (11c, 11d); a ``{"dryrun": ...}`` line
   before it holds phase 11's numbers.
12. Training across cards: ``launch.train`` under ``torchrun``, one
   process a card, each rank run through this script's
   ``--train-worker`` entry (which sets the launch counts to 0, calls
   ``launch.train.main`` and has rank 0 write its result and counts):
   - 12a: phase 10b's run with ``--distributed-init`` on one NCCL rank:
     the train state as DTensors on the host mesh (1, 1), flash through
     the DTensor route (``local_map``); every loss equal to 10b's, every
     loss finite, the last below the first, 48 flash launches a step;
     its step time, tokens/s and peak memory printed beside 10b's;
   - 12b: the reduced opt-1.3b on the card host's CPU, 3 steps on 2
     ``gloo`` ranks against one process: losses within 1e-5 relative,
     AdamW's step, m and v within 1e-4 of each leaf's max |x|, the
     parameters within 5% of lr x steps (AdamW's gain of lr / eps on
     gradients near eps turns sum-order noise into parameter moves far
     above 1e-4 of max |p|); the 2-rank checkpoint restored in one
     process, every leaf equal; resumed to step 4 on one rank and in one
     process, held the same way;
   - 12c: 12a on min(count, 4) cards when the machine has two or more,
     else ``"cross_card": "not run: 1 card"``;
   - 12d: the launcher's layout with 'model' > 1, on 4 ``gloo`` ranks of
     the card host's CPU under its torch (printed), each rank through
     this script's ``--rows-worker`` entry: the mesh (2, 2), the batch
     over 'data', the sequence over 'model', the state FSDP as
     DTensors, against one process.  The reduced opt-1.3b's 3 steps:
     losses within 1e-5 relative, the state held as 12b holds it;
     reduced mamba2-780m and recurrentgemma-2b: the loss within 1e-5
     relative and every gradient leaf within 1e-4 of its max |g|;
     reduced qwen2-moe-a2.7b the same against one process under a (2, 2)
     policy, whose 4 token groups are the reference's contiguous ones.
   The kernels line gains ``train_launches_by_part["12a"]`` (and 12c's);
   a ``{"train_distributed": ...}`` line before it holds phase 12's
   numbers.

The line before the last is one JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ATTN_TOL = 2e-2
SSD_BF16_REL = 2.0 ** -8     # SSD bf16 y: share of |plain y| ...
SSD_BF16_MEAN = 1e-2         # ... plus this share of mean |plain y|
SSD_F32_TOL = 2e-5           # SSD float32 y: share of max |plain y|
SSD_STATE_TOL = 1e-4         # SSD final state: share of max |plain state|
RGLRU_TOL = 1e-5             # RG-LRU y and h_T: share of max |plain|
LOGIT_REL_TOL = 2.5e-2       # model logits: share of max |plain logit|
FLOOR_MULT = 2.0             # recurrent models: multiple of the noise floor
L2_BYTES = 50 * 2 ** 20
# the kernels a decode step's attention layers launch besides attention
FUSED = ("rms_norm", "rope")


class SmokeError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(torch, label: str, calls, iters: int):
    """(device ms, host-paced ms) of one call, over ``iters`` calls that
    rotate through ``calls`` (distinct inputs, so the L2 cache does not
    hold them), after a warm-up.  Keep ``iters`` times the launches of one
    call well under the device's launch queue (about a thousand), or the
    host blocks behind the spin.

    Host-paced: CUDA events around the calls as an eager loop issues them,
    so host time between launches counts.  Device: the same events, but a
    spin kernel first holds the stream for longer than the host takes to
    issue the calls, so the launches reach the device back to back and the
    events measure the device's work alone."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run(spin_s: float):
        if spin_s:
            torch.cuda._sleep(int(spin_s * 2e9))   # >= spin_s at <= 2 GHz
        t0 = time.perf_counter()
        start.record()
        for i in range(iters):
            calls[i % len(calls)]()
        end.record()
        issue_s = time.perf_counter() - t0
        end.synchronize()
        if spin_s and issue_s >= spin_s:
            print(f"  note: issuing {label} took {issue_s:.3f} s, longer "
                  f"than the {spin_s:.3f} s spin: its device time is an "
                  f"upper bound")
        return start.elapsed_time(end) / iters, issue_s

    host_ms, issue_s = run(0.0)
    return run(3 * issue_s + 0.05)[0], host_ms


def n_copies(nbytes: int) -> int:
    return max(1, min(16, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def bound(cost):
    """(ms, "bytes" or "operations") of a kernel module's ``cost()``."""
    from repro_torch.launch import rooflines
    flops, moved, dtype = cost
    return rooflines.bound(moved, flops, dtype)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def product_instructions(build, lib_dir: Path):
    """The product instructions in the SASS of each attention, SSD and
    LoRA kernel: {kernel (template arguments): sorted tensor-core
    opcodes}, from ``cuobjdump -sass`` of the built library."""
    import re
    exe = Path(build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(exe), "-sass", str(lib_dir / build.LIB_NAME)],
                         capture_output=True, text=True, timeout=300)
    require(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    found, cur = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            m = re.search(r"(flash_bf16_kernel|flash_attention_kernel|"
                          r"decode_partial_mma_kernel|decode_partial_kernel|"
                          r"decode_merge_kernel|ssd_chunk_state_mma_kernel|"
                          r"ssd_chunk_out_mma_kernel|"
                          r"ssd_chunk_state_f32_kernel|"
                          r"ssd_chunk_out_f32_kernel|ssd_state_pass_kernel|"
                          r"lora_merge_kernel)(?:I(.*?)EEv)?", line)
            cur = None
            if m:
                args = (m.group(2) or "").replace("13__nv_bfloat16", "bf16,")
                args = re.sub(r"^f", "float32,", args)
                args = re.sub(r"Li(\d+)E", r"\1,", args).rstrip(",")
                cur = f"{m.group(1)}<{args}>" if args else m.group(1)
                found[cur] = set()
        elif cur is not None:
            found[cur].update(re.findall(r"\b(H[G]?MMA\.[\w.]+)", line))
    return {k: sorted(v) for k, v in found.items()}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_decode(torch, ops, dev, results):
    from repro_torch.kernels import decode_attention as dec
    g = torch.Generator(device=dev).manual_seed(10)
    bf = torch.bfloat16

    def make(B, C, Hq, Hkv, d, lens, fold, mask):
        """``mask``: None, "random" (a quarter of the slots off) or "ring"
        (the model's ring mask, as a windowed layer's decode builds it)."""
        q = torch.randn((B, 1, Hq, d), generator=g, device=dev).to(bf)
        k = torch.randn((B, C, Hkv, d), generator=g, device=dev).to(bf)
        v = torch.randn((B, C, Hkv, d), generator=g, device=dev).to(bf)
        kn = torch.randn((B, 1, Hkv, d), generator=g, device=dev).to(bf) \
            if fold else None
        vn = torch.randn((B, 1, Hkv, d), generator=g, device=dev).to(bf) \
            if fold else None
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        sm = None
        if mask == "random":
            sm = torch.rand((B, C), generator=g, device=dev) > 0.25
        elif mask == "ring":
            j = torch.arange(C, device=dev)[None, :]
            p = lens[:, None]
            sm = (j < p) & ((p < C) | (j != p % C))
        return dict(q=q, k=k, v=v, lens=lens, kn=kn, vn=vn, sm=sm)

    def run(x, plain=False):
        f = (lambda t: None if t is None else t.float()) if plain \
            else (lambda t: t)
        return ops.decode_attention(f(x["q"]), f(x["k"]), f(x["v"]),
                                    x["lens"], k_new=f(x["kn"]),
                                    v_new=f(x["vn"]), slot_mask=x["sm"])

    C = 1024
    ragged = [0, 77, 600, C - 1]
    cases = {
        "opt full cache + fold": (4, C, 32, 32, 64, [C - 1] * 4, True, None),
        "opt ragged + fold": (4, C, 32, 32, 64, ragged, True, None),
        "opt ragged": (4, C, 32, 32, 64, ragged, False, None),
        "opt slot mask + fold": (4, C, 32, 32, 64, [0, 300, C - 1, C - 1],
                                 True, "random"),
        "qwen3 GQA ragged + fold": (4, C, 16, 8, 128, [0, 513, 900, C - 1],
                                    True, None),
        "qwen3 GQA slot mask": (4, C, 16, 8, 128, [5, 64, 1000, C - 1],
                                False, "random"),
        "recurrentgemma G10 hd256 ring + fold": (4, C, 10, 1, 256, ragged,
                                                 True, "ring"),
        "recurrentgemma G10 hd256 slot mask + fold": (
            4, C, 10, 1, 256, [0, 300, C - 1, C - 1], True, "random"),
        "recurrentgemma G10 hd256 ragged": (4, C, 10, 1, 256, ragged, False,
                                            None),
        # qwen2-moe-a2.7b's decode (9a): 16 heads of 128 on 16 KV heads
        "qwen2-moe full cache + fold": (4, C, 16, 16, 128, [C - 1] * 4,
                                        True, None),
        "qwen2-moe ragged + fold": (4, C, 16, 16, 128, ragged, True, None),
        "qwen2-moe ragged": (4, C, 16, 16, 128, ragged, False, None),
        # qwen2-vl-72b's decode (9e): 64 heads on 8
        "qwen2-vl G8 ragged + fold": (4, C, 64, 8, 128, ragged, True, None),
    }
    # the edges of the cache splits: lens at 1, one split's width, one
    # more, C - 1 (qwen3 at a C that is not a multiple of the width); then
    # every row empty (every split empty)
    for tag, Cx, Hq, Hkv, d in (("opt", C, 32, 32, 64),
                                ("qwen3 GQA C=1000", 1000, 16, 8, 128),
                                ("recurrentgemma G10 hd256", C, 10, 1, 256),
                                ("qwen2-moe", C, 16, 16, 128)):
        width = -(-Cx // dec.decode_splits(4, Hkv, Cx, d))
        edges = [1, width, width + 1, Cx - 1]
        for fold in (True, False):
            f = " + fold" if fold else ""
            cases[f"{tag} split edges {edges}{f}"] = (4, Cx, Hq, Hkv, d,
                                                      edges, fold, None)
            cases[f"{tag} all rows empty{f}"] = (4, Cx, Hq, Hkv, d, [0] * 4,
                                                 fold, None)
    worst = 0.0
    for name, spec in cases.items():
        x = make(*spec)
        out = run(x)
        torch.cuda.synchronize()
        with ops.plain_versions():
            ref = run(x, plain=True)
        err = (out.float() - ref).abs().max().item()
        print(f"  decode {name}: max|kernel - plain| = {err:.3e}")
        require(err <= ATTN_TOL, f"decode {name}: {err} > {ATTN_TOL}")
        worst = max(worst, err)

    def timed(label, spec):
        B, C, Hq, Hkv, d, lens, fold, _ = spec
        x = make(*spec)
        sets = [x] + [make(*spec)
                      for _ in range(n_copies(nbytes(x["k"], x["v"])) - 1)]
        ms, paced_ms = time_ms(torch, f"decode kernel {label}",
                               [lambda s=s: run(s) for s in sets], 200)
        with ops.plain_versions():
            plain_ms, _ = time_ms(torch, f"decode plain {label}",
                                  [lambda s=s: run(s) for s in sets], 5)
        # SDPA over the cache with the same length mask (one key fewer
        # than the kernel, which also folds the new token)
        lib_sets = []
        for s in sets:
            mask = (torch.arange(C, device=dev)[None, :]
                    < s["lens"][:, None])[:, None, None, :]
            lib_sets.append((s["q"].transpose(1, 2).contiguous(),
                             s["k"].transpose(1, 2).contiguous(),
                             s["v"].transpose(1, 2).contiguous(), mask))
        F = torch.nn.functional
        library_ms, _ = time_ms(torch, f"decode SDPA {label}", [
            lambda a=a: F.scaled_dot_product_attention(
                a[0], a[1], a[2], attn_mask=a[3], enable_gqa=Hq != Hkv)
            for a in lib_sets], 50)
        b_ms, b_by = bound(dec.cost(
            batch=B, heads=Hq, kv_heads=Hkv, head_dim=d, cache_len=C,
            valid_rows=sum(lens), fold=fold, slot_mask=x["sm"] is not None))
        n = dec.decode_splits(B, Hkv, C, d)
        print(f"  decode {label}: {n} splits of {-(-C // n)} rows x {Hkv} "
              f"KV heads x {B} rows = {n * Hkv * B} CTAs, then a merge "
              f"launch of {B * Hq * -(-d // 128)} CTAs")
        print(f"  decode timed {label} {tuple(spec[:5])}, lens {lens}: "
              f"kernel {ms:.4f} ms (host-paced {paced_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})")
        return dict(ms=ms, paced_ms=paced_ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)

    main = timed("opt-1.3b", cases["opt full cache + fold"])
    rg = timed("recurrentgemma-2b", cases[
        "recurrentgemma G10 hd256 ring + fold"])
    moe = timed("qwen2-moe-a2.7b", cases["qwen2-moe full cache + fold"])
    results["decode_attention"] = dict(max_abs_err=worst, **main,
                                       at_recurrentgemma=rg,
                                       at_qwen2_moe=moe)


FLASH_F32_TOL = 2e-5          # float32 flash at head dim 80: absolute


def check_flash(torch, ops, dev, results):
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(11)
    bf = torch.bfloat16

    def make(B, Sq, Sk, Hq, Hkv, d, dt=bf):
        return [torch.randn(shape, generator=g, device=dev).to(dt)
                for shape in ((B, Sq, Hq, d), (B, Sk, Hkv, d),
                              (B, Sk, Hkv, d))]

    def run(x, kw, plain=False):
        f = (lambda t: t.float()) if plain else (lambda t: t)
        return ops.flash_attention(f(x[0]), f(x[1]), f(x[2]),
                                   **{"causal": True, **kw})

    cases = []
    for tag, Hq, Hkv, d in (("opt", 32, 32, 64), ("qwen3", 16, 8, 128),
                            ("recurrentgemma", 10, 1, 256),
                            ("qwen2-moe", 16, 16, 128)):
        for S in (128, 512):
            cases.append((f"{tag} S={S} causal", (4, S, S, Hq, Hkv, d), {}))
        cases.append((f"{tag} S=512 window 128", (4, 512, 512, Hq, Hkv, d),
                      {"window": 128}))
        cases.append((f"{tag} 128 queries at q_offset 512",
                      (4, 128, 640, Hq, Hkv, d), {"q_offset": 512}))
        for S in (65, 700):                  # ragged 64-row tiles
            cases.append((f"{tag} S={S} causal, ragged tiles",
                          (2, S, S, Hq, Hkv, d), {}))
    cases.append(("recurrentgemma S=700 window 300 ragged",
                  (2, 700, 700, 10, 1, 256), {"window": 300}))
    # qwen2-moe-a2.7b's prompts prefill one at a time at exact length (9a)
    for S in (64, 333, 512):
        cases.append((f"qwen2-moe one prompt S={S}",
                      (1, S, S, 16, 16, 128), {}))
    # head dim 80 (hubert-xlarge, non-causal; 9d), also in float32
    cases += [
        ("d80 hubert non-causal", (4, 512, 512, 16, 16, 80),
         {"causal": False}),
        ("d80 causal ragged", (2, 300, 300, 16, 16, 80), {}),
        ("d80 non-causal window 128", (2, 700, 700, 16, 16, 80),
         {"causal": False, "window": 128}),
        ("d80 GQA 16 on 4, window 64", (2, 300, 300, 16, 4, 80),
         {"window": 64}),
        ("d80 GQA 8 on 2, q_offset 512", (2, 100, 612, 8, 2, 80),
         {"q_offset": 512})]
    worst = 0.0
    for name, spec, kw in cases:
        dtypes = [(bf, ATTN_TOL)]
        if spec[-1] == 80:
            dtypes.append((torch.float32, FLASH_F32_TOL))
        for dt, tol in dtypes:
            x = make(*spec, dt=dt)
            out = run(x, kw)
            torch.cuda.synchronize()
            with ops.plain_versions():
                ref = run(x, kw, plain=True)
            err = (out.float() - ref).abs().max().item()
            tag = "" if dt == bf else " float32"
            print(f"  flash {name}{tag}: max|kernel - plain| = {err:.3e}")
            require(err <= tol, f"flash {name}{tag}: {err} > {tol}")
            if dt == bf:
                worst = max(worst, err)

    def timed(label, spec, causal=True):
        B, Sq, Sk, Hq, Hkv, d = spec
        kw = {"causal": causal}
        sets = [make(*spec)
                for _ in range(n_copies(4 * B * Sq * Hq * d * 2))]
        ms, paced_ms = time_ms(torch, f"flash kernel {label}",
                               [lambda s=s: run(s, kw) for s in sets], 100)
        with ops.plain_versions():
            plain_ms, _ = time_ms(torch, f"flash plain {label}",
                                  [lambda s=s: run(s, kw) for s in sets], 2)
        F = torch.nn.functional
        lib_sets = [[t.transpose(1, 2).contiguous() for t in s]
                    for s in sets]
        library_ms, _ = time_ms(torch, f"flash SDPA {label}", [
            lambda a=a: F.scaled_dot_product_attention(
                a[0], a[1], a[2], is_causal=causal, enable_gqa=Hq != Hkv)
            for a in lib_sets], 50)
        b_ms, b_by = bound(fa.cost(batch=B, q_len=Sq, kv_len=Sk, heads=Hq,
                                   kv_heads=Hkv, head_dim=d, causal=causal))
        print(f"  flash timed {label} {spec} "
              f"{'causal' if causal else 'non-causal'}: kernel {ms:.4f} ms "
              f"(host-paced {paced_ms:.4f} ms), plain {plain_ms:.4f} ms, "
              f"SDPA {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        return dict(ms=ms, paced_ms=paced_ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)

    # opt-1.3b's prefill at bucket 512; recurrentgemma's and qwen2-moe's
    # one 512-token prompt (their prompts prefill one by one); hubert's
    # non-causal 4 x 512 frames
    main = timed("opt-1.3b", (4, 512, 512, 32, 32, 64))
    rg = timed("recurrentgemma-2b", (1, 512, 512, 10, 1, 256))
    moe = timed("qwen2-moe-a2.7b", (1, 512, 512, 16, 16, 128))
    hb = timed("hubert-xlarge", (4, 512, 512, 16, 16, 80), causal=False)
    results["flash_attention"] = dict(max_abs_err=worst, **main,
                                      at_recurrentgemma=rg,
                                      at_qwen2_moe=moe, at_hubert=hb)


def check_lora(torch, ops, dev, results):
    from repro_torch.kernels import lora_merge as lm
    g = torch.Generator(device=dev).manual_seed(12)
    L, D, r, scale = 24, 2048, 16, 2.0
    W = (torch.randn((L, D, D), generator=g, device=dev) * 0.03).to(
        torch.bfloat16)
    A = torch.randn((L, D, r), generator=g, device=dev) * D ** -0.5
    B = torch.randn((L, r, D), generator=g, device=dev) * 0.02
    out = ops.lora_merge(W, A, B, scale)
    torch.cuda.synchronize()
    ref = lm.lora_merge_plain(W, A, B, scale)
    diff = (out.float() - ref.float()).abs()
    _, e = torch.frexp(ref.float().abs())
    ulp = torch.ldexp(torch.ones_like(diff), e - 8)
    err = diff.max().item()
    n_over = int((diff > ulp).sum().item())
    print(f"  lora L={L} {D}x{D} r={r}: max|kernel - plain| = {err:.3e}, "
          f"elements beyond 1 bf16 ulp: {n_over}")
    require(n_over == 0, f"lora merge: {n_over} elements beyond 1 ulp")
    del out, ref, diff, ulp, e
    ms, paced_ms = time_ms(torch, "lora kernel",
                           [lambda: ops.lora_merge(W, A, B, scale)], 20)
    plain_ms, _ = time_ms(torch, "lora plain",
                          [lambda: lm.lora_merge_plain(W, A, B, scale)], 5)
    A16, B16 = A.to(torch.bfloat16), B.to(torch.bfloat16)
    library_ms, _ = time_ms(torch, "lora baddbmm",
                            [lambda: torch.baddbmm(W, A16, B16, alpha=scale)],
                            20)
    b_ms, b_by = bound(lm.cost(layers=L, d_in=D, d_out=D, rank=r))
    print(f"  lora timed: kernel {ms:.4f} ms (host-paced {paced_ms:.4f} "
          f"ms), plain {plain_ms:.4f} ms, baddbmm {library_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})")
    results["lora_merge"] = dict(max_abs_err=err, ms=ms, paced_ms=paced_ms,
                                 plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=library_ms)


NORM_ROPE_SHAPES = {    # decode rows: (slots, D, Hq, Hkv, hd, theta)
    "opt": (32, 2048, 32, 32, 64, 1e4),
    "at_qwen2_moe": (64, 2048, 16, 16, 128, 1e6),
    "at_recurrentgemma": (4, 2560, 10, 1, 256, 1e4),
}


def check_norm_rope(torch, ops, dev, results):
    """The decode step's RMSNorm and RoPE kernels against their plain
    versions at pipeboost-opt-1.3b's, qwen2-moe-a2.7b's and
    recurrentgemma-2b's decode shapes (bf16): the norm's residual sum bit
    for bit and its output within one bf16 ulp (the squares summed in
    another order), RoPE within one bf16 ulp (its elements that differ at
    all printed: none where the card's cosf and sinf are PyTorch's); each
    timed beside its plain version and its bound, the norm also beside
    ``torch.nn.functional.rms_norm`` (a yardstick the port never calls)."""
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.kernels import rope as rp
    from repro_torch.models import layers
    F = torch.nn.functional
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(13)

    def ulps(got, want):
        """(elements that differ, elements beyond one bf16 ulp, the
        largest difference)."""
        diff = (got.float() - want.float()).abs()
        _, e = torch.frexp(want.float().abs())
        over = diff > torch.ldexp(torch.ones_like(diff), e - 8)
        return int((diff > 0).sum().item()), int(over.sum().item()), \
            diff.max().item()

    norm, rope = {}, {}
    for tag, (B, D, Hq, Hkv, hd, theta) in NORM_ROPE_SHAPES.items():
        n = n_copies(4 * B * D * 2)
        xs = [(torch.randn((B, 1, D), generator=g, device=dev) * 3).to(bf)
              for _ in range(n)]
        rs = [torch.randn((B, 1, D), generator=g, device=dev).to(bf)
              for _ in range(n)]
        w = (torch.randn((D,), generator=g, device=dev) * 0.5 + 1).to(bf)
        s, h = ops.rms_norm(xs[0], w, 1e-5, residual=rs[0])
        h0 = ops.rms_norm(xs[0], w, 1e-5)
        torch.cuda.synchronize()
        s_ref, h_ref = rn.rms_norm_plain(xs[0], w, 1e-5, residual=rs[0])
        require(torch.equal(s, s_ref), f"rms_norm {tag}: residual sum "
                f"differs from the plain version's")
        n_diff, n_over, err = ulps(h, h_ref)
        n_diff0, n_over0, err0 = ulps(h0, rn.rms_norm_plain(xs[0], w, 1e-5))
        print(f"  rms_norm {tag} {B} x {D}: residual sum equal; max|kernel "
              f"- plain| = {err:.3e} ({n_diff} of {h.numel()} elements "
              f"differ, {n_over} beyond 1 bf16 ulp); without residual "
              f"{err0:.3e} ({n_diff0} differ, {n_over0} beyond)")
        require(n_over == 0 and n_over0 == 0,
                f"rms_norm {tag}: elements beyond one bf16 ulp")
        ms, paced_ms = time_ms(torch, "rms_norm kernel", [
            lambda x=x, r=r: ops.rms_norm(x, w, 1e-5, residual=r)
            for x, r in zip(xs, rs)], 200)
        plain_ms, _ = time_ms(torch, "rms_norm plain", [
            lambda x=x, r=r: rn.rms_norm_plain(x, w, 1e-5, residual=r)
            for x, r in zip(xs, rs)], 50)
        ms0, paced0 = time_ms(torch, "rms_norm kernel, no residual", [
            lambda x=x: ops.rms_norm(x, w, 1e-5) for x in xs], 200)
        plain0, _ = time_ms(torch, "rms_norm plain, no residual", [
            lambda x=x: rn.rms_norm_plain(x, w, 1e-5) for x in xs], 50)
        lib0, _ = time_ms(torch, "F.rms_norm", [
            lambda x=x: F.rms_norm(x, (D,), w, 1e-5) for x in xs], 200)
        b_ms, b_by = bound(rn.cost(rows=B, dim=D, residual=True))
        b0_ms, b0_by = bound(rn.cost(rows=B, dim=D))
        print(f"  rms_norm {tag} timed: with residual kernel {ms:.4f} ms "
              f"(host-paced {paced_ms:.4f}), plain {plain_ms:.4f}, bound "
              f"{b_ms:.6f} ({b_by}); without kernel {ms0:.4f} (host-paced "
              f"{paced0:.4f}), plain {plain0:.4f}, F.rms_norm {lib0:.4f}, "
              f"bound {b0_ms:.6f} ({b0_by})")
        norm[tag] = dict(max_abs_err=max(err, err0), ms=ms,
                         paced_ms=paced_ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None, no_residual=dict(
                             ms=ms0, paced_ms=paced0, plain_ms=plain0,
                             library_ms=lib0, bound_ms=b0_ms,
                             bound_by=b0_by))
        del xs, rs

        n = n_copies(2 * B * (Hq + Hkv) * hd * 2)
        qs = [torch.randn((B, 1, Hq, hd), generator=g, device=dev).to(bf)
              for _ in range(n)]
        ks = [torch.randn((B, 1, Hkv, hd), generator=g, device=dev).to(bf)
              for _ in range(n)]
        pos = torch.randint(0, 2304, (B,), generator=g, device=dev,
                            dtype=torch.int32)
        inv = layers.kept_rope_freqs(hd, theta, dev)
        qo, ko = ops.rope_qk(qs[0], ks[0], pos, inv)
        torch.cuda.synchronize()
        rq, rk = rp.rope_qk_plain(qs[0], ks[0], pos, inv)
        dq, oq, eq = ulps(qo, rq)
        dk, ok, ek = ulps(ko, rk)
        print(f"  rope {tag} {B} x ({Hq} + {Hkv}) x {hd}: max|kernel - "
              f"plain| = {max(eq, ek):.3e}; elements that differ: q {dq}, "
              f"k {dk} ({oq + ok} beyond 1 bf16 ulp)")
        require(oq + ok == 0, f"rope {tag}: elements beyond one bf16 ulp")
        ms, paced_ms = time_ms(torch, "rope kernel", [
            lambda q=q, k=k: ops.rope_qk(q, k, pos, inv)
            for q, k in zip(qs, ks)], 200)
        plain_ms, _ = time_ms(torch, "rope plain", [
            lambda q=q, k=k: rp.rope_qk_plain(q, k, pos, inv)
            for q, k in zip(qs, ks)], 15)
        b_ms, b_by = bound(rp.cost(batch=B, heads=Hq, kv_heads=Hkv,
                                   head_dim=hd))
        print(f"  rope {tag} timed: kernel {ms:.4f} ms (host-paced "
              f"{paced_ms:.4f}), plain {plain_ms:.4f}, bound {b_ms:.6f} "
              f"({b_by}); no single PyTorch call")
        rope[tag] = dict(max_abs_err=max(eq, ek), unequal=dq + dk, ms=ms,
                         paced_ms=paced_ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None)
        del qs, ks
    results["rms_norm"] = dict(norm.pop("opt"), **norm)
    results["rope"] = dict(rope.pop("opt"), **rope)


# granite-4.0-h-small's decode step at 128 slots, then mamba2-780m's at
# phase 5's 4 slots: (B, H, P, N)
SSM_STEP_SHAPES = {"granite": (128, 128, 64, 128), "mamba2": (4, 48, 64, 128)}


def check_ssm_step(torch, ops, dev, results):
    """The Mamba-2 decode step's state-update kernel against its plain
    version, at granite-4.0-h-small's and mamba2-780m's decode shapes in
    bf16 and float32, over 4 chained steps through the views
    ``mixer_step`` passes: each step's state within four float32 ulps of
    |s dA| + |dt x B| of the plain version run from the kernel's previous
    state (the elements that differ at all printed), y within N 2^-24 of
    sum |C s'| + |D x| and, in bf16, one bf16 ulp of the readout and one
    of y; then timed at each shape beside the plain version and the bytes
    bound (no single PyTorch call computes it)."""
    from repro_torch.kernels import ssm_step as ssm
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(15)
    print(f"  torch.einsum through opt_einsum: "
          f"{torch.backends.opt_einsum.is_available()}")

    def make(B, H, P, N, dtype):
        """The per-step operands as views, as ``mixer_step`` makes them."""
        di = H * P
        conv_out = F.silu(torch.randn((B, di + 2 * N), generator=g,
                                      device=dev)).to(dtype)
        proj = torch.randn((B, 2 * di + 2 * N + H), generator=g,
                           device=dev).to(dtype)
        return (conv_out[:, :di].reshape(B, H, P), proj[:, -H:],
                conv_out[:, di:di + N], conv_out[:, di + N:])

    out = {}
    for tag, (B, H, P, N) in SSM_STEP_SHAPES.items():
        state = torch.randn((B, H, P, N), generator=g, device=dev)
        dt_bias = torch.randn((H,), generator=g, device=dev) * 0.5
        A_log = torch.log(torch.linspace(1.0, 16.0, H, device=dev))
        D_skip = torch.randn((H,), generator=g, device=dev)
        worst = 0.0
        for dtype in (torch.bfloat16, torch.float32):
            unequal, y_unequal, ratio = 0, 0, 0.0
            for _ in range(4):
                x, dt_raw, Bm, Cm = make(B, H, P, N, dtype)
                args = (x, dt_raw, dt_bias, A_log, Bm, Cm, D_skip)
                prev = state.clone()
                y = ops.ssm_step(state, *args)
                torch.cuda.synchronize()
                want_state = prev.clone()
                want = ssm.ssm_step_plain(want_state, *args)
                dt = F.softplus(dt_raw.float() + dt_bias)
                dA = torch.exp(dt * -torch.exp(A_log))
                mag = (prev.abs() * dA[..., None, None]
                       + (dt[..., None] * x.float()).abs()[..., None]
                       * Bm.float().abs()[:, None, None, :])
                ratio = max(ratio, ((state - want_state).abs()
                                    / (2.0 ** -21 * mag)).nan_to_num(
                                        0.0).max().item())
                unequal += int((state != want_state).sum().item())
                readout = torch.einsum("bn,bhpn->bhp", Cm.float(),
                                       want_state)
                dx = (D_skip.to(dtype)[:, None] * x).float()
                limit = N * 2.0 ** -24 * (torch.einsum(
                    "bn,bhpn->bhp", Cm.float().abs(), want_state.abs())
                    + dx.abs())
                if dtype == torch.bfloat16:
                    for v in (readout, want.float()):
                        _, e = torch.frexp(v.abs())
                        limit = limit + torch.ldexp(torch.ones_like(v),
                                                    e - 8)
                diff = (y.float() - want.float()).abs()
                require(bool((diff <= limit).all()),
                        f"ssm_step {tag} {dtype}: y beyond its limit")
                y_unequal += int((diff > 0).sum().item())
                worst = max(worst, diff.max().item())
                del prev, want_state, mag, readout
            print(f"  ssm_step {tag} {B} x {H} x {P} x {N} {dtype}, 4 "
                  f"chained steps: state elements that differ "
                  f"{unequal} of {4 * state.numel()} (largest at "
                  f"{ratio:.3f} of its limit), y elements that differ "
                  f"{y_unequal} of {4 * B * H * P}")
            require(ratio <= 1.0, f"ssm_step {tag} {dtype}: state beyond "
                    f"four float32 ulps")
        x, dt_raw, Bm, Cm = make(B, H, P, N, torch.bfloat16)
        args = (state, x, dt_raw, dt_bias, A_log, Bm, Cm, D_skip)
        ms, paced_ms = time_ms(torch, f"ssm_step kernel {tag}",
                               [lambda: ops.ssm_step(*args)], 200)
        plain_ms, _ = time_ms(torch, f"ssm_step plain {tag}",
                              [lambda: ssm.ssm_step_plain(*args)], 20)
        _, moved, _ = c = ssm.cost(batch=B, heads=H, head_dim=P, state=N)
        b_ms, b_by = bound(c)
        print(f"  ssm_step {tag} timed: kernel {ms:.4f} ms (host-paced "
              f"{paced_ms:.4f}), plain {plain_ms:.4f} ms, bound {b_ms:.4f} "
              f"ms ({b_by}; {moved / 1e6:.2f} MB), {100 * b_ms / ms:.1f}% "
              f"of it; no single PyTorch call")
        out[tag] = dict(max_abs_err=worst, ms=ms, paced_ms=paced_ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=None)
        del state, args
        torch.cuda.empty_cache()
    results["ssm_step"] = dict(out.pop("granite"), at_mamba2=out["mamba2"])


def check_ssd(torch, ops, dev, results):
    from repro_torch.kernels import ssd_scan as ssd
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(13)
    H, P, N = 48, 64, 128                    # mamba2-780m
    di = H * P
    A = -torch.exp(torch.log(torch.linspace(1.0, 16.0, H, device=dev)))

    def make(B, S):
        """bf16 conv_out and dt of a B x S prefill."""
        conv_out = F.silu(torch.randn((B, S, di + 2 * N), generator=g,
                                      device=dev)).to(torch.bfloat16)
        return conv_out, F.softplus(torch.randn((B, S, H), generator=g,
                                                device=dev))

    def split(conv_out, dt):
        """x, B and C as strided slices of one conv_out, as in the model."""
        B, S = conv_out.shape[:2]
        return (conv_out[..., :di].reshape(B, S, H, P), dt, A,
                conv_out[..., di:di + N], conv_out[..., di + N:])

    worst = 0.0
    for B in (1, 4):
        for S in (64, 300, 512):
            for with_state in (False, True):
                conv_out, dt = make(B, S)
                h0 = torch.randn((B, H, P, N), generator=g, device=dev) \
                    if with_state else None
                x = split(conv_out, dt)
                x32 = split(conv_out.float(), dt)   # the same inputs
                y, st = ops.ssd_scan(*x, h0)
                y32, _ = ops.ssd_scan(*x32, h0)
                torch.cuda.synchronize()
                with ops.plain_versions():
                    yr, sr = ops.ssd_scan(*x32, h0)
                diff = (y.float() - yr).abs()
                limit = (SSD_BF16_REL * yr.abs()
                         + SSD_BF16_MEAN * yr.abs().mean())
                ratio = (diff / limit).max().item()
                e32 = (y32 - yr).abs().max().item()
                t32 = SSD_F32_TOL * yr.abs().max().item()
                es = (st - sr).abs().max().item()
                ts = SSD_STATE_TOL * sr.abs().max().item()
                tag = f"ssd B={B} S={S}{' from h0' if with_state else ''}"
                print(f"  {tag}: bf16 max|y kernel - plain| = "
                      f"{diff.max().item():.3e} (max of |diff| / limit "
                      f"{ratio:.3f}; mean|y| {yr.abs().mean().item():.3f}, "
                      f"max|y| {yr.abs().max().item():.3f}), float32 "
                      f"{e32:.3e} (limit {t32:.3e}), state {es:.3e} "
                      f"(limit {ts:.3e})")
                require(ratio <= 1.0 and e32 <= t32 and es <= ts,
                        f"{tag}: bf16 y at {ratio} of its limit, float32 y "
                        f"{e32} > {t32} or state {es} > {ts}")
                require(bool(torch.isfinite(y.float()).all()),
                        f"{tag}: non-finite y")
                worst = max(worst, diff.max().item())

    def timed(B, S):
        x = split(*make(B, S))
        sets = [x] + [split(*make(B, S)) for _ in range(
            n_copies(nbytes(x[0], x[1], x[3], x[4])) - 1)]
        ms, paced_ms = time_ms(torch, f"ssd kernel S={S}", [
            lambda s=s: ops.ssd_scan(*s) for s in sets], 200)
        with ops.plain_versions():
            plain_ms, _ = time_ms(torch, f"ssd plain S={S}", [
                lambda s=s: ops.ssd_scan(*s) for s in sets], 5)
        flops, moved, _ = c = ssd.cost(batch=B, seq=S, heads=H, head_dim=P,
                                       state=N)
        b_ms, b_by = bound(c)
        print(f"  ssd timed case B={B} S={S} H={H} P={P} N={N}: kernel "
              f"{ms:.4f} ms (host-paced {paced_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, no library call, bound {b_ms:.4f} ms "
              f"({b_by}; {moved / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
        return dict(ms=ms, paced_ms=paced_ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None)

    main = timed(1, 512)                     # one 512-token prefill
    short = timed(1, 64)                     # a short serving prompt
    results["ssd_scan"] = dict(max_abs_err=worst, **main, at_s64=short)


def check_rglru(torch, ops, dev, results):
    from repro_torch.kernels import rglru_scan as rg
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(14)
    W = 2560                                  # recurrentgemma-2b lru_width
    # the model's decays: a in (0.9, 0.999) at r = 1, gated by r in (0, 1)
    lam = torch.log(torch.expm1(-torch.log(torch.linspace(
        0.9, 0.999, W, device=dev)) / 8.0))

    def make(B, S):
        r = torch.sigmoid(torch.randn((B, S, W), generator=g, device=dev))
        log_a = -8.0 * F.softplus(lam) * r
        bx = torch.sqrt(1 - torch.exp(2 * log_a)) * torch.randn(
            (B, S, W), generator=g, device=dev)
        return log_a, bx

    worst = 0.0
    for B in (1, 4):
        for S in (64, 300, 512):
            for with_h0 in (False, True):
                log_a, bx = make(B, S)
                h0 = torch.randn((B, W), generator=g, device=dev) \
                    if with_h0 else None
                y, hT = ops.rglru_scan(log_a, bx, h0)
                torch.cuda.synchronize()
                with ops.plain_versions():
                    yr, hr = ops.rglru_scan(log_a, bx, h0)
                err = (y - yr).abs().max().item()
                lim = RGLRU_TOL * yr.abs().max().item()
                err_h = (hT - hr).abs().max().item()
                lim_h = RGLRU_TOL * hr.abs().max().item()
                tag = f"rglru B={B} S={S}{' from h0' if with_h0 else ''}"
                print(f"  {tag}: max|y kernel - plain| = {err:.3e} (limit "
                      f"{lim:.3e}), h_T {err_h:.3e} (limit {lim_h:.3e})")
                require(err <= lim and err_h <= lim_h,
                        f"{tag}: y {err} > {lim} or h_T {err_h} > {lim_h}")
                require(bool(torch.isfinite(y).all()), f"{tag}: non-finite")
                worst = max(worst, err)
    for B, S in ((1, 64), (1, 512), (4, 512)):
        print(f"  rglru B={B} S={S} W={W}: {-(-W // 32) * B} clusters of "
              f"{rg.CLUSTER} CTAs a call, at most "
              f"{rg.max_active_clusters(dev.index, B, S, W)} at once "
              f"(cudaOccupancyMaxActiveClusters)")

    def timed(B, S):
        x = make(B, S)
        sets = [x] + [make(B, S) for _ in range(n_copies(nbytes(*x)) - 1)]
        ms, paced_ms = time_ms(torch, f"rglru kernel S={S}", [
            lambda s=s: ops.rglru_scan(*s) for s in sets], 200)
        with ops.plain_versions():
            plain_ms, _ = time_ms(torch, f"rglru plain S={S}", [
                lambda s=s: ops.rglru_scan(*s) for s in sets], 3)
        _, moved, _ = c = rg.cost(batch=B, seq=S, width=W)
        b_ms, b_by = bound(c)
        print(f"  rglru timed case B={B} S={S} W={W}: kernel {ms:.4f} ms "
              f"(host-paced {paced_ms:.4f} ms), plain {plain_ms:.4f} ms, no "
              f"library call, bound {b_ms:.4f} ms ({b_by}; "
              f"{moved / 1e6:.2f} MB)")
        return dict(ms=ms, paced_ms=paced_ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None)

    main = timed(1, 512)                     # one 512-token prefill
    short = timed(1, 64)                     # a short serving prompt
    results["rglru_scan"] = dict(max_abs_err=worst, **main, at_s64=short)


# ---------------------------------------------------------------------------
# phase 4: the model, kernels against plain
# ---------------------------------------------------------------------------

def sum_order_variants(cfg):
    """Patches that change only a sum order of the plain versions this
    model runs: the SSD scan's chunk (32 and 128 against 64) for SSM
    layers; for a hybrid, the key blocks of the plain attention (flash 64
    and 256 against 128, decode 256 and 1024 against 512)."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import transformer as T
    counts = T.kind_counts(cfg)
    out = []
    if "ssm" in counts:
        out += [[(ss, "ssd_scan_plain",
                  functools.partial(ss.ssd_scan_plain, chunk=c))]
                for c in (32, 128)]
    if "rec" in counts:
        out += [[(fa, "flash_attention_plain",
                  functools.partial(fa.flash_attention_plain, block_k=fk)),
                 (dec, "decode_attention_plain",
                  functools.partial(dec.decode_attention_plain,
                                    block_k=dk))]
                for fk, dk in ((64, 256), (256, 1024))]
    return out


def check_model(torch, ops, dev, cfg):
    """Kernels against plain versions through the whole model.  For a model
    with a recurrent state (SSM or RG-LRU layers) the limit is the larger
    of LOGIT_REL_TOL and FLOOR_MULT times the noise floor: the largest
    change of the plain run when only a sum order of its plain versions
    changes (``sum_order_variants``)."""
    from repro_torch.models import transformer as T
    gen = torch.Generator(device=dev).manual_seed(1)
    params = T.init_params(cfg, gen, device=dev)
    B, S = 4, 192
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=dev)
    counts_by_kind = T.kind_counts(cfg)
    recurrent = "ssm" in counts_by_kind or "rec" in counts_by_kind
    # attention rows end at ragged true lengths (right-padded, as the
    # bucketed prefill sends them); rows with a recurrent state at one
    # exact length
    last = None if recurrent else torch.tensor([S - 1, 130, 64, 17],
                                               dtype=torch.int32,
                                               device=dev)
    steps = torch.randint(0, cfg.vocab_size, (4, B), generator=gen,
                          device=dev)

    def run(cfg=cfg, params=params):
        lg, cache = T.forward(cfg, params, {"tokens": toks}, mode="prefill",
                              max_len=1024, last_index=last)
        out = [lg]
        for s in steps:
            lg, cache = T.decode_step(cfg, params, {"tokens": s}, cache)
            out.append(lg)
        return torch.stack(out)

    ops.reset_launch_counts()
    kern = run()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    floor = 0.0
    with ops.plain_versions():
        plain = run()
        for patches in (sum_order_variants(cfg) if recurrent else ()):
            with contextlib.ExitStack() as stack:
                for obj, name, fn in patches:
                    stack.enter_context(mock.patch.object(obj, name, fn))
                floor = max(floor, (run() - plain).abs().max().item())
    n_attn = counts_by_kind.get("attn", 0)
    want = {"flash_attention": n_attn, "decode_attention": 4 * n_attn,
            "ssd_scan": counts_by_kind.get("ssm", 0),
            "rglru_scan": counts_by_kind.get("rec", 0),
            # a decode step's attention layers: two norms and one RoPE
            # each, and its final norm
            "rms_norm": 4 * (2 * n_attn + 1) if n_attn else 0,
            "rope": 4 * n_attn,
            # and one state update a decode step and Mamba-2 layer
            "ssm_step": 4 * counts_by_kind.get("ssm", 0)}
    require(all(counts[k] == n for k, n in want.items()),
            f"{cfg.name}: launches {counts}, expected {want}")
    require(bool(torch.isfinite(kern).all()), f"{cfg.name}: non-finite")
    err = (kern - plain).abs().max().item()
    scale = plain.abs().max().item()
    limit = max(LOGIT_REL_TOL * scale, FLOOR_MULT * floor)
    agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    floor_note = (f", noise floor {floor:.3e} (plain versions in another "
                  f"sum order)" if recurrent else "")
    print(f"  {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype}): logits {tuple(kern.shape)}, max|kernel - plain| = "
          f"{err:.3e} (max|logit| {scale:.3f}, 2.5% of it "
          f"{LOGIT_REL_TOL * scale:.3e}{floor_note}; limit {limit:.3e}); "
          f"greedy agreement {agree:.3f}; launches {counts}")
    require(err <= limit, f"{cfg.name}: logits differ by {err} > {limit}")
    if recurrent and cfg.dtype != "float32":
        # which bf16 run is further from float32: the same weights upcast,
        # through the plain versions in float32
        params32 = _upcast(params)
        with ops.plain_versions():
            ref = run(dataclasses.replace(cfg, dtype="float32"), params32)
        del params32
        for tag, lg in (("kernel", kern), ("plain", plain)):
            dist = (lg - ref).abs().max().item()
            same = (lg.argmax(-1) == ref.argmax(-1)).float().mean().item()
            print(f"  {cfg.name} {cfg.dtype} {tag} run against float32 plain "
                  f"of the same weights: max|diff| = {dist:.3e} (max|logit| "
                  f"{ref.abs().max().item():.3f}); greedy agreement "
                  f"{same:.3f}")
        del ref
    del params, kern, plain
    torch.cuda.empty_cache()


def _upcast(tree):
    """A copy of a parameter tree with every floating tensor in float32."""
    if isinstance(tree, dict):
        return {k: _upcast(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


# ---------------------------------------------------------------------------
# phase 5: end to end
# ---------------------------------------------------------------------------

def end_to_end(torch, ops, arch, adapters, kernels, after=None):
    """Serve 8 requests of ``arch`` at full width; ``kernels`` are the
    kernels of its path, each of which must launch (the others must
    not).  ``after(result)`` runs on the serve's result once its counts
    are read."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    argv = ["--arch", arch, "--devices", "4", "--requests", "8",
            "--adapters", str(adapters), "--new-tokens", "32",
            "--prompt-len", "64-512", "--max-len", "1024", "--slots", "4",
            "--seed", "0"]
    print(f"  python -m repro_torch.launch.serve {' '.join(argv)}")
    ops.reset_launch_counts()
    res = serve.main(argv)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    cfg, full = res.cfg, get_arch(arch)
    require(cfg.n_layers == full.n_layers and cfg.d_model == full.d_model,
            "not full width")
    require(all(r.done and len(r.generated) == 32 for r in res.requests),
            "not every request finished with 32 tokens")
    require(res.hotpath["decode_compiles"] == 1,
            f"decode captured {res.hotpath['decode_compiles']} times")
    require(all(0 <= t < cfg.padded_vocab
                for r in res.requests for t in r.generated),
            "token out of range")
    require(sorted(res.ttft_s) == list(range(8)), "missing first tokens")
    cs = res.cold_start
    require(cs["loaded_bytes"] == cs["total_bytes"], "engine not loaded")
    ttft = sorted(res.ttft_s.values())
    print(f"  wall TTFT per request (s): "
          f"{[round(res.ttft_s[i], 4) for i in range(8)]}; median "
          f"{ttft[len(ttft) // 2]:.4f} s, max {ttft[-1]:.4f} s")
    print(f"  decode {res.decode_tokens_per_s:.1f} tokens/s, wall "
          f"{res.wall_s:.3f} s, time_to_ready {cs['time_to_ready']:.6f} s, "
          f"peak device memory {res.peak_memory_bytes / 2**30:.2f} GiB")
    print(f"  launches on the main path: {counts} "
          f"({res.n_adapter_switches} adapter switches, "
          f"{int(res.hotpath['n_prefill_calls'])} prefill calls, "
          f"{int(res.hotpath['n_decode_steps'])} decode steps, "
          f"{int(res.hotpath['decode_compiles'])} decode capture)")
    for name, n in counts.items():
        if name in kernels:
            require(n > 0, f"{name} never launched on the main path")
        else:
            require(n == 0, f"{name} launched off the {arch} path")
    by_kind = T.kind_counts(cfg)
    if set(by_kind) != {"attn"}:
        # a recurrent state, or MoE capacity, which couples the rows:
        # each prompt prefills alone, once through every layer
        n_prefills = int(res.hotpath["n_prefill_calls"])
        want = {"ssd_scan": 8 * by_kind.get("ssm", 0),
                "rglru_scan": 8 * by_kind.get("rec", 0),
                "flash_attention": 8 * (by_kind.get("attn", 0)
                                        + by_kind.get("moe", 0))}
        require(n_prefills == 8
                and all(counts[k] == n for k, n in want.items()),
                f"{n_prefills} prefill calls, launches {counts}, expected "
                f"{want}")
    if after is not None:
        after(res)
    return counts


# ---------------------------------------------------------------------------
# phase 6: recovery
# ---------------------------------------------------------------------------

RECOVERY_NEW = 32            # tokens a request generates
RECOVERY_CUT = 8             # tokens before the drain, crash or re-lay


def _synced(torch, fn):
    """(fn(), wall seconds) with the device synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _server(S, cfg, params, adapter_params=None):
    srv = S.ServingEngine(cfg, params, n_slots=4, max_len=1024,
                          adapter_params=adapter_params)
    srv.batcher.sampler = S.quantized_greedy
    return srv


def _requests(S, prompts):
    return [S.ServeRequest(i, p, max_new_tokens=RECOVERY_NEW)
            for i, p in enumerate(prompts)]


def _serve_to_cut(srv, reqs):
    for r in reqs:
        srv.submit(r)
    while min(len(r.generated) for r in reqs) < RECOVERY_CUT:
        srv.step()
    require(all(len(r.generated) == RECOVERY_CUT for r in reqs),
            "requests out of step")


def _uninterrupted(S, cfg, params, prompts):
    srv = _server(S, cfg, params)
    reqs = _requests(S, prompts)
    for r in reqs:
        srv.submit(r)
    srv.run()
    require(srv.batcher.compile_stats()["decode_compiles"] == 1,
            f"decode captured {srv.batcher.compile_stats()} times")
    return [r.generated for r in reqs]


def _delta(before, after):
    return {k: after[k] - before[k] for k in after}


def _require_rebuild(counts, rebuild_kernels, what):
    print(f"    {what} launches: {counts}")
    for name in rebuild_kernels:
        require(counts[name] > 0, f"{what} never launched {name}")


def recovery(torch, ops, dev, arch, adapters, kernels, rebuild_kernels):
    """Phase 6 for one model at full width and depth; ``kernels`` are the
    kernels of its recovery path (each must launch, the others must not),
    ``rebuild_kernels`` those a rebuild must launch."""
    import numpy as np
    from repro_torch.configs.base import get_arch
    from repro_torch.core.engine import PipeBoostEngine
    from repro_torch.lora.adapters import init_lora, merge_lora, \
        randomize_lora
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as S
    cfg = get_arch(arch)
    print(f"  {arch} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype})")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    gen = torch.Generator(device=dev).manual_seed(7)
    params = T.init_params(cfg, gen, device=dev)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(L))
               for L in rng.integers(64, 513, size=4)]
    out = {}

    # -- migration, in the serving dtype ---------------------------------
    want = _uninterrupted(S, cfg, params, prompts)
    a = _server(S, cfg, params)
    reqs = _requests(S, prompts)
    _serve_to_cut(a, reqs)
    drained, export_s = _synced(torch, a.drain_inflight)
    require(len(drained) == 4 and all(r.snapshot for r in drained),
            "drain lost a snapshot")
    snap_bytes = [r.snapshot.nbytes() for r in drained]
    snap_pos = [r.snapshot.pos for r in drained]
    merged = {}
    for i in range(adapters):
        lora = randomize_lora(gen, init_lora(gen, cfg, rank=16,
                                             name=f"lora{i}", device=dev))
        merged[f"lora{i}"] = merge_lora(params, lora)
    b = _server(S, cfg, params, merged)
    b.batcher.warm_decode()
    b.batcher.warm_import()
    switch_s = []
    for name in list(merged) + [None]:
        _, t = _synced(torch, lambda: b._switch_adapter(name))
        switch_s.append(t)
    accepted, import_s = _synced(torch,
                                 lambda: b.admit_with_state_batch(drained))
    hot = b.hotpath_stats()
    require(len(accepted) == 4 and hot["n_batched_imports"] == 1,
            f"imported {len(accepted)} in {hot['n_batched_imports']} "
            f"scatters")
    b.run()
    require([r.generated for r in reqs] == want,
            "migrated streams differ from the uninterrupted run")
    hot = b.hotpath_stats()
    require(hot["n_prefill_tokens"] == 0, "B prefilled tokens")
    require(hot["decode_compiles"] == 1,
            f"B captured its decode step {hot['decode_compiles']} times")
    owned = sum(t.numel() * t.element_size()
                for path, t in S._leaves(b.batcher.params)
                if path in b.batcher._owned)
    print(f"    migration: 4 requests drained at token {RECOVERY_CUT} and "
          f"imported in 1 scatter, streams equal to the uninterrupted run; "
          f"snapshot bytes per request {snap_bytes} (positions {snap_pos}); "
          f"export {export_s * 1e3:.3f} ms for 4 "
          f"({export_s / 4 * 1e3:.3f} ms each), import {import_s * 1e3:.3f} "
          f"ms for 4 ({import_s / 4 * 1e3:.3f} ms each); B prefilled 0 "
          f"tokens, decode_compiles {int(hot['decode_compiles'])}")
    if merged:
        print(f"    adapter switches on B after its capture "
              f"({len(switch_s)}, {owned / 1e6:.1f} MB of owned LoRA "
              f"targets copied each): "
              f"{[round(t * 1e3, 3) for t in switch_s]} ms")
    print(f"    peak device memory with servers U, A and B: "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    out.update(snapshot_bytes=snap_bytes, export_ms=export_s * 1e3,
               import_ms=import_s * 1e3,
               switch_ms=[t * 1e3 for t in switch_s])
    del a, b, merged, drained

    # -- re-lay in bf16: printed, no limit --------------------------------
    engine = PipeBoostEngine(cfg, params, n_devices=4, max_len=1024)
    engine.load_round()
    lost = engine.lost_state_layers([1])
    has = [not x for x in lost]
    out["bf16_relay_equal"] = _relay(torch, ops, S, cfg, params, prompts,
                                     has, want, rebuild_kernels, strict=False)
    del params
    torch.cuda.empty_cache()

    # -- partial crash and re-lay in float32 -------------------------------
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = T.init_params(cfg32, torch.Generator(device=dev).manual_seed(
        7), device=dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         size=(4, 256))).to(dev)

    def generate(crash):
        eng = PipeBoostEngine(cfg32, params32, n_devices=4, max_len=1024)
        eng.load_round()
        tok = S.quantized_greedy(eng.prefill({"tokens": toks})).to(
            torch.int32)
        outs = [tok]
        for i in range(1, RECOVERY_NEW):
            if crash and i == RECOVERY_CUT:
                lost_c = eng.lost_state_layers([1])
                eng.crash([1])
                before = ops.launch_counts()
                stats, t = _synced(torch, eng.recover)
                counts = _delta(before, ops.launch_counts())
                out.update(recover_ms=t * 1e3,
                           reconstruct=stats["reconstruct"])
                print(f"    partial crash: device 1 of 4 crashed at decode "
                      f"step {i}; lost_state_layers "
                      f"{[j for j, x in enumerate(lost_c) if x]}; recover() "
                      f"{t * 1e3:.3f} ms; reconstruct {stats['reconstruct']}")
                _require_rebuild(counts, rebuild_kernels, "recover()")
            tok = S.quantized_greedy(eng.decode(tok)).to(torch.int32)
            outs.append(tok)
        return torch.stack(outs, 1)

    ref = generate(False)
    got = generate(True)
    require(torch.equal(ref, got),
            "the crashed-and-recovered stream differs from the uncrashed one")
    print(f"    partial crash: the continued stream (4 x {RECOVERY_NEW}) "
          f"equals the uncrashed run's")
    want32 = _uninterrupted(S, cfg32, params32, prompts)
    _relay(torch, ops, S, cfg32, params32, prompts, has, want32,
           rebuild_kernels, strict=True, out=out)
    del params32
    torch.cuda.empty_cache()

    counts = ops.launch_counts()
    print(f"    launches on the recovery path: {counts}")
    for name, n in counts.items():
        if name in kernels:
            require(n > 0, f"{name} never launched on the recovery path")
        else:
            require(n == 0, f"{name} launched off the {arch} recovery path")
    out["launches"] = counts
    return out


def _relay(torch, ops, S, cfg, params, prompts, has, want, rebuild_kernels,
           strict, out=None):
    """Serve to the cut, zero the state of the layers ``has`` marks lost,
    re-lay the live batch and finish; the streams against ``want``."""
    from repro_torch.models.transformer import layers
    srv = _server(S, cfg, params)
    reqs = _requests(S, prompts)
    _serve_to_cut(srv, reqs)
    for gi, (kind, ki, ai) in enumerate(layers(cfg)):
        if not has[gi]:
            for t in srv.batcher.cache[kind].values():
                t[ai if kind == "attn" else ki].zero_()
    before = ops.launch_counts()
    stats, t = _synced(torch, lambda: srv.relay_inflight(has))
    counts = _delta(before, ops.launch_counts())
    srv.run()
    equal = sum(r.generated == w for r, w in zip(reqs, want))
    hot = srv.hotpath_stats()
    print(f"    re-lay ({cfg.dtype}): layers "
          f"{[j for j, h in enumerate(has) if not h]} lost under 4 live "
          f"requests; relay_inflight {t * 1e3:.3f} ms, "
          f"{int(hot['n_relay_scatters'])} scatter; stats {stats}; "
          f"{equal} of 4 streams equal to the uninterrupted run's; "
          f"decode_compiles {int(hot['decode_compiles'])}")
    require(hot["n_relay_scatters"] == 1 and hot["decode_compiles"] == 1,
            f"relay: {hot}")
    if strict:
        require(equal == 4, "re-laid streams differ from the uninterrupted "
                            "run")
        _require_rebuild(counts, rebuild_kernels, "relay_inflight")
        out.update(relay_ms=t * 1e3, relay_stats=stats)
    return equal


# ---------------------------------------------------------------------------
# phase 7: the cluster
# ---------------------------------------------------------------------------

CLUSTER_ARCH = "pipeboost-opt-1.3b"
CLUSTER_NEW = 32             # tokens a request generates
PREFIX_SHARED = 448          # shared prompt-prefix tokens (7a, 7c)


def cluster_trace(C, seed=21):
    """7a's trace: 8 prompts of 448 shared and 16 own tokens, 0.413 s
    apart (off the 0.05 s tick grid), merged with a 6-request burst wave of
    64-512-token prompts, half of them on the two adapters."""
    import numpy as np
    shared = C.repeated_prefix_trace(
        8, prefix_len=PREFIX_SHARED, suffix_len=16, gap_s=0.413, seed=seed,
        max_new_tokens=CLUSTER_NEW)
    wave = C.burst_wave_trace(6, base_rate=2.0, wave_rate=8.0, wave_at=0.5,
                              wave_len=1.0, seed=seed + 1,
                              max_new_tokens=CLUSTER_NEW,
                              adapters=("lora0", "lora1"))
    lens = np.random.default_rng(seed).integers(64, 513, size=len(wave))
    wave = [dataclasses.replace(a, prompt_len=int(n))
            for a, n in zip(wave, lens)]
    return C.merge_traces(shared, wave)


def entry_bytes(cfg, max_len=1024, tokens=PREFIX_SHARED + 16):
    """Bytes of one prefix-cache entry: K and V rows of every layer at
    max_len positions, plus its int64 tokens."""
    import torch
    item = torch.tensor([], dtype=getattr(torch, cfg.dtype)).element_size()
    return (2 * cfg.n_layers * max_len * cfg.n_kv_heads
            * cfg.resolved_head_dim * item + 8 * tokens)


def cluster_exact(torch, ops, dev, cfg):
    """7a: the router with a prefix cache, a state tier and a crash with
    migration and rejoin; every stream against a solo cold run."""
    import repro_torch.cluster as C
    from repro_torch.launch.serve import merged_adapters
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as S
    gen = torch.Generator(device=dev).manual_seed(11)
    params = T.init_params(cfg, gen, device=dev)
    trace = cluster_trace(C)
    per_entry = entry_bytes(cfg)
    ccfg = C.ClusterConfig(n_devices=2, n_slots=4, max_len=1024,
                           prefix_cache_bytes=4 * per_entry)
    scaler = C.Autoscaler(C.AutoscalerConfig(target_queue_per_server=4,
                                             max_servers=3, ttft_slo_s=1.0))
    ops.reset_launch_counts()
    ads = merged_adapters(cfg, params, 2, gen)
    router = C.ClusterRouter(cfg, params, n_servers=2, ccfg=ccfg,
                             autoscaler=scaler, adapter_params=ads,
                             state_tier=C.StateTier())
    done, wall = _synced(torch, lambda: router.run(
        trace, crash_after_completions=3, crash_server_id=1,
        rejoin_after_ticks=20))
    counts = ops.launch_counts()
    s = router.metrics.summary()
    kinds = [k for _, k, _ in router.metrics.events]
    hot = [srv.srv.hotpath_stats() for srv in router.servers]
    print(f"  7a: {len(done)}/{len(trace)} requests on {len(router.servers)} "
          f"servers in {wall:.1f} s wall ({cfg.dtype}); prefix hits "
          f"{int(s['prefix_hits'])} ({int(s['prefix_hit_tokens'])} tokens, "
          f"{int(s['prefix_evictions'])} evictions, {per_entry} B an "
          f"entry); rerouted {int(s['n_rerouted'])}, migrated "
          f"{int(s['recovery_mode_migrate'])}, re-prefilled "
          f"{int(s['recovery_mode_reprefill'])}; decode_compiles per server "
          f"{[int(h['decode_compiles']) for h in hot]}; prefill tokens "
          f"{int(s['hotpath_n_prefill_tokens'])}")
    events = [(round(t, 2), k, d) for t, k, d in router.metrics.events
              if k not in ("spawn", "ready")]
    live = router.servers[0].srv.batcher
    owned = sum(t.numel() * t.element_size()
                for path, t in S._leaves(live.params)
                if path in live._owned)
    cache = sum(t.numel() * t.element_size()
                for t in live.cache["attn"].values())
    print(f"    events: {events}; a server holds its cache "
          f"{cache / 1e6:.1f} MB and its owned LoRA targets "
          f"{owned / 1e6:.1f} MB ({cfg.dtype})")
    print(f"    launches: {counts}")
    require(len(done) == len(trace) and all(
        r.done and len(r.generated) == CLUSTER_NEW for r in done),
        "not every request completed")
    require(s["prefix_hits"] > 0, "no prefix hit")
    require("crash" in kinds and "rejoin" in kinds, f"events {kinds}")
    require(s["n_rerouted"] > 0, "the crash re-routed nothing")
    require(all(h["decode_compiles"] == (1 if h["n_decode_steps"] else 0)
                for h in hot), f"captures {hot}")
    for name in ("decode_attention", "flash_attention", "lora_merge"):
        require(counts[name] > 0, f"7a never launched {name}")
    del router
    torch.cuda.empty_cache()
    solo = S.ServingEngine(cfg, params, n_slots=4, max_len=1024,
                           adapter_params=ads)
    solo.batcher.sampler = S.quantized_greedy
    equal = 0
    for r in sorted(done, key=lambda r: r.rid):
        q = S.ServeRequest(r.rid, r.tokens, CLUSTER_NEW, adapter=r.adapter)
        solo.submit(q)
        solo.run()
        equal += q.generated == r.generated
    print(f"    {equal} of {len(done)} streams equal to the request served "
          f"alone by a cold ServingEngine without a cache")
    require(equal == len(done), "cluster streams differ from solo runs")
    require(solo.batcher.compile_stats()["decode_compiles"] == 1,
            "solo engine captured more than once")
    del solo, ads, params
    torch.cuda.empty_cache()
    return {"counts": counts, "summary": s}


def cluster_cli(torch, ops, dev):
    """7b: the launcher's --cluster --wall-clock at full width (bf16)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch import serve
    from repro_torch.serving import engine as S
    argv = ["--cluster", "--wall-clock", "--arch", CLUSTER_ARCH,
            "--devices", "2", "--servers", "2", "--requests", "16",
            "--crash-at", "3", "--adapters", "0",
            "--new-tokens", str(CLUSTER_NEW), "--prompt-len", "64-512",
            "--max-len", "1024", "--slots", "4", "--seed", "0"]
    print(f"  7b: python -m repro_torch.launch.serve {' '.join(argv)}")
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    res = serve.main(argv)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    router = res.router
    s = router.metrics.summary()
    full = get_arch(CLUSTER_ARCH)
    require(router.cfg.n_layers == full.n_layers
            and router.cfg.d_model == full.d_model, "not full width")
    require(s["n_completed"] == res.n_requests == 16,
            "not every request completed")
    require(s["n_rerouted"] > 0, "the crash re-routed nothing")
    hot = [srv.srv.hotpath_stats() for srv in router.servers]
    require(all(h["decode_compiles"] == (1 if h["n_decode_steps"] else 0)
                for h in hot), f"captures {hot}")
    for name in ("decode_attention", "flash_attention"):
        require(counts[name] > 0, f"7b never launched {name}")
    live = next(x.srv.batcher for x in router.servers
                if x.state != "retired")
    owned = sum(t.numel() * t.element_size()
                for path, t in S._leaves(live.params)
                if path in live._owned)
    cache = sum(t.numel() * t.element_size()
                for t in live.cache["attn"].values())
    out = {k: s[k] for k in ("ttft_p50", "ttft_p99", "ttft_mean", "tbt_p50",
                             "tbt_p99", "throughput_tok_s", "servers_max",
                             "gpu_seconds", "n_rerouted")}
    out.update(scale_ups=res.scaler.n_scale_ups, wall_s=res.wall_s,
               memory_before_spawn=res.memory_before_spawn,
               memory_after_run=res.memory_after_run,
               peak_memory=res.peak_memory_bytes, per_server_cache=cache,
               per_server_owned=owned)
    print(f"    TTFT p50 {s['ttft_p50']:.4f} s, p99 {s['ttft_p99']:.4f} s, "
          f"mean {s['ttft_mean']:.4f} s; TBT p50 {s['tbt_p50']:.4f} s, p99 "
          f"{s['tbt_p99']:.4f} s; throughput {s['throughput_tok_s']:.1f} "
          f"tokens/s; servers_max {int(s['servers_max'])}, "
          f"{res.scaler.n_scale_ups} scale-ups; gpu_seconds "
          f"{s['gpu_seconds']:.3f}; rerouted {int(s['n_rerouted'])}")
    print(f"    device memory: {res.memory_before_spawn / 2**30:.3f} GiB "
          f"before the first spawn, {res.memory_after_run / 2**30:.3f} GiB "
          f"after the run, peak {res.peak_memory_bytes / 2**30:.3f} GiB; a "
          f"server's cache {cache / 1e6:.1f} MB and owned LoRA targets "
          f"{owned / 1e6:.1f} MB")
    print(f"    launches: {counts}")
    params = router.params
    del res, router
    torch.cuda.empty_cache()
    return {"counts": counts, "numbers": out, "params": params}


def prefix_vs_cold(torch, ops, dev, params):
    """7c: a prefix hit's import and suffix walk against a cold prefill of
    the same length, and the deposit's export (bf16)."""
    import numpy as np
    from repro_torch.configs.base import get_arch
    from repro_torch.serving import engine as S
    from repro_torch.serving.prefix_cache import PrefixCache
    cfg = get_arch(CLUSTER_ARCH)
    b = S.ContinuousBatcher(cfg, params, 4, 1024, sampler=S.quantized_greedy)
    rng = np.random.default_rng(31)
    shared = rng.integers(0, cfg.vocab_size, size=PREFIX_SHARED)
    timers = {"upload": [], "scatter": [], "deposit_prefixes": []}

    def timed(name):
        fn = getattr(b, "_" + name)

        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            timers[name].append(time.perf_counter() - t0)
            return out
        return run

    def serve(p, rid):
        r = S.ServeRequest(rid, p, max_new_tokens=CLUSTER_NEW)
        _, t = _synced(torch, lambda: b.admit_batch([r]))
        while b.n_active:
            b.step()
        return r, t

    ops.reset_launch_counts()
    serve(rng.integers(0, cfg.vocab_size, size=200), 0)  # warm-up, capture
    b._upload, b._scatter = timed("upload"), timed("scatter")
    b._deposit_prefixes = timed("deposit_prefixes")
    out = {}
    for own in (16, 64):
        donor = np.concatenate([shared, rng.integers(0, cfg.vocab_size,
                                                     size=own)])
        hit = np.concatenate([shared, rng.integers(0, cfg.vocab_size,
                                                   size=own)])
        b.attach_prefix_cache(None)
        cold_hit, _ = serve(hit, 1)                  # the hit prompt, cold
        _, cold_s = serve(donor, 2)                  # cold TTFT (no deposit)
        pc = PrefixCache(1 << 34)
        b.attach_prefix_cache(pc)
        timers["deposit_prefixes"].clear()
        serve(donor, 3)                              # a miss, then deposits
        [(_, entry)] = pc.export_entries()
        export_s = timers["deposit_prefixes"][-1]
        for k in ("upload", "scatter"):
            timers[k].clear()
        r = S.ServeRequest(4, hit, max_new_tokens=CLUSTER_NEW)
        k0 = b.prefix_hit_tokens
        _, total_s = _synced(torch, lambda: b.admit_batch([r]))
        import_s = timers["upload"][-1] + timers["scatter"][-1]
        k = b.prefix_hit_tokens - k0
        require(k >= PREFIX_SHARED and len(r.generated) == 1,
                "the hit did not land")
        while b.n_active:
            b.step()
        agree = sum(x == y for x, y in zip(r.generated, cold_hit.generated))
        print(f"  7c: {PREFIX_SHARED} shared + {own} own tokens: cold "
              f"admission (prefill + first token) {cold_s * 1e3:.3f} ms; hit "
              f"{total_s * 1e3:.3f} ms = import {import_s * 1e3:.3f} ms + "
              f"suffix walk of {len(hit) - k} steps and first-token read "
              f"{(total_s - import_s) * 1e3:.3f} "
              f"ms; deposit export {export_s * 1e3:.3f} ms for "
              f"{entry.nbytes} B; hit stream agrees with the cold one on "
              f"{agree} of {CLUSTER_NEW} tokens (bf16, no limit)")
        out[own] = {"cold_ms": cold_s * 1e3, "hit_ms": total_s * 1e3,
                    "walk_steps": len(hit) - k,
                    "import_ms": import_s * 1e3,
                    "walk_ms": (total_s - import_s) * 1e3,
                    "export_ms": export_s * 1e3, "entry_bytes": entry.nbytes,
                    "agree": agree}
    require(b.compile_stats()["decode_compiles"] == 1,
            f"7c batcher captured {b.compile_stats()} times")
    counts = ops.launch_counts()
    print(f"    launches: {counts}")
    return {"counts": counts, "numbers": out}


# ---------------------------------------------------------------------------
# phase 8: the pipeline prefill
# ---------------------------------------------------------------------------

PIPE_ARCH = "pipeboost-opt-1.3b"
PIPE_S = 512                 # prompt tokens of the belt's engine runs
PIPE_NEW = 32                # tokens a request generates
PIPE_STAGES = 4
PIPE_MICRO = 2


def belt_mesh(dev, n=PIPE_STAGES):
    """n stages on n streams of the one card."""
    from repro_torch.distributed.pipeline import stage_mesh
    return stage_mesh(n, 1, devices=[dev] * n)


def _leaf_err(torch, got, want):
    """(max |got - want|, max |want|) over every cache leaf but ``pos``,
    which must be equal."""
    require(torch.equal(got["pos"], want["pos"]), "cache pos differs")
    err = scale = 0.0
    for kind in ("attn", "ssm"):
        for leaf, w in want.get(kind, {}).items():
            g = got[kind][leaf]
            require(g.shape == w.shape and g.dtype == w.dtype,
                    f"cache {kind}/{leaf}: {tuple(g.shape)} {g.dtype} "
                    f"against {tuple(w.shape)} {w.dtype}")
            err = max(err, (g.float() - w.float()).abs().max().item())
            scale = max(scale, w.float().abs().max().item())
    return err, scale


def _hold(name, err, scale):
    limit = LOGIT_REL_TOL * scale
    print(f"    {name}: max|belt - forward| = {err:.3e} (max {scale:.3f}; "
          f"limit {limit:.3e})")
    require(err <= limit, f"{name}: {err} > {limit}")


def _adapters(torch, cfg, dev, n):
    from repro_torch.lora.adapters import init_lora, randomize_lora
    g = torch.Generator(device=dev).manual_seed(41)
    return {f"lora{i}": randomize_lora(g, init_lora(
        g, cfg, rank=16, name=f"lora{i}", device=dev)) for i in range(n)}


def engine_belt(torch, ops, dev, arch, kernel, adapters=0):
    """8a/8b: a mid-load PipeBoostEngine with a 4-stage belt on the card
    prefills 4 prompts of 512 tokens through it (float32, full width and
    depth): logits and every cache leaf against ``forward``, then the
    ``generate`` stream against a fully loaded single engine's (with
    ``adapters`` merged adapters, one switched on)."""
    import dataclasses as dc
    from repro_torch.configs.base import get_arch
    from repro_torch.core.engine import PipeBoostEngine, generate
    from repro_torch.models import transformer as T
    cfg = dc.replace(get_arch(arch), dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(43)
    params = T.init_params(cfg, gen, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (4, PIPE_S), generator=gen,
                         device=dev)
    ads = _adapters(torch, cfg, dev, adapters) if adapters else {}
    tag = f"{arch}" + (f", {adapters} adapters, lora1 on" if adapters
                       else "")
    print(f"  {tag} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"float32), B 4, S {PIPE_S}")
    eng = PipeBoostEngine(cfg, params, n_devices=4, max_len=1024,
                          adapters=ads)
    require(eng.enable_pipeline_prefill(mesh=belt_mesh(dev),
                                        n_micro=PIPE_MICRO),
            "enable_pipeline_prefill refused an explicit grid")
    eng.load_round()
    require(eng.ready and not eng.fully_loaded, "engine not mid-load")
    ops.reset_launch_counts()
    if adapters:
        eng.switch_adapter("lora1")
    got = generate(eng, {"tokens": toks}, PIPE_NEW)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    require(eng.prefill_backend_used == "pipeline",
            f"generate's prefill ran {eng.prefill_backend_used}")
    require(counts[kernel] == cfg.n_layers * PIPE_MICRO,
            f"{kernel} launched {counts[kernel]} times, expected "
            f"{cfg.n_layers * PIPE_MICRO} (one a layer and microbatch)")
    require(bool(counts["lora_merge"]) == bool(adapters),
            f"lora_merge launched {counts['lora_merge']} times")
    # the belt's logits and cache against the single prefill's
    lg = eng.prefill({"tokens": toks})
    require(eng.prefill_backend_used == "pipeline", "prefill ran single")
    want_lg, want = T.forward(cfg, eng._merged_params, {"tokens": toks},
                              mode="prefill", max_len=1024)
    _hold("logits", (lg - want_lg).abs().max().item(),
          want_lg.abs().max().item())
    _hold("cache leaves", *_leaf_err(torch, eng._cache, want))
    del want, want_lg
    ref = PipeBoostEngine(cfg, params, n_devices=4, max_len=1024,
                          adapters=ads)
    while ref.load_round():
        pass
    ref.maybe_switch_strategy(1.0)
    if adapters:
        ref.switch_adapter("lora1")
    want_toks = generate(ref, {"tokens": toks}, PIPE_NEW)
    require(ref.prefill_backend_used == "single", "reference not single")
    equal = int((got == want_toks).all(dim=1).sum().item())
    print(f"    {equal} of 4 streams of {PIPE_NEW} tokens equal to a fully "
          f"loaded single engine's; generate's launches {counts}; belts "
          f"built {eng.compile_stats()['pipeline_prefill_compiles']}")
    require(equal == 4, "belt streams differ from the single engine's")
    del eng, ref, params, ads
    torch.cuda.empty_cache()
    return counts


def seqchunk_belt(torch, ops, dev):
    """8c: the sequence-chunk belt (4 stages, 8 chunks of 64) against
    ``forward`` (float32, opt-1.3b at full width and depth)."""
    import dataclasses as dc
    from repro_torch.configs.base import get_arch
    from repro_torch.distributed.pipeline import \
        build_pipeline_prefill_seqchunk
    from repro_torch.models import transformer as T
    cfg = dc.replace(get_arch(PIPE_ARCH), dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(47)
    params = T.init_params(cfg, gen, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (4, PIPE_S), generator=gen,
                         device=dev)
    want, _ = T.forward(cfg, params, {"tokens": toks}, mode="prefill")
    f = build_pipeline_prefill_seqchunk(cfg, n_stages=PIPE_STAGES,
                                        n_chunks=8, mesh=belt_mesh(dev),
                                        seq_len=PIPE_S)
    ops.reset_launch_counts()
    got = f(params, {"tokens": toks})
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"  {PIPE_ARCH} sequence-chunk belt, 4 stages x 8 chunks of "
          f"{PIPE_S // 8}, float32: launches {counts}")
    require(counts["flash_attention"] == 8 * cfg.n_layers,
            f"flash launched {counts['flash_attention']} times")
    _hold("logits", (got - want).abs().max().item(),
          want.abs().max().item())
    del params, want, got
    torch.cuda.empty_cache()
    return counts


def served_belt(torch, ops, dev):
    """8d: a ServingEngine whose batcher is wired to a mid-load engine's
    belt (as ``ClusterServer`` wires it on several cards) serves 4
    requests, the engine fills and switches, and 4 more go through the
    single prefill; one captured decode step throughout, every stream
    equal to an unwired server's (float32)."""
    import dataclasses as dc
    import numpy as np
    from repro_torch.configs.base import get_arch
    from repro_torch.core.engine import PipeBoostEngine
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as S
    cfg = dc.replace(get_arch(PIPE_ARCH), dtype="float32")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(53),
                           device=dev)
    rng = np.random.default_rng(53)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(L))
               for L in rng.integers(64, 513, size=8)]

    def serve(eng=None):
        srv = _server(S, cfg, params)
        if eng is not None:
            eng.wire_pipeline_prefill(srv.batcher)
        first = [S.ServeRequest(i, p, max_new_tokens=PIPE_NEW)
                 for i, p in enumerate(prompts[:4])]
        for r in first:
            srv.submit(r)
        srv.run()
        n_pipe = srv.batcher.n_prefill_pipeline
        if eng is not None:
            require(n_pipe >= 4, f"{n_pipe} admissions ran the belt")
            while eng.load_round():
                pass
            require(eng.maybe_switch_strategy(request_rate=1.0),
                    "no strategy switch")
        later = [S.ServeRequest(10 + i, p, max_new_tokens=PIPE_NEW)
                 for i, p in enumerate(prompts[4:])]
        for r in later:
            srv.submit(r)
        srv.run()
        require(srv.batcher.n_prefill_pipeline == n_pipe,
                "an admission after the switch ran the belt")
        require(srv.batcher.compile_stats()["decode_compiles"] == 1,
                f"decode captured {srv.batcher.compile_stats()} times")
        return [r.generated for r in first + later], srv.hotpath_stats()

    eng = PipeBoostEngine(cfg, params, n_devices=4, max_len=1024)
    require(eng.enable_pipeline_prefill(mesh=belt_mesh(dev),
                                        n_micro=PIPE_MICRO), "refused")
    eng.load_round()
    ops.reset_launch_counts()
    got, hot = serve(eng)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want, _ = serve()
    equal = sum(a == b for a, b in zip(got, want))
    print(f"  8d: {PIPE_ARCH} float32, 8 requests of "
          f"{sorted(len(p) for p in prompts)} tokens, {PIPE_NEW} new: "
          f"{int(hot['n_prefill_pipeline'])} admitted through the belt, "
          f"{int(hot['n_prefill_reqs'] - hot['n_prefill_pipeline'])} "
          f"through the single prefill after the switch; decode_compiles "
          f"{int(hot['decode_compiles'])}; {equal} of 8 streams equal to "
          f"an unwired server's; launches {counts}")
    require(equal == 8, "wired streams differ from the unwired server's")
    del eng, params
    torch.cuda.empty_cache()
    return counts


def repartitioned_belt(torch, ops, dev):
    """8e: a mid-load engine with a 4-stage belt decodes, loses device 3
    (``repartition(dead=[3])`` reports 3 stages and rebuilds the lost
    layers), decodes on, and its next prefill runs a 3-stage belt; both
    streams equal a single engine's (float32)."""
    import dataclasses as dc
    from repro_torch.configs.base import get_arch
    from repro_torch.core.engine import PipeBoostEngine, generate
    from repro_torch.models import transformer as T
    cfg = dc.replace(get_arch(PIPE_ARCH), dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(59)
    params = T.init_params(cfg, gen, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (4, 256), generator=gen,
                         device=dev)
    ref = PipeBoostEngine(cfg, params, n_devices=4, max_len=1024)
    ref.load_round()
    want = generate(ref, {"tokens": toks}, PIPE_NEW)
    eng = PipeBoostEngine(cfg, params, n_devices=4, max_len=1024)
    require(eng.enable_pipeline_prefill(mesh=belt_mesh(dev),
                                        n_micro=PIPE_MICRO), "refused")
    eng.load_round()
    ops.reset_launch_counts()
    tok = generate(eng, {"tokens": toks}, RECOVERY_CUT)
    require(eng.prefill_backend_used == "pipeline", "first prefill single")
    stats = eng.repartition(dead=[3])
    require(stats["n_stages"] == 3, f"repartition: {stats['n_stages']} "
            f"stages")
    outs = [tok]
    t = tok[:, -1]
    for _ in range(PIPE_NEW - RECOVERY_CUT):
        t = torch.argmax(eng.decode(t), dim=-1).to(torch.int32)
        outs.append(t[:, None])
    cont = torch.cat(outs, dim=1)
    again = generate(eng, {"tokens": toks}, PIPE_NEW)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    require(eng.prefill_backend_used == "pipeline"
            and eng._pipe_n_stages == 3
            and (3, 4, toks.shape[1]) in eng._pipe_fns,
            "the prefill after the repartition did not run a 3-stage belt")
    same_cont = int((cont == want).all(dim=1).sum().item())
    same_again = int((again == want).all(dim=1).sum().item())
    print(f"  8e: {PIPE_ARCH} float32, 4 x 256 tokens: repartition(dead=[3]) "
          f"-> {stats['n_stages']} stages, {stats['lost_layers']} lost "
          f"layers rebuilt; continued streams equal {same_cont} of 4, the "
          f"3-stage belt's new prefill {same_again} of 4; launches {counts}")
    require(same_cont == 4 and same_again == 4,
            "streams changed across the repartition")
    del eng, ref, params
    torch.cuda.empty_cache()
    return counts


def belt_timings(torch, ops, dev):
    """bf16, B 4, S 512: the GPipe belt (4 stages on 4 streams, 2
    microbatches) and, for opt-1.3b, the same belt with one microbatch
    and the sequence-chunk belt (8 chunks) against the single eager
    ``forward``: wall time (host clock) and CUDA
    events on the caller's stream around the call (host-paced: the host's
    issue time counts), medians of 5, and from one ``torch.profiler``
    trace each the device span (first kernel's start to last kernel's
    end), busy time (the union of the kernels' intervals) and the sum of
    kernel times (above busy where stages overlap); the flash and SSD
    launches a call.  No limit."""
    import statistics
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.configs.base import get_arch
    from repro_torch.distributed.pipeline import (
        build_pipeline_prefill, build_pipeline_prefill_seqchunk)
    from repro_torch.models import transformer as T
    out = {}
    for arch in (PIPE_ARCH, "mamba2-780m"):
        cfg = get_arch(arch)
        gen = torch.Generator(device=dev).manual_seed(61)
        params = T.init_params(cfg, gen, device=dev)
        toks = torch.randint(0, cfg.vocab_size, (4, PIPE_S), generator=gen,
                             device=dev)
        batch = {"tokens": toks}
        runs = {"forward": lambda: T.forward(cfg, params, batch,
                                             mode="prefill", max_len=1024),
                "gpipe": build_pipeline_prefill(
                    cfg, n_stages=PIPE_STAGES, n_micro=PIPE_MICRO,
                    mesh=belt_mesh(dev), seq_len=PIPE_S, max_len=1024,
                    return_cache=True)}
        if arch == PIPE_ARCH:
            # one microbatch: the forward's launches plus the hops, so the
            # belt's own cost shows apart from its doubled launches
            runs["gpipe_1micro"] = build_pipeline_prefill(
                cfg, n_stages=PIPE_STAGES, n_micro=1, mesh=belt_mesh(dev),
                seq_len=PIPE_S, max_len=1024, return_cache=True)
            runs["seqchunk"] = build_pipeline_prefill_seqchunk(
                cfg, n_stages=PIPE_STAGES, n_chunks=8, mesh=belt_mesh(dev),
                seq_len=PIPE_S)
        res = {}
        lg_fwd = None
        for name, fn in runs.items():
            call = fn if name == "forward" else (lambda fn=fn: fn(params,
                                                                   batch))
            lg = call()
            lg = lg[0] if isinstance(lg, tuple) else lg
            if name == "forward":
                lg_fwd = lg
            torch.cuda.synchronize()
            walls, events = [], []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start.record()
                call()
                end.record()      # after the belt's join of its streams
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                events.append(start.elapsed_time(end))
            ops.reset_launch_counts()
            with tprofile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            counts = ops.launch_counts()
            spans = sorted((e.time_range.start, e.time_range.end)
                           for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA)
            busy, total, cur = 0.0, 0.0, None
            for s, e in spans:
                total += e - s
                if cur is None or s > cur[1]:
                    if cur is not None:
                        busy += cur[1] - cur[0]
                    cur = [s, e]
                else:
                    cur[1] = max(cur[1], e)
            if cur is not None:
                busy += cur[1] - cur[0]
            span = (spans[-1][1] - spans[0][0]) if spans else 0.0
            agree = (lg.argmax(-1) == lg_fwd.argmax(-1)).float().mean().item()
            err = (lg - lg_fwd).abs().max().item()
            res[name] = {"wall_ms": statistics.median(walls),
                         "event_ms": statistics.median(events),
                         "device_span_ms": span / 1e3,
                         "device_busy_ms": busy / 1e3,
                         "kernel_sum_ms": total / 1e3,
                         "n_device_activities": len(spans),
                         "flash_launches": counts["flash_attention"],
                         "ssd_launches": counts["ssd_scan"],
                         "max_abs_diff_from_forward": err,
                         "greedy_agreement": agree}
            print(f"  {arch} bf16 {name}: wall {res[name]['wall_ms']:.3f} "
                  f"ms, CUDA events {res[name]['event_ms']:.3f} ms (host-"
                  f"paced; medians of 5); profiler: device span "
                  f"{span / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms, kernel "
                  f"sum {total / 1e3:.3f} ms over {len(spans)} activities; "
                  f"flash {counts['flash_attention']}, SSD "
                  f"{counts['ssd_scan']} launches; logits against forward "
                  f"max|diff| {err:.3e}, greedy agreement {agree:.3f}")
        out[arch] = res
        del params, runs, lg_fwd
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9: the remaining model families (MoE, the audio encoder, M-RoPE)
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen2-moe-a2.7b"


def _params_bytes(torch, tree):
    if isinstance(tree, dict):
        return sum(_params_bytes(torch, v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def moe_replayed_step(torch, res):
    """9a's replayed decode step: 4 live requests of 64-512 prompt tokens
    on the serve run's batcher (its one capture), the median of 20
    replays on the host clock with the device synchronised, against two
    weight-read bounds at 3.35 TB/s.  The dropless bound is what the
    port's dropless decode must read: every block weight (all experts of
    every layer), the LM head and the live cache rows, each once.  The
    routed bound is the least a step of these 4 tokens needs: the same
    without the routed experts that no token of a layer picks, counted
    from one eager step's routing on a copy of the cache."""
    from repro_torch.launch import rooflines
    import statistics
    import numpy as np
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServeRequest
    srv, cfg = res.server, res.cfg
    b = srv.batcher
    rng = np.random.default_rng(7)
    for i, L in enumerate(rng.integers(64, 513, size=4)):
        srv.submit(ServeRequest(100 + i, rng.integers(0, cfg.vocab_size,
                                                      size=int(L)),
                                max_new_tokens=1000))
    for _ in range(3):
        srv.step()                        # admissions, replays
    require(len(b.active) == 4, f"{len(b.active)} live slots, not 4")
    require(b.compile_stats()["decode_compiles"] == 1,
            "the timed step is not the serve run's capture")
    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b._graph.replay()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    p = b.params
    mlp = p["blocks"]["moe"]["mlp"]
    expert_bytes = sum(_params_bytes(torch, mlp[k])
                       for k in ("w_gate", "w_up", "w_down", "shared"))
    kv = b.cache["attn"]["k"]
    live = int(b.cache["pos"].sum().item())
    kv_bytes = 2 * live * kv.shape[0] * kv.shape[3] * kv.shape[4] \
        * kv.element_size()
    moved = (_params_bytes(torch, p["blocks"]) + _params_bytes(
        torch, p["lm_head"]) + kv_bytes)
    bound_ms = moved / rooflines.HBM_BW * 1e3
    expert_ms = expert_bytes / rooflines.HBM_BW * 1e3
    # one routed expert of one layer: its gate, up and down weights
    one_expert = sum(mlp[k][0, 0].numel() * mlp[k].element_size()
                     for k in ("w_gate", "w_up", "w_down"))
    with moe.record_routing() as rec:
        T.decode_step(cfg, p, {"tokens": b._dev_tokens.clone()},
                      _clone(b.cache))
    picked = [int(torch.unique(top_e).numel()) for top_e, _ in rec]
    require(len(picked) == cfg.n_layers, f"{len(picked)} routed layers")
    routed = moved - sum(cfg.n_experts - n for n in picked) * one_expert
    routed_ms = routed / rooflines.HBM_BW * 1e3
    print(f"  9a replayed decode step, 4 live slots: {ms:.3f} ms (median of "
          f"20, min {min(times):.3f}); dropless weight-read bound "
          f"{bound_ms:.3f} ms ({moved / 1e9:.2f} GB: block weights with "
          f"all {cfg.n_experts} routed experts of every layer, LM head, "
          f"{live} cached rows), the experts alone {expert_ms:.3f} ms ("
          f"{expert_bytes / 1e9:.2f} GB); {100 * bound_ms / ms:.1f}% of "
          f"the dropless bound")
    print(f"  9a routed-experts bound {routed_ms:.3f} ms ({routed / 1e9:.2f}"
          f" GB: the {sum(picked)} distinct routed experts that one step's "
          f"4 tokens pick over {cfg.n_layers} layers, {min(picked)}-"
          f"{max(picked)} a layer, plus the shared experts, attention, "
          f"router, norms, LM head and cached rows); the step is "
          f"{ms / routed_ms:.2f}x it")
    return {"replayed_step_ms": ms, "dropless_bound_ms": bound_ms,
            "routed_bound_ms": routed_ms, "expert_bound_ms": expert_ms,
            "routed_experts_per_layer": picked}


def _routing_alike(torch, rec_a, rec_b):
    """Share of (token, choice) pairs routed to the same expert, the top k
    of each token compared as sets (sorted)."""
    same = total = 0
    for (ea, _), (eb, _) in zip(rec_a, rec_b):
        same += int((ea.sort(-1).values == eb.sort(-1).values).sum().item())
        total += ea.numel()
    return same / max(total, 1)


def _dropped(torch, rec):
    return sum(int((~keep).sum().item()) for _, keep in rec)


def moe_kernels_vs_plain(torch, ops, dev):
    """9b: qwen2-moe-a2.7b at full width, depth cut to 4 layers, through
    the kernels and through the plain versions (flash, decode, the LoRA
    merge of one rank-16 adapter): bf16 (routing agreement and distances
    printed), float32 (held: logits within 2.5% of max |logit|, the
    greedy stream equal), and one float32 prefill at capacity factor 0.5
    whose dropped (token, choice) pairs must be equal."""
    from repro_torch.configs.base import get_arch
    from repro_torch.lora.adapters import init_lora, merge_lora, \
        randomize_lora
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    cfg16 = dataclasses.replace(get_arch(MOE_ARCH), n_layers=4)
    gen = torch.Generator(device=dev).manual_seed(61)
    params16 = T.init_params(cfg16, gen, device=dev)
    lora = randomize_lora(gen, init_lora(gen, cfg16, rank=16, device=dev))
    B, S, N = 4, 192, 8
    toks = torch.randint(0, cfg16.vocab_size, (B, S), generator=gen,
                         device=dev)
    forced = torch.randint(0, cfg16.vocab_size, (N, B), generator=gen,
                           device=dev)

    def run(cfg, params, steps=None):
        """Prefill + N decode steps; greedy unless ``steps`` (B,) tokens
        a step are given.  Returns (logits (N+1, B, V), tokens fed (N,
        B), routing records)."""
        merged = merge_lora(params, lora)
        with moe.record_routing() as rec:
            lg, cache = T.forward(cfg, merged, {"tokens": toks},
                                  mode="prefill", max_len=1024)
            out, fed = [lg], []
            for i in range(N):
                tok = (lg.argmax(-1) if steps is None else steps[i]).to(
                    torch.int32)
                fed.append(tok)
                lg, cache = T.decode_step(cfg, merged, {"tokens": tok},
                                          cache)
                out.append(lg)
        return torch.stack(out), torch.stack(fed), rec

    ops.reset_launch_counts()
    k16, _, rk16 = run(cfg16, params16, forced)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = {"flash_attention": 4, "decode_attention": 4 * N,
            "lora_merge": 4, "ssd_scan": 0, "rglru_scan": 0,
            "rms_norm": N * (2 * 4 + 1), "rope": 4 * N, "ssm_step": 0}
    require(counts == want, f"9b launches {counts}, expected {want}")
    with ops.plain_versions():
        p16, _, rp16 = run(cfg16, params16, forced)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    params32 = _upcast(params16)
    del params16
    torch.cuda.empty_cache()
    with ops.plain_versions():
        ref32, _, rref = run(cfg32, params32, forced)
    scale = ref32.abs().max().item()
    for tag, lg, rec in (("kernel", k16, rk16), ("plain", p16, rp16)):
        agree = (lg.argmax(-1) == ref32.argmax(-1)).float().mean().item()
        print(f"  9b {MOE_ARCH} bf16 {tag} run against float32 plain of "
              f"the same weights: max|diff| = "
              f"{(lg - ref32).abs().max().item():.3e} (max|logit| "
              f"{scale:.3f}); greedy agreement {agree:.3f}; (token, choice) "
              f"pairs routed alike {_routing_alike(torch, rec, rref):.4f}")
    print(f"  9b bf16 kernel run against bf16 plain run: max|diff| = "
          f"{(k16 - p16).abs().max().item():.3e}; pairs routed alike "
          f"{_routing_alike(torch, rk16, rp16):.4f}")
    del k16, p16, ref32
    # float32: the kernel run greedy, the plain run fed the kernel run's
    # tokens, so "streams equal" is each plain step's argmax
    k32, fed, rk32 = run(cfg32, params32)
    with ops.plain_versions():
        p32, _, rp32 = run(cfg32, params32, fed)
    err = (k32 - p32).abs().max().item()
    scale = p32.abs().max().item()
    same = bool(torch.equal(p32[:-1].argmax(-1).to(torch.int32), fed))
    print(f"  9b {MOE_ARCH} float32 ({cfg32.n_layers} layers, d_model "
          f"{cfg32.d_model}, {cfg32.n_experts} experts top-{cfg32.top_k} + "
          f"{cfg32.n_shared_experts} shared, adapter merged): prefill "
          f"{B} x {S} + {N} greedy steps, max|kernel - plain| = {err:.3e} "
          f"(max|logit| {scale:.3f}, limit {LOGIT_REL_TOL * scale:.3e}); "
          f"streams equal {same}; pairs routed alike "
          f"{_routing_alike(torch, rk32, rp32):.4f}")
    require(err <= LOGIT_REL_TOL * scale, f"9b float32: {err}")
    require(same, "9b float32: the greedy streams differ")
    # a capacity-binding prefill
    cap = dataclasses.replace(cfg32, capacity_factor=0.5)
    drops = []
    for plain in (False, True):
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(ops.plain_versions())
            rec = stack.enter_context(moe.record_routing())
            lg, _ = T.forward(cap, params32, {"tokens": toks},
                              mode="prefill", max_len=1024)
        drops.append((_dropped(torch, rec), lg))
    (dk, lk), (dp, lp) = drops
    C = moe.moe_capacity(B * S, cap)
    print(f"  9b capacity factor 0.5 (C = {C} slots an expert for "
          f"{B * S * cap.top_k} pairs over {cap.n_experts} experts): "
          f"dropped (token, choice) pairs over {cap.n_layers} layers: "
          f"kernel run {dk}, plain run {dp}; max|logit diff| "
          f"{(lk - lp).abs().max().item():.3e}")
    require(dk == dp and dk > 0, f"9b drops: {dk} against {dp}")
    del params32, k32, p32
    torch.cuda.empty_cache()
    return counts


def moe_belt(torch, ops, dev):
    """9c: qwen2-moe-a2.7b at full width, 8 layers, float32, capacity
    factor E/K (every expert has a slot for every token, so nothing can
    drop and every routing equals ``forward``'s): the GPipe belt (4
    stages on 4 streams of the card, 2 microbatches) against ``forward``
    over each microbatch's rows, the computation it runs, within 1e-5 of
    max |x| (logits and cache); the GPipe belt and the sequence-chunk belt
    (8 chunks) against ``forward`` over the whole batch within the larger
    of 1e-5 of max |x| and twice the noise floor, the change that
    splitting the batch alone makes (the expert GEMMs' row counts change
    their sum order, and the MoE residual stream runs to thousands); then
    a mid-load belt engine crashes device 1 at decode step 8 and
    ``recover()``s, its stream equal to an uncrashed single engine's."""
    from repro_torch.configs.base import get_arch
    from repro_torch.core.engine import PipeBoostEngine, generate
    from repro_torch.distributed.pipeline import (
        build_pipeline_prefill, build_pipeline_prefill_seqchunk)
    from repro_torch.models import transformer as T
    full = get_arch(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=8, dtype="float32",
                              capacity_factor=full.n_experts / full.top_k)
    gen = torch.Generator(device=dev).manual_seed(67)
    params = T.init_params(cfg, gen, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (4, PIPE_S), generator=gen,
                         device=dev)
    want_lg, want = T.forward(cfg, params, {"tokens": toks},
                              mode="prefill", max_len=1024)
    mb = toks.shape[0] // PIPE_MICRO
    split = [T.forward(cfg, params, {"tokens": toks[i:i + mb]},
                       mode="prefill", max_len=1024)
             for i in range(0, toks.shape[0], mb)]
    split_lg = torch.cat([lg for lg, _ in split])
    split_cache = {"pos": torch.cat([c["pos"] for _, c in split]),
                   "attn": {leaf: torch.cat([c["attn"][leaf]
                                             for _, c in split], dim=1)
                            for leaf in ("k", "v")}}
    del split
    floors = ((split_lg - want_lg).abs().max().item(),
              _leaf_err(torch, split_cache, want)[0])
    ops.reset_launch_counts()
    f = build_pipeline_prefill(cfg, n_stages=PIPE_STAGES, n_micro=PIPE_MICRO,
                               mesh=belt_mesh(dev), seq_len=PIPE_S,
                               max_len=1024, return_cache=True)
    lg, cache = f(params, {"tokens": toks})
    f2 = build_pipeline_prefill_seqchunk(cfg, n_stages=PIPE_STAGES,
                                         n_chunks=8, mesh=belt_mesh(dev),
                                         seq_len=PIPE_S)
    lg2 = f2(params, {"tokens": toks})
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"  9c {MOE_ARCH} float32, {cfg.n_layers} layers, capacity factor "
          f"{cfg.capacity_factor:g}, B 4, S {PIPE_S}: launches {counts}")
    require(counts["flash_attention"] == cfg.n_layers * (PIPE_MICRO + 8),
            f"9c flash launched {counts['flash_attention']} times")
    scale_lg = want_lg.abs().max().item()
    print(f"    noise floor (forward over each microbatch's rows against "
          f"forward over the batch): logits {floors[0]:.3e}, cache "
          f"{floors[1]:.3e}")
    for name, (err, scale), want_name, floor in (
            ("GPipe belt logits", ((lg - split_lg).abs().max().item(),
                                   scale_lg), "per-microbatch forward", 0.0),
            ("GPipe belt cache", _leaf_err(torch, cache, split_cache),
             "per-microbatch forward", 0.0),
            ("GPipe belt logits", ((lg - want_lg).abs().max().item(),
                                   scale_lg), "forward", floors[0]),
            ("GPipe belt cache", _leaf_err(torch, cache, want), "forward",
             floors[1]),
            ("sequence-chunk belt logits",
             ((lg2 - want_lg).abs().max().item(), scale_lg), "forward",
             floors[0])):
        limit = max(1e-5 * scale, FLOOR_MULT * floor)
        print(f"    {name}: max|belt - {want_name}| = {err:.3e} (max "
              f"{scale:.3f}; limit {limit:.3e})")
        require(err <= limit, f"9c {name} against {want_name}: {err}")
    del cache, want, lg, lg2, split_cache, split_lg
    # a crash on the belt's engine against an uncrashed single engine
    short = toks[:, :256]
    ref = PipeBoostEngine(cfg, params, n_devices=4, max_len=1024)
    while ref.load_round():
        pass
    ref.maybe_switch_strategy(1.0)
    want_toks = generate(ref, {"tokens": short}, PIPE_NEW)
    del ref
    eng = PipeBoostEngine(cfg, params, n_devices=4, max_len=1024)
    require(eng.enable_pipeline_prefill(mesh=belt_mesh(dev),
                                        n_micro=PIPE_MICRO), "refused")
    eng.load_round()
    lost = eng.lost_state_layers([1])
    before = ops.launch_counts()
    got = generate(eng, {"tokens": short}, PIPE_NEW, crash_at=RECOVERY_CUT,
                   crash_devices=[1])
    torch.cuda.synchronize()
    crash_counts = _delta(before, ops.launch_counts())
    stats = [p for e, p in eng.events if e == "recover"][-1]
    equal = int((got == want_toks).all(dim=1).sum().item())
    print(f"    crash of device 1 at decode step {RECOVERY_CUT} (belt "
          f"prefill of 4 x 256): lost layers "
          f"{[i for i, x in enumerate(lost) if x]}; reconstruct "
          f"{stats.get('reconstruct')}; {equal} of 4 streams of {PIPE_NEW} "
          f"equal to an uncrashed single engine's; launches {crash_counts}")
    require(eng.prefill_backend_used == "pipeline", "9c: prefill ran single")
    require(equal == 4, "9c: the recovered streams differ")
    for name, n in crash_counts.items():
        counts[name] += n
    del eng, params
    torch.cuda.empty_cache()
    return counts


def _model_runs(torch, ops, cfg, params, batches):
    """The logits of ``batches`` (the first a train-mode or prefill
    batch, the rest decode steps) through the kernels and through the
    plain versions."""
    from repro_torch.models import transformer as T

    def run():
        if len(batches) == 1:
            return T.forward(cfg, params, batches[0])[0]
        lg, cache = T.forward(cfg, params, batches[0], mode="prefill",
                              max_len=1024)
        out = [lg]
        for b in batches[1:]:
            lg, cache = T.decode_step(cfg, params, b, cache)
            out.append(lg)
        return torch.stack(out)

    ops.reset_launch_counts()
    kern = run()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    with ops.plain_versions():
        plain = run()
    return kern, plain, counts


def hubert(torch, ops, dev):
    """9d: hubert-xlarge at full width and depth (48 layers, 16 heads of
    80, non-causal, LayerNorm), ``forward`` from frame embeddings (B 4, S
    512) in bf16 and float32 through the kernels and the plain versions.
    Flash alone at head dim 80 is held and timed in phase 3."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import transformer as T
    cfg16 = get_arch("hubert-xlarge")
    gen = torch.Generator(device=dev).manual_seed(71)
    params16 = T.init_params(cfg16, gen, device=dev)
    emb = torch.randn((4, 512, cfg16.d_model), generator=gen, device=dev)
    k16, p16, counts = _model_runs(torch, ops, cfg16, params16,
                                   [{"embeds": emb.to(torch.bfloat16)}])
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    params32 = _upcast(params16)
    del params16
    k32, p32, counts32 = _model_runs(torch, ops, cfg32, params32,
                                     [{"embeds": emb}])
    for c in (counts, counts32):
        require(c["flash_attention"] == cfg16.n_layers
                and sum(c.values()) == cfg16.n_layers,
                f"9d launches {c}")
    scale = p32.abs().max().item()
    err = (k32 - p32).abs().max().item()
    for tag, lg in (("kernel", k16), ("plain", p16)):
        print(f"  9d hubert-xlarge bf16 {tag} run against float32 plain of "
              f"the same weights: max|diff| = "
              f"{(lg.float() - p32).abs().max().item():.3e}; argmax "
              f"agreement {(lg.argmax(-1) == p32.argmax(-1)).float().mean().item():.3f}")
    print(f"  9d hubert-xlarge ({cfg32.n_layers} layers, d_model "
          f"{cfg32.d_model}, 16 heads of 80, non-causal) float32 from "
          f"embeddings 4 x 512: max|kernel - plain| = {err:.3e} (max|logit| "
          f"{scale:.3f}, limit {LOGIT_REL_TOL * scale:.3e}); bf16 "
          f"{(k16.float() - p16.float()).abs().max().item():.3e}; launches "
          f"{counts32}")
    require(err <= LOGIT_REL_TOL * scale, f"9d float32: {err}")
    del params32, k16, p16, k32, p32
    torch.cuda.empty_cache()
    return counts32


def qwen2_vl(torch, ops, dev):
    """9e: qwen2-vl-72b at full width, depth cut to 4 layers, float32: a
    prefill of 2 x 256 embeddings with (t, h, w) positions that all
    differ and 8 decode steps of embeddings, through the kernels and the
    plain versions; logits within 2.5% of max |logit|, every step's
    argmax equal."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_arch("qwen2-vl-72b"), n_layers=4,
                              dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(73)
    params = T.init_params(cfg, gen, device=dev)
    B, S, N = 2, 256, 8

    def pos(t0, n):
        t = t0 + torch.arange(n, device=dev)
        p = torch.stack([t, 2 * t + 1, 3 * t + 2], dim=-1)   # t != h != w
        return (p[None] + torch.arange(B, device=dev)[:, None, None]).to(
            torch.int32)

    def emb(n):
        return torch.randn((B, n, cfg.d_model), generator=gen,
                           device=dev) * 0.02

    batches = [{"embeds": emb(S), "positions": pos(0, S)}]
    batches += [{"embeds": emb(1), "positions": pos(S + i, 1)}
                for i in range(N)]
    kern, plain, counts = _model_runs(torch, ops, cfg, params, batches)
    # M-RoPE takes the plain ops; the norms are fused
    want = {"flash_attention": 4, "decode_attention": 4 * N,
            "lora_merge": 0, "ssd_scan": 0, "rglru_scan": 0,
            "rms_norm": N * (2 * 4 + 1), "rope": 0, "ssm_step": 0}
    require(counts == want, f"9e launches {counts}, expected {want}")
    err = (kern - plain).abs().max().item()
    scale = plain.abs().max().item()
    same = bool(torch.equal(kern.argmax(-1), plain.argmax(-1)))
    print(f"  9e qwen2-vl-72b float32 ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, 64 heads of 128 on 8, M-RoPE sections "
          f"{cfg.mrope_sections}): prefill {B} x {S} embeddings + {N} "
          f"decode steps, max|kernel - plain| = {err:.3e} (max|logit| "
          f"{scale:.3f}, limit {LOGIT_REL_TOL * scale:.3e}); argmax equal "
          f"every step {same}; launches {counts}")
    require(err <= LOGIT_REL_TOL * scale, f"9e: {err}")
    require(same, "9e: the argmax streams differ")
    del params, kern, plain
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 10: training on the card
# ---------------------------------------------------------------------------

TRAIN_ARCH = "pipeboost-opt-1.3b"
TRAIN_GRAD_TOL = 1e-4        # 10a float32 gradients: share of max |plain g|
TRAIN_LEAF_TOL = 1e-3        # 10c float32 gradient leaves: share of max
TRAIN_LOSS_RTOL = 1e-5       # 10c float32 loss, relative
BACKWARD_ROUTE = {"flash_attention": "plain", "ssd_scan": "plain",
                  "rglru_scan": "kernel, reversed"}


def _grads(torch, fn, inputs, gouts=None, seed=0):
    """(outputs, grads of sum <out, gout> w.r.t. the inputs that require
    a gradient, gouts); gouts drawn from ``seed`` when not given."""
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    if gouts is None:
        g = torch.Generator(device=outs[0].device).manual_seed(seed)
        gouts = [torch.randn(o.shape, generator=g, device=o.device).to(
            o.dtype) for o in outs]
    wanted = [t for t in inputs if t is not None and t.requires_grad]
    return outs, torch.autograd.grad(outs, wanted, gouts), gouts


def _grad_err(torch, got, want):
    """max over the inputs of max|got - want| / max|want|."""
    worst = 0.0
    for a, b in zip(got, want):
        scale = b.float().abs().max().item()
        require(scale > 0, "a zero plain gradient")
        worst = max(worst, (a.float() - b.float()).abs().max().item()
                    / scale)
    return worst


def _leaf(t, dtype):
    return t.detach().to(dtype).requires_grad_()


def _time_grad(torch, label, fn, inputs, iters, bwd_iters):
    """(forward ms, backward ms, backward host-paced ms) of ``fn`` on
    ``inputs``: the forward alone, then the backward of one recorded
    forward, replayed with ``retain_graph``, ``bwd_iters`` times (a
    backward through plain code issues tens to thousands of launches, and
    ``time_ms`` wants the launches of its loop well inside the device's
    queue).  Where issuing them still outlasts ``time_ms``'s spin, the
    device time is an upper bound (a note says so) and the host-paced time
    is what a train step pays."""
    fwd_ms, _ = time_ms(torch, f"{label} forward",
                        [lambda: fn(*inputs)], iters)
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gouts = [torch.ones_like(o) for o in outs]
    wanted = [t for t in inputs if t is not None and t.requires_grad]
    bwd_ms, bwd_paced = time_ms(torch, f"{label} backward", [
        lambda: torch.autograd.grad(outs, wanted, gouts,
                                    retain_graph=True)], bwd_iters)
    return fwd_ms, bwd_ms, bwd_paced


def kernel_gradients(torch, ops, dev, results):
    """10a: each kernel's autograd Function (the launch, and the backward
    of section 1a) against the plain version differentiated by autograd:
    float32 held within TRAIN_GRAD_TOL of max |plain g|, bf16 printed
    against the float32 plain gradients of the same inputs.  Then the
    forward and backward of each timed beside the plain version's and,
    for flash, SDPA's (``library_backward_ms``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import ssd_scan as ssd
    F = torch.nn.functional
    f32, bf = torch.float32, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(31)
    launched = {}

    def check(name, kernel, plain, make, dtypes, tag):
        """``make(dt)``: the inputs of a run in dtype ``dt`` (the inputs
        the kernel takes in float32 stay float32)."""
        for dt in dtypes:
            ins = [None if t is None else _leaf(t, t.dtype)
                   for t in make(dt)]
            ops.reset_launch_counts()
            _, got, gouts = _grads(torch, kernel, ins)
            torch.cuda.synchronize()
            n = ops.launch_counts()[name]
            require(n >= 1, f"10a {name} {tag}: the kernel never launched")
            launched[name] = launched.get(name, 0) + n
            ref_ins = [None if t is None else _leaf(t, f32) for t in ins]
            _, want, _ = _grads(torch, plain, ref_ins,
                                [o.float() for o in gouts])
            err = _grad_err(torch, got, want)
            kind = "float32" if dt == f32 else "bf16 against float32"
            print(f"  10a {name} {tag} {kind}: max|grad kernel - plain| = "
                  f"{err:.3e} of max|plain grad|, launches {n}")
            if dt == f32:
                require(err <= TRAIN_GRAD_TOL,
                        f"10a {name} {tag}: {err} > {TRAIN_GRAD_TOL}")

    def flash_fns(kw):
        return (lambda q, k, v: ops.flash_attention(q, k, v, **kw),
                lambda q, k, v: fa.flash_attention_plain(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    **kw).transpose(1, 2))

    flash_cases = [("opt-1.3b", (4, 512, 32, 32, 64), {}),
                   ("recurrentgemma-2b window 128", (1, 512, 10, 1, 256),
                    {"window": 128}),
                   ("hubert-xlarge d 80 non-causal", (4, 512, 16, 16, 80),
                    {"causal": False}),
                   ("qwen2-moe-a2.7b", (1, 512, 16, 16, 128), {})]
    for tag, (B, S, Hq, Hkv, d), kw in flash_cases:
        def make(dt, B=B, S=S, Hq=Hq, Hkv=Hkv, d=d):
            return [torch.randn((B, S, h, d), generator=g, device=dev).to(dt)
                    for h in (Hq, Hkv, Hkv)]
        check("flash_attention", *flash_fns(kw), make, (f32, bf), tag)

    H, P, N = 48, 64, 128                    # mamba2-780m
    A = -torch.linspace(1.0, 16.0, H, device=dev)

    def ssd_make(dt, B=1, S=512, with_state=False):
        """conv_out in ``dt``; dt, A and the state float32."""
        return [torch.randn((B, S, H * P + 2 * N), generator=g,
                            device=dev).to(dt),
                F.softplus(torch.randn((B, S, H), generator=g, device=dev)),
                A.clone(),
                torch.randn((B, H, P, N), generator=g, device=dev)
                if with_state else None]

    def ssd_split(conv, dt, A, h0):
        B, S = conv.shape[:2]
        return (conv[..., :H * P].reshape(B, S, H, P), dt, A,
                conv[..., H * P:H * P + N], conv[..., H * P + N:], h0)

    def ssd_k(*a):
        return ops.ssd_scan(*ssd_split(*a))

    def ssd_p(*a):
        return ssd.ssd_scan_plain(*ssd_split(*a))

    for with_state in (False, True):
        check("ssd_scan", ssd_k, ssd_p,
              lambda dt, w=with_state: ssd_make(dt, with_state=w), (f32, bf),
              f"B 1 S 512{' from a state' if with_state else ''}")

    W = 2560                                  # recurrentgemma-2b
    lam = torch.log(torch.expm1(-torch.log(torch.linspace(
        0.9, 0.999, W, device=dev)) / 8.0))

    def rg_make(dt=f32, B=1, S=512, with_h0=False):
        """float32 only: the kernel's dtype."""
        r = torch.sigmoid(torch.randn((B, S, W), generator=g, device=dev))
        log_a = -8.0 * F.softplus(lam) * r
        bx = torch.sqrt(1 - torch.exp(2 * log_a)) * torch.randn(
            (B, S, W), generator=g, device=dev)
        return [log_a, bx, torch.randn((B, W), generator=g, device=dev)
                if with_h0 else None]

    for with_h0 in (False, True):
        check("rglru_scan", ops.rglru_scan, rg.rglru_scan_plain,
              lambda dt, w=with_h0: rg_make(dt, with_h0=w), (f32,),
              f"B 1 S 512 W {W}{' from h0' if with_h0 else ''}")

    # times at the train path's shapes and dtypes (bf16 attention and
    # SSD, float32 RG-LRU)
    timing = {}
    q, k, v = [_leaf(torch.randn((4, 512, 32, 64), generator=g, device=dev),
                     bf) for _ in range(3)]
    fk, fp = flash_fns({})
    ms, bwd, paced = _time_grad(torch, "flash kernel", fk, (q, k, v), 50,
                                10)
    _, plain_bwd, plain_paced = _time_grad(torch, "flash plain", fp,
                                           (q, k, v), 2, 2)
    lib = [_leaf(t.transpose(1, 2).contiguous(), bf) for t in (q, k, v)]

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    lib_fwd, lib_bwd, _ = _time_grad(torch, "flash SDPA", sdpa, lib, 50, 50)
    timing["flash_attention"] = dict(
        shape="opt-1.3b 4 x 512, 32 heads of 64, bf16", forward_ms=ms,
        backward_ms=bwd, backward_host_paced_ms=paced,
        plain_backward_ms=plain_bwd, plain_backward_host_paced_ms=plain_paced,
        library_forward_ms=lib_fwd, library_backward_ms=lib_bwd)
    sins = [None if t is None else _leaf(t, t.dtype) for t in ssd_make(bf)]
    ms, bwd, paced = _time_grad(torch, "ssd kernel", ssd_k, sins, 50, 2)
    _, plain_bwd, plain_paced = _time_grad(torch, "ssd plain", ssd_p, sins,
                                           3, 2)
    timing["ssd_scan"] = dict(
        shape="mamba2-780m B 1 S 512, H 48 P 64 N 128, bf16", forward_ms=ms,
        backward_ms=bwd, backward_host_paced_ms=paced,
        plain_backward_ms=plain_bwd, plain_backward_host_paced_ms=plain_paced)
    rins = [_leaf(t, f32) for t in rg_make()[:2]] + [None]
    ms, bwd, paced = _time_grad(torch, "rglru kernel", ops.rglru_scan, rins,
                                50, 40)
    _, plain_bwd, plain_paced = _time_grad(torch, "rglru plain",
                                           rg.rglru_scan_plain, rins, 1, 1)
    timing["rglru_scan"] = dict(
        shape="recurrentgemma-2b B 1 S 512 W 2560, float32", forward_ms=ms,
        backward_ms=bwd, backward_host_paced_ms=paced,
        plain_backward_ms=plain_bwd, plain_backward_host_paced_ms=plain_paced)
    for name, t in timing.items():
        t["backward_route"] = BACKWARD_ROUTE[name]
        print(f"  10a timed {name} ({t['shape']}): forward "
              f"{t['forward_ms']:.4f} ms, backward {t['backward_ms']:.4f} ms "
              f"(host-paced {t['backward_host_paced_ms']:.4f} ms; "
              f"{t['backward_route']}), plain backward "
              f"{t['plain_backward_ms']:.4f} ms (host-paced "
              f"{t['plain_backward_host_paced_ms']:.4f} ms)"
              + (f", SDPA forward {t['library_forward_ms']:.4f} ms, backward "
                 f"{t['library_backward_ms']:.4f} ms"
                 if "library_backward_ms" in t else ""))
    results.update(timing)
    torch.cuda.empty_cache()
    return launched


def train_step_run(torch, ops, dev):
    """10b: ``launch.train`` at opt-1.3b's full width and depth in bf16
    with every layer rematerialised, batch 8 x 512 for 10 steps: every
    loss finite, the last below the first, 48 flash launches a step (24
    layers, each forward run twice: once, and again in the backward by
    the rematerialisation)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.core import analytic
    from repro_torch.launch import rooflines
    from repro_torch.launch import train
    steps, B, S = 10, 8, 512
    argv = ["--arch", TRAIN_ARCH, "--steps", str(steps), "--batch", str(B),
            "--seq", str(S)]
    print(f"  python -m repro_torch.launch.train {' '.join(argv)}")
    ops.reset_launch_counts()
    res = train.main(argv)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    cfg = get_arch(TRAIN_ARCH)
    losses = res.losses
    require(len(losses) == steps and all(math.isfinite(x) for x in losses),
            f"10b losses {losses}")
    require(losses[-1] < losses[0], f"10b loss did not fall: {losses}")
    want = 2 * cfg.n_layers * steps
    require(counts["flash_attention"] == want
            and sum(counts.values()) == want,
            f"10b launches {counts}, expected {want} flash")
    later = sorted(res.step_s[2:])
    step_s = later[len(later) // 2]
    model_flops = analytic.train_step_flops(cfg, B, S)
    executed = 4 * analytic.forward_flops(cfg, B, S)
    out = dict(arch=TRAIN_ARCH, n_params=res.n_params, batch=B, seq=S,
               steps=steps, dtype="bfloat16", remat=True, losses=losses,
               step_ms_median=step_s * 1e3,
               step_ms_all=[x * 1e3 for x in res.step_s],
               tokens_per_s=B * S / step_s,
               peak_memory_gib=res.peak_memory_bytes / 2 ** 30,
               model_flops=model_flops,
               model_flops_source="core/analytic.py train_step_flops "
                                  "(3 x forward_flops)",
               executed_flops_with_remat=executed,
               model_flops_share_of_bf16_peak=model_flops / step_s
               / rooflines.PEAK_FLOPS["bfloat16"],
               flash_launches_per_step=counts["flash_attention"] // steps,
               state_bytes=res.state_bytes,
               peak_memory_bytes=res.peak_memory_bytes)
    print(f"  10b {TRAIN_ARCH} ({res.n_params / 1e9:.3f} B params) {B} x "
          f"{S}: losses {' '.join(f'{x:.4f}' for x in losses)}; step "
          f"{out['step_ms_median']:.1f} ms (median of steps 3-{steps}), "
          f"{out['tokens_per_s']:.0f} tokens/s, peak "
          f"{out['peak_memory_gib']:.2f} GiB, model FLOPs "
          f"{model_flops:.3e} = {100 * out['model_flops_share_of_bf16_peak']:.1f}"
          f"% of 989 TFLOP/s; flash launches {counts['flash_attention']} "
          f"({out['flash_launches_per_step']} a step: each layer's forward "
          f"twice under remat)")
    torch.cuda.empty_cache()
    return counts, out


def family_gradients(torch, ops, dev, arch, layers, B, S, kernels):
    """10c: one loss and gradient evaluation (remat on, the train path's
    ``value_and_grad``) at full width, depth cut to ``layers``, through
    the kernels and through ``plain_versions()``: float32 loss within
    TRAIN_LOSS_RTOL and every gradient leaf within TRAIN_LEAF_TOL of its
    max |g|; the bf16 run's loss printed."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train as ttrain
    cfg = dataclasses.replace(get_arch(arch), n_layers=layers,
                              dtype="float32")
    def init(c):
        """The same draws in ``c``'s dtype (the float32 leaves, such as
        A_log, stay float32)."""
        gen = torch.Generator(device=dev).manual_seed(41)
        return T.init_params(c, gen, device=dev)

    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(42))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    params16 = init(cfg16)
    (l16, _), g16 = ttrain.value_and_grad(ttrain.make_loss_fn(
        cfg16, remat=True))(params16, batch)
    del params16, g16
    params = init(cfg)
    grad_fn = ttrain.value_and_grad(ttrain.make_loss_fn(cfg, remat=True))
    ops.reset_launch_counts()
    (lk, _), gk = grad_fn(params, batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    with ops.plain_versions():
        (lp, _), gp = grad_fn(params, batch)
    for name in kernels:
        require(counts[name] > 0, f"10c {arch}: {name} never launched")
    lerr = abs(float(lk) - float(lp)) / abs(float(lp))
    worst = 0.0
    for a, b in zip(topt.tree_leaves(gk), topt.tree_leaves(gp)):
        scale = b.abs().max().item()
        if scale > 0:
            worst = max(worst, (a - b).abs().max().item() / scale)
        else:
            require(a.abs().max().item() == 0, f"10c {arch}: grad where "
                    f"the plain run has none")
    print(f"  10c {arch} ({layers} of {get_arch(arch).n_layers} layers, "
          f"full width) {B} x {S}: float32 loss kernel {float(lk):.6f}, "
          f"plain {float(lp):.6f} (rel {lerr:.2e}); gradient leaves within "
          f"{worst:.2e} of their max |g|; bf16 kernel loss "
          f"{float(l16):.6f}; launches {counts}")
    require(lerr <= TRAIN_LOSS_RTOL and worst <= TRAIN_LEAF_TOL,
            f"10c {arch}: loss {lerr} or gradients {worst}")
    del params, gk, gp
    torch.cuda.empty_cache()
    return counts


def checkpoint_resume(torch, ops, dev):
    """10d: ``launch.train`` at opt-1.3b's full width, depth cut to 2
    layers (a full-depth checkpoint with float32 m and v is about 16 GB),
    6 steps with a checkpoint every 3; then the directory as a crash after
    step 3 would leave it (step 6 set aside, LATEST at step 3) and
    ``--resume``: the resumed steps 4-6 and step 6's checkpoint equal to
    the uninterrupted run's, bit for bit."""
    import shutil
    import numpy as np
    from repro_torch.launch import train
    d = ROOT / "build" / "chip_smoke_ckpt"
    kept = ROOT / "build" / "chip_smoke_ckpt_step6"
    for p in (d, kept):
        shutil.rmtree(p, ignore_errors=True)
    argv = ["--arch", TRAIN_ARCH, "--layers", "2", "--steps", "6",
            "--batch", "8", "--seq", "512", "--ckpt-every", "3",
            "--ckpt-dir", str(d)]
    print(f"  python -m repro_torch.launch.train {' '.join(argv)}")
    ops.reset_launch_counts()
    try:
        a = train.main(argv)
        step6 = d / "step_000000006"
        nbytes_ = sum(f.stat().st_size for f in step6.iterdir())
        step6.rename(kept)
        (d / "LATEST").write_text("step_000000003")
        b = train.main(argv + ["--resume"])
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        with np.load(kept / "arrays.npz") as fa, \
                np.load(step6 / "arrays.npz") as fb:
            unequal = sorted(set(fa.files) ^ set(fb.files)) + [
                k for k in fa.files
                if k in fb.files and not np.array_equal(fa[k], fb[k])]
            leaves = len(fa.files)
    finally:
        for p in (d, kept):
            shutil.rmtree(p, ignore_errors=True)
    require(b.start_step == 3 and len(b.losses) == 3, f"10d resume {b}")
    rel = max(abs(x - y) / abs(y) for x, y in zip(b.losses, a.losses[3:]))
    print(f"  10d checkpoint {nbytes_ / 1e9:.3f} GB, final save "
          f"{a.ckpt_save_s:.2f} s, restore {b.ckpt_restore_s:.2f} s; "
          f"uninterrupted steps 4-6 {' '.join(f'{x:.6f}' for x in a.losses[3:])}"
          f", resumed {' '.join(f'{x:.6f}' for x in b.losses)} (max rel "
          f"{rel:.2e}, equal {b.losses == a.losses[3:]}); step-6 "
          f"checkpoints: {leaves - len(unequal)} of {leaves} leaves equal; "
          f"launches {counts}")
    require(b.losses == a.losses[3:],
            f"10d resumed losses {b.losses} != {a.losses[3:]}")
    require(not unequal, f"10d step-6 checkpoints differ at {unequal[:8]}")
    require(counts["flash_attention"] > 0, "10d never launched flash")
    return counts, dict(checkpoint_bytes=nbytes_, save_s=a.ckpt_save_s,
                        restore_s=b.ckpt_restore_s,
                        resumed_equal=b.losses == a.losses[3:],
                        resumed_max_rel=rel)


# ---------------------------------------------------------------------------
# phase 11: the dry run and rooflines, build_pipeline_cell, the examples
# ---------------------------------------------------------------------------

COST_ARCHS = ("pipeboost-opt-1.3b", "qwen3-1.7b", "recurrentgemma-2b")
COST_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
PIPE_CELL = ("qwen3-1.7b", "prefill_32k")
DRYRUN_WORKERS = 6          # of the host's 8 cores; the card idles meanwhile
DRYRUN_ARG_TOL = 0.01       # dry-run argument bytes against the real state
DRYRUN_PEAK = (0.5, 2.0)    # dry-run peak over the card's peak
ROOFLINE_SHARE_MAX = 1.05   # roofline time over the measured step time
PIPE_CELL_F32_TOL = 1e-4    # belt logits: share of max |forward logit|
EXAMPLES = {                # example -> (line marker, lines expected)
    "torch_quickstart": (("partial-load tokens == full-load tokens: ", 1),
                         ("tokens still equal: ", 1)),
    "torch_recovery_drill": (("exact=", 4),),
    "torch_serve_lora": (("every request served its 5 tokens: ", 1),),
    "torch_train_e2e": (("uninterrupted losses (rel 1e-5): ", 1),),
}


def _dryrun_cell(job):
    """One dry-run cell, in a worker process: (job, result, error)."""
    arch, shape, multi_pod, skip_cost, pipeline = job
    from repro_torch.launch import dryrun
    try:
        return job, dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                                    skip_cost=skip_cost,
                                    pipeline_mode=pipeline), None
    except Exception as e:          # reported, and the phase then fails
        return job, None, f"{type(e).__name__}: {e}"


def dryrun_sweep():
    """11a: ``dryrun --all --skip-cost`` over both meshes, the cost of
    three archs at three shapes, and one pipeline cell, over a pool of
    worker processes; every applicable cell must pass."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.configs.base import cells
    jobs = [(a, s, mp, True, False) for mp in (True, False)
            for a, s, ok, _ in cells() if ok]
    jobs.sort(key=lambda j: (j[1] != "train_4k", not j[2]))  # slow first
    jobs += [(a, s, False, False, False) for a in COST_ARCHS
             for s in COST_SHAPES]
    jobs.append(PIPE_CELL + (False, False, True))
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            max_workers=DRYRUN_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        done = list(pool.map(_dryrun_cell, jobs))
    wall = time.perf_counter() - t0
    failed = [(j, e) for j, _, e in done if e]
    for j, e in failed:
        print(f"  [FAIL] {j}: {e}")
    require(not failed, f"11a: {len(failed)} dry-run cells failed")
    sweep = [r for j, r, _ in done if j[3]]
    peaks = [r["memory"]["peak_per_device"] / 2 ** 30 for r in sweep]
    replicated = sorted({op for r in sweep for op in r["replicated_ops"]})
    cells = {}
    for r in sweep:
        tag = f"{r['arch']} {r['shape']} {r['mesh']}"
        cells[tag] = dict(peak_gib=r["memory"]["peak_per_device"] / 2 ** 30,
                          replicated_ops=r["replicated_ops"])
        print(f"  11a {tag}: peak/dev {cells[tag]['peak_gib']:.2f} GiB, "
              f"replicated {r['replicated_ops'] or 'none'}")
    print(f"  11a dryrun --all --skip-cost over both meshes: {len(sweep)} "
          f"cells, peak per device {min(peaks):.2f}-{max(peaks):.2f} GiB; "
          f"ops run replicated: {replicated}")
    costed = {}
    for j, r, _ in done:
        if j[3]:
            continue
        c = r["cost"]["roofline"]
        tag = f"{j[0]} {j[1]}" + (" --pipeline" if j[4] else "")
        costed[tag] = dict(peak_per_device=r["memory"]["peak_per_device"],
                           **{k: c[k] for k in ("compute_s", "memory_s",
                                                "collective_s",
                                                "dominant")})
        print(f"  11a {tag} on {r['mesh']}: peak/dev "
              f"{r['memory']['peak_per_device'] / 2 ** 30:.2f} GiB, compute "
              f"{c['compute_s'] * 1e3:.2f} ms, memory "
              f"{c['memory_s'] * 1e3:.2f} ms, collective "
              f"{c['collective_s'] * 1e3:.2f} ms ({c['dominant']})")
    print(f"  11a {len(jobs)} dry runs in {wall:.1f} s wall "
          f"({DRYRUN_WORKERS} worker processes)")
    return {"cells": len(jobs), "wall_s": wall, "costed": costed,
            "replicated_ops": replicated, "production_cells": cells}


def _hold_dryrun(tag, dr, real_args, real_peak, measured_s, smi):
    """11b's three comparisons of one dry-run point with the card."""
    mem = dr["memory"]
    arg_err = abs(mem["argument_bytes"] - real_args) / real_args
    ratio = mem["peak_per_device"] / real_peak
    roof = dr["cost"]["roofline"]
    total = max(roof["compute_s"], roof["memory_s"], roof["collective_s"])
    share = total / measured_s
    print(f"  11b {tag}: argument bytes {mem['argument_bytes']} against "
          f"the real {real_args} ({100 * arg_err:.3f}% apart); peak per "
          f"device {mem['peak_per_device'] / 2 ** 30:.3f} GiB against the "
          f"card's {real_peak / 2 ** 30:.3f} GiB (ratio {ratio:.3f}); "
          f"roofline {total * 1e3:.3f} ms ({roof['dominant']}) against "
          f"the measured "
          f"{measured_s * 1e3:.3f} ms: {100 * share:.1f}% [{smi}]")
    require(arg_err <= DRYRUN_ARG_TOL, f"11b {tag}: argument bytes "
            f"{mem['argument_bytes']} vs {real_args}")
    require(DRYRUN_PEAK[0] <= ratio <= DRYRUN_PEAK[1],
            f"11b {tag}: peak ratio {ratio}")
    require(share <= ROOFLINE_SHARE_MAX, f"11b {tag}: the roofline "
            f"{total} s exceeds the measured {measured_s} s")
    return dict(argument_bytes=mem["argument_bytes"], real_bytes=real_args,
                peak_bytes=mem["peak_per_device"], card_peak_bytes=real_peak,
                peak_ratio=ratio, roofline_ms=total * 1e3,
                measured_ms=measured_s * 1e3, roofline_share=share,
                dominant=roof["dominant"])


def dryrun_vs_card(torch, dev, train_step, smi):
    """11b: the dry run on a one-card mesh at phase 10b's train step and
    at a replayed decode step (opt-1.3b, 4 slots, max_len 1024), held
    against the card's bytes, peak memory and time."""
    import statistics
    import numpy as np
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServeRequest, ServingEngine
    one = Mesh(("data", "model"), (1, 1))
    out = {}
    B, S = train_step["batch"], train_step["seq"]
    dr = dryrun.run_cell(TRAIN_ARCH, f"train_{S}", mesh=one,
                         shape=ShapeConfig(f"train_{S}", S, B, "train"))
    out["train"] = _hold_dryrun(
        f"train {TRAIN_ARCH} {B} x {S}", dr,
        train_step["state_bytes"] + 2 * B * S * 4,
        train_step["peak_memory_bytes"],
        train_step["step_ms_median"] / 1e3, smi)

    cfg = get_arch(TRAIN_ARCH)
    gen = torch.Generator(device=dev).manual_seed(11)
    params = T.init_params(cfg, gen, device=dev)
    srv = ServingEngine(cfg, params, n_slots=4, max_len=1024)
    rng = np.random.default_rng(11)
    for i, L in enumerate(rng.integers(64, 513, size=4)):
        srv.submit(ServeRequest(i, rng.integers(0, cfg.vocab_size,
                                                size=int(L)),
                                max_new_tokens=1000))
    for _ in range(3):
        srv.step()                           # admissions, the capture
    b = srv.batcher
    require(len(b.active) == 4 and b.compile_stats()["decode_compiles"]
            == 1, "11b: the decode step is not captured over 4 slots")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b._graph.replay()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    real = (_params_bytes(torch, b.params) + _params_bytes(torch, b.cache)
            + b._dev_tokens.numel() * b._dev_tokens.element_size())
    dr = dryrun.run_cell(TRAIN_ARCH, "decode_1024", mesh=one,
                         shape=ShapeConfig("decode_1024", 1024, 4,
                                           "decode"))
    out["decode"] = _hold_dryrun(f"replayed decode {TRAIN_ARCH} 4 x 1024",
                                 dr, real, peak, statistics.median(times),
                                 smi)
    del srv, b, params
    torch.cuda.empty_cache()
    return out


def pipeline_cell_on_card(torch, ops, dev):
    """11c: ``build_pipeline_cell`` at opt-1.3b's full width and depth
    (24 layers, 8 stages as 8 streams of one card, B 8, S 512) against
    ``forward``: float32 within 1e-4 of max |logit|, bf16 within 2.5%
    with its flash launches counted."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.distributed.pipeline import (build_pipeline_cell,
                                                  stage_mesh)
    from repro_torch.launch.mesh import pipeline_stages_for
    from repro_torch.models import transformer as T
    shape = ShapeConfig("prefill_512", 512, 8, "prefill")
    base = get_arch(PIPE_ARCH)
    n_stages = pipeline_stages_for(base.n_layers)
    mesh = stage_mesh(n_stages, 1, devices=[dev] * n_stages)
    counts, out = {}, {}
    for dt, tol in (("float32", PIPE_CELL_F32_TOL),
                    ("bfloat16", LOGIT_REL_TOL)):
        cfg = dataclasses.replace(base, dtype=dt)
        fn, (ps, bs) = build_pipeline_cell(cfg, shape, mesh=mesh)
        gen = torch.Generator(device=dev).manual_seed(12)
        params = T.init_params(cfg, gen, device=dev)
        want = {k: tuple(v.shape) for k, v in
                zip(_flat_keys(ps), _flat_leaves(ps))}
        got = {k: tuple(v.shape) for k, v in
               zip(_flat_keys(params), _flat_leaves(params))}
        require(want == got, "11c: the cell's params structure differs")
        toks = torch.randint(0, cfg.vocab_size, tuple(bs["tokens"].shape),
                             generator=gen, device=dev)
        ops.reset_launch_counts()
        logits = fn(params, {"tokens": toks})
        torch.cuda.synchronize()
        c = ops.launch_counts()
        ref = T.forward(cfg, params, {"tokens": toks}, mode="prefill")[0]
        err = ((logits - ref).abs().max() / ref.abs().max()).item()
        print(f"  11c build_pipeline_cell {cfg.name} {dt}: mesh "
              f"{fn.mesh.shape} described, belt of {n_stages} streams on "
              f"one card, {fn.n_micro} microbatches of "
              f"{shape.global_batch // fn.n_micro} x {shape.seq_len}; "
              f"max|belt - forward| / max|forward| = {err:.3e} (limit "
              f"{tol:g}); flash launches {c['flash_attention']}")
        require(err <= tol, f"11c {dt}: {err} > {tol}")
        require(c["flash_attention"] == cfg.n_layers * fn.n_micro
                and sum(c.values()) == c["flash_attention"],
                f"11c {dt} launches {c}")
        counts[f"11c_{dt}"] = c
        out[dt] = dict(rel_err=err, flash_launches=c["flash_attention"])
        del params, logits, ref
        torch.cuda.empty_cache()
    return counts, out


def _flat_keys(tree, prefix=""):
    if isinstance(tree, dict):
        return [k for key in sorted(tree)
                for k in _flat_keys(tree[key], f"{prefix}/{key}")]
    return [prefix]


def _flat_leaves(tree):
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _flat_leaves(tree[key])]
    return [tree]


class _Tee:
    """Writes to every stream it holds."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def examples_on_card(torch, ops):
    """11d: the four examples' ``main`` on the card, in this process;
    each must print its equalities as true."""
    import importlib.util
    import io
    counts, times = {}, {}
    for name, marks in EXAMPLES.items():
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        print(f"  11d examples/{name}.py --device cuda")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
            mod.main(["--device", "cuda"])
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        counts[f"11d_{name}"] = ops.launch_counts()
        lines = buf.getvalue().splitlines()
        for mark, n in marks:
            hit = [ln for ln in lines if mark in ln]
            ok = all((mark + "True") in ln for ln in hit)
            require(len(hit) == n and ok,
                    f"11d {name}: {n} '{mark}True' lines expected, got {hit}")
        print(f"  11d {name}: {times[name]:.1f} s, launches "
              f"{counts[f'11d_{name}']}")
        torch.cuda.empty_cache()
    return counts, times


# ---------------------------------------------------------------------------
# phase 12: training across cards (a process group, the state as DTensors)
# ---------------------------------------------------------------------------

TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--steps", "10", "--batch", "8",
              "--seq", "512"]            # phase 10b's run
SHARDED_LOSS_REL = 1e-3     # 12a step-1 loss against 10b's (bf16)
CPU_LOSS_REL = 1e-5         # 12b losses against the one-process run's
CPU_STATE_TOL = 1e-4        # 12b m and v: share of each leaf's max |x|
# 12b parameters: share of lr x steps, the most AdamW moves an element.
# An element whose gradient is near eps (1e-8) moves by lr g / (|g| +
# eps): float32 sum-order noise in g, ~1e-7 of max |g|, then shows at a
# gain of lr / eps, far above 1e-4 of max |p| (padded vocab rows of the
# tied embedding: 0.6% of lr x steps at 2.2e-4 of max |p| on a CPU).
CPU_PARAM_LR_SHARE = 0.05
LAUNCH_LR = 1e-3            # launch/train.py's AdamW peak learning rate
TORCHRUN_TIMEOUT = 600


def train_worker(out: str, argv) -> int:
    """One rank of a phase-12 run, under torchrun (``chip_smoke.py
    --train-worker OUT -- ARGS``): ``launch.train.main(ARGS)`` with every
    launch count set to 0 just before it; rank 0 writes the run's
    ``TrainResult`` and this process's launch counts to OUT as JSON."""
    import os
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    ops.reset_launch_counts()
    res = train.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if int(os.environ["RANK"]) == 0:
        Path(out).write_text(json.dumps(dict(dataclasses.asdict(res),
                                             launches=ops.launch_counts())))
    return 0


def _run_ranks(nproc: int, args, tag: str, **env) -> str:
    """``torchrun --standalone --nproc-per-node nproc chip_smoke.py ARGS``
    (``env`` added to the ranks' environment): its log.  Fails unless
    every rank exits 0; on a timeout the whole process group is killed."""
    import os
    import signal
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), str(ROOT / "chip_smoke.py"),
           *map(str, args)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env)
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=TORCHRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        raise SmokeError(f"{tag}: torchrun did not end in "
                         f"{TORCHRUN_TIMEOUT} s: {log[-3000:]}")
    require(proc.returncode == 0,
            f"{tag}: torchrun exited {proc.returncode}: {log[-6000:]}")
    return log


def torchrun(nproc: int, argv, tag: str) -> dict:
    """``launch.train`` with ``argv`` on ``nproc`` ranks (through
    ``train_worker``): rank 0's result."""
    out = ROOT / "build" / f"chip_smoke_{tag}.json"
    out.parent.mkdir(exist_ok=True)
    out.unlink(missing_ok=True)
    print(f"  torchrun --standalone --nproc-per-node {nproc} -m "
          f"repro_torch.launch.train {' '.join(argv)}")
    log = _run_ranks(nproc, ["--train-worker", out, "--", *argv], tag)
    for line in log.splitlines():
        if line.startswith(("mesh:", "step ", "resumed")):
            print("    " + line)
    require(out.exists(), f"{tag}: rank 0 wrote no result: {log[-6000:]}")
    return json.loads(out.read_text())


def _step_summary(res, B, S):
    later = sorted(res["step_s"][2:])
    step_s = later[len(later) // 2]
    return dict(step_ms_median=step_s * 1e3,
                step_ms_all=[x * 1e3 for x in res["step_s"]],
                tokens_per_s=B * S / step_s,
                peak_memory_gib=res["peak_memory_bytes"] / 2 ** 30)


def sharded_train(torch, ops, train_step, nproc: int, tag: str):
    """12a (one rank) and 12c (one rank a card): phase 10b's run under
    torchrun with ``--distributed-init``: an NCCL group, the train state
    as DTensors laid out FSDP on the host mesh (nproc, 1), flash reached
    through the DTensor route.  Step 1's loss within 1e-3 relative of
    10b's (same seed, same batch), on one rank every loss equal to 10b's,
    every loss finite, the last below the first, 48 flash launches a step
    on rank 0 and nothing else."""
    from repro_torch.configs.base import get_arch
    torch.cuda.empty_cache()
    res = torchrun(nproc, TRAIN_ARGV + ["--distributed-init"], tag)
    cfg, steps, B, S = get_arch(TRAIN_ARCH), 10, 8, 512
    losses, counts = res["losses"], res["launches"]
    ref = train_step["losses"]
    rel = abs(losses[0] - ref[0]) / abs(ref[0])
    want = 2 * cfg.n_layers * steps
    out = dict(world=res["world"], mesh=res["mesh"], losses=losses,
               step1_rel_to_10b=rel, losses_bit_equal_to_10b=losses == ref,
               **_step_summary(res, B, S),
               state_bytes_rank0=res["state_bytes"],
               flash_launches_per_step=counts["flash_attention"] // steps)
    out["10b"] = {k: train_step[k] for k in ("step_ms_median",
                                             "tokens_per_s",
                                             "peak_memory_gib")}
    print(f"  {tag} world {res['world']} mesh {res['mesh']}: losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; step 1 {rel:.2e} "
          f"relative to 10b's; step {out['step_ms_median']:.1f} ms "
          f"(10b {train_step['step_ms_median']:.1f}), "
          f"{out['tokens_per_s']:.0f} tokens/s (10b "
          f"{train_step['tokens_per_s']:.0f}), peak "
          f"{out['peak_memory_gib']:.2f} GiB (10b "
          f"{train_step['peak_memory_gib']:.2f}); launches {counts}")
    require(res["world"] == nproc and res["mesh"] == {"data": nproc,
                                                      "model": 1},
            f"{tag} world {res['world']} mesh {res['mesh']}")
    require(rel <= SHARDED_LOSS_REL,
            f"{tag} step-1 loss {losses[0]} against 10b's {ref[0]}")
    # one rank runs 10b's step on whole rows: the same launches, the
    # same sums, so every loss equals 10b's bit for bit
    require(nproc > 1 or losses == ref,
            f"{tag} losses {losses} differ from 10b's {ref}")
    require(len(losses) == steps and all(math.isfinite(x) for x in losses),
            f"{tag} losses {losses}")
    require(losses[-1] < losses[0], f"{tag} loss did not fall: {losses}")
    require(counts["flash_attention"] == want
            and sum(counts.values()) == want,
            f"{tag} launches {counts}, expected {want} flash")
    return counts, out


def _npz_apart(a_dir: Path, b_dir: Path, step: int) -> dict:
    """Two train-state checkpoints' arrays at ``step``, leaf by leaf:
    {path: (max |a - b|, max |b|)}."""
    import numpy as np
    name = f"step_{step:09d}"
    with np.load(a_dir / name / "arrays.npz") as a, \
            np.load(b_dir / name / "arrays.npz") as b:
        require(sorted(a.files) == sorted(b.files),
                f"checkpoint leaves differ: {a.files} {b.files}")
        return {k: (float(np.abs(a[k].astype(np.float64) - b[k]).max()),
                    float(np.abs(b[k].astype(np.float64)).max()))
                for k in b.files}


def _hold_states(apart: dict, steps: int, what: str) -> dict:
    """The parameters (leaves ``0/...``) within CPU_PARAM_LR_SHARE of lr
    x steps; AdamW's step, m and v within CPU_STATE_TOL of each leaf's
    max |x|.  Returns the worst of each."""
    params = max(e for k, (e, _) in apart.items() if k.startswith("0/"))
    rel = {k: 0.0 if e == 0 else e / s for k, (e, s) in apart.items()
           if not k.startswith("0/")}
    out = dict(params_max_abs=params,
               params_share_of_lr_steps=params / (LAUNCH_LR * steps),
               params_share_of_max_p=max(
                   e / s for k, (e, s) in apart.items()
                   if k.startswith("0/") and s > 0),
               moments_max_rel=max(rel.values()))
    require(out["params_share_of_lr_steps"] <= CPU_PARAM_LR_SHARE,
            f"{what} parameters apart: {out}")
    require(out["moments_max_rel"] <= CPU_STATE_TOL,
            f"{what} step, m, v apart: "
            f"{sorted(rel.items(), key=lambda kv: -kv[1])[:4]}")
    return out


def sharded_train_cpu(torch):
    """12b: the multi-rank logic under the card's torch, on its host's
    CPU: the reduced opt-1.3b for 3 steps on 2 ``gloo`` ranks against one
    process (losses within 1e-5 relative, every leaf of the step-3
    checkpoints within 1e-4 of its max |x|); the 2-rank checkpoint
    restored in one process, every leaf equal to the saved array; then
    resumed to step 4 on one rank (a DTensor state) and in one process
    from copies of it: equal within the same bounds."""
    import io
    import shutil
    import numpy as np
    from repro_torch.configs.base import get_arch
    from repro_torch.launch import train
    from repro_torch.training.checkpoint import (Checkpointer,
                                                 _flatten_with_paths)
    from repro_torch.training.train import init_train_state
    base = ["--arch", TRAIN_ARCH, "--device", "cpu", "--batch", "8",
            "--seq", "64"]
    build = ROOT / "build"
    one, two, r1, rp = (build / f"chip_smoke_12b_{n}"
                        for n in ("one", "two", "resume_rank", "resume_one"))
    for d in (one, two, r1, rp):
        shutil.rmtree(d, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        sharded = torchrun(2, base + ["--steps", "3", "--ckpt-dir",
                                      str(two)], "12b_two")
        with contextlib.redirect_stdout(io.StringIO()):
            alone = train.main(base + ["--steps", "3", "--ckpt-dir",
                                       str(one)])
        loss_rel = max(abs(x - y) / abs(y) for x, y in
                       zip(sharded["losses"], alone.losses))
        held = _hold_states(_npz_apart(two, one, 3), 3, "12b step 3")

        # restore the 2-rank checkpoint in one process, value for value
        cfg = get_arch(TRAIN_ARCH).reduced()
        tmpl = init_train_state(cfg, torch.Generator().manual_seed(0),
                                torch.float32, torch.device("cpu"))
        got, extra = Checkpointer(str(two)).restore(tmpl, step=3)
        with np.load(two / "step_000000003" / "arrays.npz") as z:
            flat = _flatten_with_paths(got)
            unequal = [k for k in z.files
                       if not np.array_equal(flat[k].numpy(), z[k])]
            n_leaves = len(z.files)

        # and resume from it: one rank under torchrun, one process alone
        for d in (r1, rp):
            shutil.copytree(two, d)
        resumed = torchrun(1, base + ["--steps", "4", "--ckpt-dir", str(r1),
                                      "--resume"], "12b_resume")
        with contextlib.redirect_stdout(io.StringIO()):
            plain = train.main(base + ["--steps", "4", "--ckpt-dir",
                                       str(rp), "--resume"])
        resume_rel = abs(resumed["losses"][0] - plain.losses[0]) / abs(
            plain.losses[0])
        resume_held = _hold_states(_npz_apart(r1, rp, 4), 4, "12b resume")
    finally:
        for d in (one, two, r1, rp):
            shutil.rmtree(d, ignore_errors=True)
    out = dict(losses_2_ranks=sharded["losses"],
               losses_one_process=alone.losses, loss_max_rel=loss_rel,
               state=held,
               restored_leaves_equal=n_leaves - len(unequal),
               restored_leaves=n_leaves, resumed_start=resumed["start_step"],
               resumed_loss_1_rank=resumed["losses"],
               resumed_loss_one_process=plain.losses,
               resumed_loss_rel=resume_rel,
               resumed_state=resume_held,
               wall_s=time.perf_counter() - t0)
    print(f"  12b gloo, 2 ranks against one process: losses "
          f"{sharded['losses']} against {alone.losses} (max rel "
          f"{loss_rel:.2e}), step-3 state {held}; restored in one "
          f"process: {out['restored_leaves_equal']} of {n_leaves} leaves "
          f"equal; resumed to step 4 on one rank {resumed['losses']} "
          f"against one process {plain.losses} (rel {resume_rel:.2e}, "
          f"state {resume_held}); {out['wall_s']:.1f} s")
    require(sharded["world"] == 2 and sharded["mesh"] == {"data": 2,
                                                          "model": 1},
            f"12b world {sharded['world']} mesh {sharded['mesh']}")
    require(loss_rel <= CPU_LOSS_REL, f"12b losses {out}")
    require(not unequal and extra["step"] == 3,
            f"12b restore: leaves {unequal[:8]} differ")
    require(resumed["start_step"] == 3 and len(resumed["losses"]) == 1,
            f"12b resume {resumed['start_step']} {resumed['losses']}")
    require(resume_rel <= CPU_LOSS_REL, f"12b resume apart: {out}")
    return out


# 12d: the sequence-split step, (2, 2) on 4 gloo ranks of the host's CPU
ROWS_MESH = (2, 2)
ROWS_FAMILIES = (("mamba2-780m", 7), ("recurrentgemma-2b", 9), (MOE_ARCH, 11))
ROWS_OPT = dict(lr=LAUNCH_LR, warmup_steps=1, total_steps=10)
ROWS_STEPS = 3
ROWS_GRAD_TOL = 1e-4        # gradients: share of each leaf's max |g|


def _rows_inputs(torch):
    """12d's weights and batches, drawn the same in every process from
    fixed seeds: the reduced opt-1.3b and 3 batches of 8 x 16 tokens, and
    each of ``ROWS_FAMILIES`` reduced with one batch of 4 x 32."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models.transformer import init_params
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(41)

    def batch(cfg, B, S):
        toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g)
        return {"tokens": toks[:, :-1].int(), "labels": toks[:, 1:].int()}

    def draw(arch, seed, n, B, S):
        cfg = get_arch(arch).reduced()
        params = init_params(cfg, torch.Generator().manual_seed(seed),
                             torch.float32, cpu)
        return cfg, params, [batch(cfg, B, S) for _ in range(n)]
    jobs = {TRAIN_ARCH: draw(TRAIN_ARCH, 5, ROWS_STEPS, 8, 16)}
    for arch, seed in ROWS_FAMILIES:
        jobs[arch] = draw(arch, seed, 1, 4, 32)
    return jobs


def _rows_policy(mesh):
    from repro_torch.distributed.context import ShardingPolicy
    return ShardingPolicy(mesh, dp_axes=("data",), seq_axis="model")


def rows_worker(out: str) -> int:
    """One rank of 12d (``chip_smoke.py --rows-worker OUT`` under torchrun,
    4 ``gloo`` ranks): the launcher's layout on the mesh (2, 2), the batch
    over 'data', the sequence over 'model', the state FSDP as DTensors.
    The reduced opt-1.3b takes 3 train steps; each other family one loss
    and its gradients.  Rank 0 writes every result gathered whole."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import shardings as shd
    from repro_torch.distributed.context import use_policy
    from repro_torch.launch.mesh import Mesh, init_distributed
    from repro_torch.training import optimizer as O
    from repro_torch.training import train as TT
    info = init_distributed(device_type="cpu")
    shd.register_strategies()
    mesh = Mesh(("data", "model"), ROWS_MESH,
                (torch.device("cpu"),) * info.world)

    def whole(tree):
        return O.tree_map(lambda x: x.full_tensor().detach().clone(), tree)
    res = {"torch": torch.__version__, "world": info.world}
    for arch, (cfg, params, batches) in _rows_inputs(torch).items():
        t0 = time.perf_counter()
        pspec = shd.param_specs(cfg, params, mesh, mode="fsdp")

        def place(b, cfg=cfg):
            return shd.distribute(b, shd.batch_specs(cfg, b, mesh), mesh)
        with use_policy(_rows_policy(mesh)):
            if arch == TRAIN_ARCH:
                st = shd.distribute(
                    TT.TrainState(params, O.init_opt_state(params)),
                    TT.TrainState(pspec, O.OptState(shd.P(), pspec, pspec)),
                    mesh)
                step = TT.make_train_step(cfg, O.AdamWConfig(**ROWS_OPT),
                                          remat=False, shard_batch=place)
                losses = []
                for b in batches:
                    st, m = step(st, b)
                    losses.append(float(m["loss"]))
                res[arch] = {"losses": losses, "state": whole(st)}
            else:
                grad_fn = TT.value_and_grad(TT.make_loss_fn(cfg,
                                                            remat=False))
                (loss, _), grads = grad_fn(
                    shd.distribute(params, pspec, mesh), place(batches[0]))
                res[arch] = {"loss": float(loss.full_tensor()),
                             "grads": whole(grads)}
        res[arch]["wall_s"] = time.perf_counter() - t0
    if info.rank == 0:
        torch.save(res, out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _leaves_apart(got, want) -> dict:
    """{path: (max |got - want|, max |want|)} over two trees' leaves."""
    from repro_torch.training.checkpoint import _flatten_with_paths
    a, b = _flatten_with_paths(got), _flatten_with_paths(want)
    require(sorted(a) == sorted(b), f"leaves differ: {sorted(a)[:4]} "
            f"{sorted(b)[:4]}")
    return {k: (float((a[k].double() - b[k].double()).abs().max()),
                float(b[k].double().abs().max())) for k in b}


def sharded_rows_cpu(torch):
    """12d: the step on a mesh with 'model' > 1 under the card host's
    torch, on its CPU: 4 ``gloo`` ranks on (2, 2) (``rows_worker``)
    against one process.  opt-1.3b's 3 steps: losses within 1e-5
    relative, the state held as 12b holds it; mamba2 and recurrentgemma:
    the loss within 1e-5 relative, every gradient leaf within 1e-4 of its
    max |g|; qwen2-moe the same against one process under a (2, 2) policy
    (its 4 token groups the reference's contiguous ones)."""
    from repro_torch.distributed.context import use_policy
    from repro_torch.launch.mesh import Mesh
    from repro_torch.training import optimizer as O
    from repro_torch.training import train as TT
    out_path = ROOT / "build" / "chip_smoke_12d.pt"
    out_path.parent.mkdir(exist_ok=True)
    out_path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    print(f"  12d torchrun --standalone --nproc-per-node 4 chip_smoke.py "
          f"--rows-worker (gloo, mesh {ROWS_MESH}, torch "
          f"{torch.__version__})")
    _run_ranks(4, ["--rows-worker", out_path], "12d", OMP_NUM_THREADS="2")
    got = torch.load(out_path, weights_only=False)
    ranks_s = time.perf_counter() - t0
    res = {"torch": got["torch"], "world": got["world"], "mesh": ROWS_MESH,
           "ranks_wall_s": ranks_s}
    one_mesh = Mesh(("data", "model"), ROWS_MESH)
    for arch, (cfg, params, batches) in _rows_inputs(torch).items():
        g = got[arch]
        if arch == TRAIN_ARCH:
            st = TT.TrainState(params, O.init_opt_state(params))
            step = TT.make_train_step(cfg, O.AdamWConfig(**ROWS_OPT),
                                      remat=False)
            losses = []
            for b in batches:
                st, m = step(st, b)
                losses.append(float(m["loss"]))
            rel = max(abs(x - y) / abs(y) for x, y in zip(g["losses"],
                                                          losses))
            held = _hold_states(_leaves_apart(g["state"], st),
                                ROWS_STEPS, f"12d {arch}")
            res[arch] = dict(losses_4_ranks=g["losses"],
                             losses_one_process=losses, loss_max_rel=rel,
                             state=held, wall_s=g["wall_s"])
            require(rel <= CPU_LOSS_REL, f"12d {arch} losses {res[arch]}")
            continue
        pol = _rows_policy(one_mesh) if arch == MOE_ARCH else None
        with use_policy(pol):
            (loss, _), grads = TT.value_and_grad(TT.make_loss_fn(
                cfg, remat=False))(params, batches[0])
        rel = abs(g["loss"] - float(loss)) / abs(float(loss))
        apart = _leaves_apart(g["grads"], grads)
        shares = {k: 0.0 if e == 0 else e / m for k, (e, m) in apart.items()}
        worst = max(shares, key=shares.get)
        res[arch] = dict(loss_4_ranks=g["loss"], loss_one_process=float(loss),
                         loss_rel=rel, grad_max_share=shares[worst],
                         grad_worst_leaf=worst, grad_leaves=len(shares),
                         one_process_policy=ROWS_MESH if pol else None,
                         wall_s=g["wall_s"])
        require(rel <= CPU_LOSS_REL, f"12d {arch} loss {res[arch]}")
        require(shares[worst] <= ROWS_GRAD_TOL,
                f"12d {arch} gradients apart: {res[arch]}")
    for arch in (TRAIN_ARCH,) + tuple(a for a, _ in ROWS_FAMILIES):
        print(f"  12d {arch}: {res[arch]}")
    print(f"  12d gloo, 4 ranks on {ROWS_MESH} against one process, torch "
          f"{got['torch']}: {time.perf_counter() - t0:.1f} s")
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; this script runs on the "
              "card", file=sys.stderr)
        return 2
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lora_merge as lm
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.kernels import rope as rp
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import ssm_step as ssm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()

    print("== phase 1: card")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"  {kind}; device count {torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"  nvidia-smi: {smi}")

    print("== phase 2: build")
    t0 = time.perf_counter()
    lib_dir = build.build()
    build.load()
    print(f"  built {len(build.sources())} sources into {lib_dir.name} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in build.build_log().splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry",
                                   "error", "warning")):
            print("  " + line.strip())
    instr = product_instructions(build, lib_dir)
    for name, ops_ in sorted(instr.items()):
        print(f"  {name}: products by "
              + (", ".join(ops_) if ops_ else "CUDA-core FMA (no "
                 "tensor-core instruction)"))
    flash_tc = {k: v for k, v in instr.items()
                if k.startswith("flash_bf16_kernel")}
    require(len(flash_tc) == 4 and all(
        any(op.startswith("HGMMA") for op in v) for v in flash_tc.values()),
        f"bf16 flash kernels without HGMMA products: {flash_tc}")
    decode_tc = {k: v for k, v in instr.items()
                 if k.startswith("decode_partial_mma_kernel")}
    require(len(decode_tc) == 3 and all(
        any(op.startswith("HMMA") for op in v) for v in decode_tc.values()),
        f"bf16 decode kernels without HMMA products: {decode_tc}")
    ssd_tc = {k: v for k, v in instr.items()
              if k.startswith(("ssd_chunk_state_mma_kernel",
                               "ssd_chunk_out_mma_kernel"))}
    require(len(ssd_tc) == 4 and all(
        any(op.startswith("HMMA") for op in v) for v in ssd_tc.values()),
        f"bf16 SSD kernels without HMMA products: {ssd_tc}")

    print("== phase 3: kernels against their plain versions")
    results, train_results = {}, {}
    check_decode(torch, ops, dev, results)
    check_flash(torch, ops, dev, results)
    check_lora(torch, ops, dev, results)
    check_ssd(torch, ops, dev, results)
    check_rglru(torch, ops, dev, results)
    check_norm_rope(torch, ops, dev, results)
    check_ssm_step(torch, ops, dev, results)
    torch.cuda.empty_cache()

    print("== phase 4: model, kernels against plain versions")
    check_model(torch, ops, dev, get_arch("pipeboost-opt-1.3b"))
    check_model(torch, ops, dev,
                dataclasses.replace(get_arch("qwen3-1.7b"), n_layers=4))
    mamba2 = get_arch("mamba2-780m")         # full width and depth
    check_model(torch, ops, dev, dataclasses.replace(mamba2,
                                                     dtype="float32"))
    check_model(torch, ops, dev, mamba2)
    rgemma = get_arch("recurrentgemma-2b")   # full width and depth
    check_model(torch, ops, dev, dataclasses.replace(rgemma,
                                                     dtype="float32"))
    check_model(torch, ops, dev, rgemma)

    print("== phase 5: end to end")
    serve_counts = {
        "pipeboost-opt-1.3b": end_to_end(
            torch, ops, "pipeboost-opt-1.3b", 2,
            ("decode_attention", "flash_attention", "lora_merge") + FUSED),
        "mamba2-780m": end_to_end(torch, ops, "mamba2-780m", 0,
                                  ("ssd_scan", "ssm_step")),
        "recurrentgemma-2b": end_to_end(
            torch, ops, "recurrentgemma-2b", 0,
            ("decode_attention", "flash_attention", "rglru_scan") + FUSED),
    }

    print("== phase 6: recovery")
    recovered = {
        "pipeboost-opt-1.3b": recovery(
            torch, ops, dev, "pipeboost-opt-1.3b", 2,
            ("decode_attention", "flash_attention", "lora_merge") + FUSED,
            ("flash_attention",)),
        "mamba2-780m": recovery(torch, ops, dev, "mamba2-780m", 0,
                                ("ssd_scan", "ssm_step"), ("ssd_scan",)),
        "recurrentgemma-2b": recovery(
            torch, ops, dev, "recurrentgemma-2b", 0,
            ("decode_attention", "flash_attention", "rglru_scan") + FUSED,
            ("flash_attention", "rglru_scan")),
    }
    print("== phase 7: the cluster")
    opt = get_arch(CLUSTER_ARCH)
    exact = cluster_exact(torch, ops, dev,
                          dataclasses.replace(opt, dtype="float32"))
    cli = cluster_cli(torch, ops, dev)
    hit = prefix_vs_cold(torch, ops, dev, cli.pop("params"))
    torch.cuda.empty_cache()
    cluster_parts = {"exact_f32": exact["counts"], "cli": cli["counts"],
                     "prefix_vs_cold": hit["counts"]}
    print("== phase 8: the pipeline prefill")
    pipe_parts = {
        "8a_opt": engine_belt(torch, ops, dev, PIPE_ARCH, "flash_attention"),
        "8a_opt_adapter": engine_belt(torch, ops, dev, PIPE_ARCH,
                                      "flash_attention", adapters=2),
        "8b_mamba2": engine_belt(torch, ops, dev, "mamba2-780m", "ssd_scan"),
        "8c_seqchunk": seqchunk_belt(torch, ops, dev),
        "8d_served": served_belt(torch, ops, dev),
        "8e_repartition": repartitioned_belt(torch, ops, dev),
    }
    for name in ("flash_attention", "ssd_scan"):
        require(sum(c[name] for c in pipe_parts.values()) > 0,
                f"phase 8 never launched {name}")
    belt_ms = belt_timings(torch, ops, dev)
    print("== phase 9: the remaining model families")
    moe_step = {}
    family_parts = {
        "9a_moe_serve": end_to_end(
            torch, ops, MOE_ARCH, 2,
            ("decode_attention", "flash_attention", "lora_merge") + FUSED,
            after=lambda res: moe_step.update(moe_replayed_step(torch,
                                                                res))),
    }
    torch.cuda.empty_cache()
    family_parts.update({
        "9b_moe_kernels": moe_kernels_vs_plain(torch, ops, dev),
        "9c_moe_belt": moe_belt(torch, ops, dev),
        "9d_hubert": hubert(torch, ops, dev),
        "9e_qwen2_vl": qwen2_vl(torch, ops, dev),
    })
    serve_counts[MOE_ARCH] = family_parts["9a_moe_serve"]
    torch.cuda.empty_cache()
    print("== phase 10: training on the card")
    t10 = time.perf_counter()
    grad_launches = kernel_gradients(torch, ops, dev, train_results)
    train_parts, train_step = {}, {}
    train_parts["10b_train_step"], train_step = train_step_run(torch, ops,
                                                              dev)
    train_parts["10c_mamba2"] = family_gradients(
        torch, ops, dev, "mamba2-780m", 8, 2, 512, ("ssd_scan",))
    train_parts["10c_recurrentgemma"] = family_gradients(
        torch, ops, dev, "recurrentgemma-2b", 6, 1, 2176,
        ("flash_attention", "rglru_scan"))
    train_parts["10c_qwen2_moe"] = family_gradients(
        torch, ops, dev, MOE_ARCH, 4, 2, 256, ("flash_attention",))
    train_parts["10d_checkpoint"], ckpt = checkpoint_resume(torch, ops, dev)
    train_step["checkpoint_10d"] = ckpt
    print(f"  phase 10 took {time.perf_counter() - t10:.1f} s; 10a "
          f"comparison launches {grad_launches}")
    print("== phase 11: the dry run, build_pipeline_cell, the examples")
    t11 = time.perf_counter()
    dry = {"11a_sweep": dryrun_sweep()}
    dry["11b_vs_card"] = dryrun_vs_card(torch, dev, train_step, smi)
    phase11_parts, dry["11c_pipeline_cell"] = pipeline_cell_on_card(
        torch, ops, dev)
    ex_counts, dry["11d_example_s"] = examples_on_card(torch, ops)
    phase11_parts.update(ex_counts)
    dry["phase_11_s"] = time.perf_counter() - t11
    print(f"  phase 11 took {dry['phase_11_s']:.1f} s")
    print("== phase 12: training across cards (process group, DTensors)")
    t12 = time.perf_counter()
    distributed = {}
    train_parts["12a"], distributed["12a"] = sharded_train(
        torch, ops, train_step, 1, "12a")
    distributed["12b"] = sharded_train_cpu(torch)
    distributed["12d"] = sharded_rows_cpu(torch)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        train_parts["12c"], distributed["cross_card"] = sharded_train(
            torch, ops, train_step, min(n_cards, 4), "12c")
    else:
        distributed["cross_card"] = f"not run: {n_cards} card"
        print(f"  12c cross_card: {distributed['cross_card']}")
    distributed["nvidia_smi"] = smi
    distributed["phase_12_s"] = time.perf_counter() - t12
    print(f"  phase 12 took {distributed['phase_12_s']:.1f} s")
    print(f"== all phases passed in {time.perf_counter() - t_all:.1f} s")

    kernels = []
    for mod in (dec, fa, lm, ssd, rg, rn, rp, ssm):
        name = mod.__name__.rsplit(".", 1)[1]
        r = results[name]
        # launches: every serve run of phase 5 whose path runs the kernel
        by_arch = {arch: c[name] for arch, c in serve_counts.items()
                   if c[name]}
        rec_by_arch = {arch: r["launches"][name]
                       for arch, r in recovered.items()
                       if r["launches"][name]}
        entry = {"name": name, "route": "cuda", "source": mod.SOURCE,
                 "replaces": mod.REPLACES,
                 "launches": sum(by_arch.values()),
                 "launches_by_arch": by_arch,
                 "recovery_launches": sum(rec_by_arch.values()),
                 "recovery_launches_by_arch": rec_by_arch,
                 # launches of phase 7's entry point (launch.serve
                 # --cluster), and of each of its parts
                 "cluster_launches": cli["counts"][name],
                 "cluster_launches_by_part": {
                     part: c[name] for part, c in cluster_parts.items()},
                 # launches of phase 8's belt runs, and of each of its parts
                 "pipeline_launches": sum(c[name]
                                          for c in pipe_parts.values()),
                 "pipeline_launches_by_part": {
                     part: c[name] for part, c in pipe_parts.items()},
                 # launches of phase 9's parts (9a, the MoE serve, is
                 # also in launches_by_arch)
                 "families_launches_by_part": {
                     part: c[name] for part, c in family_parts.items()},
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "kernel_ms": r["ms"], "host_paced_ms": r["paced_ms"],
                 "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r["library_ms"]}
        for extra in ("at_recurrentgemma", "at_s64", "at_qwen2_moe",
                      "at_hubert", "no_residual", "unequal", "at_mamba2"):
            if extra in r:
                entry[extra] = r[extra]
        # launches of phase 10's and 12's train runs (10b the train step,
        # 10c the families, 10d the checkpoint and resume, 12a the train
        # step under torchrun on DTensors; rank 0's); 10a's comparison
        # launches are not counted
        entry["train_launches"] = sum(c[name] for c in train_parts.values())
        entry["train_launches_by_part"] = {
            part: c[name] for part, c in train_parts.items()}
        # launches of phase 11's card runs (11c the pipeline cell, 11d
        # the examples); the dry run of 11a and 11b launches nothing
        entry["phase11_launches"] = sum(c[name]
                                        for c in phase11_parts.values())
        entry["phase11_launches_by_part"] = {
            part: c[name] for part, c in phase11_parts.items()}
        if name in train_results:
            t = train_results[name]
            entry["backward_ms"] = t["backward_ms"]
            entry["backward_route"] = t["backward_route"]
            entry["train_timing"] = t
        kernels.append(entry)
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"pipeline_belt_timings": belt_ms}))
    print(json.dumps({"moe_decode_step": moe_step}))
    print(json.dumps({"train_step": train_step}))
    print(json.dumps({"dryrun": dry}))
    print(json.dumps({"train_distributed": distributed}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--train-worker"]:   # a rank of phase 12
            sys.exit(train_worker(sys.argv[2], sys.argv[4:]))
        if sys.argv[1:2] == ["--rows-worker"]:    # a rank of phase 12d
            sys.exit(rows_worker(sys.argv[2]))
        sys.exit(main())
    except Exception:                   # any failed phase: no result line
        traceback.print_exc()
        sys.exit(1)
