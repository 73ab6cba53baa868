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
   type (989 TFLOP/s bf16, 67 TFLOP/s float32).  Decode and flash attention are
   timed at opt-1.3b's shapes and again at recurrentgemma-2b's (decode
   with its split count printed); the SSD and RG-LRU scans at one
   512-token prefill and again at a 64-token one (a short serving prompt).
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

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
ATTN_TOL = 2e-2
SSD_BF16_REL = 2.0 ** -8     # SSD bf16 y: share of |plain y| ...
SSD_BF16_MEAN = 1e-2         # ... plus this share of mean |plain y|
SSD_F32_TOL = 2e-5           # SSD float32 y: share of max |plain y|
SSD_STATE_TOL = 1e-4         # SSD final state: share of max |plain state|
RGLRU_TOL = 1e-5             # RG-LRU y and h_T: share of max |plain|
LOGIT_REL_TOL = 2.5e-2       # model logits: share of max |plain logit|
FLOOR_MULT = 2.0             # recurrent models: multiple of the noise floor
L2_BYTES = 50 * 2 ** 20


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


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    }
    # the edges of the cache splits: lens at 1, one split's width, one
    # more, C - 1 (qwen3 at a C that is not a multiple of the width); then
    # every row empty (every split empty)
    for tag, Cx, Hq, Hkv, d in (("opt", C, 32, 32, 64),
                                ("qwen3 GQA C=1000", 1000, 16, 8, 128),
                                ("recurrentgemma G10 hd256", C, 10, 1, 256)):
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
        valid = sum(lens)
        moved = (nbytes(x["q"], x["kn"], x["vn"], x["lens"], x["sm"])
                 + 2 * valid * Hkv * d * 2                 # valid K/V rows
                 + B * Hq * d * 2)                         # out
        flops = 4 * Hq * d * (valid + (B if fold else 0))
        b_ms, b_by = bound(moved, flops, "bfloat16")
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
    results["decode_attention"] = dict(max_abs_err=worst, **main,
                                       at_recurrentgemma=rg)


def check_flash(torch, ops, dev, results):
    g = torch.Generator(device=dev).manual_seed(11)
    bf = torch.bfloat16

    def make(B, Sq, Sk, Hq, Hkv, d):
        return [torch.randn(shape, generator=g, device=dev).to(bf)
                for shape in ((B, Sq, Hq, d), (B, Sk, Hkv, d),
                              (B, Sk, Hkv, d))]

    def run(x, kw, plain=False):
        f = (lambda t: t.float()) if plain else (lambda t: t)
        return ops.flash_attention(f(x[0]), f(x[1]), f(x[2]), causal=True,
                                   **kw)

    cases = []
    for tag, Hq, Hkv, d in (("opt", 32, 32, 64), ("qwen3", 16, 8, 128),
                            ("recurrentgemma", 10, 1, 256)):
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
    worst = 0.0
    for name, spec, kw in cases:
        x = make(*spec)
        out = run(x, kw)
        torch.cuda.synchronize()
        with ops.plain_versions():
            ref = run(x, kw, plain=True)
        err = (out.float() - ref).abs().max().item()
        print(f"  flash {name}: max|kernel - plain| = {err:.3e}")
        require(err <= ATTN_TOL, f"flash {name}: {err} > {ATTN_TOL}")
        worst = max(worst, err)

    def timed(label, spec):
        B, Sq, Sk, Hq, Hkv, d = spec
        sets = [make(*spec)
                for _ in range(n_copies(4 * B * Sq * Hq * d * 2))]
        ms, paced_ms = time_ms(torch, f"flash kernel {label}",
                               [lambda s=s: run(s, {}) for s in sets], 100)
        with ops.plain_versions():
            plain_ms, _ = time_ms(torch, f"flash plain {label}",
                                  [lambda s=s: run(s, {}) for s in sets], 2)
        F = torch.nn.functional
        lib_sets = [[t.transpose(1, 2).contiguous() for t in s]
                    for s in sets]
        library_ms, _ = time_ms(torch, f"flash SDPA {label}", [
            lambda a=a: F.scaled_dot_product_attention(
                a[0], a[1], a[2], is_causal=True, enable_gqa=Hq != Hkv)
            for a in lib_sets], 50)
        pairs = Sq * (Sq + 1) // 2           # causal (q, k) pairs per head
        moved = 2 * nbytes(sets[0][0]) + nbytes(sets[0][1], sets[0][2])
        flops = 4 * B * Hq * d * pairs
        b_ms, b_by = bound(moved, flops, "bfloat16")
        print(f"  flash timed {label} {spec} causal: kernel {ms:.4f} ms "
              f"(host-paced {paced_ms:.4f} ms), plain {plain_ms:.4f} ms, "
              f"SDPA {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        return dict(ms=ms, paced_ms=paced_ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)

    # opt-1.3b's prefill at bucket 512; recurrentgemma's one 512-token
    # prompt (its prompts prefill one by one)
    main = timed("opt-1.3b", (4, 512, 512, 32, 32, 64))
    rg = timed("recurrentgemma-2b", (1, 512, 512, 10, 1, 256))
    results["flash_attention"] = dict(max_abs_err=worst, **main,
                                      at_recurrentgemma=rg)


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
    moved = 2 * nbytes(W) + nbytes(A, B)
    flops = L * D * D * (2 * r + 1)
    b_ms, b_by = bound(moved, flops, "float32")
    print(f"  lora timed: kernel {ms:.4f} ms (host-paced {paced_ms:.4f} "
          f"ms), plain {plain_ms:.4f} ms, baddbmm {library_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})")
    results["lora_merge"] = dict(max_abs_err=err, ms=ms, paced_ms=paced_ms,
                                 plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=library_ms)


def check_ssd(torch, ops, dev, results):
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
        # bytes: each input read once, y and the final state written
        # once; operations: per chunk of q rows (64, the SSD kernel's
        # chunk), the causal pairs of C B^T once, and per head G x over
        # the pairs, C state and the state update x^T B
        moved = (2 * nbytes(x[0]) + nbytes(x[1], x[2], x[3], x[4])
                 + B * H * P * N * 4)
        flops = 0
        for t0 in range(0, S, 64):
            q = min(64, S - t0)
            pairs = q * (q + 1) // 2
            flops += B * (2 * N * pairs
                          + H * (2 * P * pairs + 4 * q * P * N))
        b_ms, b_by = bound(moved, flops, "bfloat16")
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
        # bytes: log_a and bx read once, y and h_T written once;
        # operations: one exp and one multiply-add per element
        moved = nbytes(*x) + B * S * W * 4 + B * W * 4
        flops = 3 * B * S * W
        b_ms, b_by = bound(moved, flops, "float32")
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
            "rglru_scan": counts_by_kind.get("rec", 0)}
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

def end_to_end(torch, ops, arch, adapters, kernels):
    """Serve 8 requests of ``arch`` at full width; ``kernels`` are the
    kernels of its path, each of which must launch (the others must
    not)."""
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
    if "ssm" in by_kind or "rec" in by_kind:
        # a recurrent state: each prompt prefills alone, once through
        # every layer
        n_prefills = int(res.hotpath["n_prefill_calls"])
        want = {"ssd_scan": 8 * by_kind.get("ssm", 0),
                "rglru_scan": 8 * by_kind.get("rec", 0),
                "flash_attention": 8 * by_kind.get("attn", 0)}
        require(n_prefills == 8
                and all(counts[k] == n for k, n in want.items()),
                f"{n_prefills} prefill calls, launches {counts}, expected "
                f"{want}")
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
    from repro_torch.core.kv_reconstruct import _kind_indices
    srv = _server(S, cfg, params)
    reqs = _requests(S, prompts)
    _serve_to_cut(srv, reqs)
    for gi, (kind, ki, ai) in enumerate(_kind_indices(cfg)):
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
    from repro_torch.kernels import ssd_scan as ssd

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
    require(len(flash_tc) == 3 and all(
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
    results = {}
    check_decode(torch, ops, dev, results)
    check_flash(torch, ops, dev, results)
    check_lora(torch, ops, dev, results)
    check_ssd(torch, ops, dev, results)
    check_rglru(torch, ops, dev, results)
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
            ("decode_attention", "flash_attention", "lora_merge")),
        "mamba2-780m": end_to_end(torch, ops, "mamba2-780m", 0,
                                  ("ssd_scan",)),
        "recurrentgemma-2b": end_to_end(
            torch, ops, "recurrentgemma-2b", 0,
            ("decode_attention", "flash_attention", "rglru_scan")),
    }

    print("== phase 6: recovery")
    recovered = {
        "pipeboost-opt-1.3b": recovery(
            torch, ops, dev, "pipeboost-opt-1.3b", 2,
            ("decode_attention", "flash_attention", "lora_merge"),
            ("flash_attention",)),
        "mamba2-780m": recovery(torch, ops, dev, "mamba2-780m", 0,
                                ("ssd_scan",), ("ssd_scan",)),
        "recurrentgemma-2b": recovery(
            torch, ops, dev, "recurrentgemma-2b", 0,
            ("decode_attention", "flash_attention", "rglru_scan"),
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
    print(f"== all phases passed in {time.perf_counter() - t_all:.1f} s")

    kernels = []
    for mod in (dec, fa, lm, ssd, rg):
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
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "kernel_ms": r["ms"], "host_paced_ms": r["paced_ms"],
                 "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r["library_ms"]}
        for extra in ("at_recurrentgemma", "at_s64"):
            if extra in r:
                entry[extra] = r[extra]
        kernels.append(entry)
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:                   # any failed phase: no result line
        traceback.print_exc()
        sys.exit(1)
