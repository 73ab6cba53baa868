"""PipeBoost in PyTorch for NVIDIA Hopper (H100).

The port of the JAX package ``repro``: the same single-server request path
(pipelined cold start, bucketed prefill, zero-copy continuous-batched
decode captured once as a CUDA graph, merged-LoRA adapter epochs, and crash
recovery: KV snapshots, migration and in-place state reconstruction)
written in PyTorch, with the Pallas TPU
kernels replaced by hand-written CUDA C++ kernels for ``sm_90a``
(``repro_torch.kernels``).  Every entry point runs on the card unless the
caller passes ``device="cpu"``; on the CPU each kernel wrapper runs its
plain PyTorch version.

The package imports ``torch`` and numpy only — never ``jax`` and nothing
of ``repro`` — and keeps its own copy of every configuration and planner
module it needs.
"""
