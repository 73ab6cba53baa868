"""PipeBoost's pipeline prefill belt (paper §4.3; the port of
``repro/distributed/pipeline.py``).

Stage *i* holds a contiguous slice of the stacked layers; microbatches flow
stage -> stage on a GPipe belt [arXiv:1811.06965]:

    tick t:  stage s runs microbatch t - s through its L / n_stages layers.

The reference is one ``shard_map`` program over a ('data', 'stage') mesh of
XLA devices.  Its counterpart here is one Python controller over a grid of
``torch.device``s (``StageMesh``): every stage of every data row is issued
from this thread.  On CUDA each stage runs on its own stream (one a device
and stage index for the life of the process, ``stage_stream``), a hop
copies the ``(mb, S, D)`` belt into the next stage's receive buffer on the
receiving stream after it waits for the sender, and the caller's stream
waits for every stage before the function returns.  The grid may name one
card several times: on one H100 the stages are concurrent streams, on a
host with several cards the same code runs them on separate cards.  On the
CPU the same loop runs in order.  Off-belt stages do nothing (the
reference's compute on a zeros belt is an SPMD artefact whose results it
discards).

The layers are the model's own (``transformer.attn_layer_fwd``,
``mamba2.ssm_block_fwd``), so every attention or MoE stage runs the flash
kernel and every SSM stage the SSD scan on the card.  An MoE layer routes
the tokens of the block it is given: each microbatch (GPipe) or chunk
(sequence-chunk belt) has its own routing and capacity, exactly as the
reference's belts compute them, so where capacity binds the belt's result
differs from ``forward``'s over the whole batch.  With ``return_cache=True``
each stage writes its layers' state straight into a cache of
``transformer.init_cache``'s layout, at its layer range and the
microbatch's rows: the same keys, shapes and dtypes as
``forward(mode="prefill")`` returns, so the serving batcher's scatter and
its captured decode step take it as it is.

Uniform layer stacks only: the hybrid pattern is refused, as the reference
refuses it.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2, transformer

Lane = Tuple[int, int]          # (data row, stage)


def visible_devices() -> List[torch.device]:
    """The CUDA cards this process sees (none on a CPU-only host)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _as_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclass(frozen=True)
class StageMesh:
    """An (n_data, n_stages) grid of devices: row d is data replica d's
    chain of stages.  A device may appear several times."""
    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "stage": len(self.devices[0])}

    def flat(self) -> List[torch.device]:
        return [d for row in self.devices for d in row]


def stage_mesh(n_stages: int, n_data: Optional[int] = None,
               devices: Optional[Sequence] = None) -> StageMesh:
    """('data', 'stage') grid over the first ``n_data * n_stages`` of
    ``devices`` (default: ``visible_devices()``).  Like the reference's, it
    may use a SUBSET of the pool: after a 4 -> 3 shrink, 3 stages run on a
    pool of 4.  ``n_data`` defaults to the most replicas that fit."""
    devs = [_as_device(d) for d in (visible_devices() if devices is None
                                    else devices)]
    if n_stages < 1:
        raise ValueError(f"stage_mesh: {n_stages=}")
    if n_data is None:
        n_data = max(1, len(devs) // n_stages)
    need = n_data * n_stages
    if need > len(devs):
        raise ValueError(f"stage_mesh({n_stages=}, {n_data=}) needs {need} "
                         f"devices, have {len(devs)}")
    if len({d.type for d in devs[:need]}) != 1:
        raise ValueError("stage_mesh: devices of one type only")
    return StageMesh(tuple(tuple(devs[r * n_stages:(r + 1) * n_stages])
                           for r in range(n_data)))


def _uniform_kind(cfg: ArchConfig) -> str:
    kinds = set(cfg.layer_kinds())
    if len(kinds) != 1:
        raise ValueError(
            f"pipeline lowering needs a uniform layer stack; {cfg.name} has "
            f"{sorted(kinds)} (hybrid pipelines run via core/engine.py)")
    return next(iter(kinds))


_STAGE_STREAMS: Dict[Tuple[torch.device, int], "torch.cuda.Stream"] = {}


def stage_stream(device: torch.device, stage: int) -> "torch.cuda.Stream":
    """The stream of ``stage`` on ``device``, made once a process and shared
    by every belt: cuBLAS keeps a workspace (32 MiB on Hopper) for each
    stream it ever ran on, so streams made per belt or per server would
    leak one each."""
    key = (device, stage)
    if key not in _STAGE_STREAMS:
        _STAGE_STREAMS[key] = torch.cuda.Stream(device)
    return _STAGE_STREAMS[key]


class _Lanes:
    """The lanes of one belt run.  Lane (d, s) runs on the mesh's device
    (d, s): on CUDA on its stage's stream, on the CPU in order on the
    calling thread."""

    def __init__(self, mesh: StageMesh, out_device: torch.device):
        self.mesh = mesh
        self.out_device = out_device
        self.cuda = mesh.devices[0][0].type == "cuda"
        self.streams = ({(d, s): stage_stream(dev, s)
                         for d, row in enumerate(mesh.devices)
                         for s, dev in enumerate(row)} if self.cuda else {})
        self.held: List[torch.Tensor] = []

    def device(self, lane: Lane) -> torch.device:
        return self.mesh.devices[lane[0]][lane[1]]

    def start(self) -> None:
        """Every stage stream waits for the work queued so far on its
        device and the caller's (inputs, params, the zeroed outputs)."""
        for lane, st in self.streams.items():
            st.wait_stream(torch.cuda.current_stream(self.device(lane)))
            if self.out_device.type == "cuda":
                st.wait_stream(torch.cuda.current_stream(self.out_device))

    def on(self, lane: Lane):
        st = self.streams.get(lane)
        return torch.cuda.stream(st) if st is not None \
            else contextlib.nullcontext()

    def hop(self, x: torch.Tensor, buf: torch.Tensor, src: Lane,
            dst: Lane) -> None:
        """Copy ``x`` (made on ``src``) into ``dst``'s receive buffer, on
        ``dst``'s stream once ``src`` has made it."""
        if not self.cuda:
            buf.copy_(x)
            return
        s_dst = self.streams[dst]
        s_dst.wait_stream(self.streams[src])
        with torch.cuda.stream(s_dst):
            buf.copy_(x, non_blocking=True)
        # x was allocated on src's stream: keep its block from src's reuse
        # until dst's copy is done (across cards, until the join)
        if x.device == buf.device:
            x.record_stream(s_dst)
        else:
            self.held.append(x)

    def join(self) -> None:
        """The caller's stream (and each stage device's current stream)
        waits for every stage."""
        for lane, st in self.streams.items():
            torch.cuda.current_stream(self.device(lane)).wait_stream(st)
            if self.out_device.type == "cuda":
                torch.cuda.current_stream(self.out_device).wait_stream(st)
        self.held.clear()


def _to(tree, dev: torch.device):
    """``tree``'s tensors on ``dev`` (the tensors themselves when they are
    there already, so a mesh over the params' device copies nothing)."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _stage_layers(params, kind: str, per: int, mesh: StageMesh):
    """Per lane (d, s): the views of stage s's ``per`` layers on its
    device."""
    stacked = params["blocks"][kind]
    return {(d, s): [_to(transformer.layer_params(stacked, i), dev)
                     for i in range(s * per, (s + 1) * per)]
            for d, row in enumerate(mesh.devices)
            for s, dev in enumerate(row)}


def _head(cfg: ArchConfig, params, x_last: torch.Tensor) -> torch.Tensor:
    """Final norm and unembed of (mb, 1, D) -> float32 (mb, V)."""
    dev = x_last.device
    head = {"embed": params["embed"].to(dev)}
    if not cfg.tie_embeddings:
        head["lm_head"] = params["lm_head"].to(dev)
    xl = transformer._apply_norm(cfg, _to(params["final_norm"], dev), x_last)
    return transformer.unembed(cfg, head, xl)[:, 0]


def _inputs(batch) -> torch.Tensor:
    """The batch's (B, S) tokens, or its (B, S, D) embeddings."""
    return batch["embeds"] if "embeds" in batch else batch["tokens"]


def _stage0_input(batch, embed0, rows, cols, dev):
    """Stage 0's block: rows ``rows`` and positions ``cols`` of the batch,
    embedded (tokens) or as given (embeds), on ``dev``."""
    if "embeds" in batch:
        return batch["embeds"][rows, cols].to(dev)
    return embed0[batch["tokens"][rows, cols].to(dev)]


def _check_grid(cfg: ArchConfig, mesh: StageMesh, n_stages: int,
                B: int, S: int, seq_len: int, per_row: int) -> None:
    if mesh.shape["stage"] != n_stages:
        raise ValueError(f"mesh has {mesh.shape['stage']} stages, belt "
                         f"{n_stages}")
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers over {n_stages} stages")
    if S != seq_len:
        raise ValueError(f"belt built for S={seq_len}, got {S}")
    if B % (mesh.shape["data"] * per_row):
        raise ValueError(f"batch {B} does not split over "
                         f"{mesh.shape['data']} data rows x {per_row}")


def build_pipeline_prefill(cfg: ArchConfig, *, n_stages: int, n_micro: int,
                           mesh: StageMesh, seq_len: int,
                           max_len: Optional[int] = None,
                           return_cache: bool = False) -> Callable:
    """Returns f(params, batch) -> last-token logits (B, V) float32, or
    with ``return_cache=True`` (logits, cache).

    batch: {"tokens": (B, S)} or {"embeds": (B, S, D)}, and optionally
    {"last_index": (B,)}: per-row true last prompt token of right-padded
    prompts; logits are gathered there and ``cache["pos"]`` is
    ``last_index + 1`` (else S), as ``transformer.forward(last_index=...)``
    does (attention-only).  M-RoPE models are refused: this belt has no
    (t, h, w) position stream (the reference's passes (B, S) positions to
    M-RoPE and fails).

    B splits over the mesh's data rows (row d takes rows [d B/n_data,
    (d+1) B/n_data)) and each row's share into ``n_micro`` microbatches.
    The cache is ``transformer.init_cache``'s, attention K/V sized to
    ``attn_cache_capacity(cfg, max_len)`` (ring-rolled when windowed), on
    the inputs' device."""
    kind = _uniform_kind(cfg)
    if kind not in ("attn", "moe", "ssm"):
        raise ValueError(f"pipeline belt: layer kind {kind!r}")
    if cfg.mrope:
        raise ValueError(f"{cfg.name}: the GPipe belt has no M-RoPE "
                         f"position stream")

    def f(params, batch):
        last_index = batch.get("last_index")
        B, S = _inputs(batch).shape[:2]
        _check_grid(cfg, mesh, n_stages, B, S, seq_len, n_micro)
        n_data = mesh.shape["data"]
        Bl = B // n_data
        mb = Bl // n_micro
        out_dev = _inputs(batch).device
        dtype = params["embed"].dtype
        logits = torch.empty((B, cfg.padded_vocab), dtype=torch.float32,
                             device=out_dev)
        cache = (transformer.init_cache(cfg, B, max_len or S, dtype,
                                        out_dev) if return_cache else None)
        lanes = _Lanes(mesh, out_dev)
        lanes.start()
        per = cfg.n_layers // n_stages
        layers = _stage_layers(params, kind, per, mesh)
        recv: Dict[Lane, torch.Tensor] = {}
        positions: Dict[Lane, torch.Tensor] = {}
        for lane in layers:
            dev = lanes.device(lane)
            with lanes.on(lane):
                if lane[1] > 0:
                    recv[lane] = torch.empty((mb, S, cfg.d_model),
                                             dtype=dtype, device=dev)
                positions[lane] = torch.arange(
                    S, device=dev)[None, :].expand(mb, S)
        embed0 = [params["embed"].to(row[0]) for row in mesh.devices]

        def run(lane: Lane, m: int):
            d, s = lane
            dev = lanes.device(lane)
            rows = slice(d * Bl + m * mb, d * Bl + (m + 1) * mb)
            x = (_stage0_input(batch, embed0[d], rows, slice(None), dev)
                 if s == 0 else recv[lane])
            for j, p in enumerate(layers[lane]):
                i = s * per + j
                if kind == "ssm":
                    x, states = mamba2.ssm_block_fwd(cfg, p, x)
                    if cache is not None:   # leaves in the block's order
                        for leaf, st in zip(cache["ssm"], states):
                            cache["ssm"][leaf][i, rows].copy_(st)
                else:
                    x, kv, _ = transformer.attn_layer_fwd(cfg, p, x,
                                                          positions[lane])
                    if cache is not None:   # into the zeroed cache
                        for leaf, t in zip(("k", "v"), kv):
                            dst = cache["attn"][leaf][i, rows]
                            transformer._place_kv(dst, t, dst.shape[1])
            if s < n_stages - 1:
                return x
            if last_index is not None:
                li = last_index[rows].to(dev).long()
                x_last = x[torch.arange(mb, device=dev), li][:, None]
            else:
                x_last = x[:, -1:]
            logits[rows].copy_(_head(cfg, params, x_last))
            return None

        _run_belt(lanes, mesh, n_micro, n_stages, run, recv)
        if cache is None:
            return logits
        if last_index is not None:
            cache["pos"] = (torch.as_tensor(last_index, device=out_dev)
                            .to(torch.int32) + 1)
        else:
            cache["pos"] = torch.full((B,), S, dtype=torch.int32,
                                      device=out_dev)
        return logits, cache

    return f


def _run_belt(lanes: _Lanes, mesh: StageMesh, n_micro: int, n_stages: int,
              run: Callable, recv: Dict[Lane, torch.Tensor]) -> None:
    """The belt's ticks: at tick t every stage s with a microbatch t - s on
    the belt runs it (``run(lane, m)`` returns the output to hand on, None
    at the last stage); then every output hops to the next stage's receive
    buffer, which that stage reads at tick t + 1.  A stage's read of its
    buffer and the next hop into it are queued in that order on its own
    stream."""
    for t in range(n_micro + n_stages - 1):
        outs = []
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < n_micro:
                continue                       # off the belt: idle
            for d in range(mesh.shape["data"]):
                with lanes.on((d, s)):
                    x = run((d, s), m)
                if x is not None:
                    outs.append(((d, s), x))
        for (d, s), x in outs:
            lanes.hop(x, recv[(d, s + 1)], (d, s), (d, s + 1))
    if lanes.cuda:
        lanes.join()


def _attn_layer_chunk(cfg: ArchConfig, p, x, positions, k_buf, v_buf,
                      q_off: int):
    """One attention (or MoE) layer over a chunk of queries at ``q_off``:
    its roped K/V land in the layer's (B, S, Hkv, hd) buffers at [q_off,
    q_off + chunk), and the chunk attends causally to [0, q_off + chunk)
    of them (the flash kernel with ``q_offset``, Sk > Sq).  An MoE FFN
    routes the chunk's tokens with the chunk's capacity."""
    end = q_off + x.shape[1]
    h = transformer._apply_norm(cfg, p["ln1"], x)
    q, k, v = transformer._project_qkv(cfg, p, h)
    q = transformer.rope(cfg, q, positions)
    k_buf[:, q_off:end] = transformer.rope(cfg, k, positions)
    v_buf[:, q_off:end] = v
    o = attn_lib.attention(q, k_buf[:, :end], v_buf[:, :end], causal=True,
                           window=cfg.attn_window, q_offset=q_off)
    return transformer.attn_out_ffn(cfg, p, x, o)[0]


def build_pipeline_prefill_seqchunk(cfg: ArchConfig, *, n_stages: int,
                                    n_chunks: int, mesh: StageMesh,
                                    seq_len: int) -> Callable:
    """TeraPipe-style belt [arXiv:2102.07988]: the microbatches are
    SEQUENCE CHUNKS of the same requests, not batch splits, so a batch of
    one still fills the belt.  Each stage keeps the K/V of its layers for
    the chunks it has seen and each chunk attends causally over them; the
    belt carries one (B/n_data, chunk, D) block a tick.  Attention and MoE
    stacks.  Returns f(params, {"tokens": (B, S)} or {"embeds": (B, S,
    D)}) -> last-token logits (B, V).  An M-RoPE model gets the
    reference's text-like stub stream: t = h = w = the position."""
    kind = _uniform_kind(cfg)
    if kind not in ("attn", "moe"):
        raise ValueError("seq-chunk pipeline needs attention KV semantics")
    if seq_len % n_chunks:
        raise ValueError(f"{seq_len=} does not split into {n_chunks} chunks")
    chunk = seq_len // n_chunks
    hd = cfg.resolved_head_dim

    def f(params, batch):
        B, S = _inputs(batch).shape[:2]
        _check_grid(cfg, mesh, n_stages, B, S, seq_len, 1)
        Bl = B // mesh.shape["data"]
        out_dev = _inputs(batch).device
        dtype = params["embed"].dtype
        logits = torch.empty((B, cfg.padded_vocab), dtype=torch.float32,
                             device=out_dev)
        lanes = _Lanes(mesh, out_dev)
        lanes.start()
        per = cfg.n_layers // n_stages
        layers = _stage_layers(params, kind, per, mesh)
        recv: Dict[Lane, torch.Tensor] = {}
        kv: Dict[Lane, torch.Tensor] = {}
        for lane in layers:
            dev = lanes.device(lane)
            with lanes.on(lane):
                if lane[1] > 0:
                    recv[lane] = torch.empty((Bl, chunk, cfg.d_model),
                                             dtype=dtype, device=dev)
                kv[lane] = torch.empty((per, 2, Bl, S, cfg.n_kv_heads, hd),
                                       dtype=dtype, device=dev)
        embed0 = [params["embed"].to(row[0]) for row in mesh.devices]

        def run(lane: Lane, c: int):
            d, s = lane
            dev = lanes.device(lane)
            rows = slice(d * Bl, (d + 1) * Bl)
            q_off = c * chunk
            positions = (q_off + torch.arange(chunk, device=dev))[
                None, :].expand(Bl, chunk)
            if cfg.mrope:       # the text-like stub stream: t = h = w
                positions = positions[..., None].expand(Bl, chunk, 3)
            x = (_stage0_input(batch, embed0[d], rows,
                               slice(q_off, q_off + chunk), dev)
                 if s == 0 else recv[lane])
            for j, p in enumerate(layers[lane]):
                x = _attn_layer_chunk(cfg, p, x, positions, kv[lane][j, 0],
                                      kv[lane][j, 1], q_off)
            if s < n_stages - 1:
                return x
            if c == n_chunks - 1:
                logits[rows].copy_(_head(cfg, params, x[:, -1:]))
            return None

        _run_belt(lanes, mesh, n_chunks, n_stages, run, recv)
        return logits

    return f


def build_pipeline_cell(cfg: ArchConfig, shape: ShapeConfig, *,
                        total_chips: int = 256, n_micro: Optional[int] = None,
                        seq_chunk: bool = False,
                        mesh: Optional[StageMesh] = None
                        ) -> Tuple[Callable, tuple]:
    """Dry-run entry: returns (belt fn, (params, batch) as meta tensors)
    for the pipeline prefill of one (arch x shape) cell.

    The cell's ('data', 'stage') mesh is ``make_pipeline_mesh``'s over
    ``total_chips``: ``pipeline_stages_for(n_layers)`` stages, the data
    rows halved until they divide the batch (idle replicas rather than an
    unshardable batch).  The belt runs over ``mesh`` when one is given
    (on one card: a stage a stream), else over a grid of meta devices of
    the described shape.  ``fn.mesh`` is the description, ``fn.n_micro``
    the microbatches (GPipe) or chunks (sequence-chunk belt) it runs."""
    from repro_torch.launch.mesh import (make_pipeline_mesh,
                                         pipeline_stages_for)
    if shape.kind != "prefill":
        raise ValueError("pipeline lowering targets the prefill (TTFT) step")
    n_stages = pipeline_stages_for(cfg.n_layers)
    B = shape.global_batch
    n_data = total_chips // n_stages
    while n_data > 1 and B % n_data != 0:
        n_data //= 2        # idle replicas rather than unshardable batch
    described = make_pipeline_mesh(n_stages, total=n_data * n_stages)
    n_micro = n_micro or max(2, min(8, B // max(1, n_data)))
    if mesh is None:
        mesh = stage_mesh(n_stages, n_data,
                          devices=[torch.device("meta")] * described.size)

    meta = torch.device("meta")
    params_struct = transformer.init_params(cfg, torch.Generator(),
                                            torch.bfloat16, meta)
    if cfg.family in ("audio", "vlm"):
        batch_struct = {"embeds": torch.empty(
            (B, shape.seq_len, cfg.d_model), dtype=torch.bfloat16,
            device=meta)}
    else:
        batch_struct = {"tokens": torch.empty((B, shape.seq_len),
                                              dtype=torch.int32,
                                              device=meta)}

    if seq_chunk:
        n_micro = max(n_stages, 8)
        f = build_pipeline_prefill_seqchunk(
            cfg, n_stages=n_stages, n_chunks=n_micro, mesh=mesh,
            seq_len=shape.seq_len)
    else:
        f = build_pipeline_prefill(cfg, n_stages=n_stages, n_micro=n_micro,
                                   mesh=mesh, seq_len=shape.seq_len)
    f.mesh = described
    f.n_micro = n_micro
    return f, (params_struct, batch_struct)
