"""granite-4.0-h-small in the harness: its reference module's three hooks
at full size, its chunked SSM against the step-by-step recurrence, its
forward against the program's own float32 reference, one run of the cell
at tiny widths on the CPU, and the opt-chat traffic whose every seed
admits each request alone.  The guard holds ``reference/granite_hybrid.py``
as it holds every reference module (``test_pbbench_guard.py``), and here
the harness with it loaded."""
import dataclasses
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from pbb import check, costs, manifest, serve, traffic, weights
from reference import granite_hybrid as gh

NAME = "granite-4.0-h-small"
POINTS = ((1, 40), (7, 2613), (64, 98304))


def test_the_full_size_leaves_and_their_bytes():
    m = manifest.config(NAME)
    specs = weights.leaf_specs(m)
    by = {"/".join(s[0]): tuple(s[1]) for s in specs}
    assert len(specs) == 32
    assert by["blocks/ssm/in_proj"] == (18, 4096, 16768)
    assert by["blocks/ssm/conv_w"] == (18, 4, 8448)
    assert by["blocks/ssm/mlp/w_gate"] == (18, 72, 4096, 768)
    assert by["blocks/ssm/mlp/shared/w_down"] == (18, 1, 1536, 4096)
    assert by["blocks/moe/wk"] == (2, 4096, 1024)
    assert by["embed"] == (100352, 4096)
    n = sum(math.prod(s[1]) for s in specs)
    nbytes = sum(math.prod(s[1]) * (4 if s[3:] == ("float32",) else 2)
                 for s in specs)
    assert n == 16_309_191_936            # 16.31 B parameters
    assert nbytes == 32_618_397_696       # 30.38 GiB
    assert costs.attn_layers(m) == 2


# decode_step_cost at full size (pure arithmetic)
COSTS = {(1, 40): (9328735232.0, 8545635328.0),
         (7, 2613): (65377594368.0, 23348138274.626694),
         (64, 98304): (600176394240.0, 42406896280.462494)}


@pytest.mark.parametrize("point", POINTS)
def test_the_decode_step_cost(point):
    m = manifest.config(NAME)
    f, b = costs.decode_step_cost(m, *point)
    assert (f, b) == pytest.approx(COSTS[point], rel=1e-12)
    # every expert read: the bytes of the rest plus 72 experts' weights
    _, b_all = costs.decode_step_cost(m, *point, routed_read=72)
    hit = gh.expected_experts_hit(m, point[0])
    assert b_all - b == pytest.approx((72 - hit) * 20 * 3 * 4096 * 768 * 2)


def test_the_program_names_repeat_the_published_sizes():
    m = manifest.config(NAME)
    same = {"n_layers": "num_hidden_layers", "d_model": "hidden_size",
            "n_heads": "num_attention_heads",
            "n_kv_heads": "num_key_value_heads", "moe_d_ff": "intermediate_size",
            "n_experts": "num_local_experts", "top_k": "num_experts_per_tok",
            "ssm_state": "mamba_d_state", "ssm_head_dim": "mamba_d_head",
            "ssm_expand": "mamba_expand", "ssm_conv": "mamba_d_conv",
            "ssm_chunk": "mamba_chunk_size", "ssm_conv_bias": "mamba_conv_bias",
            "shared_d_ff": "shared_intermediate_size", "norm_eps": "rms_norm_eps",
            "tie_embeddings": "tie_word_embeddings"}
    for mine, published in same.items():
        assert m[mine] == m[published], mine
    assert m["head_dim"] * m["n_heads"] == m["hidden_size"]
    assert m["use_rope"] is False and m["position_embedding_type"] == "nope"
    assert m["mamba_n_heads"] * m["mamba_d_head"] == \
        m["mamba_expand"] * m["hidden_size"]
    cfg = serve.program_config(m)
    assert cfg.layer_kinds() == ["moe" if t == "attention" else "ssm"
                                 for t in gh.kinds(m)]


def test_the_chunked_ssm_is_the_recurrence():
    g = torch.Generator().manual_seed(3)
    S, H, P, N = 45, 3, 4, 5
    x = torch.randn(S, H, P, generator=g, dtype=torch.float64)
    dt = torch.rand(S, H, generator=g, dtype=torch.float64)
    A = -torch.rand(H, generator=g, dtype=torch.float64) * 4
    B = torch.randn(S, N, generator=g, dtype=torch.float64)
    C = torch.randn(S, N, generator=g, dtype=torch.float64)
    s = torch.zeros(H, P, N, dtype=torch.float64)
    want = []
    for t in range(S):
        s = torch.exp(dt[t] * A)[:, None, None] * s + \
            dt[t][:, None, None] * x[t][:, :, None] * B[t]
        want.append(s @ C[t])
    got = gh.ssd_chunked(x, dt, A, B, C, chunk=16)
    torch.testing.assert_close(got, torch.stack(want), rtol=1e-12,
                               atol=1e-12)


def tiny():
    """The configuration at widths the CPU runs in a moment, float32, both
    sets of names changed alike."""
    m = manifest.config(NAME)
    m.update(num_hidden_layers=10, n_layers=10, hidden_size=64, d_model=64,
             num_attention_heads=4, n_heads=4, num_key_value_heads=2,
             n_kv_heads=2, head_dim=16, intermediate_size=24, d_ff=24,
             moe_d_ff=24, num_local_experts=8, n_experts=8,
             num_experts_per_tok=3, top_k=3, shared_intermediate_size=40,
             shared_d_ff=40, mamba_d_state=16, ssm_state=16, mamba_d_head=16,
             ssm_head_dim=16, mamba_n_heads=8, vocab_size=300,
             mamba_chunk_size=16, ssm_chunk=16, dtype="float32",
             serving={"n_slots": 4, "max_len": 160,
                      "policy": {"epoch_budget": 4, "max_batch": 4}})
    return m


def test_the_reference_is_the_programs_reference():
    """The harness's copy and the program's copy of the equations, written
    apart, give the same logits on the harness's weights."""
    from repro_torch.reference import granite_hybrid as port_ref
    m = tiny()
    params = weights.make_params(m, weights.generator(2 ** 31 + 9, "cpu"),
                                 "cpu")
    toks = torch.from_numpy(traffic.stream(5, 1).integers(0, 300, 70))
    h = gh.final_hidden(m, params, [(toks, 70)])[0]
    ours = (h @ params["embed"][:300].float().T) / m["logits_scaling"]
    theirs = port_ref.forward(serve.program_config(m), params, toks)
    torch.testing.assert_close(ours, theirs, rtol=0, atol=1e-5 * float(
        theirs.abs().max()))


def test_a_tiny_run_of_the_cell_is_correct_and_reads_its_counters():
    """The cell's path on the CPU: the backlog admitted at exact lengths,
    decoded, checked against the reference (float32 both: no gap), the
    fp8 control off the reference's best, the new counters read."""
    from repro_torch.serving.tracing import TRACER
    TRACER.clear()
    m = tiny()
    spec = manifest.traffic("granite-rag-batch")
    spec["arrivals"]["requests"] = 8
    spec["prompt_len"].update(min=40, max=100)
    spec["output_len"].update(min=8, max=30)
    spec["check"]["per_adapter"] = 4
    seed = 2 ** 31 + 5
    srv, due, queued = serve.prepare(m, spec, seed, 10.0, "cpu")
    win = serve.run_window(srv, due, 6.0, queued)
    serve.release(srv)
    assert len(win.finished) == 8
    got = check.judge_run(srv, win.finished, seed, spec, control=True)
    assert got["gap_max"] == 0.0 and got["requests_checked"] >= 4
    assert got["control_gap_max"] > 0.0
    ctx = dataclasses.make_dataclass("C", ["m"])(m)
    assert manifest.reader("prefill_dropped.granite")(ctx) == 0
    ssm = 9 * 4 * 8 * 16 * 16 * 4     # 9 layers x 4 slots, (8, 16, 16) f32
    assert manifest.reader("ssm_state_gib")(ctx) == ssm / 2 ** 30
    TRACER.clear()


def test_opt_chat_gives_every_seed_the_same_gaps():
    spec = manifest.traffic("opt-chat")
    gaps = []
    for seed in range(1, 7):
        due = np.array([r.due for r in traffic.make(spec, seed, 51.0,
                                                     50272)])
        gaps.append(np.sort(np.round(np.diff(np.append(due, 51.0)), 9)))
    for g in gaps[1:]:
        np.testing.assert_allclose(g, gaps[0], atol=1e-8)
    assert len(gaps[0]) == 106 and gaps[0].min() >= 0.27


def test_the_harness_with_the_hybrid_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import pbb.runner, pbb.serve, pbb.check\n"
            "import reference.granite_hybrid\n"
            "pbb.serve._program()\n"
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'repro'}\n"
            "print(sorted(bad))" % (str(manifest.BENCH_DIR),
                                    str(manifest.ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
