"""granite-4.0-h-small — Mamba-2 + GQA NoPE hybrid, every mixer followed by
72 SwiGLU experts top-10 and a shared SwiGLU MLP
[hf:ibm-granite/granite-4.0-h-small; hf].

40 layers in four periods of ten: Mamba-2 mixers (kind ``ssm``: 128 heads of
64, state 128, one group, conv 4 with a bias) and at layers 5, 15, 25 and 35
an attention mixer without position embedding (kind ``moe``: 32 query
heads of 128 on 8 KV heads, scores scaled by 1/128).  Each mixer and each
FFN add their output to the residual scaled by 0.22; the embedding is
multiplied by 12 and the logits divided by 16.  Routing is top-10 of 72 with
no capacity (every assignment computed); the shared MLP (width 1536) is
added ungated by any sigmoid.
"""
from repro_torch.configs.base import ArchConfig

PERIOD = ("ssm",) * 5 + ("moe",) + ("ssm",) * 4

CONFIG = ArchConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=768,
    vocab_size=100352,
    n_experts=72,
    top_k=10,
    moe_d_ff=768,
    capacity_factor=0.0,
    shared_d_ff=1536,
    shared_gate=False,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=256,
    ssm_conv_bias=True,
    block_pattern=PERIOD,
    use_rope=False,
    attention_multiplier=0.0078125,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    rope_theta=10000.0,
    norm_eps=1e-5,
    tie_embeddings=True,
    source="[hf:ibm-granite/granite-4.0-h-small; hf]",
)
