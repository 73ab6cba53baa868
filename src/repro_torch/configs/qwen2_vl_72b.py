"""qwen2-vl-72b — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Backbone only; the vision patch frontend is a STUB (``input_specs()``
provides precomputed patch/text embeddings and 3-section M-RoPE position
ids (B, S, 3)).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    source="[arXiv:2409.12191; hf]",
)
