"""phi3.5-moe-42b-a6.6b — 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    n_experts=16,
    n_shared_experts=0,
    top_k=2,
    moe_d_ff=6400,
    rope_theta=1e4,
    source="[hf:microsoft/Phi-3.5-MoE-instruct; hf]",
)
