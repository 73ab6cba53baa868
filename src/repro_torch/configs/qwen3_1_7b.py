"""qwen3-1.7b — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    source="[hf:Qwen/Qwen3-8B; hf]",
)
