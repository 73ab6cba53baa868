"""recurrentgemma-2b — RG-LRU + local attn, 1:2 [arXiv:2402.19427; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rec", "rec", "attn"),
    lru_width=2560,
    attn_window=2048,
    act="gelu",
    tie_embeddings=True,
    source="[arXiv:2402.19427; hf]",
)
