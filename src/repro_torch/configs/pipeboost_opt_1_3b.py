"""OPT-1.3B-like config — the paper's own benchmark family [arXiv:2205.01068].

Used by the paper-table benchmarks (TTFT / recovery); not an assigned cell.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pipeboost-opt-1.3b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=50272,
    act="gelu",
    rope_theta=1e4,
    gated_mlp=False,
    tie_embeddings=True,
    source="[arXiv:2205.01068; hf]",
)
