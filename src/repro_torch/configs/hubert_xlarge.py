"""hubert-xlarge — encoder-only audio backbone [arXiv:2106.07447; unverified].

The conv waveform frontend is a STUB per the assignment: ``input_specs()``
feeds precomputed frame embeddings (B, S, D) directly to the transformer.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    act="gelu",
    norm_eps=1e-5,
    gated_mlp=False,
    source="[arXiv:2106.07447; unverified]",
)
