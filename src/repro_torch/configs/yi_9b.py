"""yi-9b — llama-architecture dense GQA decoder [arXiv:2403.04652]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    source="arXiv:2403.04652 (assignment: 48L d_model=4096 32H GQA kv=4 d_ff=11008 vocab=64000)",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    head_dim=128,
    rope_theta=5_000_000.0,
)
