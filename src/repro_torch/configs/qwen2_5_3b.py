"""qwen2.5-3b — dense GQA decoder with QKV bias [hf:Qwen/Qwen2.5-0.5B family card]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    source="hf:Qwen/Qwen2.5-0.5B (assignment: 36L d_model=2048 16H GQA kv=2 d_ff=11008 vocab=151936, QKV bias)",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
