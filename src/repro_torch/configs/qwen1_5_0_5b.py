"""qwen1.5-0.5b — small dense MHA decoder with QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B (assignment: 24L d_model=1024 16H GQA kv=16 d_ff=2816 vocab=151936, QKV bias)",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    head_dim=64,
    qkv_bias=True,
    tie_embeddings=True,
)
