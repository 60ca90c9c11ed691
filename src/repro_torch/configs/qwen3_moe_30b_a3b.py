"""qwen3-moe-30b-a3b — 128-expert top-8 MoE decoder [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B (assignment: 48L d_model=2048 32H GQA kv=4 d_ff=768 vocab=151936, MoE 128e top-8)",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,                     # per-expert ff dim (assignment value)
    vocab_size=151936,
    head_dim=128,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
    moe_every=0,                  # every layer is MoE
)
