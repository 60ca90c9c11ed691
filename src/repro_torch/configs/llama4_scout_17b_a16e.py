"""llama4-scout-17b-a16e — 16-expert top-1 MoE, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E (assignment: 48L d_model=5120 40H GQA kv=8 d_ff=8192 vocab=202048, MoE 16e top-1, early fusion)",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=1, d_ff_expert=8192),
    moe_every=0,                   # every layer MoE (Scout interleave step 1)
    frontend="vision",             # early-fusion multimodal: stubbed patch embeddings
)
