"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave with MoE [arXiv:2403.19887]."""
from repro_torch.configs.base import ArchConfig, MoEConfig, MambaConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887 (assignment: 72L d_model=8192 64H GQA kv=8 d_ff=24576 vocab=65536, MoE 16e top-2, Mamba:attn 7:1)",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    # 1 attention layer per 8-layer Jamba period (the paper places it mid-period)
    attn_every=8,
    attn_offset=4,
    # MoE on every other layer (Jamba's e=2 stride), 16 experts top-2
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576),
    moe_every=2,
    moe_offset=1,
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=128, chunk=256),
)
