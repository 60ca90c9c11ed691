"""gemma2-27b — local+global alternating attention with logit softcap [arXiv:2408.00118]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    source="arXiv:2408.00118 (assignment: 46L d_model=4608 32H GQA kv=16 d_ff=36864 vocab=256000, local+global alternating, logit softcap)",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    local_global_alternate=True,
    sliding_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
)
