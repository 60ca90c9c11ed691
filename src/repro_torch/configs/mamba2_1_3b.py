"""mamba2-1.3b — attention-free SSD (state-space duality) model [arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig, MambaConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    source="arXiv:2405.21060 (assignment: 48L d_model=2048 attn-free d_ff=0 vocab=50280, ssm_state=128)",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                        # attn-free, no MLP blocks (Mamba2 pure stack)
    vocab_size=50280,              # padded to 50304 for model-axis sharding
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    tie_embeddings=True,
)
