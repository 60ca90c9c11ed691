"""whisper-base — encoder-decoder audio model, conv frontend stubbed [arXiv:2212.04356]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    source="arXiv:2212.04356 (assignment: 6L d_model=512 8H GQA kv=8 d_ff=2048 vocab=51865, enc-dec, conv frontend stub)",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    is_encoder_decoder=True,
    n_encoder_layers=6,
    encoder_seq=1500,              # 30 s of audio after the (stubbed) conv frontend
    frontend="audio",
    act="gelu",
)
