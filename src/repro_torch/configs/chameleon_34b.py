"""chameleon-34b — early-fusion VLM over VQ image tokens [arXiv:2405.09818]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    source="arXiv:2405.09818 (assignment: 48L d_model=8192 64H GQA kv=8 d_ff=22016 vocab=65536, early-fusion VQ image tokens)",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,              # text + VQ image codes in one vocab (early fusion)
    head_dim=128,
    frontend="vision",             # VQ tokenizer stubbed: input_specs gives token ids
)
