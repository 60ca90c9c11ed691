from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, MoEConfig, MambaConfig, ShapeConfig, SHAPES,
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K, reduced,
)
