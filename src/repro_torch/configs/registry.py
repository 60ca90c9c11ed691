"""Architecture registry: maps ``--arch <id>`` to its ArchConfig.

Applicable-shape logic lives here too: which of the four assigned input
shapes each architecture runs (the 524k-token decode shape only for the
sub-quadratic ones).  A copy of the JAX package's registry.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES
from repro_torch.configs import (
    qwen2_5_3b, jamba_1_5_large_398b, yi_9b, qwen1_5_0_5b, qwen3_moe_30b_a3b,
    mamba2_1_3b, llama4_scout_17b_a16e, whisper_base, chameleon_34b, gemma2_27b,
)

ARCHS: Dict[str, ArchConfig] = {
    c.name: c for c in (
        qwen2_5_3b.CONFIG,
        jamba_1_5_large_398b.CONFIG,
        yi_9b.CONFIG,
        qwen1_5_0_5b.CONFIG,
        qwen3_moe_30b_a3b.CONFIG,
        mamba2_1_3b.CONFIG,
        llama4_scout_17b_a16e.CONFIG,
        whisper_base.CONFIG,
        chameleon_34b.CONFIG,
        gemma2_27b.CONFIG,
    )
}

# Archs whose attention is sub-quadratic (SSM / hybrid / sliding-window),
# eligible for the 524k-token decode shape.
SUBQUADRATIC = {"mamba2-1.3b", "jamba-1.5-large-398b", "gemma2-27b"}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> bool:
    """The 524k-token shape runs only on sub-quadratic archs."""
    if shape.name == "long_500k":
        return arch.name in SUBQUADRATIC
    return True


def applicable_pairs() -> List[tuple]:
    out = []
    for a in ARCHS.values():
        for s in SHAPES.values():
            if shape_applicable(a, s):
                out.append((a.name, s.name))
    return out
