"""Architecture + run configuration dataclasses.

Every assigned architecture is expressed as an :class:`ArchConfig`; the four
assigned input shapes as :class:`ShapeConfig`.  Configs are plain frozen
dataclasses, a copy of the JAX package's ``configs/base.py`` field for
field, so a configuration means the same model in both packages.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Layer kinds used by the unified stack ------------------------------------
ATTN = "attn"          # full (causal) attention
ATTN_LOCAL = "attn_local"   # sliding-window attention
MAMBA = "mamba"        # Mamba2 SSD block
# MLP kinds
MLP_DENSE = "dense"
MLP_MOE = "moe"


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int            # per-expert hidden dim
    capacity_factor: float = 1.25
    # "tensor": experts replicated across data, d_ff sharded over model.
    # "expert": experts sharded over model axis (expert parallel).
    sharding: str = "tensor"
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2               # d_inner = expand * d_model
    head_dim: int = 64
    chunk: int = 256              # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ArchConfig:
    """One assigned architecture.  Field values follow the assignment block
    verbatim; ``source`` cites the paper / model card."""

    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    source: str
    n_layers: int
    d_model: int
    n_heads: int                  # query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # attention details
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    logit_softcap: float = 0.0    # gemma2 final-logit softcap (0 = off)
    attn_softcap: float = 0.0     # gemma2 attention-logit softcap
    sliding_window: int = 0       # window for ATTN_LOCAL layers
    local_global_alternate: bool = False   # gemma2 pattern

    # block composition
    moe: Optional[MoEConfig] = None
    moe_every: int = 0            # MoE MLP on layers where (i % moe_every)==moe_offset
    moe_offset: int = 1
    mamba: Optional[MambaConfig] = None
    attn_every: int = 0           # hybrid: attention on layers where (i % attn_every)==attn_offset
    attn_offset: int = 0

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0          # e.g. 1500 mel frames after conv stub

    # modality frontend stub: "none" | "audio" | "vision"
    frontend: str = "none"

    # norms / misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"             # silu -> SwiGLU, gelu -> GeGLU-ish dense

    # ---------------------------------------------------------------- utils
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 for clean model-axis sharding."""
        return _round_up(self.vocab_size, 128)

    def layer_kind(self, i: int) -> str:
        """Sequence-mixer kind for layer i."""
        if self.family == "ssm":
            return MAMBA
        if self.attn_every:  # hybrid (jamba): attention every `attn_every`
            return ATTN if (i % self.attn_every) == self.attn_offset else MAMBA
        if self.local_global_alternate:
            return ATTN_LOCAL if (i % 2) == 0 else ATTN
        return ATTN

    def mlp_kind(self, i: int) -> str:
        if self.moe is None:
            return MLP_DENSE
        if self.moe_every == 0:
            return MLP_MOE            # every layer MoE
        return MLP_MOE if (i % self.moe_every) == self.moe_offset else MLP_DENSE

    # layer-pattern period: the scan body covers `period` layers so that
    # heterogeneous stacks (jamba, gemma2, moe-alternating) still scan.
    @property
    def pattern_period(self) -> int:
        p = 1
        if self.attn_every:
            p = math.lcm(p, self.attn_every)
        if self.local_global_alternate:
            p = math.lcm(p, 2)
        if self.moe is not None and self.moe_every:
            p = math.lcm(p, self.moe_every)
        return p

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d = self.d_model
        n = 0
        n += self.padded_vocab * d                     # embedding
        if not self.tie_embeddings:
            n += self.padded_vocab * d                 # lm head
        hd = self.resolved_head_dim
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind in (ATTN, ATTN_LOCAL):
                q = d * self.n_heads * hd
                kv = 2 * d * self.n_kv_heads * hd
                o = self.n_heads * hd * d
                n += q + kv + o
                if self.qkv_bias:
                    n += (self.n_heads + 2 * self.n_kv_heads) * hd
            else:  # mamba
                mc = self.mamba or MambaConfig()
                di = mc.d_inner(d)
                nh = mc.n_heads(d)
                n += d * (2 * di + 2 * mc.d_state * 1 + nh)   # in_proj(z,x)+B,C,dt (grouped)
                n += di * mc.d_conv                            # conv
                n += di * d                                    # out proj
                n += 2 * nh                                    # A_log, D
            if self.mlp_kind(i) == MLP_MOE:
                m = self.moe
                n += m.num_experts * (3 * d * m.d_ff_expert)   # gate,up,down
                n += d * m.num_experts                         # router
            else:
                n += 3 * d * self.d_ff
            n += 2 * d                                         # 2 norms
        if self.is_encoder_decoder:
            # encoder blocks + cross attention in decoder
            for _ in range(self.n_encoder_layers):
                n += 4 * d * self.n_heads * hd + 3 * d * self.d_ff + 2 * d
            n += self.n_layers * (4 * d * self.n_heads * hd + d)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts)."""
        if self.moe is None:
            return self.param_count()
        n = self.param_count()
        m = self.moe
        n_moe_layers = sum(1 for i in range(self.n_layers) if self.mlp_kind(i) == MLP_MOE)
        full = n_moe_layers * m.num_experts * 3 * self.d_model * m.d_ff_expert
        active = n_moe_layers * m.top_k * 3 * self.d_model * m.d_ff_expert
        return n - full + active


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                     # "train" | "prefill" | "decode"


# The four assigned input shapes -------------------------------------------
TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def reduced(cfg: ArchConfig, n_layers: int = 2, d_model: int = 256,
            max_experts: int = 4, vocab: int = 512) -> ArchConfig:
    """Reduced variant of the same family for CPU smoke tests
    (2 layers, d_model<=512, <=4 experts)."""
    hd = 32
    n_heads = max(1, min(cfg.n_heads, d_model // hd)) if cfg.n_heads else 0
    kv = max(1, min(cfg.n_kv_heads, n_heads)) if n_heads else 0
    # keep the GQA ratio flavour
    if n_heads and cfg.n_kv_heads < cfg.n_heads:
        kv = max(1, n_heads // max(1, cfg.n_heads // max(cfg.n_kv_heads, 1)))
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, max_experts),
            top_k=min(cfg.moe.top_k, 2), d_ff_expert=max(64, d_model // 4))
    mamba = None
    if cfg.mamba is not None:
        mamba = dataclasses.replace(cfg.mamba, d_state=16, head_dim=32, chunk=32)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=kv,
        head_dim=hd if n_heads else 0,
        d_ff=max(64, d_model * 2),
        vocab_size=vocab,
        moe=moe,
        mamba=mamba,
        attn_every=min(cfg.attn_every, n_layers) if cfg.attn_every else 0,
        attn_offset=min(cfg.attn_offset, n_layers - 1) if cfg.attn_every else 0,
        moe_every=min(cfg.moe_every, 2) if cfg.moe_every else 0,
        moe_offset=min(cfg.moe_offset, 1),
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 64) if cfg.encoder_seq else 0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
    )
