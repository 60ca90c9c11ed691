"""Unified decoder stack: builds an assigned architecture from ArchConfig.

The JAX package stacks each pattern slot's params over a leading
``n_periods`` axis and scans over periods; here the stack is an
``nn.ModuleList`` of one :class:`Block` per layer, run in layer order, so
layer i is period ``i // p``, slot ``i % p`` for pattern period p
(:func:`repro_torch.convert.lm_params_from_numpy` splits the reference's
stacked params in that order).  Four entry points, as there: ``forward``
(full logits; with ``remat`` each pattern period's activations are
recomputed in the backward pass, as the reference's
``jax.checkpoint(period_body)``), ``loss_fn`` (the training loss),
``prefill`` (last-token logits + populated caches) and ``decode_step``
(one token against the caches).  Caches are a list of per-layer dicts, in
layer order.

The params are built with ``requires_grad=False``, for serving; training
switches them on (``Transformer.requires_grad_(True)``, as
``launch/train.py`` does).

Attention mixers and dense MLPs are ported.  A Mamba mixer or an MoE MLP
raises :class:`NotImplementedError` when the stack is built (ROADMAP.md
lists them).  The reference's ``sharding_ctx.constrain`` is a no-op
without a mesh and is dropped.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (
    ArchConfig, ATTN, ATTN_LOCAL, MLP_MOE)
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (
    cross_entropy, dense_init, embed_apply, embed_init, lm_head_apply,
    mlp_apply, mlp_init, rms_norm, rms_norm_init)

F32 = torch.float32
Cache = Dict[str, torch.Tensor]


def _slot_kinds(cfg: ArchConfig):
    """(mixer_kind, mlp_kind) for each of the p slots in a period."""
    p = cfg.pattern_period
    return [(cfg.layer_kind(i), cfg.mlp_kind(i)) for i in range(p)]


def n_periods(cfg: ArchConfig) -> int:
    p = cfg.pattern_period
    if cfg.n_layers % p != 0:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} not divisible "
                         f"by pattern period {p}")
    return cfg.n_layers // p


def layer_kinds(cfg: ArchConfig) -> List[Tuple[str, str]]:
    """(mixer_kind, mlp_kind) of every layer, in layer order."""
    slots = _slot_kinds(cfg)
    return [slots[i % len(slots)] for i in range(n_periods(cfg) * len(slots))]


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One layer: norm1 + mixer (attention), then norm2 + dense MLP."""

    def __init__(self, cfg: ArchConfig, mixer: str, mlp: str, gen=None,
                 dtype=F32, device="cpu"):
        super().__init__()
        if mixer not in (ATTN, ATTN_LOCAL):
            raise NotImplementedError(
                f"{cfg.name}: the {mixer!r} mixer (models/mamba.py) is not "
                "ported yet; ROADMAP.md lists it")
        if mlp == MLP_MOE:
            raise NotImplementedError(
                f"{cfg.name}: the MoE MLP (models/moe.py) is not ported "
                "yet; ROADMAP.md lists it")
        self.mixer = mixer
        self.norm1 = _param(rms_norm_init(cfg.d_model, dtype, device))
        self.attn = attn_mod.attn_init(gen, cfg, dtype, device)
        self.norm2 = _param(rms_norm_init(cfg.d_model, dtype, device))
        self.mlp = nn.ParameterDict(
            {k: _param(w) for k, w in
             mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device).items()})


class Transformer(nn.Module):
    """The stack's params: embed (padded vocab, d), final_norm, lm_head
    where embeddings are not tied, and ``blocks``, one per layer."""

    def __init__(self, cfg: ArchConfig, gen: Optional[torch.Generator] = None,
                 dtype=F32, device="cpu"):
        super().__init__()
        if cfg.is_encoder_decoder:
            raise NotImplementedError(
                f"{cfg.name}: encoder-decoder models (models/encdec.py) are "
                "not ported yet; ROADMAP.md lists them")
        self.embed = _param(embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                       dtype, device))
        self.final_norm = _param(rms_norm_init(cfg.d_model, dtype, device))
        self.lm_head = (None if cfg.tie_embeddings else _param(
            dense_init(gen, cfg.d_model, cfg.padded_vocab, dtype, device)))
        self.blocks = nn.ModuleList(
            Block(cfg, mixer, mlp, gen, dtype, device)
            for mixer, mlp in layer_kinds(cfg))


def init_params(gen, cfg: ArchConfig, dtype=F32, device="cpu"
                ) -> Transformer:
    return Transformer(cfg, gen, dtype, device)


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _mlp_half(lp: Block, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return x + mlp_apply(lp.mlp, rms_norm(x, lp.norm2, cfg.norm_eps), cfg.act)


def _head(params: Transformer, x: torch.Tensor, cfg: ArchConfig):
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    head = params.embed if cfg.tie_embeddings else params.lm_head
    return lm_head_apply(head, x, cfg.tie_embeddings, cfg.logit_softcap)


def _period(blocks, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """One pattern period: its p layers in order."""
    for lp in blocks:
        window = cfg.sliding_window if lp.mixer == ATTN_LOCAL else 0
        h = rms_norm(x, lp.norm1, cfg.norm_eps)
        x = x + attn_mod.attn_apply(lp.attn, h, cfg, window=window)
        x = _mlp_half(lp, x, cfg)
    return x


def forward(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig, *,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  tokens: (B,T) -> (logits (B,T,Vpad) f32,
    aux); aux is 0 (it counts MoE load balance, which is not ported).

    With ``remat``, and only where autograd records (a forward under
    ``torch.no_grad`` has nothing to recompute), each pattern period runs
    under ``torch.utils.checkpoint``: its activations are dropped and
    recomputed in the backward pass, as the reference's
    ``jax.checkpoint(period_body)`` does."""
    x = embed_apply(params.embed, tokens)
    p = cfg.pattern_period
    blocks = list(params.blocks)
    remat = remat and torch.is_grad_enabled()
    for i in range(0, len(blocks), p):
        period = blocks[i:i + p]
        if remat:
            x = checkpoint(_period, period, cfg, x, use_reentrant=False)
        else:
            x = _period(period, cfg, x)
    return _head(params, x, cfg), torch.zeros((), dtype=F32, device=x.device)


def loss_fn(params: Transformer, batch: Dict[str, torch.Tensor],
            cfg: ArchConfig, *, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(ce + aux, {"ce", "aux"}) on a batch of ``tokens`` and ``labels``
    (B,T)."""
    logits, aux = forward(params, batch["tokens"], cfg, remat=remat)
    ce = cross_entropy(logits, batch["labels"], cfg.vocab_size)
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# caches (decode)
# ---------------------------------------------------------------------------

def init_caches(cfg: ArchConfig, batch: int, seq_len: int,
                dtype=torch.bfloat16, device="cpu") -> List[Cache]:
    """One zeroed cache per layer, in layer order."""
    return [attn_mod.init_cache(cfg, mixer, batch, seq_len, dtype, device)
            for mixer, _ in layer_kinds(cfg)]


def decode_step(params: Transformer, tokens: torch.Tensor,
                caches: List[Cache], pos: int, cfg: ArchConfig):
    """One decode step.  tokens: (B,1); caches from init_caches/prefill;
    pos: the count of tokens already in the caches.  Returns (logits
    (B,Vpad) f32, caches), the caches updated in place."""
    x = embed_apply(params.embed, tokens)
    for lp, c in zip(params.blocks, caches):
        h = rms_norm(x, lp.norm1, cfg.norm_eps)
        h, _ = attn_mod.attn_decode(lp.attn, h, c, cfg, pos=pos,
                                    kind=lp.mixer)
        x = _mlp_half(lp, x + h, cfg)
    return _head(params, x[:, 0], cfg), caches


def prefill(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig,
            cache_seq: Optional[int] = None):
    """Prefill: consume the (B,T) prompt, return (last logits (B,Vpad),
    caches sized for cache_seq (default T) further decode)."""
    T = tokens.shape[1]
    S = cache_seq or T
    x = embed_apply(params.embed, tokens)
    caches = []
    for lp in params.blocks:
        h = rms_norm(x, lp.norm1, cfg.norm_eps)
        h, c = attn_mod.attn_prefill(lp.attn, h, cfg, kind=lp.mixer,
                                     cache_seq=S)
        x = _mlp_half(lp, x + h, cfg)
        caches.append(c)
    return _head(params, x[:, -1], cfg), caches
