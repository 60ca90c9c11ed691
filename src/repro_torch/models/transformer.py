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

A layer's mixer is attention (``models/attention.py``) or a Mamba2 SSD
block (``models/mamba.py``); its MLP, where it has one (``cfg.d_ff > 0``
or an MoE layer, as the reference's ``_layer_init`` decides), is dense or
an MoE (``models/moe.py``), whose load-balance aux loss ``forward`` sums
over layers and ``prefill``/``decode_step`` drop.  A Mamba layer's cache
is its state dict {ssm, conv}.

On DTensor params under a mesh context (the dry run) the stack pins its
activations with ``sharding_ctx.constrain`` where the reference does: the
embedding output, the carry after each pattern period and the logits.
Without a context those calls return their argument.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (
    ArchConfig, ATTN_LOCAL, MAMBA, MLP_MOE)
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (
    cross_entropy, dense_init, embed_apply, embed_init, lm_head_apply,
    mlp_apply, mlp_init, rms_norm, rms_norm_init)
from repro_torch.sharding_ctx import constrain, follow

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
    """One layer: norm1 + mixer (``attn`` or ``mamba``), then, where the
    layer has an MLP, norm2 + ``mlp`` (dense) or ``moe``."""

    def __init__(self, cfg: ArchConfig, mixer: str, mlp: str, gen=None,
                 dtype=F32, device="cpu"):
        super().__init__()
        self.mixer = mixer
        self.norm1 = _param(rms_norm_init(cfg.d_model, dtype, device))
        if mixer == MAMBA:
            self.mamba = mamba_mod.mamba_init(gen, cfg, dtype, device)
        else:
            self.attn = attn_mod.attn_init(gen, cfg, dtype, device)
        # the MLP kind, or None for a layer without one (mamba2: d_ff 0)
        self.mlp_kind = mlp if cfg.d_ff > 0 or mlp == MLP_MOE else None
        if self.mlp_kind is None:
            return
        self.norm2 = _param(rms_norm_init(cfg.d_model, dtype, device))
        if mlp == MLP_MOE:
            self.moe = moe_mod.moe_init(gen, cfg, dtype, device)
        else:
            self.mlp = nn.ParameterDict(
                {k: _param(w) for k, w in
                 mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device).items()})


class Transformer(nn.Module):
    """The stack's params: embed (padded vocab, d), final_norm, lm_head
    where embeddings are not tied, and ``blocks``, one per layer."""

    def __init__(self, cfg: ArchConfig, gen: Optional[torch.Generator] = None,
                 dtype=F32, device="cpu"):
        super().__init__()
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

def _mlp_half(lp: Block, x: torch.Tensor, cfg: ArchConfig):
    """x + the layer's MLP, and the MoE aux loss (None elsewhere)."""
    if lp.mlp_kind is None:
        return x, None
    h = rms_norm(x, lp.norm2, cfg.norm_eps)
    if lp.mlp_kind == MLP_MOE:
        h, aux = moe_mod.moe_apply(lp.moe, h, cfg, cfg.act)
        return x + h, aux
    return x + mlp_apply(lp.mlp, h, cfg.act), None


def _head(params: Transformer, x: torch.Tensor, cfg: ArchConfig):
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    head = params.embed if cfg.tie_embeddings else params.lm_head
    return lm_head_apply(head, x, cfg.tie_embeddings, cfg.logit_softcap)


def _period(blocks, cfg: ArchConfig, x: torch.Tensor, aux: torch.Tensor):
    """One pattern period: its p layers in order; returns (x, aux plus the
    period's MoE aux losses)."""
    for lp in blocks:
        h = rms_norm(x, lp.norm1, cfg.norm_eps)
        if lp.mixer == MAMBA:
            h, _ = mamba_mod.mamba_forward(lp.mamba, h, cfg)
        else:
            window = cfg.sliding_window if lp.mixer == ATTN_LOCAL else 0
            h = attn_mod.attn_apply(lp.attn, h, cfg, window=window)
        x, a = _mlp_half(lp, x + h, cfg)
        if a is not None:
            aux = aux + a
    return constrain(x, "btd"), aux


def forward(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig, *,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  tokens: (B,T) -> (logits (B,T,Vpad) f32,
    aux), aux the sum of the MoE layers' load-balance losses (0 without
    MoE layers).

    With ``remat``, and only where autograd records (a forward under
    ``torch.no_grad`` has nothing to recompute), each pattern period runs
    under ``torch.utils.checkpoint``: its activations are dropped and
    recomputed in the backward pass, as the reference's
    ``jax.checkpoint(period_body)`` does."""
    x = constrain(embed_apply(params.embed, tokens), "btd")
    aux = follow(torch.zeros((), dtype=F32, device=x.device), x)
    p = cfg.pattern_period
    blocks = list(params.blocks)
    remat = remat and torch.is_grad_enabled()
    for i in range(0, len(blocks), p):
        period = blocks[i:i + p]
        if remat:
            x, aux = checkpoint(_period, period, cfg, x, aux,
                                use_reentrant=False)
        else:
            x, aux = _period(period, cfg, x, aux)
    return constrain(_head(params, x, cfg), "btv"), aux


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
    """One zeroed cache per layer, in layer order: a KV cache for an
    attention layer, a Mamba state (its conv state in ``dtype``) for a
    Mamba layer."""
    return [mamba_mod.init_mamba_state(cfg, batch, dtype, device)
            if mixer == MAMBA else
            attn_mod.init_cache(cfg, mixer, batch, seq_len, dtype, device)
            for mixer, _ in layer_kinds(cfg)]


def decode_step(params: Transformer, tokens: torch.Tensor,
                caches: List[Cache], pos: int, cfg: ArchConfig):
    """One decode step.  tokens: (B,1); caches from init_caches/prefill;
    pos: the count of tokens already in the caches.  Returns (logits
    (B,Vpad) f32, caches), the caches updated in place (a Mamba layer's
    dict takes its new state)."""
    x = constrain(embed_apply(params.embed, tokens), "btd")
    p = cfg.pattern_period
    for i, (lp, c) in enumerate(zip(params.blocks, caches)):
        h = rms_norm(x, lp.norm1, cfg.norm_eps)
        if lp.mixer == MAMBA:
            h, st = mamba_mod.mamba_decode(lp.mamba, h, c, cfg)
            c.update(st)
        else:
            h, _ = attn_mod.attn_decode(lp.attn, h, c, cfg, pos=pos,
                                        kind=lp.mixer)
        x, _ = _mlp_half(lp, x + h, cfg)
        if (i + 1) % p == 0:
            x = constrain(x, "btd")
    return constrain(_head(params, x[:, 0], cfg), "bv"), caches


def prefill(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig,
            cache_seq: Optional[int] = None):
    """Prefill: consume the (B,T) prompt, return (last logits (B,Vpad),
    caches sized for cache_seq (default T) further decode)."""
    T = tokens.shape[1]
    S = cache_seq or T
    x = constrain(embed_apply(params.embed, tokens), "btd")
    p = cfg.pattern_period
    caches = []
    for i, lp in enumerate(params.blocks):
        h = rms_norm(x, lp.norm1, cfg.norm_eps)
        if lp.mixer == MAMBA:
            h, c = mamba_mod.mamba_forward(lp.mamba, h, cfg)
        else:
            h, c = attn_mod.attn_prefill(lp.attn, h, cfg, kind=lp.mixer,
                                         cache_seq=S)
        x, _ = _mlp_half(lp, x + h, cfg)
        if (i + 1) % p == 0:
            x = constrain(x, "btd")
        caches.append(c)
    return constrain(_head(params, x[:, -1], cfg), "bv"), caches
