"""Encoder-decoder stack (whisper-base).

A port of the JAX package's ``models/encdec.py``.  The audio frontend (mel
spectrogram + conv feature extractor) is a stub there and here: the
encoder takes precomputed frame embeddings of shape (B, encoder_seq,
d_model).  The transformer encoder (bidirectional self-attention) and the
decoder (causal self-attention, cross-attention, and KV caches for both)
are real.

The reference stacks each layer's params over a leading layer axis and
scans over layers; here ``enc_layers`` and ``dec_layers`` are
``nn.ModuleList``s of one layer each, run in order (each decoder layer
under ``torch.utils.checkpoint`` with ``remat``, where autograd records,
as the reference's ``jax.checkpoint`` per decoder layer; the encoder is
not rematerialized there either).

Attention routes, as in ``models/attention.py``: the encoder's
self-attention is non-causal, without rope, window or softcap, over
positions ``arange(S)``, which is exactly what the ``flash_attention``
kernel computes in its full mode (``causal=False``), so it runs there
unless autograd records the call (the kernel has no backward), and then
takes ``_sdpa_chunked``.  The decoder's causal self-attention takes the
kernel by ``attention.attn_apply``'s own rule.  Cross-attention has
T_q != T_k and always takes ``_sdpa_chunked``; it is not counted in
``attention.ROUTES``.

Decode caches are ``{"self": [...], "cross": [...]}``, one dict {k, v} a
decoder layer in each list: the self-attention KV cache, and the encoder
keys and values, cast to bf16 by ``prefill`` as the reference does (decode
then attends an f32 query over them in f32).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (
    cross_entropy, dense_init, embed_apply, embed_init, lm_head_apply,
    mlp_apply, mlp_init, rms_norm, rms_norm_init)
from repro_torch.sharding_ctx import constrain, follow, settle

F32 = torch.float32
BF16 = torch.bfloat16
Caches = Dict[str, List[Dict[str, torch.Tensor]]]


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _dict(leaves: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: _param(w) for k, w in leaves.items()})


def _xattn_init(gen, cfg: ArchConfig, dtype, device) -> nn.ParameterDict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    return _dict({"wq": dense_init(gen, d, h * hd, dtype, device),
                  "wk": dense_init(gen, d, h * hd, dtype, device),
                  "wv": dense_init(gen, d, h * hd, dtype, device),
                  "wo": dense_init(gen, h * hd, d, dtype, device)})


class EncLayer(nn.Module):
    """norm1 + bidirectional self-attention, norm2 + MLP."""

    def __init__(self, cfg: ArchConfig, gen=None, dtype=F32, device="cpu"):
        super().__init__()
        self.norm1 = _param(rms_norm_init(cfg.d_model, dtype, device))
        self.attn = attn_mod.attn_init(gen, cfg, dtype, device)
        self.norm2 = _param(rms_norm_init(cfg.d_model, dtype, device))
        self.mlp = _dict(mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device))


class DecLayer(nn.Module):
    """norm1 + causal self-attention, norm_x + cross-attention (``xattn``),
    norm2 + MLP."""

    def __init__(self, cfg: ArchConfig, gen=None, dtype=F32, device="cpu"):
        super().__init__()
        self.norm1 = _param(rms_norm_init(cfg.d_model, dtype, device))
        self.attn = attn_mod.attn_init(gen, cfg, dtype, device)
        self.norm_x = _param(rms_norm_init(cfg.d_model, dtype, device))
        self.xattn = _xattn_init(gen, cfg, dtype, device)
        self.norm2 = _param(rms_norm_init(cfg.d_model, dtype, device))
        self.mlp = _dict(mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device))


class EncDec(nn.Module):
    """The stack's params: embed (padded vocab, d), enc_pos (encoder_seq,
    d), enc_layers, enc_norm, dec_layers, final_norm and lm_head (d,
    padded vocab), as the reference's dict."""

    def __init__(self, cfg: ArchConfig, gen: Optional[torch.Generator] = None,
                 dtype=F32, device="cpu"):
        super().__init__()
        self.embed = _param(embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                       dtype, device))
        self.enc_pos = _param(embed_init(gen, cfg.encoder_seq, cfg.d_model,
                                         dtype, device))
        self.enc_layers = nn.ModuleList(
            EncLayer(cfg, gen, dtype, device)
            for _ in range(cfg.n_encoder_layers))
        self.enc_norm = _param(rms_norm_init(cfg.d_model, dtype, device))
        self.dec_layers = nn.ModuleList(
            DecLayer(cfg, gen, dtype, device) for _ in range(cfg.n_layers))
        self.final_norm = _param(rms_norm_init(cfg.d_model, dtype, device))
        self.lm_head = _param(dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                         dtype, device))


def init_params(gen, cfg: ArchConfig, dtype=F32, device="cpu") -> EncDec:
    return EncDec(cfg, gen, dtype, device)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _bidir_core(q, k, v):
    T = q.shape[1]
    if attn_mod._records_grad(q, k, v):
        attn_mod.ROUTES["chunked_grad"] += 1
        positions = torch.arange(T, dtype=torch.int32, device=q.device)
        return attn_mod._sdpa_chunked(q, k, v, positions, positions,
                                      causal=False, window=0, attn_cap=0.0)
    attn_mod.ROUTES["flash"] += 1
    return attn_mod._flash(q, k, v, causal=False)


def _bidir_attn(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Non-causal self-attention (encoder), positions arange(T): the flash
    kernel's full mode outside autograd, the chunked softmax under it."""
    B, T, _ = x.shape
    positions = torch.arange(T, dtype=torch.int32, device=x.device)
    q, k, v = attn_mod._project_qkv(p, x, cfg, positions, rope=False)
    out = attn_mod.attention_region(
        _bidir_core, q, k, v, seq_core=attn_mod.chunked_core(False))
    return settle(attn_mod.merge_heads(out, p.wo) @ p.wo, None)


def encode(params: EncDec, frames: torch.Tensor, cfg: ArchConfig
           ) -> torch.Tensor:
    """frames: (B, S_enc, D), the stubbed conv frontend's output."""
    S = frames.shape[1]
    x = frames + params.enc_pos[None, :S]
    for lp in params.enc_layers:
        h = rms_norm(x, lp.norm1, cfg.norm_eps)
        x = x + _bidir_attn(lp.attn, h, cfg)
        h = rms_norm(x, lp.norm2, cfg.norm_eps)
        x = constrain(x + mlp_apply(lp.mlp, h, cfg.act), "btd")
    return rms_norm(x, params.enc_norm, cfg.norm_eps)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _cross_attn(p, x: torch.Tensor, enc_kv, cfg: ArchConfig) -> torch.Tensor:
    """x: (B,T,D); enc_kv: the encoder's (k, v), each (B,S_enc,H,hd)."""
    B, T, _ = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    q = attn_mod.split_heads(x @ p["wq"], h, hd)
    out = attn_mod.attention_region(
        _cross_core, q, *enc_kv, seq_core=attn_mod.chunked_core(False))
    return settle(attn_mod.merge_heads(out, p["wo"]) @ p["wo"], None)


def _cross_core(q, k, v):
    tq = torch.arange(q.shape[1], dtype=torch.int32, device=q.device)
    tk = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
    return attn_mod._sdpa_chunked(q, k, v, tq, tk, causal=False, window=0,
                                  attn_cap=0.0)


def enc_kv(params_layer, enc_out: torch.Tensor, cfg: ArchConfig):
    B, S, _ = enc_out.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    k = attn_mod.split_heads(enc_out @ params_layer["wk"], h, hd)
    v = attn_mod.split_heads(enc_out @ params_layer["wv"], h, hd)
    return k, v


def _dec_block(lp: DecLayer, x: torch.Tensor, enc_out: torch.Tensor,
               cfg: ArchConfig) -> torch.Tensor:
    h = rms_norm(x, lp.norm1, cfg.norm_eps)
    x = x + attn_mod.attn_apply(lp.attn, h, cfg)
    h = rms_norm(x, lp.norm_x, cfg.norm_eps)
    x = x + _cross_attn(lp.xattn, h, enc_kv(lp.xattn, enc_out, cfg), cfg)
    h = rms_norm(x, lp.norm2, cfg.norm_eps)
    return constrain(x + mlp_apply(lp.mlp, h, cfg.act), "btd")


def _logits(params: EncDec, x: torch.Tensor, cfg: ArchConfig):
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return lm_head_apply(params.lm_head, x, False, 0.0)


def forward(params: EncDec, frames: torch.Tensor, tokens: torch.Tensor,
            cfg: ArchConfig, *, remat: bool = True):
    """Training forward: (frames (B,S_enc,D), tokens (B,T)) -> (logits
    (B,T,Vpad) f32, aux 0)."""
    enc_out = encode(params, frames, cfg)
    x = embed_apply(params.embed, tokens)
    remat = remat and torch.is_grad_enabled()
    for lp in params.dec_layers:
        if remat:
            x = checkpoint(_dec_block, lp, x, enc_out, cfg,
                           use_reentrant=False)
        else:
            x = _dec_block(lp, x, enc_out, cfg)
    return constrain(_logits(params, x, cfg), "btv"), follow(
        torch.zeros((), dtype=F32, device=x.device), x)


def loss_fn(params: EncDec, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            *, remat: bool = True):
    """(ce, {"ce", "aux"}) on a batch of ``frames``, ``tokens`` and
    ``labels``."""
    logits, aux = forward(params, batch["frames"], batch["tokens"], cfg,
                          remat=remat)
    ce = cross_entropy(logits, batch["labels"], cfg.vocab_size)
    return ce, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def init_caches(cfg: ArchConfig, batch: int, seq_len: int, dtype=BF16,
                device="cpu") -> Caches:
    """A zeroed self-attention KV cache and cross K/V a decoder layer."""
    h, hd = cfg.n_heads, cfg.resolved_head_dim

    def cross():
        return {k: torch.zeros((batch, cfg.encoder_seq, h, hd), dtype=dtype,
                               device=device) for k in ("k", "v")}
    return {"self": [attn_mod.init_cache(cfg, "attn", batch, seq_len, dtype,
                                         device)
                     for _ in range(cfg.n_layers)],
            "cross": [cross() for _ in range(cfg.n_layers)]}


def prefill(params: EncDec, frames: torch.Tensor, tokens: torch.Tensor,
            cfg: ArchConfig, cache_seq: Optional[int] = None):
    """Encode, consume the (B,T) prompt and build the decode caches;
    returns (last logits (B,Vpad), caches)."""
    enc_out = encode(params, frames, cfg)
    S = cache_seq or tokens.shape[1]
    x = embed_apply(params.embed, tokens)
    caches: Caches = {"self": [], "cross": []}
    for lp in params.dec_layers:
        h = rms_norm(x, lp.norm1, cfg.norm_eps)
        a, self_c = attn_mod.attn_prefill(lp.attn, h, cfg, kind="attn",
                                          cache_seq=S)
        x = x + a
        ck, cv = enc_kv(lp.xattn, enc_out, cfg)
        h = rms_norm(x, lp.norm_x, cfg.norm_eps)
        x = x + _cross_attn(lp.xattn, h, (ck, cv), cfg)
        h = rms_norm(x, lp.norm2, cfg.norm_eps)
        x = constrain(x + mlp_apply(lp.mlp, h, cfg.act), "btd")
        caches["self"].append(self_c)
        caches["cross"].append({"k": ck.to(BF16), "v": cv.to(BF16)})
    return _logits(params, x[:, -1], cfg), caches


def decode_step(params: EncDec, tokens: torch.Tensor, caches: Caches,
                pos: int, cfg: ArchConfig):
    """tokens: (B,1); pos: the count of tokens already in the self caches.
    Returns (logits (B,Vpad) f32, caches), the self caches updated in
    place."""
    x = embed_apply(params.embed, tokens)
    for lp, self_c, cross_c in zip(params.dec_layers, caches["self"],
                                   caches["cross"]):
        h = rms_norm(x, lp.norm1, cfg.norm_eps)
        a, _ = attn_mod.attn_decode(lp.attn, h, self_c, cfg, pos=pos,
                                    kind="attn")
        x = x + a
        h = rms_norm(x, lp.norm_x, cfg.norm_eps)
        x = x + _cross_attn(lp.xattn, h, (cross_c["k"], cross_c["v"]), cfg)
        h = rms_norm(x, lp.norm2, cfg.norm_eps)
        x = constrain(x + mlp_apply(lp.mlp, h, cfg.act), "btd")
    return _logits(params, x[:, 0], cfg), caches
