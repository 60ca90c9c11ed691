"""GQA attention with QKV bias, RoPE, sliding-window masks, logit softcap,
chunked (memory-bounded) softmax, and KV-cache decode.

The functions keep the JAX package's names and take the layer's
:class:`Attention` module for its params.  Full-sequence attention
(:func:`attn_apply`, :func:`attn_prefill`) runs the hand-written
``flash_attention`` kernel (``kernels/csrc/flash_attention.cu`` through
:func:`repro_torch.kernels.ops.flash_attention`) wherever the layer
computes exactly what the kernel computes: causal, no sliding window
(``window == 0``), no logit softcap (``cfg.attn_softcap == 0``), scale
1/sqrt(hd), and positions ``arange(T)`` (``positions=None``), and
autograd does not record it.  Every other layer (gemma2's local and
softcapped layers, explicit positions) runs :func:`_sdpa_chunked`, the
q-chunked plain softmax that the JAX package runs everywhere.  Both give
the same function up to rounding.  The reference's docstring names an
``impl="pallas"`` switch for this that its code never had.

The kernel has no backward (nor has the JAX package's), and it writes its
result through raw pointers, so a gradient through it would be lost
without an error.  Where grad mode is on and q, k or v requires grad (a
training step), the layer runs :func:`_sdpa_chunked`, which is what the
reference differentiates.  The choice is made from the grad mode before
any launch, never after a kernel fails, and each call counts its route in
``ROUTES``.

Decode (:func:`attn_decode`) is a plain product over the cache, as in the
reference.  It writes the new key and value into the cache in place (the
reference returns a new cache; the in-place write saves a copy of every
layer's cache per token) and returns the same dict.  The reference's
``sharding_ctx.constrain`` is a no-op without a mesh and is dropped.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, softcap

F32 = torch.float32
BF16 = torch.bfloat16
NEG_INF = -1e30
# full-sequence attention calls by route: the flash kernel, the chunked
# softmax for a layer the kernel does not compute, and the chunked softmax
# because autograd records the call
ROUTES: Dict[str, int] = {"flash": 0, "chunked": 0, "chunked_grad": 0}


class Attention(nn.Module):
    """One attention layer's params: wq, wk, wv (d, heads*hd), wo
    (Hq*hd, d), and with ``cfg.qkv_bias`` the biases bq, bk, bv."""

    def __init__(self, cfg: ArchConfig, gen: Optional[torch.Generator] = None,
                 dtype=F32, device="cpu"):
        super().__init__()
        d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        hd = cfg.resolved_head_dim
        for name, d_in, d_out in (("wq", d, hq * hd), ("wk", d, hkv * hd),
                                  ("wv", d, hkv * hd), ("wo", hq * hd, d)):
            setattr(self, name, nn.Parameter(
                dense_init(gen, d_in, d_out, dtype, device),
                requires_grad=False))
        for name, n in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            b = (nn.Parameter(torch.zeros((n * hd,), dtype=dtype,
                                          device=device), requires_grad=False)
                 if cfg.qkv_bias else None)
            self.register_parameter(name, b)


def attn_init(gen, cfg: ArchConfig, dtype=F32, device="cpu") -> Attention:
    return Attention(cfg, gen, dtype, device)


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor, rope: bool = True):
    B, T, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, T, hq, hd)
    k = k.reshape(B, T, hkv, hd)
    v = v.reshape(B, T, hkv, hd)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """(Tq, Tk) additive mask from absolute positions."""
    dif = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(dif.shape, dtype=torch.bool, device=dif.device)
    if causal:
        ok &= dif >= 0
    if window > 0:
        ok &= dif < window
    return torch.where(ok, 0.0, NEG_INF).to(F32)


def _sdpa_chunked(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
                  attn_cap: float, block_q: int = 512) -> torch.Tensor:
    """q:(B,Tq,Hq,hd) k,v:(B,Tk,Hkv,hd) -> (B,Tq,Hq,hd).

    Walks q in blocks of ``block_q`` rows; each block materializes
    (B,Hkv,G,block_q,Tk) logits only.  GQA reshapes the q heads as
    (Hkv, G), so q head h reads kv head h // G without repeating K/V.
    """
    B, Tq, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Tq, Hkv, G, hd)
    kf = k.to(F32)
    vf = v.to(F32)
    outs = []
    for s in range(0, Tq, block_q):
        qb = qg[:, s:s + block_q].to(F32)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qb, kf) * scale
        logits = softcap(logits, attn_cap)
        logits = logits + _mask_bias(q_pos[s:s + block_q], k_pos, causal,
                                     window)
        w = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhgqk,bkhd->bqhgd", w, vf).to(q.dtype))
    return torch.cat(outs, dim=1).reshape(B, Tq, Hq, hd)


def _flash(q, k, v, causal: bool = True) -> torch.Tensor:
    """Attention through the flash kernel, causal or (for the
    encoder-decoder's encoder) full: q (B,T,Hq,hd), k,v (B,T,Hkv,hd) ->
    (B,T,Hq,hd).  The kernel reads the (B,H,T,hd) views of all three in
    place and writes the (B,T,Hq,hd) result directly; q head h reads kv
    head h // G as in :func:`_sdpa_chunked`."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal,
                        out=out.transpose(1, 2))
    return out


def _flash_applies(cfg: ArchConfig, window: int, positions) -> bool:
    """Whether a causal full-sequence layer computes exactly what the flash
    kernel computes: no window, no logit softcap, positions arange(T)."""
    return window == 0 and cfg.attn_softcap == 0 and positions is None


def _records_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _attend(q, k, v, cfg: ArchConfig, positions, window: int, block_q: int):
    if _flash_applies(cfg, window, positions):
        if not _records_grad(q, k, v):
            ROUTES["flash"] += 1
            return _flash(q, k, v)
        ROUTES["chunked_grad"] += 1
    else:
        ROUTES["chunked"] += 1
    positions = _positions(positions, q.shape[1], q.device)
    return _sdpa_chunked(q, k, v, positions, positions, causal=True,
                         window=window, attn_cap=cfg.attn_softcap,
                         block_q=block_q)


def _positions(positions, T: int, device) -> torch.Tensor:
    if positions is None:
        return torch.arange(T, dtype=torch.int32, device=device)
    return positions


def attn_apply(p: Attention, x: torch.Tensor, cfg: ArchConfig, *,
               positions: Optional[torch.Tensor] = None, window: int = 0,
               block_q: int = 512) -> torch.Tensor:
    """Full-sequence (train/prefill) attention; returns (B,T,D).
    ``positions=None`` means arange(T)."""
    B, T, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, _positions(positions, T, x.device))
    out = _attend(q, k, v, cfg, positions, window, block_q)
    return out.reshape(B, T, cfg.n_heads * cfg.resolved_head_dim) @ p.wo


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def cache_len(cfg: ArchConfig, kind: str, seq_len: int) -> int:
    """Local (sliding-window) layers keep a window-capped ring cache."""
    if kind == "attn_local" and cfg.sliding_window:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg: ArchConfig, kind: str, batch: int, seq_len: int,
               dtype=BF16, device="cpu") -> Dict[str, torch.Tensor]:
    S = cache_len(cfg, kind, seq_len)
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {"k": torch.zeros((batch, S, hkv, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, S, hkv, hd), dtype=dtype, device=device)}


def attn_prefill(p: Attention, x: torch.Tensor, cfg: ArchConfig, *,
                 positions: Optional[torch.Tensor] = None, kind: str,
                 cache_seq: int, block_q: int = 512):
    """Prefill: full attention + a populated bf16 cache of cache_seq slots
    (window-capped on local layers).  ``positions=None`` means
    arange(T)."""
    B, T, _ = x.shape
    window = cfg.sliding_window if kind == "attn_local" else 0
    q, k, v = _project_qkv(p, x, cfg, _positions(positions, T, x.device))
    out = _attend(q, k, v, cfg, positions, window, block_q)
    S = cache_len(cfg, kind, cache_seq)
    if T >= S:
        # keep the last S entries, laid out in ring order (slot = abs_pos % S)
        # so attn_decode's ring-slot bookkeeping continues seamlessly
        ck = torch.roll(k[:, T - S:], shifts=T % S, dims=1)
        cv = torch.roll(v[:, T - S:], shifts=T % S, dims=1)
    else:
        pad = (0, 0, 0, 0, 0, S - T)
        ck = torch.nn.functional.pad(k, pad)
        cv = torch.nn.functional.pad(v, pad)
    cache = {"k": ck.to(BF16), "v": cv.to(BF16)}
    o = out.reshape(B, T, cfg.n_heads * cfg.resolved_head_dim) @ p.wo
    return o, cache


def attn_decode(p: Attention, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                cfg: ArchConfig, *, pos: int, kind: str):
    """One-token decode. x: (B,1,D); cache k/v: (B,S,Hkv,hd); pos: the
    number of tokens already in the cache.  Returns (out, cache), the cache
    updated in place.

    For sliding-window layers the cache is a ring buffer of window slots
    (slot = pos % S); masking selects the valid window entries.  The new
    key and value are read back from the cache, rounded to its dtype, as
    the reference reads them.
    """
    B = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    S = cache["k"].shape[1]
    window = cfg.sliding_window if kind == "attn_local" else 0
    pos = int(pos)
    dev = x.device

    positions = torch.full((1,), pos, dtype=torch.int32, device=dev)
    q, k, v = _project_qkv(p, x, cfg, positions)

    slot = pos % S                     # == pos for full-length caches
    ck, cv = cache["k"], cache["v"]
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)

    # absolute position of every cache slot (ring-aware): slots <= the
    # current one hold positions (pos - slot + idx), slots beyond hold the
    # previous wrap (pos - slot + idx - S)
    idx = torch.arange(S, dtype=torch.int64, device=dev)
    abs_pos = pos - slot + idx - torch.where(idx > slot, S, 0)
    valid = (abs_pos >= 0) & (abs_pos <= pos)
    if window > 0:
        valid &= (pos - abs_pos) < window

    G = hq // hkv
    qg = q.reshape(B, hkv, G, hd).to(F32)
    logits = torch.einsum("bhgd,bshd->bhgs", qg, ck.to(F32))
    logits = logits / math.sqrt(hd)
    logits = softcap(logits, cfg.attn_softcap)
    logits = torch.where(valid[None, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", w, cv.to(F32))
    o = o.reshape(B, 1, hq * hd).to(x.dtype) @ p.wo
    return o, cache
