"""Shared neural building blocks: norms, RoPE, MLPs, embeddings.

Plain functions on tensors, one for each of the JAX package's
``models/layers.py``, with its names, layouts and f32 rounding points.
Dense weights are stored (d_in, d_out) as there, so ``x @ w`` is the
same product.  Initializers draw from an explicit ``torch.Generator``
(``None`` leaves the tensor uninitialized, for weights that are loaded
next); they cannot give ``jax.random``'s numbers, so the parity tests
carry the reference's weights across (``convert.lm_params_from_numpy``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

F32 = torch.float32


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def _normal(gen: Optional[torch.Generator], shape, std: float, dtype,
            device) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=F32, device=device) * std
    return w.to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype=F32, device="cpu"
               ) -> torch.Tensor:
    return _normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype, device)


def embed_init(gen, vocab: int, d_model: int, dtype=F32, device="cpu"
               ) -> torch.Tensor:
    return _normal(gen, (vocab, d_model), 0.02, dtype, device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(F32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.to(F32))).to(dtype)


def rms_norm_init(d: int, dtype=F32, device="cpu") -> torch.Tensor:
    # stored as (scale - 1) so zeros-init == identity, gemma-style
    return torch.zeros((d,), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# softcap (gemma2)
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device="cpu"
                     ) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., T, H, head_dim); positions: (..., T) or (T,).  Rotates the
    two halves of the head dim, in f32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)            # (hd/2,)
    angles = positions.to(F32)[..., None] * freqs            # (..., T, hd/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., T, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp_init(gen, d_model: int, d_ff: int, dtype=F32, device="cpu") -> dict:
    return {"w_gate": dense_init(gen, d_model, d_ff, dtype, device),
            "w_up": dense_init(gen, d_model, d_ff, dtype, device),
            "w_down": dense_init(gen, d_ff, d_model, dtype, device)}


def mlp_apply(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """``p`` maps w_gate, w_up, w_down.  ``gelu`` is the tanh form, as
    ``jax.nn.gelu`` computes it by default."""
    gate = x @ p["w_gate"]
    gate = F.silu(gate) if act == "silu" else F.gelu(gate, approximate="tanh")
    return (gate * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------------------
# embeddings / LM head
# ---------------------------------------------------------------------------

def embed_apply(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def lm_head_apply(table_or_w: torch.Tensor, x: torch.Tensor, tied: bool,
                  logit_cap: float = 0.0) -> torch.Tensor:
    logits = x @ table_or_w.T if tied else x @ table_or_w
    return softcap(logits.to(F32), logit_cap)
