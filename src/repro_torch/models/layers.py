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

from repro_torch.sharding_ctx import (
    _AllReduceSum, current, follow, is_dtensor, local_region, settle)

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
    cos = follow(torch.cos(angles)[..., None, :], x)         # (..., T, 1, hd/2)
    sin = follow(torch.sin(angles)[..., None, :], x)
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
    return settle((gate * (x @ p["w_up"])) @ p["w_down"], None)


# ---------------------------------------------------------------------------
# embeddings / LM head
# ---------------------------------------------------------------------------

def embed_apply(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    if is_dtensor(table):
        return _embed_sharded(table, ids)
    return table[ids]


def _embed_sharded(table, ids):
    """:func:`embed_apply` of a DTensor table whose vocab is split over the
    context's model axis (the vocab-parallel form): each device looks up
    the ids in its vocab slice (zeros elsewhere) for its batch rows, and
    an all-reduce over the model axis sums the slices."""
    ctx = current()
    mesh = table.device_mesh
    m_dim = list(mesh.mesh_dim_names).index(ctx["model"])

    def body(tab, idx):
        vloc = tab.shape[0]
        idx = idx.long() - mesh.get_local_rank(m_dim) * vloc
        hit = (idx >= 0) & (idx < vloc)
        rows = tab[idx.clamp(0, vloc - 1)]
        rows = torch.where(hit[..., None], rows, torch.zeros_like(rows))
        return _AllReduceSum.apply(rows, [(mesh, m_dim)])

    b = ctx["batch"]
    return local_region(body, ((ctx["model"], None), (b, None)), (1,),
                        table, ids)


def lm_head_apply(table_or_w: torch.Tensor, x: torch.Tensor, tied: bool,
                  logit_cap: float = 0.0) -> torch.Tensor:
    logits = x @ table_or_w.T if tied else x @ table_or_w
    return softcap(logits.to(F32), logit_cap)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_true: int) -> torch.Tensor:
    """Mean token cross-entropy in f32; positions >= vocab_true (padding
    vocab) masked with -1e30 before the logsumexp, as the reference adds
    it."""
    if is_dtensor(logits):
        return _cross_entropy_sharded(logits, labels, vocab_true)
    logits = logits.to(F32)
    vpad = logits.shape[-1]
    if vpad > vocab_true:
        neg = torch.zeros((vpad,), dtype=F32, device=logits.device)
        neg[vocab_true:] = -1e30
        logits = logits + neg
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def _cross_entropy_sharded(logits, labels, vocab_true: int):
    """:func:`cross_entropy` of DTensor logits (B, T, Vpad), batch over the
    context's batch axes and vocab over its model axis, computed where
    they lie (the vocab-parallel form): each device takes the max, the sum
    of exps and the gold logit over its vocab slice, three all-reduces
    over the model axis combine them, and the per-token losses keep the
    batch layout.  The same function as the plain form, up to rounding."""
    from torch.distributed import _functional_collectives as funcol
    ctx = current()
    mesh = logits.device_mesh
    names = list(mesh.mesh_dim_names)
    m_dim = names.index(ctx["model"])
    group = (mesh, m_dim)
    b = ctx["batch"]

    def body(lg, lab):
        lg = lg.to(F32)
        vloc = lg.shape[-1]
        lo = mesh.get_local_rank(m_dim) * vloc
        cols = torch.arange(lo, lo + vloc, device=lg.device)
        lg = torch.where(cols < vocab_true, lg, torch.full_like(lg, -1e30))
        mx = funcol.wait_tensor(funcol.all_reduce(
            lg.detach().amax(-1), "max", group))
        sumexp = _AllReduceSum.apply(
            torch.exp(lg - mx[..., None]).sum(-1), [group])
        idx = lab.long() - lo
        hit = (idx >= 0) & (idx < vloc)
        g = torch.gather(lg, -1, idx.clamp(0, vloc - 1)[..., None])[..., 0]
        gold = _AllReduceSum.apply(torch.where(hit, g, torch.zeros_like(g)),
                                   [group])
        return torch.log(sumexp) + mx - gold

    per_tok = local_region(body, ((b, None, ctx["model"]), (b, None)), (1,),
                           logits, labels)
    return settle(torch.mean(per_tok), None)
