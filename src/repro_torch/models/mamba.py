"""Mamba2 SSD (state-space duality) block: the chunked scan over a whole
sequence and the O(1) decode recurrence [arXiv:2405.21060].

A port of the JAX package's ``models/mamba.py``, function for function.
The full-sequence path evaluates the SSD dual form chunk by chunk: each
chunk computes the quadratic intra-chunk term (an attention-like (L x L)
product under the cumulative-decay mask) plus the inter-chunk term from
the carried state, then updates the state.  The reference runs the chunks
in one ``lax.scan``; here it is a Python loop over chunks, which bounds
the transient (B, L, L, H) tiles to one chunk in the same way.

Numerics follow the reference: A < 0, so every exponent (cum_t - cum_s
for t >= s, total - cum_s, cum_t) is <= 0; the masked exponent is set to
-inf before the ``exp`` (masking the product after it would turn inf * 0
into NaN); ``dt_bias``, ``A_log``, ``D`` and the state are f32, and ``y``
is cast back to the input's dtype.  ``softplus`` is ``jax.nn.softplus``'s
``logaddexp(x, 0)``, not ``F.softplus`` (whose threshold switch differs).

Decode carries {ssm: (B,H,P,N) f32, conv: (B,k-1,conv_dim)}, the SSM
analogue of a KV cache.  The conv state from ``mamba_forward`` has the
params' dtype, from ``init_mamba_state`` the cache dtype; after a decode
step it has the dtype the window promotes to, as in the reference.

The params are an ``nn.ParameterDict`` keyed as the reference's dict.
There is no kernel here: the reference's SSD scan is plain ``jnp``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense_init, rms_norm, rms_norm_init

F32 = torch.float32
State = Dict[str, torch.Tensor]


def _dims(cfg: ArchConfig):
    mc = cfg.mamba
    d = cfg.d_model
    return mc, d, mc.d_inner(d), mc.n_heads(d), mc.head_dim, mc.d_state


def conv_dim(cfg: ArchConfig) -> int:
    mc, d, di, nh, hd, N = _dims(cfg)
    return di + 2 * N          # conv runs over [x, B, C] (single group)


def mamba_init(gen: Optional[torch.Generator], cfg: ArchConfig, dtype=F32,
               device="cpu") -> nn.ParameterDict:
    """One Mamba layer's params, drawn from ``gen`` (``None`` leaves the
    drawn ones uninitialized, for weights that are loaded next); built with
    ``requires_grad=False``, as the stack's other params."""
    mc, d, di, nh, hd, N = _dims(cfg)
    cd = conv_dim(cfg)
    if gen is None:
        conv_w = torch.empty((mc.d_conv, cd), dtype=dtype, device=device)
    else:
        conv_w = (torch.randn((mc.d_conv, cd), generator=gen, dtype=F32,
                              device=device) * (1.0 / mc.d_conv)).to(dtype)
    leaves = (
        ("wz", dense_init(gen, d, di, dtype, device)),
        ("wx", dense_init(gen, d, di, dtype, device)),
        ("wB", dense_init(gen, d, N, dtype, device)),
        ("wC", dense_init(gen, d, N, dtype, device)),
        ("wdt", dense_init(gen, d, nh, dtype, device)),
        ("dt_bias", torch.zeros((nh,), dtype=F32, device=device)),
        ("conv_w", conv_w),
        ("conv_b", torch.zeros((cd,), dtype=dtype, device=device)),
        ("A_log", torch.log(torch.arange(1, nh + 1, dtype=F32,
                                         device=device))),
        ("D", torch.ones((nh,), dtype=F32, device=device)),
        ("norm", rms_norm_init(di, dtype, device)),
        ("wo", dense_init(gen, di, d, dtype, device)))
    return nn.ParameterDict({k: nn.Parameter(w, requires_grad=False)
                             for k, w in leaves})


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over time.  xbc: (B,T,Cd); w: (k,Cd).  The k
    shifts are summed in order i = 0..k-1, then the bias is added."""
    k = w.shape[0]
    T = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(k):
        out = out + pad[:, i:i + T] * w[i]
    return out + b


def _project(p, x: torch.Tensor, cfg: ArchConfig):
    """x: (B,T,D) -> z, the conv input xBC, and dt (f32)."""
    z = x @ p["wz"]
    xin = x @ p["wx"]
    Bp = x @ p["wB"]
    Cp = x @ p["wC"]
    dt = _softplus((x @ p["wdt"]).to(F32) + p["dt_bias"])
    return z, torch.cat([xin, Bp, Cp], dim=-1), dt


def _split_conv(xbc: torch.Tensor, cfg: ArchConfig):
    mc, d, di, nh, hd, N = _dims(cfg)
    xin, Bp, Cp = torch.split(xbc, [di, N, N], dim=-1)
    return F.silu(xin), Bp, Cp


def _ssd_chunk_scan(xh, Bp, Cp, dt, A, h0):
    """SSD over all chunks, one after the other.

    xh: (B,C,L,H,P); Bp, Cp: (B,C,L,N) f32; dt: (B,C,L,H) f32; A: (H,)
    negative; h0: (B,H,P,N) f32 initial state.  Returns (y: (B,C,L,H,P)
    f32, h_final)."""
    L = xh.shape[2]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=xh.device))
    h = h0
    ys = []
    for c in range(xh.shape[1]):
        xc = xh[:, c].to(F32)                                  # (B,L,H,P)
        Bc, Cc, dtc = Bp[:, c], Cp[:, c], dt[:, c]
        dA = dtc * A                                           # (B,L,H) <= 0
        cum = torch.cumsum(dA, dim=1)
        total = cum[:, -1]                                     # (B,H)

        # intra-chunk (dual, attention-like) term; the exponent is masked
        CB = torch.einsum("btn,bsn->bts", Cc, Bc)              # (B,L,L)
        expo = cum[:, :, None, :] - cum[:, None, :, :]          # (B,t,s,H)
        decay = torch.exp(torch.where(tri[None, :, :, None], expo,
                                      -torch.inf))
        scores = CB[..., None] * decay * dtc[:, None, :, :]    # (B,t,s,H)
        y_intra = torch.einsum("btsh,bshp->bthp", scores, xc)

        # inter-chunk term from the carried state
        y_inter = torch.exp(cum)[..., None] * torch.einsum(
            "btn,bhpn->bthp", Cc, h)

        # state update
        w = torch.exp(total[:, None, :] - cum) * dtc           # (B,L,H)
        S = torch.einsum("blh,bln,blhp->bhpn", w, Bc, xc)
        h = torch.exp(total)[:, :, None, None] * h + S
        ys.append(y_intra + y_inter)
    return torch.stack(ys, dim=1), h


def _ssd(xin, Bp, Cp, dt, A, D, cfg: ArchConfig, h0=None):
    """xin: (B,T,di) post-conv; returns (y: (B,T,di), h_final: (B,H,P,N)).
    The chunk length is ``cfg.mamba.chunk`` (at most T), halved until it
    divides T."""
    mc, d, di, nh, hd, N = _dims(cfg)
    B, T, _ = xin.shape
    L = min(mc.chunk, T)
    while T % L != 0:
        L //= 2
    L = max(L, 1)
    C = T // L
    xh = xin.reshape(B, C, L, nh, hd)
    Bc = Bp.reshape(B, C, L, N).to(F32)
    Cc = Cp.reshape(B, C, L, N).to(F32)
    dtc = dt.reshape(B, C, L, nh)
    if h0 is None:
        h0 = torch.zeros((B, nh, hd, N), dtype=F32, device=xin.device)
    y, h = _ssd_chunk_scan(xh, Bc, Cc, dtc, A, h0)
    y = y.reshape(B, T, nh, hd) + D[None, None, :, None] * xh.reshape(
        B, T, nh, hd).to(F32)
    return y.reshape(B, T, di).to(xin.dtype), h


def mamba_forward(p, x: torch.Tensor, cfg: ArchConfig, h0=None, conv0=None):
    """Full-sequence forward.  Returns (out (B,T,D), {"ssm", "conv"}): the
    final state, and the last k-1 rows of the pre-conv xBC (left-padded
    with zeros when T < k-1).  ``h0`` and ``conv0`` continue from a carried
    state."""
    mc, d, di, nh, hd, N = _dims(cfg)
    z, xbc, dt = _project(p, x, cfg)
    if conv0 is not None:
        xbc_in = torch.cat([conv0, xbc], dim=1)
        conv_out = _causal_conv(xbc_in, p["conv_w"],
                                p["conv_b"])[:, conv0.shape[1]:]
    else:
        conv_out = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xin, Bp, Cp = _split_conv(conv_out, cfg)
    A = -torch.exp(p["A_log"])
    y, h = _ssd(xin, Bp, Cp, dt, A, p["D"], cfg, h0)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["wo"]
    k = mc.d_conv
    T = xbc.shape[1]
    conv_state = (xbc[:, T - (k - 1):] if T >= k - 1
                  else F.pad(xbc, (0, 0, k - 1 - T, 0)))
    return out, {"ssm": h, "conv": conv_state}


def init_mamba_state(cfg: ArchConfig, batch: int, dtype=F32, device="cpu"
                     ) -> State:
    mc, d, di, nh, hd, N = _dims(cfg)
    return {"ssm": torch.zeros((batch, nh, hd, N), dtype=F32, device=device),
            "conv": torch.zeros((batch, mc.d_conv - 1, conv_dim(cfg)),
                                dtype=dtype, device=device)}


def mamba_decode(p, x: torch.Tensor, state: State, cfg: ArchConfig):
    """One-token decode.  x: (B,1,D).  Returns (out (B,1,D), new state);
    the conv is an f32 product over the window of the carried k-1 rows and
    the new one."""
    mc, d, di, nh, hd, N = _dims(cfg)
    B = x.shape[0]
    z, xbc, dt = _project(p, x, cfg)                       # T = 1
    window = torch.cat([state["conv"], xbc[:, :1]], dim=1)  # (B,k,Cd)
    conv_out = torch.einsum("bkc,kc->bc", window.to(F32),
                            p["conv_w"].to(F32)) + p["conv_b"].to(F32)
    xin, Bp, Cp = _split_conv(conv_out[:, None].to(x.dtype), cfg)
    xh = xin[:, 0].reshape(B, nh, hd).to(F32)
    Bv = Bp[:, 0].to(F32)                                  # (B,N)
    Cv = Cp[:, 0].to(F32)
    dt1 = dt[:, 0]                                         # (B,H)

    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt1 * A)                                # (B,H)
    upd = dt1[:, :, None, None] * xh[:, :, :, None] * Bv[:, None, None, :]
    h1 = dA[:, :, None, None] * state["ssm"] + upd         # (B,H,P,N)
    y = torch.einsum("bhpn,bn->bhp", h1, Cv) + p["D"][None, :, None] * xh
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["wo"], {"ssm": h1, "conv": window[:, 1:]}
