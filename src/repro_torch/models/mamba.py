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
from repro_torch.sharding_ctx import (
    _PartialSum, current, is_dtensor, local_region, placements_for, settle)

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


def _products(p, x: torch.Tensor):
    """x: (B,T,D) -> the in-projections z, x, B, C and dt's f32 logits."""
    return (x @ p["wz"], x @ p["wx"], x @ p["wB"], x @ p["wC"],
            (x @ p["wdt"]).to(F32))


def _xbc_dt(xin, Bp, Cp, dt_logit, dt_bias):
    return torch.cat([xin, Bp, Cp], dim=-1), _softplus(dt_logit + dt_bias)


def _project(p, x: torch.Tensor, cfg: ArchConfig):
    """x: (B,T,D) -> z, the conv input xBC, and dt (f32)."""
    z, xin, Bp, Cp, dt_logit = _products(p, x)
    return (z,) + _xbc_dt(xin, Bp, Cp, dt_logit, p["dt_bias"])


_LEAVES = ("dt_bias", "conv_w", "conv_b", "A_log", "D", "norm")


class HeadShard:
    """One device's share of a Mamba layer's heads under a mesh: ``rank``
    of ``n`` along the model axis, ``group`` its collectives' group.  The
    core cuts the conv's x channels to its heads (the B and C channels,
    shared by every head, stay whole; a decode step convolves its share
    of them and gathers the rest), splits the SSD's C·Bᵀ over the state
    channels, sums the gated norm's squares over the group, and gathers
    the conv state's x channels back whole."""

    def __init__(self, rank: int, n: int, group):
        self.rank, self.n, self.group = rank, n, group

    def conv_cut(self, w: torch.Tensor, di_loc: int) -> torch.Tensor:
        """A conv-channel tensor (..., di + 2N) cut to this device's x
        channels followed by every B and C channel."""
        di = di_loc * self.n
        lo = self.rank * di_loc
        return torch.cat([w[..., lo:lo + di_loc], w[..., di:]], dim=-1)

    def conv_whole(self, state: torch.Tensor, di_loc: int) -> torch.Tensor:
        """A conv state (B, k-1, di_loc + 2N) with the x channels of every
        device gathered in order."""
        from repro_torch.models.moe import _all_gather
        x = _all_gather(state[..., :di_loc].contiguous(), state.dim() - 1,
                        self.group)
        return torch.cat([x, state[..., di_loc:]], dim=-1)

    def conv_step(self, window: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor, di_loc: int) -> torch.Tensor:
        """A decode step's conv (:func:`_conv_step`) over the channels
        :meth:`conv_cut` keeps: the x channels local, and each device its
        N/n of the B and of the C channels, the rest gathered from the
        group, so no device convolves every B and C channel (all of them
        where the axis does not divide N)."""
        N = (window.shape[-1] - di_loc) // 2
        if N % self.n:
            return _conv_step(window, w, b)
        m = N // self.n
        lo = di_loc + self.rank * m

        def mine(t):
            return torch.cat([t[..., :di_loc], t[..., lo:lo + m],
                              t[..., lo + N:lo + N + m]], dim=-1)
        out = _conv_step(mine(window), mine(w), mine(b))
        from repro_torch.models.moe import _all_gather
        bc = _all_gather(out[:, di_loc:].contiguous(), 1, self.group)
        bc = bc.reshape(out.shape[0], self.n, 2, m).transpose(1, 2)
        return torch.cat([out[:, :di_loc], bc.reshape(out.shape[0], 2 * N)],
                         dim=-1)

    def cb(self, Cc: torch.Tensor, Bc: torch.Tensor) -> torch.Tensor:
        """The SSD's per-chunk C·Bᵀ, (B,L,N) x (B,L,N) -> (B,L,L), shared
        by every head: each device contracts its N/n of the state
        channels and the partial products are summed over the group, so
        the product is not repeated on every device (N whole where the
        axis does not divide it)."""
        N = Cc.shape[-1]
        if N % self.n:
            return _cb(Cc, Bc)
        lo, hi = self.rank * N // self.n, (self.rank + 1) * N // self.n
        return _PartialSum.apply(_cb(Cc[..., lo:hi], Bc[..., lo:hi]),
                                 self.group)

    def norm(self, v: torch.Tensor, weight: torch.Tensor, eps: float):
        """:func:`rms_norm` over the whole d_inner of which ``v`` holds
        this device's slice: its sum of squares is summed over the
        group."""
        dtype = v.dtype
        v = v.to(F32)
        ss = _PartialSum.apply(torch.sum(torch.square(v), dim=-1,
                                         keepdim=True), self.group)
        v = v * torch.rsqrt(ss / (v.shape[-1] * self.n) + eps)
        return (v * (1.0 + weight.to(F32))).to(dtype)


def _mixer(core, p, x: torch.Tensor, cfg: ArchConfig, *state):
    """``core(z, xin, Bp, Cp, dt_logit, *leaves, *state, shard)`` after the
    in-projections.  On DTensors the projections stay sharded products
    and the core (conv, SSD scan, gated norm) runs on each device's batch
    rows (``local_region``) and, where the heads divide the model axis,
    on its heads (``shard`` a :class:`HeadShard`; else None and the
    heads whole on every device).  Its outputs: y split over d_inner as
    the heads are, the SSM state by heads, the conv state whole."""
    args = _products(p, x) + tuple(p[k] for k in _LEAVES) + state
    if not is_dtensor(x):
        return core(*args, None)
    ctx = current()
    b, m = ctx["batch"], ctx["model"]
    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    n = mesh.shape[names.index(m)]
    nh = cfg.mamba.n_heads(cfg.d_model)
    split = n > 1 and nh % n == 0
    h = m if split else None
    # z, x, B, C, dt; dt_bias, conv_w, conv_b, A_log, D, norm; ssm, conv
    specs = ((b, None, h), (b, None, h), (b, None, None), (b, None, None),
             (b, None, h), (h,), (None, None), (None,), (h,), (h,), (h,),
             (b, h, None, None), (b, None, None))
    ssm_pl = placements_for(mesh, (x.shape[0], nh, cfg.mamba.head_dim,
                                   cfg.mamba.d_state), specs[11])
    shard = (HeadShard(mesh.get_local_rank(names.index(m)), n,
                       (mesh, names.index(m))) if split else None)
    return local_region(lambda *a: core(*a, shard),
                        tuple(None if a is None else sp
                              for a, sp in zip(args, specs)),
                        (0, ssm_pl, 2), *args)


def _split_conv(xbc: torch.Tensor, cfg: ArchConfig):
    """xBC -> silu(x), B, C; x is every channel before the last 2N (all of
    d_inner, or one device's heads of it)."""
    N = cfg.mamba.d_state
    xin, Bp, Cp = torch.split(xbc, [xbc.shape[-1] - 2 * N, N, N], dim=-1)
    return F.silu(xin), Bp, Cp


def _conv_step(window: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """One decode step's causal conv in f32: window (B,k,C) of the
    carried k-1 rows and the new one, w (k,C), b (C,) -> (B,C)."""
    return torch.einsum("bkc,kc->bc", window.to(F32),
                        w.to(F32)) + b.to(F32)


def _cb(Cc: torch.Tensor, Bc: torch.Tensor) -> torch.Tensor:
    return torch.einsum("btn,bsn->bts", Cc, Bc)


def _ssd_chunk_scan(xh, Bp, Cp, dt, A, h0, cb=_cb):
    """SSD over all chunks, one after the other.

    xh: (B,C,L,H,P); Bp, Cp: (B,C,L,N) f32; dt: (B,C,L,H) f32; A: (H,)
    negative; h0: (B,H,P,N) f32 initial state; ``cb`` the chunk's C·Bᵀ
    (:meth:`HeadShard.cb` on a device's heads).  Returns (y: (B,C,L,H,P)
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
        CB = cb(Cc, Bc)                                        # (B,L,L)
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


def _ssd(xin, Bp, Cp, dt, A, D, cfg: ArchConfig, h0=None, cb=_cb):
    """xin: (B,T,di) post-conv; returns (y: (B,T,di), h_final: (B,H,P,N)).
    The chunk length is ``cfg.mamba.chunk`` (at most T), halved until it
    divides T; ``cb`` is :func:`_ssd_chunk_scan`'s."""
    mc, hd, N = cfg.mamba, cfg.mamba.head_dim, cfg.mamba.d_state
    B, T, di = xin.shape
    nh = di // hd               # all heads, or one device's
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
    y, h = _ssd_chunk_scan(xh, Bc, Cc, dtc, A, h0, cb)
    y = y.reshape(B, T, nh, hd) + D[None, None, :, None] * xh.reshape(
        B, T, nh, hd).to(F32)
    return y.reshape(B, T, di).to(xin.dtype), h


def mamba_forward(p, x: torch.Tensor, cfg: ArchConfig, h0=None, conv0=None):
    """Full-sequence forward.  Returns (out (B,T,D), {"ssm", "conv"}): the
    final state, and the last k-1 rows of the pre-conv xBC (left-padded
    with zeros when T < k-1).  ``h0`` and ``conv0`` continue from a carried
    state."""
    def core(z, xin, Bp, Cp, dt_logit, dt_bias, conv_w, conv_b, A_log, D,
             norm, h0, conv0, shard):
        di_loc = xin.shape[-1]
        if shard is not None:
            conv_w, conv_b = (shard.conv_cut(conv_w, di_loc),
                              shard.conv_cut(conv_b, di_loc))
            if conv0 is not None:
                conv0 = shard.conv_cut(conv0, di_loc)
        xbc, dt = _xbc_dt(xin, Bp, Cp, dt_logit, dt_bias)
        if conv0 is not None:
            xbc_in = torch.cat([conv0, xbc], dim=1)
            conv_out = _causal_conv(xbc_in, conv_w,
                                    conv_b)[:, conv0.shape[1]:]
        else:
            conv_out = _causal_conv(xbc, conv_w, conv_b)
        xin, Bp, Cp = _split_conv(conv_out, cfg)
        A = -torch.exp(A_log)
        y, h = _ssd(xin, Bp, Cp, dt, A, D, cfg, h0,
                    _cb if shard is None else shard.cb)
        gated = y * F.silu(z)
        y = (rms_norm(gated, norm, cfg.norm_eps) if shard is None
             else shard.norm(gated, norm, cfg.norm_eps))
        k = cfg.mamba.d_conv
        T = xbc.shape[1]
        conv_state = (xbc[:, T - (k - 1):] if T >= k - 1
                      else F.pad(xbc, (0, 0, k - 1 - T, 0)))
        if shard is not None:
            conv_state = shard.conv_whole(conv_state, di_loc)
        return y, h, conv_state

    y, h, conv_state = _mixer(core, p, x, cfg, h0, conv0)
    return settle(y @ p["wo"], None), {"ssm": h, "conv": conv_state}


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
    hd = cfg.mamba.head_dim

    def core(z, xin, Bp, Cp, dt_logit, dt_bias, conv_w, conv_b, A_log, D,
             norm, ssm, conv, shard):
        B = z.shape[0]
        di_loc = xin.shape[-1]
        nh_loc = di_loc // hd
        if shard is not None:
            conv_w, conv_b, conv = (shard.conv_cut(t, di_loc)
                                    for t in (conv_w, conv_b, conv))
        xbc, dt = _xbc_dt(xin, Bp, Cp, dt_logit, dt_bias)      # T = 1
        window = torch.cat([conv, xbc[:, :1]], dim=1)          # (B,k,Cd)
        conv_out = (_conv_step(window, conv_w, conv_b) if shard is None
                    else shard.conv_step(window, conv_w, conv_b, di_loc))
        xin, Bp, Cp = _split_conv(conv_out[:, None].to(z.dtype), cfg)
        xh = xin[:, 0].reshape(B, nh_loc, hd).to(F32)
        Bv = Bp[:, 0].to(F32)                                  # (B,N)
        Cv = Cp[:, 0].to(F32)
        dt1 = dt[:, 0]                                         # (B,H)

        A = -torch.exp(A_log)
        dA = torch.exp(dt1 * A)                                # (B,H)
        upd = (dt1[:, :, None, None] * xh[:, :, :, None]
               * Bv[:, None, None, :])
        h1 = dA[:, :, None, None] * ssm + upd                  # (B,H,P,N)
        y = torch.einsum("bhpn,bn->bhp", h1, Cv) + D[None, :, None] * xh
        y = y.reshape(B, 1, di_loc).to(z.dtype)
        gated = y * F.silu(z)
        y = (rms_norm(gated, norm, cfg.norm_eps) if shard is None
             else shard.norm(gated, norm, cfg.norm_eps))
        new_conv = window[:, 1:]
        if shard is not None:
            new_conv = shard.conv_whole(new_conv, di_loc)
        return y, h1, new_conv

    y, h1, conv = _mixer(core, p, x, cfg, state["ssm"], state["conv"])
    return settle(y @ p["wo"], None), {"ssm": h1, "conv": conv}
