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
layer's cache per token) and returns the same dict.

On DTensors under a mesh context (the dry run, ``sharding_ctx``), the
projections stay sharded products and the attention itself runs on each
device's shard (:func:`attention_region`: batch rows, and heads over the
model axis where they divide it), the flash kernel included through its
op; decode writes each device's cache shard there, and the layer's dict
takes the caches it returns.  Without a mesh the regions are plain calls.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, softcap
from repro_torch.sharding_ctx import (
    count, current, is_dtensor, local_region, placements_for, same_layout,
    settle)

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
    q = split_heads(q, hq, hd)
    k = split_heads(k, hkv, hd)
    v = split_heads(v, hkv, hd)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def split_heads(t: torch.Tensor, heads: int, hd: int) -> torch.Tensor:
    """(B, T, heads * hd) -> (B, T, heads, hd).  A DTensor projection
    still holding partial sums (its weight's input dim split, as FSDP's
    split stays where the batch cannot use the axis) is summed first, so
    no cache is cast to bf16 part by part; one whose last dim is split
    over a mesh axis whose size does not divide ``heads`` (so the split
    would cut a head) is first gathered whole along it, counted under
    ``"heads"``."""
    B, T = t.shape[:2]
    if is_dtensor(t):
        t = settle(t, None)
        whole = _whole_heads(t, heads)
        if whole is not t:
            count("heads")
        t = whole
    return t.reshape(B, T, heads, hd)


def _whole_heads(t, heads: int):
    """DTensor ``t`` gathered whole along its last dim over each mesh axis
    that splits it and whose size does not divide ``heads``; ``t`` itself
    where there is none."""
    sizes = t.device_mesh.shape
    pl = list(t.placements)
    bad = [i for i, p in enumerate(pl)
           if p.is_shard(t.dim() - 1) and heads % sizes[i]]
    if not bad:
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate() if i in bad else p
                                          for i, p in enumerate(pl)])


def merge_heads(o: torch.Tensor, wo=None) -> torch.Tensor:
    """(B, T, H, hd) -> (B, T, H * hd), as ``reshape``.  On a DTensor its
    gradient, which the next product may hand back split along the merged
    dim over an axis whose size does not divide H, is first gathered whole
    along it, so the split back into heads cuts none; and where ``wo``,
    the output projection, splits its rows over an axis the merged dim is
    whole on, the merged dim is cut to match (a local slice), so the
    product, and its weight gradient, run on each device's rows."""
    B, T, H, hd = o.shape
    if not is_dtensor(o):
        return o.reshape(B, T, H * hd)
    o = _MergeHeads.apply(o)
    if wo is not None and is_dtensor(wo):
        from torch.distributed.tensor import Shard
        pl = [Shard(2) if w.is_shard(0) and p.is_replicate() else p
              for p, w in zip(o.placements, wo.placements)]
        if pl != list(o.placements):
            o = o.redistribute(o.device_mesh, pl)
    return o


class _MergeHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, o):
        B, T, H, hd = o.shape
        ctx.shape = o.shape
        return o.reshape(B, T, H * hd)

    @staticmethod
    def backward(ctx, g):
        return _whole_heads(g, ctx.shape[2]).reshape(ctx.shape)


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
    head h // G as in :func:`_sdpa_chunked`.  The call goes through the
    kernel's PyTorch op (``ops.FLASH_OP``), which a fake tensor and a FLOP
    counter also read."""
    return ops.FLASH_OP(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal).transpose(1, 2)


def _flash_applies(cfg: ArchConfig, window: int, positions) -> bool:
    """Whether a causal full-sequence layer computes exactly what the flash
    kernel computes: no window, no logit softcap, positions arange(T)."""
    return window == 0 and cfg.attn_softcap == 0 and positions is None


def _records_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def head_specs(q, k):
    """(q's spec, k's and v's spec) for (B, T, H, hd) activations inside
    an attention region under a mesh context: batch over the batch axes;
    q's heads over the model axis where their count divides it, and k's
    and v's too where theirs does.  Where the kv heads do not divide it
    (GQA with few kv heads) they stay whole on every device, and each
    device's q heads read the slice of them they map to
    (:func:`_kv_cutter`); where even that cannot be (a device's q heads
    would straddle a group unevenly) everything stays whole."""
    ctx = current()
    m = ctx["model"]
    n = dict(zip(q.device_mesh.mesh_dim_names, q.device_mesh.shape))[m]
    hq, hkv = q.shape[2], k.shape[2]
    g, hq_loc = hq // hkv, hq // n
    q_ok = hq % n == 0 and (hkv % n == 0 or hq_loc % g == 0
                            or g % hq_loc == 0)
    kv_ok = q_ok and hkv % n == 0
    b = ctx["batch"]
    return ((b, None, m if q_ok else None, None),
            (b, None, m if kv_ok else None, None))


def attention_region(core, q, k, v, *rest, seq_core=None, q_pos=None,
                     k_pos=None):
    """``core(q, k, v, *rest)``, a function of (B, T, H, hd) tensors that
    returns one of q's shape, run on local shards when q is a DTensor
    (``sharding_ctx.local_region``, specs by :func:`head_specs`, k and v
    cut to the local q heads' kv heads; ``rest`` replicated), else as
    is.  Where q's heads cannot split over the model axis (40 or 8 heads
    on 16 devices), ``seq_core(q, k, v, q_pos, k_pos)`` runs instead on
    each device's block of queries (``q_pos``, default arange(Tq), split
    with it; the rows padded to a multiple of the axis) against every key
    (``k_pos``, default arange(Tk)), so the attention is not repeated on
    every device of the axis; its output is gathered back to q's layout
    (counted under ``"seq"``).  A single query row cannot split so: where
    ``seq_core`` is unmasked (whisper's cross-attention at decode) and the
    axis divides the head dim, :func:`_attend_row` runs on each device's
    slice of it, its logits' partial sums summed over the axis (counted
    under ``"hd"``)."""
    if not is_dtensor(q):
        return core(q, k, v, *rest)
    qs, kvs = head_specs(q, k)
    ctx = current()
    m = ctx["model"]
    n = dict(zip(q.device_mesh.mesh_dim_names, q.device_mesh.shape))[m]
    kw = getattr(seq_core, "keywords", {})
    if (qs[2] is None and q.shape[1] == 1 and n > 1 and q.shape[3] % n == 0
            and kw and not kw["causal"] and not kw["window"]):
        hs = (ctx["batch"], None, None, m)
        partial_sum = _axis_sum(q.device_mesh, m)
        out = local_region(
            lambda q, k, v: _attend_row(q, k, v, None, kw["attn_cap"],
                                        partial_sum, n).to(q.dtype),
            (hs,) * 3, (0,), q, k, v)
        count("hd")
        return out.redistribute(q.device_mesh, placements_for(
            q.device_mesh, q.shape, qs))
    if qs[2] is None and seq_core is not None and n > 1 and q.shape[1] > 1:
        dev = q.device
        T = q.shape[1]
        if q_pos is None:
            q_pos = torch.arange(T, dtype=torch.int32, device=dev)
        if k_pos is None:
            k_pos = torch.arange(k.shape[1], dtype=torch.int32, device=dev)
        pad = -T % n
        if pad:
            # a sequence the axis does not divide (whisper's 1500 frames):
            # padded query rows, dropped from the output
            q = same_layout(lambda t: torch.nn.functional.pad(
                t, (0, 0, 0, 0, 0, pad)), q)
            q_pos = torch.cat([q_pos, q_pos[-1:].expand(pad)])
        b = ctx["batch"]
        whole = (b, None, None, None)
        out = local_region(seq_core, ((b, m, None, None), whole, whole, (m,),
                                      (None,)), (0,), q, k, v, q_pos, k_pos)
        count("seq")
        out = out.redistribute(q.device_mesh, placements_for(
            q.device_mesh, q.shape, whole))
        return same_layout(lambda t: t[:, :T], out) if pad else out
    cut = _kv_cutter(q, k, qs, kvs)

    def local(q, k, v, *r):
        return core(q, *cut(q, k, v), *r)
    return local_region(local, (qs, kvs, kvs) + tuple(
        None if r is None else (None,) * r.dim() for r in rest), (0,),
        q, k, v, *rest)


def _axis_sum(mesh, axis: str):
    """t -> t all-reduced (sum) over ``axis`` of ``mesh``: the logits'
    partial sums over a split head dim (no gradient: decode only)."""
    from torch.distributed import _functional_collectives as funcol
    group = (mesh, list(mesh.mesh_dim_names).index(axis))
    return lambda t: funcol.wait_tensor(funcol.all_reduce(t, "sum", group))


def chunked_core(causal: bool, window: int = 0, attn_cap: float = 0.0,
                 block_q: int = 512):
    """A ``seq_core`` for :func:`attention_region`: :func:`_sdpa_chunked`
    over explicit positions, its route counted in ``ROUTES``; its
    ``keywords`` tell the region the mask."""
    return functools.partial(_chunked, causal=causal, window=window,
                             attn_cap=attn_cap, block_q=block_q)


def _chunked(q, k, v, q_pos, k_pos, **kw):
    ROUTES["chunked_grad" if _records_grad(q, k, v) else "chunked"] += 1
    return _sdpa_chunked(q, k, v, q_pos, k_pos, **kw)


def _kv_cutter(q, k, qs, kvs):
    """A function (q_loc, k_loc, v_loc) -> (k, v) cut to the kv heads the
    device's q heads read (identity unless q's heads are split over the
    model axis and k's are whole)."""
    if qs[2] is None or kvs[2] is not None:
        return lambda q, k, v: (k, v)
    mesh = q.device_mesh
    rank = mesh.get_local_rank(list(mesh.mesh_dim_names).index(qs[2]))
    g = q.shape[2] // k.shape[2]

    def cut(q_loc, k_loc, v_loc):
        hq_loc = q_loc.shape[2]
        lo = rank * hq_loc // g
        hi = (rank * hq_loc + hq_loc - 1) // g + 1
        return k_loc[:, :, lo:hi], v_loc[:, :, lo:hi]
    return cut


def _attend(q, k, v, cfg: ArchConfig, positions, window: int, block_q: int):
    if is_dtensor(q):
        return attention_region(
            lambda q, k, v, *pos: _attend(q, k, v, cfg, pos[0] if pos
                                          else None, window, block_q),
            q, k, v, *(() if positions is None else (positions,)),
            seq_core=chunked_core(True, window, cfg.attn_softcap, block_q),
            q_pos=positions, k_pos=positions)
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
    return settle(merge_heads(out, p.wo) @ p.wo, None)


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
        def ring(t):
            return torch.roll(t, shifts=T % S, dims=1)
        ck = same_layout(ring, k[:, T - S:])
        cv = same_layout(ring, v[:, T - S:])
    else:
        pad = (0, 0, 0, 0, 0, S - T)
        ck = torch.nn.functional.pad(k, pad)
        cv = torch.nn.functional.pad(v, pad)
    cache = {"k": ck.to(BF16), "v": cv.to(BF16)}
    o = settle(merge_heads(out, p.wo) @ p.wo, None)
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
    hq, hd = cfg.n_heads, cfg.resolved_head_dim
    window = cfg.sliding_window if kind == "attn_local" else 0
    pos = int(pos)

    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)

    def core(q, k, v, ck, cv, cut=None, partial_sum=None, hd_parts=1):
        return _decode_core(q, k, v, ck, cv, pos, window, cfg.attn_softcap,
                            x.dtype, cut, partial_sum, hd_parts)
    if is_dtensor(q):
        o, ck, cv = _decode_region(core, q, k, v, cache["k"], cache["v"])
        cache["k"], cache["v"] = ck, cv
    else:
        o, _, _ = core(q, k, v, cache["k"], cache["v"])
    o = settle(merge_heads(o, p.wo) @ p.wo, None)
    return o, cache


def _decode_region(core, q, k, v, ck, cv):
    """:func:`_decode_core` on local shards.  Where the kv heads do not
    divide the model axis and the head dim does (the cache's own layout
    then: ``cache_specs`` splits its head dim), every tensor is split
    along the head dim: each device writes its slice of the new key and
    value, the logits' partial sums are all-reduced over the axis, and
    the output, split along the head dim, is gathered whole (one token a
    row: small); a batch the batch axes cannot split splits q's heads
    over them (:func:`_idle_heads`), here and on a model axis of one
    device.  Otherwise q, and k, v and the cache, by
    :func:`head_specs` (a cache laid out otherwise is redistributed to
    it, counted), each device writing its kv heads and its q heads
    reading the ones they map to.  Returns (o, ck, cv) as DTensors, the
    cache in the region's layout."""
    ctx = current()
    m = ctx["model"]
    mesh = q.device_mesh
    names = list(mesh.mesh_dim_names)
    n = mesh.shape[names.index(m)]
    hd_split = n > 1 and k.shape[2] % n and q.shape[3] % n == 0
    if hd_split or n == 1:
        hs = (ctx["batch"], None, None, m if hd_split else None)
        qs, cut = _idle_heads(q, k, hs)
        if hd_split or cut is not None:
            partial_sum = _axis_sum(mesh, m) if hd_split else None
            o, ck, cv = local_region(
                lambda q, k, v, ck, cv: core(q, k, v, ck, cv, cut,
                                             partial_sum, n),
                (qs,) + (hs,) * 4, (0, 3, 4), q, k, v, ck, cv)
            count("hd" if hd_split else "idle_heads")
            return (o.redistribute(mesh, placements_for(
                mesh, o.shape, (ctx["batch"], None, None, None))), ck, cv)
    qs, kvs = head_specs(q, k)
    cut = _kv_cutter(q, k, qs, kvs)
    return local_region(lambda q, k, v, ck, cv: core(q, k, v, ck, cv, cut),
                        (qs,) + (kvs,) * 4, (0, 3, 4), q, k, v, ck, cv)


def _idle_heads(q, k, hs):
    """(q's spec, cut) for the head-dim split of :func:`_decode_region`.
    Where the batch cannot split over the batch axes (long_500k's one
    row), those axes would repeat the whole score: q's heads split over
    them instead (where they divide the heads and a device's heads map
    evenly onto kv heads), and ``cut(q, ck, cv)`` keeps the kv heads the
    device's q heads read.  Else (``hs``, None)."""
    ctx = current()
    axes = ctx["all_batch_axes"]
    mesh = q.device_mesh
    names = list(mesh.mesh_dim_names)
    if ctx["batch"] is not None or not axes:
        return hs, None
    nb, rank = 1, 0
    for a in axes:
        i = names.index(a)
        rank = rank * mesh.shape[i] + mesh.get_local_rank(i)
        nb *= mesh.shape[i]
    hq, hkv = q.shape[2], k.shape[2]
    g, hq_loc = hq // hkv, hq // nb
    if nb == 1 or hq % nb or not (g % hq_loc == 0 or hq_loc % g == 0):
        return hs, None
    lo = rank * hq_loc // g
    hi = (rank * hq_loc + hq_loc - 1) // g + 1

    def cut(q_loc, ck, cv):
        return ck[:, :, lo:hi], cv[:, :, lo:hi]
    return (None, None, axes, hs[3]), cut


def _decode_core(q, k, v, ck, cv, pos: int, window: int, attn_cap: float,
                 dtype, cut=None, partial_sum=None, hd_parts: int = 1):
    """Write the new key and value into the (B,S,Hkv,hd) caches at slot
    ``pos % S`` (in place) and attend q (B,1,Hq,hd) over them (over the
    kv heads ``cut(q, ck, cv)`` keeps, where given); returns (o
    (B,1,Hq,hd) in ``dtype``, ck, cv).  With ``partial_sum`` the tensors
    hold one of ``hd_parts`` slices of the head dim: the logits' partial
    sums go through it, scaled by the whole head dim."""
    S = ck.shape[1]
    dev = q.device
    slot = pos % S                     # == pos for full-length caches
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

    ak, av = (ck, cv) if cut is None else cut(q, ck, cv)
    o = _attend_row(q, ak, av, valid, attn_cap, partial_sum, hd_parts)
    return o.to(dtype), ck, cv


def _attend_row(q, k, v, valid, attn_cap: float, partial_sum=None,
                hd_parts: int = 1) -> torch.Tensor:
    """One query row q (B,1,Hq,hd) over k, v (B,S,Hkv,hd), the keys
    ``valid`` (S,) keeps (None: every key); returns (B,1,Hq,hd) f32.  With
    ``partial_sum`` the tensors hold one of ``hd_parts`` slices of the
    head dim: the logits' partial sums go through it, scaled by the whole
    head dim."""
    B, _, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(B, hkv, hq // hkv, hd).to(F32)
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k.to(F32))
    if partial_sum is not None:
        logits = partial_sum(logits)
    logits = softcap(logits / math.sqrt(hd * hd_parts), attn_cap)
    if valid is not None:
        logits = torch.where(valid[None, None, None, :], logits,
                             torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", w, v.to(F32))
    return o.reshape(B, 1, hq, hd)
