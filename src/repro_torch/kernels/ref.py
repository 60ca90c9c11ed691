"""Plain PyTorch versions of the hand-written CUDA kernels in this package.

Each ``*_ref`` function defines the semantics its kernel must match, with
the same signature and layout as the JAX package's ``kernels/ref.py``.
They are what :mod:`repro_torch.kernels.ops` runs for a tensor on the CPU,
and what the kernels are held against on the card.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

F32 = torch.float32
U32_MASK = 0xFFFFFFFF


def stump_scan_ref(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                   thresholds: torch.Tensor) -> torch.Tensor:
    """Weighted error of the polarity-(+1) stump for every (feature,
    threshold) pair.

    x: (N,F); y: (N,) in {-1,+1}; w: (N,); thresholds: (F,T) -> (F,T) f32.

    err[f,t] = sum_i w_i * [ sign(x[i,f] - thr[f,t]) != y_i ]
    (sign(0) counts as -1: strict `>` decides the +1 side.)

    The sum is taken in f64 and rounded once to f32, so it is the exact
    sum's f32 rounding whatever the order of the terms: f64 holds every
    partial sum of N f32 weights exactly while they span less than
    2**29 / N in magnitude, and misses it by far less than an f32 step
    otherwise.  Errors equal in exact arithmetic thus come out equal on
    every device.  The JAX package sums in f32.
    """
    pred = torch.where(x.to(F32)[:, :, None] > thresholds.to(F32)[None],
                       1.0, -1.0)
    miss = (pred != y.to(F32)[:, None, None]).to(torch.float64)
    return torch.einsum("n,nft->ft", w.to(F32).double(), miss).to(F32)


def stump_scan_batched_ref(x: torch.Tensor, y: torch.Tensor,
                           w: torch.Tensor, thresholds: torch.Tensor
                           ) -> torch.Tensor:
    """Per-slot weighted stump errors for a stacked fleet batch.

    x: (B,N,F); y, w: (B,N); thresholds: (B,F,T) -> (B,F,T) f32, which is
    :func:`stump_scan_ref` per batch slot.  A row or slot of zero weight
    contributes nothing, so ragged client shards stack safely.

    The sum runs over n = 0..N-1 in order, in f64, and is rounded once to
    f32: the rule of :func:`stump_scan_ref`.  The CUDA kernel
    (``csrc/stump_scan.cu``) has two routes (``ops.scan_batched_split``
    picks one from the shape): one thread a row sums in this order, so
    the two agree bit for bit; the split sums in
    :func:`scan_batched_in_kernel_order`'s order, which gives these bits
    wherever the weights span less than 2**29 / N (every order does).
    A loop over the rows keeps the working set at (B,F,T) whatever N is.
    """
    x, y, thresholds = x.to(F32), y.to(F32), thresholds.to(F32)
    w = w.to(F32).double()
    B, N, _ = x.shape
    err = torch.zeros(thresholds.shape, dtype=torch.float64, device=x.device)
    for n in range(N):
        pred = torch.where(x[:, n, :, None] > thresholds, 1.0, -1.0)
        miss = pred != y[:, n, None, None]
        err += miss * w[:, n, None, None]
    return err.to(F32)


class ScanSplit(NamedTuple):
    """How ``csrc/stump_scan.cu`` splits the rows of one slot: chunks of
    ``rows`` consecutive rows, ``chunks`` a column, spread over ``blocks``
    blocks (``chunks // blocks`` chunks a block), ``cols`` features a
    block (a power of two up to 256).  The four fix the order of the
    sum (:func:`scan_in_kernel_order`)."""
    rows: int
    chunks: int
    blocks: int
    cols: int


def _scan_block_sums(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                     thresholds: torch.Tensor, split: ScanSplit
                     ) -> torch.Tensor:
    """One slot's block sums in ``csrc/stump_scan.cu``'s order, f64
    (blocks, F, T): chunk c holds rows [c * rows, (c + 1) * rows) that lie
    below N (a chunk past N is empty); its sum runs over them in order from
    zero.  A block's kb = chunks // blocks chunks form a grid of kb / R rows
    of R (chunk i * R + q, R = kb // 16 where kb >= 16, else 1); the
    block's sum is a pairwise tree over i, ((v0 + v1) + (v2 + v3)) + ...,
    then over q."""
    x, thresholds = x.to(F32), thresholds.to(F32)
    y, w = y.to(F32), w.to(F32).double()
    N, F = x.shape
    T = thresholds.shape[1]
    rows, chunks, blocks, cols = split
    part = torch.zeros((chunks, F, T), dtype=torch.float64)
    starts = torch.arange(chunks) * rows
    for i in range(rows if N else 0):
        n = starts + i
        live = (n < N)[:, None, None]
        n = n.clamp(max=N - 1)
        above = x[n][:, :, None] > thresholds[None]
        miss = torch.where(above, (y[n] != 1.0)[:, None, None],
                           (y[n] != -1.0)[:, None, None])
        part = part + torch.where(miss & live, w[n][:, None, None], 0.0)
    kb = chunks // blocks
    R = kb // 16 if kb >= 16 else 1
    grid = part.view(blocks, kb // R, R, F, T)
    for dim in (1, 2):                 # a pairwise tree over i, then q
        while grid.shape[dim] > 1:
            lo, hi = grid.unflatten(dim, (-1, 2)).unbind(dim + 1)
            grid = lo + hi
    return grid[:, 0, 0]


def _pairwise(sums: torch.Tensor, leaves: int) -> torch.Tensor:
    """A pairwise tree over ``sums``' first dimension padded with zeros to
    ``leaves`` (a power of two at least as long)."""
    tree = torch.cat([sums, sums.new_zeros((leaves - len(sums),
                                            *sums.shape[1:]))])
    while tree.shape[0] > 1:
        tree = tree[0::2] + tree[1::2]
    return tree[0]


def scan_in_kernel_order(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                         thresholds: torch.Tensor, split: ScanSplit
                         ) -> torch.Tensor:
    """``csrc/stump_scan.cu``'s sum for one slot, emulated on the CPU:
    x (N,F), y/w (N,), thresholds (F,T), split -> (F,T) f32.  Used by the
    tests only.

    The blocks' sums as :func:`_scan_block_sums` takes them; where there
    are several blocks, their sums are padded with zeros to 32 * P (P the
    least power of two that holds them) and added as a pairwise tree.  All
    in f64, rounded once to f32."""
    block_sums = _scan_block_sums(x, y, w, thresholds, split)
    blocks = split.blocks
    if blocks == 1:
        return block_sums[0].to(F32)
    leaves = 32                          # the second pass: 32 lanes of P
    while leaves < blocks:
        leaves *= 2
    return _pairwise(block_sums, leaves).to(F32)


SCAN_CLUSTER_LEAVES = 8     # the split route's tree over a cluster's blocks


def scan_batched_in_kernel_order(x: torch.Tensor, y: torch.Tensor,
                                 w: torch.Tensor, thresholds: torch.Tensor,
                                 split) -> torch.Tensor:
    """``csrc/stump_scan.cu``'s batched sum, emulated on the CPU: x (B,N,F),
    y/w (B,N), thresholds (B,F,T) and the route
    (``ops.scan_batched_split``) -> (B,F,T) f32.  Used by the tests,
    ``chip_smoke.py`` and ``tools/`` only.

    ``split`` None, the one-thread-a-row route: the rows of each slot in
    order (:func:`stump_scan_batched_ref`).  A :class:`ScanSplit`, the split
    route: each slot's block sums as :func:`scan_in_kernel_order` takes
    them (:func:`_scan_block_sums`), and its ``blocks`` block sums (one
    cluster, at most 8) padded with zeros to 8 and added as a pairwise
    tree (one block: its sum as it is).  Zeros add nothing, so this is
    :func:`scan_in_kernel_order`'s sum of each slot.  All in f64, rounded
    once to f32."""
    if split is None:
        return stump_scan_batched_ref(x, y, w, thresholds)
    if x.shape[0] == 0:
        return torch.zeros(thresholds.shape, dtype=F32)
    if not 1 <= split.blocks <= SCAN_CLUSTER_LEAVES:
        raise ValueError(f"a split route of {split.blocks} blocks a column "
                         f"group: the cluster holds 1 to "
                         f"{SCAN_CLUSTER_LEAVES}")
    return torch.stack([
        _pairwise(_scan_block_sums(x[b], y[b], w[b], thresholds[b], split),
                  SCAN_CLUSTER_LEAVES).to(F32)
        for b in range(x.shape[0])])


def ensemble_vote_ref(margins: torch.Tensor, alphas: torch.Tensor
                      ) -> torch.Tensor:
    """Weighted ensemble margin: H(x) = sum_t alpha_t h_t(x).

    margins: (T, N) per-learner predictions in [-1, 1]; alphas: (T,)
    (already staleness-compensated) -> (N,) f32 ensemble margin.
    """
    return torch.einsum("t,tn->n", alphas.to(F32), margins.to(F32))


def ensemble_vote_batched_ref(margins: torch.Tensor, alphas: torch.Tensor
                              ) -> torch.Tensor:
    """Per-tenant weighted ensemble margins (serving generic path).

    margins: (B, T, N) per-learner predictions for B packed tenants;
    alphas: (B, T) -> (B, N) f32 ensemble margins.  Zero-alpha padding rows
    over zero padding margins contribute exactly 0.
    """
    return torch.einsum("bt,btn->bn", alphas.to(F32), margins.to(F32))


def stump_vote_batched_ref(xsel: torch.Tensor, thr: torch.Tensor,
                           pol: torch.Tensor, alphas: torch.Tensor
                           ) -> torch.Tensor:
    """Fused stump prediction + weighted vote (serving stump path).

    xsel: (B, T, N) gathered features xsel[b,t,n] = x_b[n, feat_{b,t}];
    thr, pol, alphas: (B, T) -> (B, N) f32 ensemble margins.  The 1e-12
    sign tiebreak matches the stump predictor used at training time.
    """
    m = pol.to(F32)[:, :, None] * torch.sign(
        xsel.to(F32) - thr.to(F32)[:, :, None] + 1e-12)
    return torch.einsum("bt,btn->bn", alphas.to(F32), m)


# The vote kernels' order (csrc/ensemble_vote.cu, csrc/stump_vote.cu):
# chunks of VOTE_ROWS rows (kRows there), VOTE_WARPS chunks a stage (kWarps)
VOTE_ROWS, VOTE_WARPS = 32, 8
VOTE_STAGE_ROWS = VOTE_ROWS * VOTE_WARPS


def vote_in_kernel_order(m: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The vote kernels' sum, emulated in f32: (B,T,N), (B,T) -> (B,N).
    Used by the tests and ``chip_smoke.py`` only.

    Chunks of ``VOTE_ROWS`` rows summed in t order from zero, a stage's
    ``VOTE_WARPS`` chunk sums added as a pairwise tree, the stage partials
    added in order from zero; every multiply and add rounded on its own
    (no fused multiply-add)."""
    m, a = m.to(F32), a.to(F32)
    B, T, N = m.shape
    acc = torch.zeros((B, N), dtype=F32, device=m.device)
    for s0 in range(0, T, VOTE_STAGE_ROWS):
        chunks = []
        for t0 in range(s0, s0 + VOTE_STAGE_ROWS, VOTE_ROWS):
            c = torch.zeros((B, N), dtype=F32, device=m.device)
            for tt in range(t0, min(t0 + VOTE_ROWS, T)):
                c = c + a[:, tt, None] * m[:, tt]
            chunks.append(c)
        while len(chunks) > 1:
            chunks = [chunks[i] + chunks[i + 1]
                      for i in range(0, len(chunks), 2)]
        acc = acc + chunks[0]
    return acc


def stump_margins(xsel: torch.Tensor, thr: torch.Tensor, pol: torch.Tensor,
                  alphas: torch.Tensor) -> torch.Tensor:
    """The stump vote kernels' margins, (B,T,N) f32:
    pol * sign((xsel - thr) + 1e-12) on the rows with alpha != 0, 0 on the
    others whatever their thr, pol or xsel hold.  The sign is the kernels'
    (a NaN difference counts 0)."""
    d = xsel.to(F32) - thr.to(F32)[:, :, None] + 1e-12
    s = (d > 0).to(F32) - (d < 0).to(F32)
    m = pol.to(F32)[:, :, None] * s
    return torch.where((alphas.to(F32) != 0.0)[:, :, None], m,
                       torch.zeros_like(m))


def stump_vote_in_kernel_order(xsel: torch.Tensor, thr: torch.Tensor,
                               pol: torch.Tensor, alphas: torch.Tensor
                               ) -> torch.Tensor:
    """``csrc/stump_vote.cu``'s margins, emulated in f32: the generic
    votes' order (:func:`vote_in_kernel_order`) over
    :func:`stump_margins`.  Used by the tests and ``chip_smoke.py`` only."""
    return vote_in_kernel_order(stump_margins(xsel, thr, pol, alphas),
                                alphas)


# Feature-fingerprint mixing constants, shared verbatim with the fused
# CUDA kernel (kernels/csrc/stump_vote.cu) and the JAX package, so every
# implementation folds the same bits: two independent 32-bit lanes give a
# 64-bit fingerprint.  The multiplier 2*t + ODD is always odd (invertible
# mod 2^32), making the fold position-sensitive; rows are gated on
# alpha != 0 so zero-alpha padding rows contribute the XOR identity and
# the fingerprint is invariant under the serving batch's T padding.
FP_SALT0 = 0x9E3779B9
FP_SALT1 = 0x85EBCA6B
FP_ODD0 = 0x0001_0001
FP_ODD1 = 0x00C2_B2AF


def _as_u32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensors holding the same 32
    bits."""
    return (v - ((v >> 31) << 32)).to(torch.int32)


def _fp_lanes(xsel: torch.Tensor, alphas: torch.Tensor):
    """The two uint32 fingerprint lanes of each (batch, column) pair, as
    int32 tensors holding the uint32 bits (``.numpy().view(np.uint32)``
    reads them unsigned).

    Lane k folds ``XOR_t [(bits(x[t]) ^ SALT_k) * (2 t + ODD_k)]`` over the
    rows with ``alpha_t != 0``.  Torch has no wrapping uint32 multiply, so
    the product is taken in int64 and masked to its low 32 bits (an int64
    product that overflows still has the right low 32 bits).
    """
    bits = xsel.to(F32).contiguous().view(torch.int32).to(torch.int64)
    bits = bits & U32_MASK                                     # (B, T, N)
    B, T, N = xsel.shape
    tt = torch.arange(T, dtype=torch.int64, device=xsel.device)[None, :, None]
    live = (alphas.to(F32) != 0.0)[:, :, None]
    lanes = []
    for salt, odd in ((FP_SALT0, FP_ODD0), (FP_SALT1, FP_ODD1)):
        c = ((bits ^ salt) * ((2 * tt + odd) & U32_MASK)) & U32_MASK
        c = torch.where(live, c, torch.zeros_like(c))
        f = torch.zeros((B, N), dtype=torch.int64, device=xsel.device)
        for t in range(T):
            f = f ^ c[:, t, :]
        lanes.append(_as_u32_bits(f))
    return lanes[0], lanes[1]


def stump_vote_fp_batched_ref(xsel: torch.Tensor, thr: torch.Tensor,
                              pol: torch.Tensor, alphas: torch.Tensor):
    """Fused stump vote + per-column feature fingerprint (serving one-launch
    path): ``(margins (B,N) f32, fp0 (B,N), fp1 (B,N))``, the lanes as
    uint32 bits in int32 tensors.  The lanes are exact integers that every
    implementation reproduces bit for bit."""
    margins = stump_vote_batched_ref(xsel, thr, pol, alphas)
    f0, f1 = _fp_lanes(xsel, alphas)
    return margins, f0, f1


def dist_update_ref(alpha, D: torch.Tensor, y: torch.Tensor,
                    h: torch.Tensor):
    """AdaBoost distribution update (paper eq. 4): returns ``(D', Z)``.

    w_i = D_i exp((-alpha y_i) h_i) in f32, in the JAX package's order;
    Z = sum_i w_i (f32); D' = w / (Z + 1e-30).  ``alpha`` is a number or a
    0-d tensor; Z comes back as a 0-d f32 tensor.
    """
    a = torch.as_tensor(alpha, dtype=F32, device=D.device)
    w = D.to(F32) * torch.exp(-a * y.to(F32) * h.to(F32))
    Z = torch.sum(w)
    return w / (Z + 1e-30), Z


class DistSplit(NamedTuple):
    """How ``csrc/dist_update.cu`` spreads N samples: float4 vectors
    v = i // 4, ``tile`` consecutive vectors a block over ``blocks`` blocks
    of ``threads`` threads (thread t takes the block's vectors t,
    t + threads, ...), in one thread-block cluster where ``cluster``, else
    in a cooperative grid.  A block keeps the first ``held`` vectors of its
    tile on chip across the barrier and computes the rest again.
    ``blocks``, ``threads`` and ``tile`` fix the order of Z
    (:func:`dist_update_in_kernel_order`); ``cluster`` and ``held`` do
    not."""
    cluster: bool
    blocks: int
    threads: int
    tile: int
    held: int


def _fold(v: torch.Tensor) -> torch.Tensor:
    """A warp's fixed tree over the last dimension (a power of two): the
    upper half added to the lower, until one is left."""
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


def dist_update_in_kernel_order(alpha, D: torch.Tensor, y: torch.Tensor,
                                h: torch.Tensor, split: DistSplit):
    """``csrc/dist_update.cu``'s update, emulated on the CPU: ``(D', Z)``
    as :func:`dist_update_ref` returns them, with Z summed in the kernel's
    order.  Used by the tests only.

    w as :func:`dist_update_ref` computes it (its exp may differ from the
    card's by an ulp; at alpha = 0 w is D on both).  Thread t of block b
    adds its samples 4 v .. 4 v + 3 of vectors v = b * tile + t,
    b * tile + t + threads, ... (those below b * tile + tile and samples
    below N) to an f64 sum from zero, in that order.  A block's sum is the
    fixed tree (:func:`_fold`) over each warp's 32 lanes, then over the
    warps' sums padded with zeros to 32.  Z: lane l adds the block sums
    l, l + 32, ... in order from zero, then the tree over the lanes,
    rounded once to f32.  Samples past N add zeros, which leave every sum
    as it is.  N >= 1."""
    a = torch.as_tensor(alpha, dtype=F32)
    D, y, h = D.to(F32), y.to(F32), h.to(F32)
    N = D.shape[0]
    w = D * torch.exp(-a * y * h)
    _cluster, blocks, threads, tile, _held = split
    steps = -(-tile // threads)
    b = torch.arange(blocks)[:, None, None, None]
    k = torch.arange(steps)[None, :, None, None]
    t = torch.arange(threads)[None, None, :, None]
    j = torch.arange(4)[None, None, None, :]
    lv = k * threads + t
    i = 4 * (b * tile + lv) + j
    live = (lv < tile) & (i < N)
    w64 = w.double()
    vals = torch.where(live, w64[i.clamp(max=N - 1)], 0.0)
    acc = torch.zeros((blocks, threads), dtype=torch.float64)
    for kk in range(steps):
        for jj in range(4):
            acc = acc + vals[:, kk, :, jj]
    warps = _fold(acc.view(blocks, threads // 32, 32))
    warps = torch.cat([warps, warps.new_zeros((blocks, 32 - warps.shape[1]))],
                      1)
    parts = _fold(warps)
    rows = -(-blocks // 32)
    lanes = torch.cat([parts, parts.new_zeros(rows * 32 - blocks)]).view(
        rows, 32)
    total = torch.zeros(32, dtype=torch.float64)
    for r in range(rows):
        total = total + lanes[r]
    Z = _fold(total).to(F32)
    return w / (Z + 1e-30), Z


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """Plain softmax attention.  q: (B,H,Tq,hd), k,v: (B,Hkv,Tk,hd) with H
    a multiple of Hkv (query head h reads key and value head h // (H/Hkv))
    -> (B,H,Tq,hd) in q's dtype.

    The math is f32 at scale 1/sqrt(hd); under ``causal`` query i sees the
    keys j <= i + Tk - Tq (``tril(k=Tk-Tq)``), the rest take -1e30 before
    the softmax, as in the JAX package's ``flash_attention_ref``.
    """
    G = q.shape[1] // k.shape[1]
    if G > 1:
        k = k.repeat_interleave(G, dim=1)
        v = v.repeat_interleave(G, dim=1)
    Tq, Tk = q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(F32), k.to(F32)) * scale
    if causal:
        mask = torch.ones((Tq, Tk), dtype=torch.bool,
                          device=q.device).tril(Tk - Tq)
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    wts = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", wts, v.to(F32))
    return out.to(q.dtype)
