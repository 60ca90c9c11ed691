"""Token-choice top-k Mixture-of-Experts with capacity-bounded scatter
dispatch, routed independently per batch row.

A port of the JAX package's ``models/moe.py``: the same routing (an f32
softmax router, top-k by k argmax passes), the same per-row capacity
(``capacity``), the same dispatch into an (E, C, D) buffer per row with
overflow slots dropped, the dense per-expert SwiGLU/GeGLU over that
buffer, the gate-weighted combine and the Switch load-balance aux loss.

On DTensors under a mesh context (``sharding_ctx``) the layer pins its
activations where the reference does (``constrain``: the router's
probabilities, the gates and picks, the dispatch intermediates, the
expert output, the layer's output) and runs the steps DTensor has no rule
for (the argmax passes, the dispatch scatter, the aux loss's one-hot, the
combine) on each device's batch rows (``local_region``): every row is
routed and dispatched on the device that holds it, as the reference's
per-row vmap is.  The router's product is kept from repeating on every
device of the model axis (:func:`_router_logits`).
``moe.sharding == "tensor_sm"`` is the reference's ``shard_map`` branch
(:func:`_expert_tensor_sm`): the expert products run on the local weight
shards, the FSDP all-gathers are explicit, and the down projection's
partial sums are cast to the activation dtype before the all-reduce over
the model axis.  Without a mesh every branch takes
the ``dense_path`` as before.

The params are an ``nn.ParameterDict`` keyed ``router`` (D, E), always
f32, ``w_gate`` and ``w_up`` (E, D, F) and ``w_down`` (E, F, D), as the
reference's dict, so ``convert`` maps the leaves by name.  There is no
kernel here: the reference's dispatch and expert products are plain
``jnp`` outside any Pallas kernel, so here they are indexing and
``torch.einsum``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.layers import dense_init
from repro_torch.sharding_ctx import (
    _AllReduceSum, constrain, current, is_dtensor, local_region, settle)

F32 = torch.float32


def moe_init(gen: Optional[torch.Generator], cfg: ArchConfig, dtype=F32,
             device="cpu") -> nn.ParameterDict:
    """One MoE layer's params, drawn from ``gen`` (``None`` leaves them
    uninitialized, for weights that are loaded next); built with
    ``requires_grad=False``, as the stack's other params."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts

    def stack(di, do):
        if gen is None:
            return torch.empty((e, di, do), dtype=dtype, device=device)
        return torch.stack([dense_init(gen, di, do, dtype, device)
                            for _ in range(e)])

    return nn.ParameterDict({
        k: nn.Parameter(w, requires_grad=False) for k, w in (
            ("router", dense_init(gen, d, e, F32, device)),
            ("w_gate", stack(d, f)),
            ("w_up", stack(d, f)),
            ("w_down", stack(f, d)))})


def capacity(m: MoEConfig, tokens_per_row: int) -> int:
    """Expert slots a row: Python float arithmetic and ``int()``, as the
    reference computes it (K at T = 1, so decode drops nothing)."""
    cap = int(m.capacity_factor * tokens_per_row * m.top_k / m.num_experts)
    return max(m.top_k, min(tokens_per_row, max(1, cap)))


def _topk_iterative(probs: torch.Tensor, k: int):
    """Top-k by k argmax passes, each pick pushed down by 1e9 before the
    next, as the reference takes it: ``torch.argmax`` returns the first of
    equal maxima, as ``jnp.argmax`` does.  Returns (values, int32
    indices), each (..., k)."""
    vals, idxs = [], []
    p = probs
    for _ in range(k):
        i = torch.argmax(p, dim=-1)
        vals.append(torch.gather(p, -1, i[..., None])[..., 0])
        idxs.append(i)
        p = p - F.one_hot(i, probs.shape[-1]).to(p.dtype) * 1e9
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1).to(
        torch.int32)


def _slots(expert_idx: torch.Tensor, m: MoEConfig, cap: int):
    """(keep, dst), each (B, T*K), from (B, T, K) top-k choices: per row,
    each expert's slots are numbered by a cumsum over the token-major
    (T*K) order, and a slot at or past ``cap`` goes to the sentinel
    ``E*cap`` (dropped)."""
    B = expert_idx.shape[0]
    E = m.num_experts
    flat_e = expert_idx.reshape(B, -1).long()
    pos = torch.cumsum(F.one_hot(flat_e, E), dim=1) - 1    # (B, T*K, E)
    pos_in_e = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    keep = pos_in_e < cap
    return keep, torch.where(keep, flat_e * cap + pos_in_e, E * cap)


def _dispatch(x: torch.Tensor, expert_idx: torch.Tensor, m: MoEConfig,
              cap: int):
    """Scatter every row of (B, T, D) tokens into its (E, C, D) expert
    buffer, given the (B, T, K) top-k choices (:func:`_slots`).  Returns
    (keep, dst, tok, xe): keep and dst (B, T*K), tok (T*K,) and xe (B, E,
    C, D).

    The rows share one (B*E*cap + 1, D) buffer whose last row takes every
    dropped slot and is sliced off; kept destinations are unique, so the
    write is deterministic."""
    B, T, D = x.shape
    E, K = m.num_experts, m.top_k
    keep, dst = _slots(expert_idx, m, cap)
    tok = torch.arange(T, device=x.device).repeat_interleave(K)
    rows = torch.arange(B, device=x.device)[:, None] * (E * cap)
    flat_dst = torch.where(keep, dst + rows, B * E * cap)
    buf = x.new_zeros((B * E * cap + 1, D)).index_put(
        (flat_dst.reshape(-1),), x[:, tok].reshape(B * T * K, D))
    return keep, dst, tok, buf[:-1].reshape(B, E, cap, D)


def _dispatch_row(x_row: torch.Tensor, expert_idx: torch.Tensor,
                  m: MoEConfig, cap: int):
    """One row of :func:`_dispatch`: x_row (T, D), expert_idx (T, K) ->
    (keep, dst, tok, xe (E, C, D)), as the reference's ``_dispatch_row``."""
    keep, dst, tok, xe = _dispatch(x_row[None], expert_idx[None], m, cap)
    return keep[0], dst[0], tok, xe[0]


def _swiglu(xe, wg, wu, wd, act: str) -> torch.Tensor:
    g = torch.einsum("becd,edf->becf", xe, wg)
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    u = torch.einsum("becd,edf->becf", xe, wu)
    return torch.einsum("becf,efd->becd", g * u, wd)


def _expert_compute(p, xe: torch.Tensor, act: str,
                    m: Optional[MoEConfig] = None) -> torch.Tensor:
    """(B,E,C,D) -> (B,E,C,D) through the per-expert SwiGLU (``gelu`` is
    the tanh form, as ``jax.nn.gelu`` computes it by default): the
    reference's ``dense_path``, or under a mesh context with
    ``m.sharding == "tensor_sm"`` its ``shard_map`` branch."""
    if (m is not None and m.sharding == "tensor_sm" and is_dtensor(xe)
            and current() is not None):
        return _expert_tensor_sm(p, xe, act)
    return constrain(_swiglu(xe, p["w_gate"], p["w_up"], p["w_down"], act),
                     "b4")


def _stored(p, name: str):
    """A param as stored (its shard), past an FSDP gather that reads it
    (``launch.steps.Unshard``)."""
    if hasattr(p, "parametrizations") and name in p.parametrizations:
        return p.parametrizations[name].original
    return p[name]


def _all_gather(w, dim, group):
    from torch.distributed import _functional_collectives as funcol
    fn = getattr(funcol, "all_gather_single_autograd",
                 None) or funcol.all_gather_tensor_autograd
    return fn(w, dim, group)


def _expert_tensor_sm(p, xe, act: str):
    """The reference's ``tensor_sm`` branch on local shards: xe's batch
    rows on each device, gate/up (E, D -> fsdp, F -> model), down (E,
    F -> model, D -> fsdp).  The FSDP all-gathers over the fsdp axis are
    explicit, and the down projection's partial is cast to the activation
    dtype BEFORE the all-reduce over the model axis: a bf16 all-reduce,
    not f32."""
    from torch.distributed import _functional_collectives as funcol
    ctx = current()
    mesh = xe.device_mesh
    names = list(mesh.mesh_dim_names)
    model_ax, fsdp_ax, batch_ax = ctx["model"], ctx.get("fsdp"), ctx["batch"]

    def gather(w, dim):
        if fsdp_ax is None:
            return w
        return _all_gather(
            w, dim, (mesh, names.index(fsdp_ax)))

    def expert_body(xe_l, wg_l, wu_l, wd_l):
        wg_l, wu_l, wd_l = gather(wg_l, 1), gather(wu_l, 1), gather(wd_l, 2)
        ye_part = _swiglu(xe_l, wg_l, wu_l, wd_l, act).to(xe_l.dtype)
        return _AllReduceSum.apply(ye_part, [(mesh, names.index(model_ax))])

    w_gu = (None, fsdp_ax, model_ax)
    w_d = (None, model_ax, fsdp_ax)
    xe_spec = (batch_ax, None, None, None)
    return local_region(expert_body, (xe_spec, w_gu, w_gu, w_d), (0,), xe,
                        _stored(p, "w_gate"), _stored(p, "w_up"),
                        _stored(p, "w_down"))


def _batch_region(fn, n_out: int, *args):
    """``fn`` on each device's batch rows (dim 0 over the context's batch
    axes, every other dim whole); its ``n_out`` outputs keep that
    layout.  Plain tensors: ``fn`` as is."""
    if not is_dtensor(args[0]):
        return fn(*args)
    b = current()["batch"]
    return local_region(fn, tuple((b,) + (None,) * (a.dim() - 1)
                                  for a in args), (0,) * n_out, *args)


def _topk_gates(probs: torch.Tensor, k: int):
    gate_vals, expert_idx = _topk_iterative(probs, k)
    gate_vals = gate_vals / (torch.sum(gate_vals, -1, keepdim=True) + 1e-9)
    return gate_vals, expert_idx


def _router_logits(x: torch.Tensor, w) -> torch.Tensor:
    """x (B,T,D) @ router (D,E) in f32, the (B,T,E) logits.  Under a mesh
    context the product is not repeated on every device of the model
    axis where the axis divides E: with one token a row (decode) each
    device takes its E/n columns of the router, a local slice, and the
    logits are gathered whole (``constrain`` "b3": one small row a
    token); with many, the forward stays whole on every device (a gather
    of every token's logits would cost more than the product saves) and
    its backward splits the weight's gradient by columns
    (:class:`_RouterProduct`)."""
    x = x.to(F32)
    ctx = current()
    if is_dtensor(w) and ctx is not None:
        mesh = w.device_mesh
        i = list(mesh.mesh_dim_names).index(ctx["model"])
        n = mesh.shape[i]
        if n > 1 and w.shape[1] % n == 0 and w.placements[i].is_replicate():
            if x.shape[1] == 1:
                from torch.distributed.tensor import Shard
                pl = list(w.placements)
                pl[i] = Shard(1)
                w = w.redistribute(mesh, pl)
            elif torch.is_grad_enabled() and w.requires_grad:
                return _RouterProduct.apply(x, w, i)
    return _router_product(x, w)


class _RouterProduct(torch.autograd.Function):
    """x @ w for DTensors whole on mesh dim ``i`` (the model axis); the
    backward computes x's gradient whole, as the forward, and w's by
    columns, each device its E/n (a local slice of the logits' gradient),
    gathered whole by the layout change back to w's."""

    @staticmethod
    def forward(ctx, x, w, i):
        ctx.save_for_backward(x, w)
        ctx.i = i
        return _router_product(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return _router_grads(x, w, g, ctx.i) + (None,)


def _router_product(x, w):
    return constrain(x @ w, "b3")


def _router_grads(x, w, g, i: int):
    """(x's gradient, whole; w's, each device its columns, gathered)."""
    from torch.distributed.tensor import Shard
    gx = g @ w.transpose(0, 1)
    pl = list(g.placements)
    pl[i] = Shard(g.dim() - 1)
    ge = g.redistribute(g.device_mesh, pl)
    gw = x.reshape(-1, x.shape[-1]).transpose(0, 1) @ ge.reshape(
        -1, ge.shape[-1])
    # w's layout, but a pending sum (over the batch shards) stays pending:
    # the step's gradient reduction carries it out
    pl = [p if p.is_partial() else q
          for p, q in zip(gw.placements, w.placements)]
    return gx, gw.redistribute(w.device_mesh, pl)


def route(p, x: torch.Tensor, m: MoEConfig):
    """(probs (B,T,E) f32, normalized gates (B,T,K) f32, expert_idx
    (B,T,K) int32) from the f32 router."""
    probs = constrain(torch.softmax(_router_logits(x, p["router"]), dim=-1),
                      "b3")
    gate_vals, expert_idx = _batch_region(
        lambda pr: _topk_gates(pr, m.top_k), 2, probs)
    return probs, constrain(gate_vals, "b3"), constrain(expert_idx, "b3")


def _combine(ye, keep, dst, gate_vals, K: int) -> torch.Tensor:
    """The gate-weighted sum over each token's K expert slots: ye (B,E,C,D),
    keep and dst (B, T*K), gates (B,T,K) -> (B,T,D)."""
    B, E, C, D = ye.shape
    TK = dst.shape[1]
    yf = ye.reshape(B, E * C, D)
    picked = torch.gather(yf, 1, torch.clamp(dst, max=E * C - 1)[..., None]
                          .expand(B, TK, D))
    picked = torch.where(keep[..., None], picked, 0.0)
    contrib = picked * gate_vals.reshape(B, TK, 1).to(ye.dtype)
    # each token's K contributions are contiguous (tok repeats arange(T)
    # K times): a sum over K, not an atomic scatter-add
    return contrib.view(B, TK // K, K, D).sum(2)


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig, act: str = "silu",
              expert_idx: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,T,D) -> (out, aux_loss).  Capacity-overflow tokens fall back
    to the residual path (they add 0 here).  ``expert_idx``, where given,
    replaces the router's own top-k picks (a (B,T,K) tensor; the gates are
    still the router's probabilities at those picks, normalized): it lets a
    run follow another's routing in lockstep."""
    m = cfg.moe
    B, T, D = x.shape
    E, K = m.num_experts, m.top_k
    C = capacity(m, T)

    probs, gate_vals, own_idx = route(p, x, m)
    if expert_idx is not None:
        expert_idx = expert_idx.to(device=x.device, dtype=torch.int32)
        gate_vals = torch.gather(probs, -1, expert_idx.long())
        gate_vals = gate_vals / (torch.sum(gate_vals, -1, keepdim=True)
                                 + 1e-9)
    else:
        expert_idx = own_idx
    keep, dst, xe = _batch_region(
        lambda x, i: _keep_dst_xe(x, i, m, C), 3, x, expert_idx)
    keep, dst, xe = constrain(keep, "b2"), constrain(dst, "b2"), \
        constrain(xe, "b4")

    # load-balance auxiliary loss (Switch eq. 4), global over the batch
    me = settle(torch.mean(probs.reshape(-1, E), dim=0), None)
    hits = _batch_region(lambda i: F.one_hot(i.reshape(-1, K).long(),
                                             E).to(F32), 1, expert_idx)
    ce = settle(torch.mean(torch.sum(hits, dim=1), dim=0), None)
    aux = m.aux_loss_coef * E * torch.sum(me * ce)

    ye = _expert_compute(p, xe, act, m)                    # (B,E,C,D)
    out = _batch_region(lambda *a: _combine(*a, K), 1, ye, keep, dst,
                        gate_vals)
    return constrain(out, "btd"), aux


def _keep_dst_xe(x, expert_idx, m: MoEConfig, cap: int):
    keep, dst, _, xe = _dispatch(x, expert_idx, m, cap)
    return keep, dst, xe
