"""Optimizers from scratch: SGD, momentum, Adam, AdamW, with global-norm
clipping and LR schedules, each the JAX package's in f32.

PyTorch's idiom with the reference's contract: an optimizer is an
``init(params) -> state`` and an ``update(grads, params, state, step) ->
(new_params, new_state)`` pair over lists of tensors (the reference's
pytree leaves), and ``state`` is a dict of such lists (``{}`` for plain
SGD, ``{"m"}`` with momentum, ``{"m", "v"}`` for Adam).  ``update`` builds
new tensors and changes none of its arguments; a caller that keeps its
params in a module copies the new values in.  ``torch.optim`` is not used:
the numbers are the reference's, its global-norm clip and its bias
correction at ``step + 1`` included.  A schedule returns an f32 scalar
tensor on the host; every scalar that mixes into the update stays a
tensor, so an update reads nothing back from the card.  The moments'
dtype is ``state_dtype`` (f32 by default; the reference's dry run keeps
bf16 moments).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import torch

F32 = torch.float32
Params = List[torch.Tensor]
State = Dict[str, List[torch.Tensor]]


class Optimizer(NamedTuple):
    init: Callable[[Sequence[torch.Tensor]], State]
    update: Callable[..., Tuple[Params, State]]
    # update(grads, params, state, step) -> (new_params, new_state)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over the leaves, in leaf order, of each leaf's sum
    of squares in f32."""
    total = sum(torch.sum(torch.square(t.to(F32))) for t in tensors)
    return torch.sqrt(torch.as_tensor(total, dtype=F32))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> Params:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return [(g.to(F32) * scale).to(g.dtype) for g in grads]


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=F32)


def constant_schedule(lr: float) -> Callable:
    return lambda step: _f32(lr)


def cosine_schedule(lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> Callable:
    def sched(step):
        step = _f32(step)
        warm = lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = final_frac * lr + (1 - final_frac) * lr * 0.5 * (
            1 + torch.cos(_f32(math.pi) * frac))
        return torch.where(step < warmup, warm, cos)
    return sched


def linear_schedule(lr: float, warmup: int, total: int) -> Callable:
    def sched(step):
        step = _f32(step)
        warm = lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        return torch.where(step < warmup, warm, lr * (1 - frac))
    return sched


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _zeros(params, dtype) -> Params:
    return [torch.zeros(p.shape, dtype=dtype, device=p.device)
            for p in params]


def sgd(lr: Callable | float, momentum: float = 0.0,
        clip_norm: Optional[float] = None,
        state_dtype=F32) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        if momentum == 0.0:
            return {}
        return {"m": _zeros(params, state_dtype)}

    def update(grads, params, state, step):
        if clip_norm is not None:
            grads = clip_by_global_norm(grads, clip_norm)
        lr_t = sched(step)
        if momentum == 0.0:
            return [(p.to(F32) - lr_t * g.to(F32)).to(p.dtype)
                    for p, g in zip(params, grads)], state
        m = [(momentum * mm.to(F32) + g.to(F32)).to(state_dtype)
             for mm, g in zip(state["m"], grads)]
        new = [(p.to(F32) - lr_t * mm.to(F32)).to(p.dtype)
               for p, mm in zip(params, m)]
        return new, {"m": m}

    return Optimizer(init, update)


def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          clip_norm: Optional[float] = 1.0,
          state_dtype=F32) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        return {"m": _zeros(params, state_dtype),
                "v": _zeros(params, state_dtype)}

    def update(grads, params, state, step):
        if clip_norm is not None:
            grads = clip_by_global_norm(grads, clip_norm)
        step_f = _f32(step) + 1.0
        lr_t = sched(step)
        bc1 = 1.0 - b1 ** step_f
        bc2 = 1.0 - b2 ** step_f

        def upd(p, g, m, v):
            g = g.to(F32)
            m1 = b1 * m.to(F32) + (1 - b1) * g
            v1 = b2 * v.to(F32) + (1 - b2) * torch.square(g)
            mhat = m1 / bc1
            vhat = v1 / bc2
            p32 = p.to(F32)
            step_d = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p32
            return ((p32 - lr_t * step_d).to(p.dtype),
                    m1.to(state_dtype), v1.to(state_dtype))

        out = [upd(p, g, m, v) for p, g, m, v in
               zip(params, grads, state["m"], state["v"])]
        return ([o[0] for o in out],
                {"m": [o[1] for o in out], "v": [o[2] for o in out]})

    return Optimizer(init, update)


def adam(lr, **kw) -> Optimizer:
    return adamw(lr, weight_decay=0.0, **kw)


def get_optimizer(name: str, lr, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr, **kw)
    if name == "momentum":
        return sgd(lr, momentum=kw.pop("momentum", 0.9), **kw)
    if name == "adam":
        return adam(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    raise KeyError(name)
