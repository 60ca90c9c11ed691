"""Weak learners for (federated) AdaBoost.

Three families, all trained against a *weighted* sample distribution
D_t(i), as the paper's boosting loop requires:

* ``stump``    decision stumps: exhaustive search over (feature, threshold,
               polarity) for the least weighted error.  The search's hot
               spot is the ``stump_scan`` kernel
               (:mod:`repro_torch.kernels.ops`), which the card always takes
               and the CPU replaces with its plain version; the fleet
               profile fits a whole wave of client shards at once through
               ``stump_scan_batched``.
* ``logistic`` weighted logistic regression, 50 full-batch gradient steps.
* ``mlp``      one-hidden-layer tanh MLP, 80 full-batch gradient steps from
               a normal init drawn from the caller's ``torch.Generator``.

The two gradient learners take their gradients from ``torch.autograd`` in
f32 on the device of their inputs, as the JAX package takes them from
``jax.grad``; the two libraries round the chain rule differently, so their
fitted params agree to a relative tolerance, not bit for bit.

A weak learner is a params dict of tensors on the caller's device plus the
spec's predict function; the params' byte size is what crosses the
network at a synchronization event, so it is what the communication
accounting measures.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import ops as kops

F32 = torch.float32


def _quantile_levels(n_thresholds: int, device) -> torch.Tensor:
    """The interior levels of an (n+2)-point grid on [0, 1] in f32, as the
    JAX package computes them: ``i * (1 / (n + 1))``."""
    step = torch.tensor(1.0, dtype=F32) / torch.tensor(
        float(n_thresholds + 1), dtype=F32)
    idx = torch.arange(1, n_thresholds + 1, dtype=F32)
    return (idx * step).to(device)


def stump_thresholds(x: torch.Tensor, n_thresholds: int = 16
                     ) -> torch.Tensor:
    """Per-feature threshold grid from feature quantiles.  x: (N,F) ->
    (F,T) f32.

    Linear interpolation between order statistics, written out in f32 in
    the JAX package's order so the grid is bit-equal to it: position
    ``q * (N - 1)``, weights ``pos - floor(pos)`` and its complement, and
    ``low * lw + high * hw`` with one of the two products fused into a
    multiply-add, as the JAX package's compiled quantile evaluates it: the
    low product for a grid of features, the high one for a single feature.
    The fused step runs in f64, where an f32 product is exact, and rounds
    once to f32.
    """
    x = x.to(F32)
    n, f = x.shape
    xs = torch.sort(x, dim=0).values                        # (N, F)
    pos = _quantile_levels(n_thresholds, x.device) * float(n - 1)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    low = low.clamp(0, n - 1).long()
    high = high.clamp(0, n - 1).long()
    terms = [(xs[low], lw[:, None]), (xs[high], hw[:, None])]
    (fa, fb), (ra, rb) = terms if f > 1 else terms[::-1]
    grid = (fa.double() * fb.double() + (ra * rb).double()).to(F32)
    return grid.T.contiguous()                              # (F, T)


def fit_stump(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
              thresholds: torch.Tensor, policy=None
              ) -> Dict[str, torch.Tensor]:
    """Weighted-error-optimal stump.

    x: (N,F); y: (N,) in {-1,+1}; w: (N,) distribution; thresholds: (F,T).
    Returns {"feature", "threshold", "polarity"} 0-d tensors.

    err(f,t,+) = sum_i w_i * [sign(x_if - t) != y_i]; polarity flips sign.
    The scan goes through the kernel dispatcher under ``policy`` (a
    :class:`repro_torch.kernels.KernelPolicy`).  ``None`` means the
    dispatcher's default: the kernel on the card, the plain version on the
    CPU.  (In the JAX package ``None`` means its jnp oracle.)
    """
    err_pos = kops.stump_scan(x, y, w, thresholds, policy=policy)
    return _pick_stump(err_pos, thresholds)


def predict_stump(p: Dict[str, torch.Tensor], x: torch.Tensor
                  ) -> torch.Tensor:
    """-> (N,) margins in {-1,+1}."""
    xv = x[:, p["feature"]]
    return p["polarity"] * torch.sign(xv - p["threshold"] + 1e-12)


def _pick_stump(err_pos: torch.Tensor, thresholds: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """The least-error stump over both polarities, by the JAX package's
    rule: err_pos is the (F,T) weighted error grid of polarity +1, polarity
    -1 errs by 1 - err_pos; each polarity's first least cell (row-major),
    and polarity +1 where the two are equal.

    The scan sums each error in f64 and rounds it once, so stumps whose
    errors tie in exact arithmetic (common under a uniform or two-valued
    distribution) tie here too, on every device, and the first index
    settles them; no summation order can.
    """
    err_neg = 1.0 - err_pos
    ip = torch.argmin(err_pos)
    ineg = torch.argmin(err_neg)
    take_pos = err_pos.reshape(-1)[ip] <= err_neg.reshape(-1)[ineg]
    cell = torch.where(take_pos, ip, ineg)
    T = err_pos.shape[1]
    f = cell // T
    thr = thresholds[f, cell % T]
    pol = torch.where(take_pos, 1.0, -1.0).to(F32)
    return {"feature": f.to(torch.int32), "threshold": thr,
            "polarity": pol}


def fit_stump_batched(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                      thresholds: torch.Tensor, policy=None
                      ) -> Dict[str, torch.Tensor]:
    """Fit one stump per fleet slot in a single ``stump_scan_batched``
    launch.

    x: (B,N,F); y, w: (B,N); thresholds: (B,F,T).  Returns
    {"feature", "threshold", "polarity", "eps"} tensors of shape (B,),
    each slot picked by :func:`_pick_stump`'s rule.  ``w`` rows need not be
    normalized (the argmin is scale-invariant); the convention is to pass
    D_t rows directly.  ``policy`` is :func:`fit_stump`'s.
    """
    err_pos = kops.stump_scan_batched(x, y, w, thresholds, policy=policy)
    return _pick_stump_batched(err_pos, thresholds)


def _pick_stump_batched(err_pos: torch.Tensor, thresholds: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
    """:func:`_pick_stump` row by row: err_pos (B,F,T) -> per slot the
    first least cell of each polarity (row-major over (F,T)), polarity +1
    where the two are equal.  ``torch.argmin`` returns the first index of a
    minimum on every device.  ``eps`` is the chosen polarity's error in
    f32 (the mesh trainer's local alpha reads it)."""
    B, F, T = err_pos.shape
    e_pos = err_pos.reshape(B, F * T)
    e_neg = 1.0 - e_pos
    ip = torch.argmin(e_pos, dim=1, keepdim=True)
    ineg = torch.argmin(e_neg, dim=1, keepdim=True)
    best_pos, best_neg = e_pos.gather(1, ip), e_neg.gather(1, ineg)
    take_pos = best_pos <= best_neg
    cell = torch.where(take_pos, ip, ineg)
    thr = thresholds.reshape(B, F * T).gather(1, cell)[:, 0]
    pol = torch.where(take_pos[:, 0], 1.0, -1.0).to(F32)
    return {"feature": (cell[:, 0] // T).to(torch.int32), "threshold": thr,
            "polarity": pol,
            "eps": torch.where(take_pos, best_pos, best_neg)[:, 0]}


def stump_thresholds_batched(x: torch.Tensor, n_valid: torch.Tensor,
                             n_thresholds: int = 16) -> torch.Tensor:
    """Per-client quantile threshold grids for a padded fleet stack.

    x: (B,N,F) with slot b valid in rows [0, n_valid[b]) -> (B,F,T) f32,
    bit-equal to the JAX package's grid.  Padding rows become +inf, so they
    sink to the bottom of each slot's sort, and the quantile position is
    scaled by the slot's true row count.  The grid is ``low * lw + high *
    hw`` with the low product fused into a multiply-add, as the JAX
    package's compiled batched quantile evaluates it at every F: the fused
    step runs in f64, where an f32 product is exact, and rounds once.
    """
    x = x.to(F32)
    B, N, F = x.shape
    dev = x.device
    qs = _quantile_levels(n_thresholds, dev)                  # (T,)
    n_valid = n_valid.to(dev)
    valid = torch.arange(N, device=dev)[None, :] < n_valid[:, None]
    xs = torch.sort(torch.where(valid[:, :, None], x, torch.inf),
                    dim=1).values
    pos = qs[None, :] * (n_valid[:, None].to(F32) - 1.0)      # (B,T) f32
    low = torch.floor(pos)
    hw = (pos - low)[:, :, None]
    lw = 1.0 - hw
    T = qs.shape[0]

    def take(idx):
        return torch.gather(xs, 1, idx.long()[:, :, None].expand(B, T, F))
    grid = (take(low).double() * lw.double()
            + (take(torch.ceil(pos)) * hw).double()).to(F32)  # (B,T,F)
    return grid.permute(0, 2, 1).contiguous()


STUMP_BYTES = 3 * 4   # feature idx + threshold + polarity


# ---------------------------------------------------------------------------
# gradient learners
# ---------------------------------------------------------------------------

def gradient_steps(loss_fn, params: Dict[str, torch.Tensor], steps: int,
             lr: float) -> Dict[str, torch.Tensor]:
    """``steps`` full-batch gradient steps ``p - lr * grad`` on every leaf
    of ``params``, the gradient of ``loss_fn(params)`` from autograd."""
    names = list(params)
    leaves = [params[k].detach() for k in names]
    with torch.enable_grad():
        for _ in range(steps):
            leaves = [v.requires_grad_() for v in leaves]
            loss = loss_fn(dict(zip(names, leaves)))
            grads = torch.autograd.grad(loss, leaves)
            leaves = [(v - lr * g).detach() for v, g in zip(leaves, grads)]
    return dict(zip(names, leaves))


def fit_logistic(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                 generator=None, steps: int = 50, lr: float = 0.5
                 ) -> Dict[str, torch.Tensor]:
    """Weighted logistic regression from zero weights: ``steps`` gradient
    steps on -sum_i w_i log-likelihood_i.  x: (N,F); y: (N,) in {-1,+1};
    w: (N,) -> {"w": (F,), "b": ()}, in the dtype of ``x`` (f32 in the
    engine; a check may run it in f64).  The generator is not used (the
    start is zeros)."""
    y, w = y.to(x.dtype), w.to(x.dtype)
    y01 = (y + 1.0) / 2.0

    def loss(p):
        prob = torch.sigmoid(x @ p["w"] + p["b"])
        ll = (y01 * torch.log(prob + 1e-9)
              + (1 - y01) * torch.log(1 - prob + 1e-9))
        return -torch.sum(w * ll)
    params = {"w": torch.zeros(x.shape[1], dtype=x.dtype, device=x.device),
              "b": torch.zeros((), dtype=x.dtype, device=x.device)}
    return gradient_steps(loss, params, steps, lr)


def predict_logistic(p: Dict[str, torch.Tensor], x: torch.Tensor
                     ) -> torch.Tensor:
    """-> (N,) margins in (-1, 1)."""
    return torch.tanh(x @ p["w"] + p["b"])


def init_mlp(n_features: int, generator: torch.Generator, hidden: int = 16
             ) -> Dict[str, torch.Tensor]:
    """The MLP's start on the generator's device: normal weights scaled by
    1/sqrt(fan-in), zero biases.  ``torch.Generator`` does not give
    ``jax.random``'s bits, so a parity test hands :func:`train_mlp` the JAX
    package's start instead."""
    dev = generator.device
    return {
        "w1": torch.randn((n_features, hidden), generator=generator,
                          device=dev) / math.sqrt(n_features),
        "b1": torch.zeros((hidden,), dtype=F32, device=dev),
        "w2": torch.randn((hidden,), generator=generator,
                          device=dev) / math.sqrt(hidden),
        "b2": torch.zeros((), dtype=F32, device=dev),
    }


def train_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor,
              y: torch.Tensor, w: torch.Tensor, steps: int = 80,
              lr: float = 0.1) -> Dict[str, torch.Tensor]:
    """``steps`` gradient steps on sum_i w_i (mlp(x_i) - y_i)^2 from
    ``params`` (as :func:`init_mlp` gives them) -> the fitted params, in
    the dtype of ``x`` and ``params`` (f32 in the engine)."""
    y, w = y.to(x.dtype), w.to(x.dtype)

    def loss(p):
        return torch.sum(w * torch.square(predict_mlp(p, x) - y))
    return gradient_steps(loss, params, steps, lr)


def fit_mlp(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
            generator: torch.Generator, steps: int = 80, hidden: int = 16,
            lr: float = 0.1) -> Dict[str, torch.Tensor]:
    """One-hidden-layer tanh MLP: :func:`init_mlp` from ``generator`` (on
    the device of ``x``), then :func:`train_mlp`.  x: (N,F) ->
    {"w1": (F,H), "b1": (H,), "w2": (H,), "b2": ()} f32."""
    return train_mlp(init_mlp(x.shape[1], generator, hidden), x, y, w,
                     steps, lr)


def predict_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor
                ) -> torch.Tensor:
    """-> (N,) margins in (-1, 1)."""
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return torch.tanh(h @ p["w2"] + p["b2"])


def _pytree_bytes(p: Dict[str, torch.Tensor]) -> int:
    """Bytes of every leaf of a params dict, as they cross the network."""
    return int(sum(v.numel() * v.element_size() for v in p.values()))


@dataclass(frozen=True)
class WeakLearnerSpec:
    name: str
    fit: Callable              # (x, y, w, generator) -> params
    predict: Callable          # (params, x) -> margins (N,)
    param_bytes: Callable      # params -> bytes on the wire
    # (x, y, w, thresholds) stacked per slot -> per-slot params: the fleet
    # profile's batched fit (stumps only)
    fit_batched: Optional[Callable] = None


def get_weak_learner(name: str, n_thresholds: int = 16,
                     policy=None) -> WeakLearnerSpec:
    """The weak-learner family ``name``.  Only the MLP's fit draws from its
    random generator argument; the stump search is exhaustive and the
    logistic fit starts from zeros.

    ``policy`` (a :class:`repro_torch.kernels.KernelPolicy`) routes the
    stump scans, the single fit's and the fleet's batched one, through the
    kernel dispatcher, re-resolved on every fit.
    This is a deliberate divergence from the JAX package: there ``None``
    keeps its jnp oracle; here ``None`` means the dispatcher's default,
    which is the kernel on the card and the plain version on the CPU."""
    if name == "stump":
        def fit(x, y, w, generator=None):
            return fit_stump(x, y, w, stump_thresholds(x, n_thresholds),
                             policy)

        def fit_batched(x, y, w, thresholds):
            return fit_stump_batched(x, y, w, thresholds, policy)
        return WeakLearnerSpec("stump", fit, predict_stump,
                               lambda p: STUMP_BYTES, fit_batched)
    if name == "logistic":
        return WeakLearnerSpec("logistic", fit_logistic, predict_logistic,
                               _pytree_bytes)
    if name == "mlp":
        return WeakLearnerSpec("mlp", fit_mlp, predict_mlp, _pytree_bytes)
    raise KeyError(name)
