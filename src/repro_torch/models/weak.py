"""Weak learners for (federated) AdaBoost: the decision-stump family.

A stump is trained against a *weighted* sample distribution D_t(i), as the
paper's boosting loop requires, by exhaustive search over (feature,
threshold, polarity) for the least weighted error.  The search's hot spot
is the ``stump_scan`` kernel (:mod:`repro_torch.kernels.ops`), which the
card always takes and the CPU replaces with its plain version.

A weak learner is a params dict of 0-d tensors on the caller's device plus
the spec's predict function; the params' byte size is what crosses the
network at a synchronization event, so it is what the communication
accounting measures.  The logistic and MLP families are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

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
              thresholds: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Weighted-error-optimal stump.

    x: (N,F); y: (N,) in {-1,+1}; w: (N,) distribution; thresholds: (F,T).
    Returns {"feature", "threshold", "polarity"} 0-d tensors.

    err(f,t,+) = sum_i w_i * [sign(x_if - t) != y_i]; polarity flips sign.
    """
    err_pos = kops.stump_scan(x, y, w, thresholds)
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


STUMP_BYTES = 3 * 4   # feature idx + threshold + polarity


@dataclass(frozen=True)
class WeakLearnerSpec:
    name: str
    fit: Callable              # (x, y, w, generator) -> params
    predict: Callable          # (params, x) -> margins (N,)
    param_bytes: Callable      # params -> bytes on the wire


def get_weak_learner(name: str, n_thresholds: int = 16) -> WeakLearnerSpec:
    """The weak-learner family ``name``.  The stump fit ignores its random
    generator argument (the search is exhaustive)."""
    if name == "stump":
        def fit(x, y, w, generator=None):
            return fit_stump(x, y, w, stump_thresholds(x, n_thresholds))
        return WeakLearnerSpec("stump", fit, predict_stump,
                               lambda p: STUMP_BYTES)
    if name in ("logistic", "mlp"):
        raise NotImplementedError(
            f"weak learner {name!r} is not ported yet; only 'stump' is")
    raise KeyError(name)
