"""AdaBoost core: weighted errors, vote weights, the sample distribution
update and the grown ensemble.

Binary labels live in {-1,+1}; weak-learner outputs are margins in [-1,1]
(stumps emit exactly +-1).  Every function computes in f32 on the device
of its inputs.  The centralized loop (:func:`fit_adaboost`) is the
non-federated reference the paper compares to; the multiclass extension
(SAMME) serves the domain datasets that need it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.compensation import adaboost_alpha

F32 = torch.float32
TINY = torch.finfo(F32).tiny        # the least normal f32


def weighted_error(D: torch.Tensor, y: torch.Tensor, margins: torch.Tensor
                   ) -> torch.Tensor:
    """eps = sum_i D_i [sign(h(x_i)) != y_i]; ties (h==0) count as errors."""
    pred = torch.where(margins > 0, 1.0, -1.0)
    miss = (pred != y).to(F32)
    return torch.sum(D * miss)


def update_distribution(D: torch.Tensor, alpha_tilde, y: torch.Tensor,
                        margins: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """D_{t+1}(i) = D_t(i) exp(-alpha~ y_i h_t(x_i)) / Z_t  (paper eq. 4).

    Returns (D_new, Z_t).  Weights that fall below the least normal f32
    become zero, as the JAX package's compiled programs (and the TPU) flush
    them: a weight kept as a subnormal would grow back under later updates
    where the JAX package's stays zero.  (The factor exp(-alpha~ y h) is
    never subnormal: the clipped errors bound |alpha~|.)
    """
    w = D * torch.exp(-alpha_tilde * y * margins)
    w = w.masked_fill(w < TINY, 0.0)                   # w >= 0
    Z = torch.sum(w)
    D_new = w / (Z + 1e-30)
    return D_new.masked_fill(D_new < TINY, 0.0), Z


def ensemble_margin(margins_stack: torch.Tensor, alphas) -> torch.Tensor:
    """H(x) = sum_t alpha~_t h_t(x).  margins_stack: (T,N); alphas: (T,)."""
    alphas = torch.as_tensor(alphas, dtype=F32, device=margins_stack.device)
    return torch.einsum("t,tn->n", alphas, margins_stack.to(F32))


def ensemble_predict(margins_stack: torch.Tensor, alphas) -> torch.Tensor:
    """H_T(x) = sign(sum alpha~ h) (paper eq. 3), ties to -1."""
    return torch.where(ensemble_margin(margins_stack, alphas) > 0, 1.0, -1.0)


def accuracy(margins_stack: torch.Tensor, alphas, y: torch.Tensor
             ) -> torch.Tensor:
    return torch.mean((ensemble_predict(margins_stack, alphas) == y).to(F32))


# ---------------------------------------------------------------------------
# centralized AdaBoost (the non-federated reference the paper compares to)
# ---------------------------------------------------------------------------

@dataclass
class Ensemble:
    """A grown ensemble: learner params + compensated weights."""
    learners: List[Dict] = field(default_factory=list)
    alphas: List[float] = field(default_factory=list)

    def add(self, params: Dict, alpha: float) -> None:
        self.learners.append(params)
        self.alphas.append(float(alpha))

    def margins(self, predict: Callable, x: torch.Tensor) -> torch.Tensor:
        if not self.learners:
            return torch.zeros((1, x.shape[0]), dtype=F32, device=x.device)
        return torch.stack([predict(p, x) for p in self.learners])

    def predict(self, predict_fn: Callable, x: torch.Tensor) -> torch.Tensor:
        m = self.margins(predict_fn, x)
        return torch.where(ensemble_margin(m, self.alphas) > 0, 1.0, -1.0)

    def error(self, predict_fn: Callable, x: torch.Tensor,
              y: torch.Tensor) -> float:
        return float(torch.mean((self.predict(predict_fn, x) != y).to(F32)))


def fit_adaboost(x: torch.Tensor, y: torch.Tensor, n_rounds: int, weak,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[Ensemble, List[float]]:
    """Classical (centralized, synchronous) AdaBoost on the device of ``x``.
    Returns the ensemble and the per-round training-error-bound factors Z_t
    (prod Z_t bounds the training error).  ``weak`` is a
    :class:`~repro_torch.models.weak.WeakLearnerSpec`; each fit draws from
    ``generator`` (default: one seeded 0 on the device of ``x``), where the
    JAX package hands each fit a split of its key."""
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    N = x.shape[0]
    D = torch.full((N,), 1.0 / N, dtype=F32, device=x.device)
    ens = Ensemble()
    zs: List[float] = []
    for _ in range(n_rounds):
        params = weak.fit(x, y, D, generator)
        h = weak.predict(params, x)
        eps = weighted_error(D, y, h)
        if float(eps) >= 0.5:      # weak learner no better than chance: stop
            break
        alpha = adaboost_alpha(eps)
        D, Z = update_distribution(D, alpha, y, h)
        ens.add(params, float(alpha))
        zs.append(float(Z))
    return ens, zs


# ---------------------------------------------------------------------------
# SAMME multiclass extension
# ---------------------------------------------------------------------------

def samme_alpha(eps, n_classes: int) -> torch.Tensor:
    eps = torch.clamp(torch.as_tensor(eps, dtype=F32), 1e-6, 1.0 - 1e-6)
    return torch.log((1.0 - eps) / eps) + torch.log(
        torch.tensor(n_classes - 1.0, dtype=F32))


def samme_update_distribution(D: torch.Tensor, alpha, y_idx: torch.Tensor,
                              pred_idx: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    miss = (pred_idx != y_idx).to(F32)
    w = D * torch.exp(alpha * miss)
    Z = torch.sum(w)
    return w / (Z + 1e-30), Z
