"""AdaBoost core: weighted errors, vote weights, the sample distribution
update and the grown ensemble.

Binary labels live in {-1,+1}; weak-learner outputs are margins in [-1,1]
(stumps emit exactly +-1).  Every function computes in f32 on the device
of its inputs.  The centralized reference loop and the SAMME multiclass
extension are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

from repro_torch.core.compensation import adaboost_alpha  # noqa: F401

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


@dataclass
class Ensemble:
    """A grown ensemble: learner params + compensated weights."""
    learners: List[Dict] = field(default_factory=list)
    alphas: List[float] = field(default_factory=list)

    def add(self, params: Dict, alpha: float) -> None:
        self.learners.append(params)
        self.alphas.append(float(alpha))
