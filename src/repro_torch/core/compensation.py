"""Delayed weight compensation — the paper's eq. (2) plus the FedAsync
staleness-decay family.

The paper's rule is

    alpha~_t = alpha_t * exp(-lambda * tau)

where alpha_t = 1/2 ln((1 - eps_t)/eps_t) is the classical AdaBoost vote
weight of weak learner h_t and tau is its staleness in rounds at the moment
the server folds it into the global ensemble.  Continuous (per-message)
aggregation generalizes this to alpha~ = alpha * s(tau) with ``s`` drawn
from the FedAsync decay family (Xie et al.; the FLGo ``fedasync``
implementation is the reference):

* ``exp``       s(tau) = exp(-lambda * tau)          — paper eq. (2), default
* ``constant``  s(tau) = 1                           — no decay (FedAsync a=0)
* ``hinge``     s(tau) = 1 if tau <= b else 1/(a*(tau-b))
* ``poly``      s(tau) = (tau + 1)^(-a)

``tau`` is clamped to ``[0, tau_cap]`` for every family, so a pathological
delay can never zero a learner out entirely (nor divide by a huge hinge
denominator).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.paper_fedboost import CompensationConfig

EPS_CLIP = 1e-6
DECAYS = ("exp", "constant", "hinge", "poly")


F32 = torch.float32


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=F32)


def adaboost_alpha(eps) -> torch.Tensor:
    """alpha_t = 1/2 ln((1-eps)/eps) in f32, eps clipped away from {0, 1}."""
    eps = torch.clamp(_f32(eps), EPS_CLIP, 1.0 - EPS_CLIP)
    return 0.5 * torch.log((1.0 - eps) / eps)


def staleness_scale(tau, cfg: CompensationConfig) -> float:
    """s(tau) as a python float — the scalar fast path the fleet-profile
    engine uses so a 100k-sync run never touches the device per merge.
    Matches :func:`compensate` (same clamp, same family)."""
    tau = max(0.0, min(float(tau), float(cfg.tau_cap)))
    decay = cfg.decay
    if decay == "exp":
        return math.exp(-cfg.lam * tau)
    if decay == "constant":
        return 1.0
    if decay == "hinge":
        if tau <= cfg.hinge_b:
            return 1.0
        return 1.0 / (cfg.hinge_a * max(tau - cfg.hinge_b, EPS_CLIP))
    if decay == "poly":
        return (tau + 1.0) ** (-cfg.poly_a)
    raise KeyError(f"unknown staleness decay {decay!r}; one of {DECAYS}")


def compensate(alpha, tau, cfg: CompensationConfig) -> torch.Tensor:
    """alpha~ = alpha * s(min(tau, tau_cap)) in f32; tau >= 0.

    Each branch is the JAX package's op for op, in f32, so the compensated
    weights agree with it to the last bit wherever the two libraries'
    ``exp`` do.
    """
    tau = torch.clamp(_f32(tau), max=float(cfg.tau_cap))
    tau = torch.clamp(tau, min=0.0)
    alpha = _f32(alpha)
    decay = cfg.decay
    if decay == "exp":
        return alpha * torch.exp(-cfg.lam * tau)
    if decay == "constant":
        return alpha * torch.ones_like(tau)
    if decay == "hinge":
        scale = torch.where(
            tau <= cfg.hinge_b, 1.0,
            1.0 / (cfg.hinge_a * torch.clamp(tau - cfg.hinge_b,
                                             min=EPS_CLIP)))
        return alpha * scale
    if decay == "poly":
        return alpha * (tau + 1.0) ** (-cfg.poly_a)
    raise KeyError(f"unknown staleness decay {decay!r}; one of {DECAYS}")


def compensated_alpha(eps, tau, cfg: CompensationConfig):
    return compensate(adaboost_alpha(eps), tau, cfg)
