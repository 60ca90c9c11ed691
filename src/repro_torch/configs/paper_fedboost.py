"""The paper's own experiment configuration: enhanced asynchronous AdaBoost
federated learning across the five application domains.

All hyperparameters referenced in the paper's Methodology section (α, β,
θ₁, θ₂, λ, I bounds) live here, with the values used for the reproduction
runs.  The paper does not publish its exact constants; these were chosen so
the *baseline* (synchronize every round, no compensation) and *enhanced*
configurations reproduce the relative improvement bands of Table 1 — see
EXPERIMENTS.md §Paper for the sensitivity sweep over these choices.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class SchedulerConfig:
    """Adaptive communication scheduling rule (paper eq. 1)."""
    alpha: float = 1.0          # interval increase step when error stable/improving
    beta: float = 2.0           # interval decrease step when error regresses
    # Δε < θ₁ (improving, or stable within +θ₁) → widen interval;
    # Δε > θ₂ (regressing) → shrink.  The paper calls θ₁, θ₂ "stability
    # thresholds": a plateau (Δε ≈ 0 < θ₁) must widen the interval, which is
    # exactly when synchronization stops paying for itself.
    theta1: float = 0.001
    theta2: float = 0.01
    i_min: int = 1
    i_max: int = 8
    i_init: int = 1


@dataclass(frozen=True)
class CompensationConfig:
    """Delayed weight compensation α̃ = α·s(τ) (paper eq. 2 generalized).

    ``decay`` selects s(τ) from the FedAsync staleness family
    (repro_torch.core.compensation): ``exp`` is the paper's eq.-(2)
    exp(−λτ) and the default; ``constant``/``hinge``/``poly`` are the
    FedAsync alternatives (FLGo's defaults for a and b).  τ is clamped to
    [0, tau_cap] for every family."""
    lam: float = 0.15           # staleness decay constant λ (exp family)
    tau_cap: int = 32           # clamp pathological delays
    decay: str = "exp"          # exp | constant | hinge | poly
    hinge_a: float = 10.0       # hinge slope 1/(a·(τ−b)) beyond b
    hinge_b: float = 6.0        # hinge grace period in rounds
    poly_a: float = 0.5         # polynomial exponent (τ+1)^(−a)


@dataclass(frozen=True)
class FedBoostConfig:
    """One federated async-AdaBoost experiment."""
    n_clients: int = 16
    n_rounds: int = 80          # local boosting rounds per client
    target_error: float = 0.0   # 0 = run all rounds; else early stop metric
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    compensation: CompensationConfig = field(default_factory=CompensationConfig)
    weak_learner: str = "stump"  # stump | logistic | mlp
    balanced_init: bool = False  # class-balanced D_0 (imbalanced domains)
    # BEYOND-PAPER: client-side relevance filter — at sync, drop buffered
    # learners whose staleness-compensated local alpha falls below
    # `relevance_filter` x the buffer's best (0 = off, paper-faithful).
    # Realizes the paper's "fewer but more relevant updates" remark
    # (Mobile Personalization section) as an actual mechanism.
    relevance_filter: float = 0.0
    seed: int = 0
    # async client heterogeneity (simulator): per-client compute-time
    # multipliers drawn log-uniform in [1, straggler_factor]
    straggler_factor: float = 4.0
    dropout_prob: float = 0.05   # per-round client dropout probability
    # communication model: bytes per learner and per sync message header
    link_mbps: float = 10.0      # client uplink
    header_bytes: int = 256
    # scale knob: at sync, replay at most this many of the newest foreign
    # learners into the client's local distribution (None = exact/paper-
    # faithful replay of the whole window).  Fleet-scale scenarios cap this
    # so catch-up work per sync is O(cap), not O(ensemble); it applies to
    # both modes so the baseline/enhanced comparison stays apples-to-apples.
    catch_up_cap: Optional[int] = None


@dataclass(frozen=True)
class DomainConfig:
    """One of the paper's five application domains (synthetic environment)."""
    name: str
    n_samples: int
    n_features: int
    n_clients: int
    noniid_alpha: float          # Dirichlet concentration (lower = more skew)
    label_imbalance: float       # fraction of positive class
    noise: float
    straggler_factor: float
    dropout_prob: float
    link_mbps: float


DEFAULT = FedBoostConfig()
