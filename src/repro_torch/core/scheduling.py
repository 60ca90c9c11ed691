"""Adaptive communication scheduling — the paper's eq. (1).

    I_{t+1} = I_t + alpha          if  de_t < theta1   (improving fast)
            = max(1, I_t - beta)   if  de_t > theta2   (regressing)
            = I_t                  otherwise
    I_{t+1} clipped to [I_min, I_max]

where de_t = eps_t - eps_{t-1} is the change of the global ensemble error.

Two implementations with identical semantics:

* :func:`adapt_interval` — on f32 scalar tensors, the functional form
  that the mesh-integrated trainer (:mod:`repro_torch.core.fed_mesh`)
  carries as state;
* :class:`HostScheduler` — plain Python, for the event-driven engine and
  for the serving batch window.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.paper_fedboost import SchedulerConfig

F32 = torch.float32


class SchedulerState(NamedTuple):
    interval: torch.Tensor     # f32 scalar (fractional steps allowed; floor at use)
    prev_error: torch.Tensor   # f32 scalar, eps_{t-1}
    initialized: bool          # the first observation sets prev only


def _clipped_init(cfg: SchedulerConfig) -> float:
    """i_init clipped into [i_min, i_max] — the invariant eq. (1) maintains
    must hold from construction, not only after the first observation."""
    return min(max(float(cfg.i_init), float(cfg.i_min)), float(cfg.i_max))


def init_state(cfg: SchedulerConfig, device="cpu") -> SchedulerState:
    return SchedulerState(
        interval=torch.tensor(_clipped_init(cfg), dtype=F32, device=device),
        prev_error=torch.tensor(1.0, dtype=F32, device=device),
        initialized=False)


def adapt_interval(state: SchedulerState, error, cfg: SchedulerConfig
                   ) -> SchedulerState:
    """One application of eq. (1) given the newly observed global error,
    in f32 as the JAX package computes it."""
    error = torch.as_tensor(error, dtype=F32, device=state.interval.device)
    if not state.initialized:
        return SchedulerState(state.interval, error, True)
    de = error - state.prev_error
    inc = state.interval + cfg.alpha
    dec = torch.clamp(state.interval - cfg.beta, min=1.0)
    new = torch.where(de < cfg.theta1, inc,
                      torch.where(de > cfg.theta2, dec, state.interval))
    new = torch.clamp(new, float(cfg.i_min), float(cfg.i_max))
    return SchedulerState(new, error, True)


class HostScheduler:
    """Eq. (1) on a stream of observed errors."""

    def __init__(self, cfg: SchedulerConfig):
        self.cfg = cfg
        self.interval = _clipped_init(cfg)
        self.prev_error = None

    def observe(self, error: float) -> int:
        c = self.cfg
        if self.prev_error is not None:
            de = error - self.prev_error
            if de < c.theta1:
                self.interval += c.alpha
            elif de > c.theta2:
                self.interval = max(1.0, self.interval - c.beta)
            self.interval = min(max(self.interval, float(c.i_min)),
                                float(c.i_max))
        self.prev_error = error
        return int(self.interval)

    @property
    def current(self) -> int:
        return int(self.interval)
