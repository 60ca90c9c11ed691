"""Adaptive communication scheduling — the paper's eq. (1).

    I_{t+1} = I_t + alpha          if  de_t < theta1   (improving fast)
            = max(1, I_t - beta)   if  de_t > theta2   (regressing)
            = I_t                  otherwise
    I_{t+1} clipped to [I_min, I_max]

where de_t = eps_t - eps_{t-1} is the change of the global ensemble error.
:class:`HostScheduler` runs it in plain Python for the event-driven engine
and for the serving batch window.
"""
from __future__ import annotations

from repro_torch.configs.paper_fedboost import SchedulerConfig


def _clipped_init(cfg: SchedulerConfig) -> float:
    """i_init clipped into [i_min, i_max] — the invariant eq. (1) maintains
    must hold from construction, not only after the first observation."""
    return min(max(float(cfg.i_init), float(cfg.i_min)), float(cfg.i_max))


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
