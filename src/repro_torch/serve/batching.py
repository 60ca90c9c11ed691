"""Adaptive micro-batching: request queue, batch window control, admission.

The batch window is driven by the paper's adaptive-interval rule (eq. 1,
:mod:`repro_torch.core.scheduling`), transferred from communication scheduling to
serving:

* training: error improving/stable -> widen the sync interval (sync less);
  error regressing -> shrink it (sync more).
* serving: the observed signal is the *negated* normalized p99 latency
  ``-p99/target``.  Latency rising (queue building under load) reads as the
  signal dropping fast -> the ``de < theta1`` branch fires and the window
  *grows*, buying throughput through bigger batches.  Latency stable or
  improving reads as ``de > theta2`` -> the window *shrinks*, drifting back
  toward minimum-latency single-request dispatch when load is light.

The controller is literally
:class:`~repro_torch.core.scheduling.HostScheduler` on that signal — same
state, same clipping, same step rule — so every property of eq. (1)
(bounded interval) carries over to the batch window.

Admission control: a hard queue budget.  When the queue is at budget the
submit is rejected (backpressure to the caller) rather than growing an
unbounded backlog that would blow the latency SLO for everyone.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Iterator, List, Optional

import numpy as np

from repro_torch.configs.paper_fedboost import SchedulerConfig
from repro_torch.core.scheduling import HostScheduler
from repro_torch.serve.metrics import percentile

# eq.-(1) constants for the serving controller, on the -p99/target scale:
# de < theta1  (latency worsened by >8% of target)  -> grow the window
# de > theta2  (latency stable within 2% or better) -> shrink the window
SERVE_SCHEDULER = SchedulerConfig(alpha=2.0, beta=1.0,
                                  theta1=-0.08, theta2=-0.02,
                                  i_min=1, i_max=32, i_init=2)


@dataclass(frozen=True)
class BatchConfig:
    """Micro-batching policy knobs."""
    max_batch: int = 64           # hard cap on requests per dispatched batch
    base_window_s: float = 1e-3   # seconds per window unit (interval tick)
    queue_budget: int = 512       # admission control: max queued requests
    target_p99_s: float = 0.025   # latency scale normalizing the signal
    adapt_every: int = 32         # completions per controller observation
    adaptive: bool = True         # False -> fixed window (ablation baseline)
    fixed_window_units: int = 8   # window when adaptive=False
    cache_capacity: int = 0       # per-snapshot result-cache entries (0 = off)
    scheduler: SchedulerConfig = field(default_factory=lambda: SERVE_SCHEDULER)


@dataclass
class Request:
    """One prediction request: a single feature vector for its tenant,
    kept on the host until the batch that serves it is packed.  ``ctx`` is
    the submitter's trace context (None when tracing is off); it rides the
    queue — surviving :meth:`MicroBatchQueue.requeue` across a scale-in
    reroute — so the completion on whichever host finally serves the
    request links back into the submit trace."""
    rid: int
    tenant: str
    x: np.ndarray                # (F,) f32 feature vector
    t_submit: float
    ctx: Optional[object] = None   # obs.TraceContext of the submit span


class AdaptiveWindow:
    """Batch-window controller: eq. (1) on the negated-latency signal."""

    def __init__(self, cfg: BatchConfig):
        self.cfg = cfg
        self.sched = HostScheduler(cfg.scheduler)
        self._lat: List[float] = []

    @property
    def units(self) -> int:
        if not self.cfg.adaptive:
            return self.cfg.fixed_window_units
        return self.sched.current

    @property
    def window_s(self) -> float:
        return self.units * self.cfg.base_window_s

    def record(self, latency_s: float) -> None:
        """Feed one completed-request latency; adapts every adapt_every."""
        self._lat.append(float(latency_s))
        if len(self._lat) >= self.cfg.adapt_every:
            self.observe_p99(percentile(self._lat, 99.0))
            self._lat.clear()

    def observe_p99(self, p99_s: float) -> int:
        """One controller step from an observed p99; returns window units."""
        if self.cfg.adaptive:
            self.sched.observe(-float(p99_s) / self.cfg.target_p99_s)
        return self.units


class MicroBatchQueue:
    """FIFO request queue with budget-based admission control.  Per-tenant
    budgets and batch caps (the reference's policy-table path) are not
    ported yet."""

    def __init__(self, cfg: BatchConfig,
                 rid_counter: Optional[Iterator[int]] = None):
        """``rid_counter`` lets several queues share one id space — the
        sharded fleet passes a common counter so a response's rid is unique
        across hosts, not just within one."""
        self.cfg = cfg
        self._q: Deque[Request] = deque()
        self._rids = (rid_counter if rid_counter is not None
                      else itertools.count())
        self.rejected = 0

    def __len__(self) -> int:
        return len(self._q)

    @property
    def depth(self) -> int:
        return len(self._q)

    def submit(self, tenant: str, x, now: float,
               ctx=None) -> Optional[Request]:
        """Enqueue; returns None (backpressure) when the queue is at its
        budget."""
        if len(self._q) >= self.cfg.queue_budget:
            self.rejected += 1
            return None
        req = Request(rid=next(self._rids), tenant=tenant,
                      x=np.asarray(x, np.float32), t_submit=float(now),
                      ctx=ctx)
        self._q.append(req)
        return req

    def requeue(self, req: Request) -> None:
        """Re-admit a request rerouted from a drained (scaled-in) host.
        Admission was already granted once, so the budget check is
        skipped — dropping an accepted request is strictly worse than a
        transiently over-budget queue.  The request keeps its rid and
        original submit time (its latency keeps accruing across the move)."""
        self._q.append(req)

    def pop_all(self) -> List[Request]:
        """Drain every queued request (scale-in hand-off), FIFO order."""
        out = list(self._q)
        self._q.clear()
        return out

    def oldest_t(self) -> Optional[float]:
        return self._q[0].t_submit if self._q else None

    def full_batch_t(self) -> Optional[float]:
        """Submit time of the request that filled a max_batch — the earliest
        instant a size-capped batch existed — or None if under the cap."""
        if len(self._q) < self.cfg.max_batch:
            return None
        return self._q[self.cfg.max_batch - 1].t_submit

    def pop_batch(self) -> List[Request]:
        n = min(len(self._q), self.cfg.max_batch)
        return [self._q.popleft() for _ in range(n)]
