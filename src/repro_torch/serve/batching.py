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
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Iterator, List, Optional

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
    """FIFO request queue with budget-based admission control.

    With a ``tenant_cfg`` resolver attached (the per-(tenant, host)
    :class:`~repro_torch.serve.policy.PolicyTable` path), two per-tenant
    knobs apply on top of the host-level config, in both directions:

    * admission: a tenant's queued requests may not exceed *its* resolved
      ``queue_budget`` — a cold tenant with a small budget gets early
      backpressure instead of a deep backlog (its accepted requests stay
      near the queue head: minimum latency).  A hot tenant's budget
      *above* the host scope is honored too: its submits are admitted
      until the total queue reaches the larger of the two budgets, so
      raising a tenant is not a silent no-op;
    * batching: one dispatched batch carries at most the tenant's resolved
      ``max_batch`` of its requests; the overflow keeps its FIFO position
      for the next batch, so a hot tenant's burst cannot monopolize every
      slot of a shared batch beyond its policy's share.  A tenant cap
      above the host scope lifts the shared batch bound to match (its big
      batches ride with everyone else's policy-bounded shares).
    """

    def __init__(self, cfg: BatchConfig,
                 rid_counter: Optional[Iterator[int]] = None,
                 tenant_cfg: Optional[Callable[[str], BatchConfig]] = None):
        """``rid_counter`` lets several queues share one id space — the
        sharded fleet passes a common counter so a response's rid is unique
        across hosts, not just within one.  ``tenant_cfg`` resolves a
        tenant's effective :class:`BatchConfig` (None = host config for
        every tenant)."""
        self.cfg = cfg
        self._q: Deque[Request] = deque()
        self._rids = (rid_counter if rid_counter is not None
                      else itertools.count())
        self._tenant_cfg = tenant_cfg
        self._depth: Counter = Counter()      # per-tenant queued counts
        self.rejected = 0

    def __len__(self) -> int:
        return len(self._q)

    @property
    def depth(self) -> int:
        return len(self._q)

    def tenant_depth(self, tenant: str) -> int:
        return self._depth[tenant]

    def _cfg_for(self, tenant: str) -> BatchConfig:
        return self._tenant_cfg(tenant) if self._tenant_cfg else self.cfg

    def submit(self, tenant: str, x, now: float,
               ctx=None) -> Optional[Request]:
        """Enqueue; returns None (backpressure) when the tenant is at its
        resolved budget, or the total queue is at the larger of the host
        budget and the tenant's own (so a hot tenant's raised budget is
        real capacity, not a no-op behind the host cap)."""
        budget = self.cfg.queue_budget
        if self._tenant_cfg is not None:
            t_budget = self._cfg_for(tenant).queue_budget
            if self._depth[tenant] >= t_budget:
                self.rejected += 1
                return None
            budget = max(budget, t_budget)
        if len(self._q) >= budget:
            self.rejected += 1
            return None
        req = Request(rid=next(self._rids), tenant=tenant,
                      x=np.asarray(x, np.float32), t_submit=float(now),
                      ctx=ctx)
        self._q.append(req)
        self._depth[tenant] += 1
        return req

    def requeue(self, req: Request) -> None:
        """Re-admit a request rerouted from a drained (scaled-in) host.
        Admission was already granted once, so the budget checks are
        skipped — dropping an accepted request is strictly worse than a
        transiently over-budget queue.  The request keeps its rid and
        original submit time (its latency keeps accruing across the move)."""
        self._q.append(req)
        self._depth[req.tenant] += 1

    def pop_all(self) -> List[Request]:
        """Drain every queued request (scale-in hand-off), FIFO order."""
        out = list(self._q)
        self._q.clear()
        self._depth.clear()
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
        if self._tenant_cfg is None:
            n = min(len(self._q), self.cfg.max_batch)
            out = [self._q.popleft() for _ in range(n)]
        else:
            # honor per-tenant batch caps; skipped requests keep FIFO
            # order.  A queued tenant whose cap exceeds the host scope
            # lifts the shared bound — its policy promised batches that
            # big — while every tenant's own share stays policy-bounded.
            caps = {t: max(1, self._cfg_for(t).max_batch)
                    for t, d in self._depth.items() if d > 0}
            bound = max([self.cfg.max_batch] + list(caps.values()))
            # the batch can never exceed what the caps allow; stopping at
            # that bound keeps a drain against capped-out tenants linear
            bound = min(bound, sum(min(self._depth[t], c)
                                   for t, c in caps.items()))
            out, kept, taken = [], deque(), Counter()
            while self._q and len(out) < bound:
                req = self._q.popleft()
                if taken[req.tenant] >= caps[req.tenant]:
                    kept.append(req)
                    continue
                taken[req.tenant] += 1
                out.append(req)
            if kept:                   # skipped all predate the remainder
                kept.extend(self._q)
                self._q = kept
        self._depth.subtract(r.tenant for r in out)
        return out
