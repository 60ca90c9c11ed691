"""Queue-depth fleet autoscaling: the paper's eq.-(1) controller applied to
serving *capacity*.

The adaptive-interval rule already drives two control loops in this tree —
the training sync interval (:mod:`repro_torch.core.scheduling`) and the serving
batch window (:mod:`repro_torch.serve.batching`).  :class:`FleetAutoscaler` is
the third: the same :class:`~repro_torch.core.scheduling.HostScheduler` with the
host count as its interval, clipped to ``[min_hosts, max_hosts]`` by the
same rule that clips ``[I_min, I_max]`` — so eq. (1)'s bounded-interval
property carries over to the fleet size.  The observed quantity is the
**negated integrated excess pressure**::

    pressure_t = max(mean queue depth per up host / target_queue,
                     p99 latency since the last observation / target_p99_s)
    signal_t   = -(sum_{i<=t} (pressure_i - release))

Training feeds eq. (1) the global *error*, which is naturally cumulative —
it keeps falling while things go well.  Queue pressure is instantaneous (a
saturated queue pins at the admission budget and stops moving), so the
fleet controller integrates it first; the per-step delta the controller
sees is then ``de_t = -(pressure_t - release)``, and the eq.-(1) branches
become a textbook high/low-water hysteresis on instantaneous pressure:

* ``de < theta1``  ⟺  pressure above the high water ``release - theta1``
  -> the interval grows -> **scale out** (one host per control period);
* ``de > theta2``  ⟺  pressure below the low water ``release - theta2``
  (burst over, backlog drained) -> **scale in**;
* pressure inside the band holds the fleet, so the relief a scale-out
  brings does not immediately read as a reason to scale back in.

Membership changes go through :class:`ShardedEnsembleServer` so they are
loss-free by construction (ASO-Fed-style capacity control under
heterogeneous load, churn-tolerant membership in the spirit of the async
FLchain analysis — arXiv:1911.02134, arXiv:2112.07938):

* **scale-out** spins up a host whose registry replica warms via a gossip
  pull *before* it enters the rendezvous ring (no cold-replica serving);
* **scale-in** picks the shallowest-queue victim, dispatches its due
  batches, reroutes its residual :class:`MicroBatchQueue` along rendezvous
  rank (admission bypassed — already-accepted requests are never dropped),
  hands its registry window to a survivor, then removes it.

The controller is clock-agnostic like everything else in
``repro_torch.serve``: ``step(now)`` self-gates on ``adapt_every_s`` of
*caller* time, so the same loop runs under the simulated clock of the
scenario replay and under a wall clock.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch import obs
from repro_torch.configs.paper_fedboost import SchedulerConfig
from repro_torch.core.scheduling import HostScheduler
from repro_torch.serve.engine import Response
from repro_torch.serve.metrics import percentile
from repro_torch.serve.service import ShardedEnsembleServer


@dataclass(frozen=True)
class AutoscaleConfig:
    """Fleet-capacity policy knobs (eq.-(1) constants on the pressure scale)."""
    min_hosts: int = 1
    max_hosts: int = 8
    target_queue: float = 32.0    # per-host queue depth normalizing pressure
    target_p99_s: float = 0.025   # latency scale normalizing pressure
    adapt_every_s: float = 0.05   # control period (caller-clock seconds)
    # asymmetric by default — scale out a whole host per over-pressure
    # period, but bleed capacity off at a quarter host per calm period:
    # shedding a host is cheap to regret during the next burst onset
    # (the queue refills before the re-add lands), so calm must persist
    # ~1/step_down periods before a host is actually removed
    step_up: float = 1.0          # eq.-(1) alpha: hosts added per step
    step_down: float = 0.25       # eq.-(1) beta: host fraction shed per step
    release: float = 0.4          # pressure the integrator bleeds per period
    theta1: float = -0.25         # high water: scale out above release-theta1
    theta2: float = 0.25          # low water: scale in below release-theta2
    # cost awareness (ROADMAP "cost-aware autoscaling"): each up host is
    # projected to cost `cost_per_host_hour` $/h; a scale-out that would
    # push the fleet's projected spend past `budget_per_hour` is skipped
    # (and counted in stats.budget_capped).  None = uncapped.  The budget
    # acts as a dynamic i_max — it never forces a scale-in below
    # min_hosts, it only refuses growth the operator can't pay for.
    cost_per_host_hour: float = 1.0
    budget_per_hour: Optional[float] = None

    def scheduler(self, init_hosts: int) -> SchedulerConfig:
        """The eq.-(1) constants with the host count as the interval."""
        return SchedulerConfig(alpha=self.step_up, beta=self.step_down,
                               theta1=self.theta1, theta2=self.theta2,
                               i_min=self.min_hosts, i_max=self.max_hosts,
                               i_init=init_hosts)


@dataclass
class AutoscaleStats:
    observations: int = 0
    scale_outs: int = 0
    scale_ins: int = 0
    rerouted: int = 0             # requests moved by scale-in drains
    budget_capped: int = 0        # scale-outs refused by the $/hour budget
    pressure_peak: float = 0.0
    # (now, "out"/"in", host_id, fleet size after the event)
    events: List[Tuple[float, str, str, int]] = field(default_factory=list)


class FleetAutoscaler:
    """Eq.-(1) control loop over a :class:`ShardedEnsembleServer`'s size.

    Drive it from the serving loop: call :meth:`step(now)` whenever
    convenient (every submit is fine — it self-gates on the control
    period) and collect any responses it returns; scale-in drains dispatch
    batches, so those completions belong to the caller's tally.
    """

    def __init__(self, server: ShardedEnsembleServer,
                 cfg: Optional[AutoscaleConfig] = None,
                 host_prefix: str = "scale", *,
                 budget_per_host: Optional[float] = None,
                 budget_per_hour: Optional[float] = None,
                 slo=None):
        # budget_per_host / budget_per_hour override the cfg cost knobs:
        # a host is projected to cost budget_per_host $/h and scale-out is
        # refused once (n+1) hosts would exceed budget_per_hour $/h
        self.server = server
        self.cfg = cfg or AutoscaleConfig()
        self.cost_per_host_hour = (self.cfg.cost_per_host_hour
                                   if budget_per_host is None
                                   else float(budget_per_host))
        self.budget_per_hour = (self.cfg.budget_per_hour
                                if budget_per_hour is None
                                else float(budget_per_hour))
        n0 = min(max(len(server.servers), self.cfg.min_hosts),
                 self.cfg.max_hosts)
        self.sched = HostScheduler(self.cfg.scheduler(n0))
        self.stats = AutoscaleStats()
        self._seq = itertools.count()
        self._prefix = host_prefix
        self._lat: List[float] = []   # completions since last observation
        self._next_obs: Optional[float] = None
        self._integral = 0.0          # summed excess pressure (see module doc)
        # optional obs.slo.SLOMonitor: its burn rate joins the pressure max
        self.slo = slo
        for s in server.servers.values():
            s.on_completion = self._lat.append

    # ------------------------------------------------------------- signal
    def _up(self, host_id: str) -> bool:
        host = self.server.cluster.hosts.get(host_id)
        return host is not None and host.up

    def _up_hosts(self) -> List[str]:
        return [hid for hid in self.server.servers if self._up(hid)]

    def pressure(self, now: Optional[float] = None) -> float:
        """Normalized fleet pressure: queue depth and latency, whichever is
        worse.  Queue depth is the total backlog averaged over *up* hosts
        (capacity-relative — a host that is marked down contributes its
        stuck queue to the numerator but no capacity to the denominator);
        p99 is over completions since the last observation so stale calm
        never masks a fresh spike.  With an attached SLO monitor (and a
        clock), the fleet's burn rate joins the max: crossing 1.0 exactly
        when some tenant burns its error budget at alerting speed, so the
        fleet grows *before* the p99 target itself is breached."""
        depth = sum(s.queue.depth for s in self.server.servers.values())
        p = depth / max(1, len(self._up_hosts())) / self.cfg.target_queue
        if self._lat:
            p = max(p, percentile(self._lat, 99.0) / self.cfg.target_p99_s)
        if self.slo is not None and now is not None:
            p = max(p, self.slo.burn_pressure(now))
        return p

    # --------------------------------------------------------------- cost
    def projected_cost(self, n_hosts: Optional[int] = None) -> float:
        """Projected fleet spend in $/hour for ``n_hosts`` (default: the
        current up count)."""
        n = len(self._up_hosts()) if n_hosts is None else n_hosts
        return n * self.cost_per_host_hour

    def max_affordable(self) -> int:
        """The largest fleet the $/hour budget pays for (never below
        ``min_hosts`` — the budget refuses growth, it does not force a
        scale-in under the floor)."""
        if self.budget_per_hour is None:
            return self.cfg.max_hosts
        # epsilon before flooring: a budget that exactly pays for N hosts
        # must afford N even when the division lands at N - 1ulp
        afford = int(self.budget_per_hour
                     / max(self.cost_per_host_hour, 1e-12) + 1e-9)
        return max(self.cfg.min_hosts, min(afford, self.cfg.max_hosts))

    # ------------------------------------------------------------ control
    def step(self, now: float) -> List[Response]:
        """One possible control action; self-gates on ``adapt_every_s``.
        Returns responses dispatched by a scale-in drain (usually empty)."""
        if self._next_obs is None:
            self._next_obs = now + self.cfg.adapt_every_s
            return []
        if now < self._next_obs:
            return []
        self._next_obs = now + self.cfg.adapt_every_s
        p = self.pressure(now)
        self._lat.clear()
        self.stats.observations += 1
        self.stats.pressure_peak = max(self.stats.pressure_peak, p)
        # eq. (1) on the negated integrated excess pressure: the step the
        # controller observes is de = -(p - release), i.e. the high/low-
        # water hysteresis derived in the module docstring
        self._integral += p - self.cfg.release
        self.sched.observe(-self._integral)
        return self._reconcile(now)

    def _reconcile(self, now: float) -> List[Response]:
        """Move the fleet one membership action toward the controller's
        target per control period — churn paced by the observation clock,
        never faster than gossip warm-up/drain can follow.  *Capacity* is
        the up-host count: a host marked down by failover is not capacity,
        so it is shed unconditionally (its accepted requests reroute to
        live hosts instead of starving behind a dead queue) and the
        controller replaces it rather than holding a dead fleet.

        Scale decisions compare the eq.-(1) state's *fractional* interval
        against the up count with a full unit of margin: a scale-out
        leaves the interval at an integer, and comparing ``int(interval)``
        would let a single epsilon of calm shed the newest host — the
        fractional comparison makes the first shed wait the same
        ``~1/step_down`` calm periods as every later one, while one
        over-pressure period (``step_up = 1``) still scales out
        immediately."""
        up = self._up_hosts()
        down = [hid for hid in self.server.servers if hid not in up]
        if down and up:
            return self._shed(down, now)
        current = len(up)
        target = self.sched.interval            # fractional eq.-(1) state
        if target >= current + 1:
            if current + 1 > self.max_affordable():
                # the budget binds: refuse the scale-out and clamp the
                # eq.-(1) state at the affordable fleet (a dynamic i_max)
                # so the integrator doesn't wind up unboundedly and make
                # the eventual scale-in sluggish
                self.stats.budget_capped += 1
                self.sched.interval = min(self.sched.interval,
                                          float(self.max_affordable()))
                return []
            return self._scale_out(now)
        if (target <= current - 1 and current > self.cfg.min_hosts
                and current > 1):
            return self._shed(up, now)
        return []

    def _scale_out(self, now: float) -> List[Response]:
        # probe past ids already taken (live or retired) — a rebuilt
        # autoscaler on the same server restarts its sequence at 0
        host_id = f"{self._prefix}-{next(self._seq)}"
        while self.server.host_id_taken(host_id):
            host_id = f"{self._prefix}-{next(self._seq)}"
        server = self.server.add_host(host_id, now=now)
        server.on_completion = self._lat.append
        self.stats.scale_outs += 1
        self.stats.events.append((now, "out", host_id,
                                  len(self.server.servers)))
        obs.count("autoscale.scale_outs")
        if obs.enabled():
            obs.point("autoscale.scale_out", sim_t0=now, sim_t1=now,
                      host=host_id, hosts=len(self.server.servers))
        return []

    def _shed(self, pool: List[str], now: float) -> List[Response]:
        # shallowest queue = cheapest drain; rendezvous hashing makes any
        # victim equally safe for ownership (only its tenants move)
        victim = min(pool,
                     key=lambda hid: self.server.servers[hid].queue.depth)
        responses, rerouted = self.server.remove_host(victim, now=now)
        self.stats.scale_ins += 1
        self.stats.rerouted += rerouted
        self.stats.events.append((now, "in", victim,
                                  len(self.server.servers)))
        obs.count("autoscale.scale_ins")
        obs.count("autoscale.rerouted", rerouted)
        if obs.enabled():
            obs.point("autoscale.scale_in", sim_t0=now, sim_t1=now,
                      host=victim, hosts=len(self.server.servers),
                      rerouted=rerouted)
        return responses
