"""SLO error budgets and multi-window burn-rate alerting on the sim clock.

The serving stack reports latency distributions; this module turns them
into *objectives*: a per-tenant :class:`SLObjective` declares what counts
as a good request (completed within a latency threshold — a rejection is
always bad) and what fraction must be good (``target``, e.g. 0.99).  The
complement ``1 - target`` is the **error budget**: the fraction of
requests the tenant is allowed to fail over a rolling window before the
objective is breached.

Alerting follows the multi-window burn-rate construction from the Google
SRE workbook: the *burn rate* over a window is the observed bad fraction
divided by the budget fraction (burn 1.0 = spending the budget exactly at
the sustainable rate; burn 10 = ten times too fast).  A
:class:`BurnRateRule` fires only when **both** a long and a short window
exceed its factor — the long window keeps one transient spike from paging,
the short window makes the alert *resolve* promptly once the burst ends
instead of waiting for the long window to drain.  Transitions are recorded
in an :class:`AlertLog` and emitted into the trace stream as
``alert.fire`` / ``alert.resolve`` points, so a stitched timeline shows
exactly which requests burned the budget.

Everything runs on the **simulated clock** (the same virtual time the
serving spans carry); nothing here reads wall time, so a quick CI run and
a long soak exercise identical logic.

The ledger is exact, not sampled: :class:`SLOMonitor` counts every
recorded outcome in ``good_total``/``bad_total`` (and optionally journals
each one), so a caller can reconcile it against its own request log.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Iterable, List, Optional, Tuple

import repro_torch.obs as obs

__all__ = ["SLObjective", "BurnRateRule", "AlertEvent", "AlertLog",
           "ErrorBudget", "SLOMonitor", "default_rules"]


@dataclass(frozen=True)
class SLObjective:
    """One tenant's serving objective: at least ``target`` of requests must
    complete within ``latency_threshold_s`` (rejections count as misses),
    measured over a rolling ``window_s`` of simulated time."""
    tenant: str
    latency_threshold_s: float = 0.025
    target: float = 0.99
    window_s: float = 1.0

    @property
    def budget_fraction(self) -> float:
        """The error budget as a fraction of traffic (``1 - target``)."""
        return max(1e-9, 1.0 - float(self.target))


@dataclass(frozen=True)
class BurnRateRule:
    """Fire when the burn rate over BOTH windows is >= ``factor``; resolve
    once the short window drops back below it."""
    name: str
    long_s: float
    short_s: float
    factor: float


def default_rules(objective: SLObjective) -> Tuple[BurnRateRule, ...]:
    """The stock two-rule ladder, scaled to the objective's window: a fast
    page (burning >= 8x budget over window/4 + window/16) and a slow
    ticket (>= 2x over the full window + window/4)."""
    w = float(objective.window_s)
    return (BurnRateRule("page", long_s=w / 4.0, short_s=w / 16.0,
                         factor=8.0),
            BurnRateRule("ticket", long_s=w, short_s=w / 4.0, factor=2.0))


@dataclass
class AlertEvent:
    t: float
    tenant: str
    rule: str
    kind: str                  # "fire" | "resolve"
    burn_short: float
    burn_long: float

    def to_dict(self) -> Dict:
        return {"t": self.t, "tenant": self.tenant, "rule": self.rule,
                "kind": self.kind, "burn_short": self.burn_short,
                "burn_long": self.burn_long}


class AlertLog:
    """Ordered record of alert transitions across all tenants/rules."""

    def __init__(self):
        self.events: List[AlertEvent] = []
        self._active: Dict[Tuple[str, str], AlertEvent] = {}

    def fire(self, ev: AlertEvent) -> None:
        self.events.append(ev)
        self._active[(ev.tenant, ev.rule)] = ev

    def resolve(self, ev: AlertEvent) -> None:
        self.events.append(ev)
        self._active.pop((ev.tenant, ev.rule), None)

    def is_active(self, tenant: str, rule: str) -> bool:
        return (tenant, rule) in self._active

    def active(self) -> List[AlertEvent]:
        """The fire events still unresolved, oldest first."""
        return sorted(self._active.values(), key=lambda e: e.t)

    def timeline(self) -> List[Dict]:
        return [e.to_dict() for e in self.events]


class ErrorBudget:
    """One tenant's rolling ledger of request outcomes on the sim clock.

    Every outcome is counted exactly once in the cumulative totals; the
    windowed view trims to ``horizon_s`` so a long soak holds bounded
    state.  Records must arrive in non-decreasing ``t`` order (the serving
    stack's completion order), which makes trimming a deque pop."""

    def __init__(self, objective: SLObjective, horizon_s: float):
        self.objective = objective
        self.horizon_s = float(horizon_s)
        self._events: Deque[Tuple[float, bool]] = deque()
        self.good_total = 0
        self.bad_total = 0

    def record(self, t: float, good: bool) -> None:
        t = float(t)
        if good:
            self.good_total += 1
        else:
            self.bad_total += 1
        self._events.append((t, good))
        self._trim(t)

    def _trim(self, now: float) -> None:
        cutoff = now - self.horizon_s
        ev = self._events
        while ev and ev[0][0] < cutoff:
            ev.popleft()

    # ------------------------------------------------------------- reading
    @property
    def total(self) -> int:
        return self.good_total + self.bad_total

    def window_counts(self, now: float, window_s: float) -> Tuple[int, int]:
        """(good, bad) over ``(now - window_s, now]``."""
        cutoff = now - float(window_s)
        good = bad = 0
        for t, g in reversed(self._events):
            if t <= cutoff:
                break
            if g:
                good += 1
            else:
                bad += 1
        return good, bad

    def bad_fraction(self, now: float, window_s: float) -> float:
        good, bad = self.window_counts(now, window_s)
        n = good + bad
        return bad / n if n else 0.0

    def burn_rate(self, now: float, window_s: float) -> float:
        """Observed bad fraction over the window, in units of the budget:
        1.0 = spending the error budget exactly as fast as allowed."""
        return (self.bad_fraction(now, window_s)
                / self.objective.budget_fraction)

    def remaining(self, now: float) -> float:
        """Fraction of the objective-window budget still unspent (clipped
        to [0, 1]): 1.0 = no bad requests in the window, 0.0 = budget
        exhausted or overdrawn."""
        return min(1.0, max(0.0, 1.0 - self.burn_rate(
            now, self.objective.window_s)))


class SLOMonitor:
    """Per-tenant error budgets + burn-rate alerting over a serving run.

    Feed it every request outcome (:meth:`record` / the serving stack's
    ``on_slo`` hook via :meth:`record_completion`), call :meth:`check`
    as the sim clock advances, and read alerts from :attr:`alerts`.
    ``journal`` (optional) collects one dict per recorded outcome — the
    exact request log a caller reconciles the ledger against."""

    def __init__(self, objectives: Iterable[SLObjective],
                 rules: Optional[Iterable[BurnRateRule]] = None,
                 journal: Optional[List[Dict]] = None):
        self.objectives: Dict[str, SLObjective] = {
            o.tenant: o for o in objectives}
        if not self.objectives:
            raise ValueError("SLOMonitor needs at least one SLObjective")
        self._rules: Dict[str, Tuple[BurnRateRule, ...]] = {}
        self.budgets: Dict[str, ErrorBudget] = {}
        for tenant, o in self.objectives.items():
            tr = tuple(rules) if rules is not None else default_rules(o)
            self._rules[tenant] = tr
            horizon = max([o.window_s] + [r.long_s for r in tr])
            self.budgets[tenant] = ErrorBudget(o, horizon)
        self.alerts = AlertLog()
        self.journal = journal

    def rules_for(self, tenant: str) -> Tuple[BurnRateRule, ...]:
        return self._rules[tenant]

    # ------------------------------------------------------------ recording
    def record(self, tenant: str, t: float, latency_s: Optional[float] = None,
               rejected: bool = False) -> bool:
        """Record one request outcome at sim time ``t``; returns whether it
        was good.  Unknown tenants (no objective) are ignored."""
        obj = self.objectives.get(tenant)
        if obj is None:
            return True
        good = ((not rejected) and latency_s is not None
                and latency_s <= obj.latency_threshold_s)
        self.budgets[tenant].record(t, good)
        obs.count("slo.good" if good else "slo.bad", tenant=tenant)
        if self.journal is not None:
            self.journal.append({"t": float(t), "tenant": tenant,
                                 "good": good, "rejected": bool(rejected),
                                 "latency_s": latency_s})
        return good

    def record_completion(self, tenant: str, t: float,
                          latency_s: float) -> None:
        """`EnsembleServer.on_slo`-shaped adapter."""
        self.record(tenant, t, latency_s=latency_s)

    # ------------------------------------------------------------- alerting
    def check(self, now: float) -> List[AlertEvent]:
        """Evaluate every (tenant, rule) at sim time ``now``; returns the
        transitions (fires + resolves) this call produced."""
        out: List[AlertEvent] = []
        for tenant, budget in self.budgets.items():
            for rule in self._rules[tenant]:
                bl = budget.burn_rate(now, rule.long_s)
                bs = budget.burn_rate(now, rule.short_s)
                self._gauge(tenant, rule, bs)
                active = self.alerts.is_active(tenant, rule.name)
                if not active and bl >= rule.factor and bs >= rule.factor:
                    ev = AlertEvent(float(now), tenant, rule.name, "fire",
                                    bs, bl)
                    self.alerts.fire(ev)
                    out.append(ev)
                    obs.count("alert.fires", tenant=tenant, rule=rule.name)
                    obs.point("alert.fire", sim_t0=now, sim_t1=now,
                              tenant=tenant, rule=rule.name,
                              burn_short=bs, burn_long=bl)
                elif active and bs < rule.factor:
                    ev = AlertEvent(float(now), tenant, rule.name,
                                    "resolve", bs, bl)
                    self.alerts.resolve(ev)
                    out.append(ev)
                    obs.count("alert.resolves", tenant=tenant,
                              rule=rule.name)
                    obs.point("alert.resolve", sim_t0=now, sim_t1=now,
                              tenant=tenant, rule=rule.name,
                              burn_short=bs, burn_long=bl)
        return out

    def _gauge(self, tenant: str, rule: BurnRateRule, burn: float) -> None:
        obs.get_registry().gauge("slo.burn_rate", tenant=tenant,
                                 rule=rule.name).set(burn)

    # -------------------------------------------------------------- reading
    def burn_pressure(self, now: float) -> float:
        """Burn rate as an autoscaler pressure signal: the max over every
        (tenant, rule) of ``burn_short / factor`` — crosses 1.0 exactly
        when some rule's short window is burning fast enough to fire."""
        p = 0.0
        for tenant, budget in self.budgets.items():
            for rule in self._rules[tenant]:
                p = max(p, budget.burn_rate(now, rule.short_s) / rule.factor)
        return p

    def budget_remaining(self, tenant: str, now: float) -> float:
        return self.budgets[tenant].remaining(now)

    def report(self, now: float) -> Dict:
        """Per-tenant ledger summary + the alert timeline."""
        return {
            "tenants": {
                tenant: {
                    "good": b.good_total,
                    "bad": b.bad_total,
                    "budget_remaining": b.remaining(now),
                    "burn_window": b.burn_rate(now, b.objective.window_s),
                }
                for tenant, b in sorted(self.budgets.items())
            },
            "alerts": self.alerts.timeline(),
            "active_alerts": [e.to_dict() for e in self.alerts.active()],
        }
