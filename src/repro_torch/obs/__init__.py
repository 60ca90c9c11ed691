"""repro_torch.obs — unified tracing + metrics across train / serve / sim.

Two process-wide singletons, both consumed through cheap module-level
helpers the instrumented subsystems call unconditionally:

* the **tracer** (:mod:`repro_torch.obs.trace`): off by default; while off,
  :func:`span`/:func:`point` return the shared :data:`NULL_SPAN` without
  allocating.  Enable with :func:`configure` (CLIs) or the :func:`tracing`
  context manager (tests, harness runs), which installs a fresh
  :class:`Tracer` and restores the previous state on exit.
* the **metrics registry** (:mod:`repro_torch.obs.registry`): always available
  via :func:`get_registry` (counters are a dict hit + float add).  The
  expensive recorders, which must block on device results to time them,
  additionally gate on :func:`profiling_enabled`, which
  :func:`configure`/:func:`tracing` switch on alongside tracing unless
  told otherwise.

The JSONL trace schema is the reference package's, unchanged.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

from repro_torch.obs.registry import (Counter, Gauge, Histogram, MetricsRegistry,
                                percentile, weighted_percentile)
from repro_torch.obs.trace import (NULL_SPAN, Span, TraceContext, Tracer,
                             load_jsonl, load_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL_SPAN",
    "Span", "TraceContext", "Tracer", "configure", "count", "disable",
    "enabled", "get_registry", "get_tracer", "load_jsonl", "load_trace",
    "observe", "percentile", "point", "profiling_enabled", "set_registry",
    "span", "tracing", "weighted_percentile",
]

_TRACER: Optional[Tracer] = None
_REGISTRY = MetricsRegistry()
_PROFILE = False


# ------------------------------------------------------------------ tracer
def get_tracer() -> Optional[Tracer]:
    """The active tracer, or None while tracing is disabled."""
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


def profiling_enabled() -> bool:
    """Whether the blocking kernel-launch timers should run."""
    return _PROFILE


def configure(trace: bool = True, ring: int = 65536,
              profile_kernels: Optional[bool] = None,
              registry: Optional[MetricsRegistry] = None) -> Optional[Tracer]:
    """Install (or tear down) the process-wide observability state.

    ``trace=True`` installs a fresh :class:`Tracer` with a ``ring``-bounded
    span buffer; ``trace=False`` disables tracing.  ``profile_kernels``
    defaults to following ``trace``.  ``registry`` swaps the global
    metrics registry (a fresh one isolates a run's counters).  Returns the
    active tracer (None when disabled)."""
    global _TRACER, _PROFILE, _REGISTRY
    _TRACER = Tracer(ring) if trace else None
    _PROFILE = trace if profile_kernels is None else bool(profile_kernels)
    if registry is not None:
        _REGISTRY = registry
    return _TRACER


def disable() -> None:
    """Turn tracing and kernel profiling off (the default state)."""
    global _TRACER, _PROFILE
    _TRACER = None
    _PROFILE = False


@contextlib.contextmanager
def tracing(ring: int = 65536, profile_kernels: Optional[bool] = None,
            fresh_registry: bool = True) -> Iterator[Tracer]:
    """Scoped tracing: install a fresh tracer (and, by default, a fresh
    metrics registry so the scope's counters are isolated), yield it, and
    restore the previous global state on exit — exception-safe, so a test
    or harness run can never leak an enabled tracer into the process."""
    global _TRACER, _PROFILE, _REGISTRY
    prev = (_TRACER, _PROFILE, _REGISTRY)
    tracer = Tracer(ring)
    _TRACER = tracer
    _PROFILE = True if profile_kernels is None else bool(profile_kernels)
    if fresh_registry:
        _REGISTRY = MetricsRegistry()
    try:
        yield tracer
    finally:
        _TRACER, _PROFILE, _REGISTRY = prev


def span(name: str, sim_t: Optional[float] = None,
         ctx: Optional[TraceContext] = None, host: Optional[str] = None,
         link=None, **attrs):
    """Open a nested span on the active tracer — or return the shared
    no-op span when tracing is off (the hot-path fast path).  ``ctx``
    continues a propagated :class:`TraceContext`, ``host`` stamps the
    emitting host/node, ``link`` records extra cross-trace causal edges."""
    if _TRACER is None:
        return NULL_SPAN
    return _TRACER.span(name, sim_t=sim_t, ctx=ctx, host=host, link=link,
                        **attrs)


def point(name: str, sim_t0: Optional[float] = None,
          sim_t1: Optional[float] = None,
          ctx: Optional[TraceContext] = None, host: Optional[str] = None,
          link=None, **attrs):
    """Record an instant (already-finished) span; no-op when disabled."""
    if _TRACER is None:
        return NULL_SPAN
    return _TRACER.point(name, sim_t0=sim_t0, sim_t1=sim_t1, ctx=ctx,
                        host=host, link=link, **attrs)


# ---------------------------------------------------------------- registry
def get_registry() -> MetricsRegistry:
    return _REGISTRY


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the global registry; returns the previous one."""
    global _REGISTRY
    old, _REGISTRY = _REGISTRY, registry
    return old


def count(name: str, n: float = 1.0, **labels) -> None:
    """Increment a counter on the global registry (always cheap)."""
    _REGISTRY.counter(name, **labels).inc(n)


def observe(name: str, v: float, **labels) -> None:
    """Observe one histogram sample on the global registry."""
    _REGISTRY.histogram(name, **labels).observe(v)


# SLO + audit layers consume the helpers above, so they import last (they
# only touch the module object at call time, never during import).
from repro_torch.obs.audit import AuditFlag, ContributionAudit  # noqa: E402
from repro_torch.obs.slo import (AlertEvent, AlertLog,  # noqa: E402
                                 BurnRateRule, ErrorBudget, SLObjective,
                                 SLOMonitor)

__all__ += [
    "AlertEvent", "AlertLog", "AuditFlag", "BurnRateRule",
    "ContributionAudit", "ErrorBudget", "SLObjective", "SLOMonitor",
]
