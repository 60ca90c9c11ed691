"""repro_torch.obs — unified tracing + metrics across train / serve / sim.

Process-wide state, consumed through cheap module-level helpers the
instrumented subsystems call unconditionally:

* the **tracer** (:mod:`repro_torch.obs.trace`): off by default.  Enable
  it with :func:`configure` (CLIs) or the :func:`tracing` context manager
  (tests, harness runs), which installs a fresh :class:`Tracer` and
  restores the previous state on exit.
* the **profiled tracer**: while a torch profiler runs and no tracer is
  installed, spans go to a tracer of their own, created at the first
  such span; :func:`profiled_tracer` hands it back.  So a run traced by
  ``torch.profiler`` alone still gets the program's spans, each also a
  range of its own name on the profiler's timeline.
* the **metrics registry** (:mod:`repro_torch.obs.registry`): always available
  via :func:`get_registry` (counters are a dict hit + float add).

:func:`active` is true while either tracer would take a span; while it is
false :func:`span`/:func:`point` return the shared :data:`NULL_SPAN`
without allocating, and instrumented code skips its counters.  Spans
opened with ``device=True`` carry CUDA events until :func:`resolve` turns
them into ``device_ms``; nothing on a span's path waits for the card.

The JSONL trace schema is the reference package's, unchanged.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

from repro_torch.obs.registry import (Counter, Gauge, Histogram, MetricsRegistry,
                                percentile, weighted_percentile)
from repro_torch.obs.trace import (NULL_SPAN, Span, TraceContext, Tracer,
                                   load_jsonl, load_trace, profiler_running)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL_SPAN",
    "Span", "TraceContext", "Tracer", "active", "configure", "count",
    "disable", "enabled", "get_registry", "get_tracer", "load_jsonl",
    "load_trace", "observe", "percentile", "point", "profiled_tracer",
    "resolve", "set_registry", "span", "tracing", "weighted_percentile",
]

_TRACER: Optional[Tracer] = None
_PROFILED: Optional[Tracer] = None
_REGISTRY = MetricsRegistry()


# ------------------------------------------------------------------ tracer
def get_tracer() -> Optional[Tracer]:
    """The installed tracer, or None while tracing is disabled."""
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


def active() -> bool:
    """Whether a span would be recorded: a tracer is installed or a torch
    profiler is running."""
    return _TRACER is not None or profiler_running()


def profiled_tracer() -> Optional[Tracer]:
    """The tracer that takes spans while a torch profiler runs with no
    tracer installed, or None before the first such span."""
    return _PROFILED


def _profiled() -> Tracer:
    global _PROFILED
    if _PROFILED is None:
        _PROFILED = Tracer()
    return _PROFILED


def resolve() -> None:
    """Turn the finished device spans of both tracers into ``device_ms``
    (waits for the card once)."""
    for tracer in (_TRACER, _PROFILED):
        if tracer is not None:
            tracer.resolve()


def configure(trace: bool = True, ring: int = 65536,
              registry: Optional[MetricsRegistry] = None) -> Optional[Tracer]:
    """Install (or tear down) the process-wide observability state.

    ``trace=True`` installs a fresh :class:`Tracer` with a ``ring``-bounded
    span buffer; ``trace=False`` disables tracing.  ``registry`` swaps the
    global metrics registry (a fresh one isolates a run's counters).
    Returns the installed tracer (None when disabled)."""
    global _TRACER, _REGISTRY
    _TRACER = Tracer(ring) if trace else None
    if registry is not None:
        _REGISTRY = registry
    return _TRACER


def disable() -> None:
    """Turn tracing off (the default state)."""
    global _TRACER
    _TRACER = None


@contextlib.contextmanager
def tracing(ring: int = 65536, fresh_registry: bool = True
            ) -> Iterator[Tracer]:
    """Scoped tracing: install a fresh tracer (and, by default, a fresh
    metrics registry so the scope's counters are isolated), yield it, and
    restore the previous global state on exit — exception-safe, so a test
    or harness run can never leak an enabled tracer into the process."""
    global _TRACER, _REGISTRY
    prev = (_TRACER, _REGISTRY)
    tracer = Tracer(ring)
    _TRACER = tracer
    if fresh_registry:
        _REGISTRY = MetricsRegistry()
    try:
        yield tracer
    finally:
        _TRACER, _REGISTRY = prev


def span(name: str, sim_t: Optional[float] = None,
         ctx: Optional[TraceContext] = None, host: Optional[str] = None,
         link=None, device: bool = False, **attrs):
    """Open a nested span on the installed tracer, or on the profiled
    tracer while only a torch profiler runs — or return the shared no-op
    span (the hot-path fast path).  ``ctx`` continues a propagated
    :class:`TraceContext`, ``host`` stamps the emitting host/node, ``link``
    records extra cross-trace causal edges, ``device=True`` also times the
    span on the current CUDA stream."""
    tracer = _TRACER
    if tracer is None:
        if not profiler_running():
            return NULL_SPAN
        tracer = _profiled()
    return tracer.span(name, sim_t=sim_t, ctx=ctx, host=host, link=link,
                       device=device, **attrs)


def point(name: str, sim_t0: Optional[float] = None,
          sim_t1: Optional[float] = None,
          ctx: Optional[TraceContext] = None, host: Optional[str] = None,
          link=None, **attrs):
    """Record an instant (already-finished) span; no-op while
    :func:`active` is false."""
    tracer = _TRACER
    if tracer is None:
        if not profiler_running():
            return NULL_SPAN
        tracer = _profiled()
    return tracer.point(name, sim_t0=sim_t0, sim_t1=sim_t1, ctx=ctx,
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
