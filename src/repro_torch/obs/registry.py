"""Metrics registry: labeled counters / gauges / histograms in one
snapshot-able namespace.

Instrument names are dotted namespaces (``train.*``, ``serve.*``,
``kernel.*``, ``gossip.*``, ``autoscale.*``); labels are keyword pairs —
``registry.counter("serve.completed", tenant="mobile")`` — and each
distinct (name, labels) pair is one instrument, created on first touch and
returned on every later one (so call sites just write
``registry.counter(...).inc()`` with no registration step).

:class:`Histogram` is the repo's *single* bounded-reservoir quantile
estimator: it keeps the first ``reservoir`` samples verbatim, then thins
the stream by keeping every 8th sample, sweeping a dedicated write cursor
across the whole reservoir — the exact policy ``serve.metrics.
TenantMetrics`` used to carry privately (that class is now a view over one
of these).  Memory stays bounded under an unbounded soak; quantiles track
the full stream within the tolerance pinned by
``tests/test_obs.py::test_reservoir_soak``.

This module depends on nothing else in the repo (the serving/engine layers
import *it*, never the reverse).
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


# --------------------------------------------------------------- quantiles
def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (no numpy dependency on the hot path).

    Explicit ceil form: the smallest sample value with at least ``q``\\ %
    of the sorted sample at or below it, i.e. rank ``ceil(q/100 * n)``
    (1-based).  An earlier ``int(round(...))`` formulation used banker's
    rounding, which can land an index off the nearest rank on even-length
    lists; the behavior is pinned by a table-driven test."""
    if not values:
        return 0.0
    s = sorted(values)
    rank = math.ceil(q / 100.0 * len(s))          # 1-based nearest rank
    return s[min(len(s) - 1, max(0, rank - 1))]


def weighted_percentile(pairs: Iterable[Tuple[float, float]],
                        q: float) -> float:
    """Nearest-rank percentile of a *weighted* sample.

    ``pairs`` is ``(value, weight)`` with weight the number of stream
    observations each retained sample stands for.  The result is the
    smallest value whose cumulative weight reaches ``q``\\ % of the total —
    the weighted generalisation of :func:`percentile` (with unit weights
    they agree exactly).  This is how a fleet percentile is computed over
    per-tenant thinned reservoirs: a tenant whose 100k completions were
    thinned to 4k samples carries 25x the weight per sample of a tenant
    whose 4k completions all fit, instead of being undercounted 25x."""
    items = sorted((float(v), float(w)) for v, w in pairs if w > 0)
    if not items:
        return 0.0
    total = sum(w for _, w in items)
    need = q / 100.0 * total
    cum = 0.0
    for v, w in items:
        cum += w
        if cum >= need - 1e-12:
            return v
    return items[-1][0]


# -------------------------------------------------------------- instruments
class Counter:
    """Monotone accumulator (float increments allowed)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins scalar, with a convenience high-water helper."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def max(self, v: float) -> None:
        if v > self.value:
            self.value = float(v)


class Histogram:
    """Bounded-reservoir stream summary: count, sum, and quantiles.

    The first ``reservoir`` observations are kept verbatim; past that the
    stream is thinned — every 8th sample overwrites the slot under a
    dedicated write cursor that sweeps the whole reservoir (``count %
    size`` would revisit only ``size/8`` slots).  ``weight_per_sample``
    exposes how many stream observations each retained sample represents,
    which is what weighted cross-histogram percentiles consume."""

    __slots__ = ("values", "count", "sum", "_reservoir", "_skip")

    def __init__(self, reservoir: int = 4096):
        self.values: List[float] = []
        self.count = 0
        self.sum = 0.0
        self._reservoir = int(reservoir)
        self._skip = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if len(self.values) < self._reservoir:
            self.values.append(v)
        else:                        # thin the stream: keep every 8th sample
            self._skip += 1
            if self._skip % 8 == 0:
                self.values[(self._skip // 8) % self._reservoir] = v

    def extend(self, other: "Histogram") -> None:
        """Fold another histogram's retained samples + totals in (fleet
        merging of per-host instruments for the *same* stream)."""
        self.count += other.count
        self.sum += other.sum
        for v in other.values:
            if len(self.values) < self._reservoir:
                self.values.append(v)
            else:
                self._skip += 1
                if self._skip % 8 == 0:
                    self.values[(self._skip // 8) % self._reservoir] = v

    @property
    def weight_per_sample(self) -> float:
        """Stream observations each retained sample stands for."""
        return self.count / len(self.values) if self.values else 0.0

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        return percentile(self.values, q)

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)


# ---------------------------------------------------------------- registry
def _key(name: str, labels: Dict) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render(key) -> str:
    name, labels = key
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class MetricsRegistry:
    """One flat namespace of labeled instruments.

    ``counter``/``gauge``/``histogram`` get-or-create; ``snapshot``
    renders everything to plain JSON-able dicts (instrument kind ->
    ``name{label=value,...}`` -> state); ``save`` persists the snapshot.
    """

    def __init__(self):
        self._counters: Dict = {}
        self._gauges: Dict = {}
        self._hists: Dict = {}

    # ------------------------------------------------------------- factory
    def counter(self, name: str, **labels) -> Counter:
        return self._counters.setdefault(_key(name, labels), Counter())

    def gauge(self, name: str, **labels) -> Gauge:
        return self._gauges.setdefault(_key(name, labels), Gauge())

    def histogram(self, name: str, reservoir: int = 4096,
                  **labels) -> Histogram:
        key = _key(name, labels)
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = Histogram(reservoir)
        return h

    # ----------------------------------------------------------- iteration
    def counters(self) -> List[Tuple[str, Dict[str, str], Counter]]:
        return [(n, dict(ls), c) for (n, ls), c in self._counters.items()]

    def histograms(self) -> List[Tuple[str, Dict[str, str], Histogram]]:
        return [(n, dict(ls), h) for (n, ls), h in self._hists.items()]

    def gauges(self) -> List[Tuple[str, Dict[str, str], Gauge]]:
        return [(n, dict(ls), g) for (n, ls), g in self._gauges.items()]

    def __len__(self) -> int:
        return len(self._counters) + len(self._gauges) + len(self._hists)

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> Dict:
        return {
            "counters": {_render(k): c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {_render(k): g.value
                       for k, g in sorted(self._gauges.items())},
            "histograms": {
                _render(k): {"count": h.count, "sum": h.sum,
                             "mean": h.mean, "p50": h.p50, "p99": h.p99}
                for k, h in sorted(self._hists.items())},
        }

    def save(self, path) -> str:
        p = Path(path)
        if p.parent != Path(""):
            p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.snapshot(), indent=2) + "\n")
        return str(p)

    def clear(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()
