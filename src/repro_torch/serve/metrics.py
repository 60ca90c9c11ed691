"""Serving observability: per-tenant latency quantiles, queue depth, batch
sizes, snapshot staleness — the operational counters the load benchmark and
the `serve_ensemble` driver report.

Since the `repro_torch.obs` layer landed, this module is a thin *view* over a
:class:`~repro_torch.obs.registry.MetricsRegistry` rather than a parallel
implementation: every per-tenant counter is a registry ``Counter``/
``Gauge`` and every latency reservoir a registry ``Histogram`` (the single
bounded-reservoir estimator in the repo — keep every sample until full,
then every 8th under a sweeping cursor).  Each :class:`ServeMetrics` owns a
*private* registry, because per-host serving counters must merge per fleet
(``ShardedEnsembleServer.report``) rather than blending into the
process-wide namespace; pass ``registry=obs.get_registry()`` to publish a
single server's counters globally.

Fleet percentiles weight each tenant's retained samples by how many stream
observations they stand for (``Histogram.weight_per_sample``) — see
:meth:`ServeMetrics.fleet_percentile` for why plain concatenation is
biased.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.registry import (MetricsRegistry, percentile,
                                weighted_percentile)

__all__ = ["percentile", "weighted_percentile", "TenantMetrics",
           "ServeMetrics"]


class TenantMetrics:
    """One tenant's serving counters — a view over registry instruments
    (``serve.completed{tenant=...}``, ``serve.latency_s{tenant=...}``, ...)
    that keeps the pre-obs read surface (``completed``, ``latencies``,
    ``p50``, ``mean_staleness``) intact for callers and tests."""

    __slots__ = ("_completed", "_rejected", "_staleness", "_lat", "_version")

    def __init__(self, registry: MetricsRegistry, tenant: str):
        self._completed = registry.counter("serve.completed", tenant=tenant)
        self._rejected = registry.counter("serve.rejected", tenant=tenant)
        self._staleness = registry.counter("serve.staleness_s_sum",
                                           tenant=tenant)
        self._lat = registry.histogram("serve.latency_s", tenant=tenant)
        self._version = registry.gauge("serve.snapshot_version",
                                       tenant=tenant)

    # ------------------------------------------------------------- records
    def record(self, latency_s: float, staleness_s: float, version: int
               ) -> None:
        self._completed.inc()
        self._staleness.inc(max(0.0, staleness_s))
        self._version.max(version)
        self._lat.observe(latency_s)

    def record_rejected(self) -> None:
        self._rejected.inc()

    def merge_from(self, other: "TenantMetrics") -> None:
        """Fold another host's counters for the *same* tenant in (fleet
        report merging): counters add, the latency histogram extends with
        retained samples + stream totals, version merges by max."""
        self._completed.inc(other._completed.value)
        self._rejected.inc(other._rejected.value)
        self._staleness.inc(other._staleness.value)
        self._lat.extend(other._lat)
        self._version.max(other._version.value)

    # --------------------------------------------------------------- reads
    @property
    def completed(self) -> int:
        return int(self._completed.value)

    @property
    def rejected(self) -> int:
        return int(self._rejected.value)

    @property
    def latencies(self) -> List[float]:
        """The retained latency reservoir (thinned once past capacity)."""
        return self._lat.values

    @property
    def latency_hist(self):
        return self._lat

    @property
    def staleness_sum(self) -> float:
        return self._staleness.value

    @property
    def last_version(self) -> int:
        return int(self._version.value)

    @property
    def p50(self) -> float:
        return self._lat.p50

    @property
    def p99(self) -> float:
        return self._lat.p99

    @property
    def mean_staleness(self) -> float:
        return self.staleness_sum / self.completed if self.completed else 0.0


class ServeMetrics:
    """Aggregated serving counters (per tenant + fleet-wide) over one
    private :class:`MetricsRegistry` (injectable for a global namespace)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tenants: Dict[str, TenantMetrics] = {}
        self.batch_size_hist: Counter = Counter()
        self.window_units_hist: Counter = Counter()
        self.first_submit_t: Optional[float] = None
        self.last_finish_t: Optional[float] = None
        self._batches = self.registry.counter("serve.batches")
        self._depth_peak = self.registry.gauge("serve.queue_depth_peak")

    def tenant(self, name: str) -> TenantMetrics:
        t = self.tenants.get(name)
        if t is None:
            t = self.tenants[name] = TenantMetrics(self.registry, name)
        return t

    # ------------------------------------------------------------- records
    def record_submit(self, now: float, depth: int) -> None:
        if self.first_submit_t is None:
            self.first_submit_t = now
        self._depth_peak.max(depth)

    def record_rejected(self, tenant: str) -> None:
        self.tenant(tenant).record_rejected()

    def record_batch(self, size: int, window_units: int, finish_t: float
                     ) -> None:
        self._batches.inc()
        self.batch_size_hist[size] += 1
        self.window_units_hist[window_units] += 1
        self.last_finish_t = (finish_t if self.last_finish_t is None
                              else max(self.last_finish_t, finish_t))

    def record_completion(self, tenant: str, latency_s: float,
                          staleness_s: float, version: int) -> None:
        self.tenant(tenant).record(latency_s, staleness_s, version)

    # ------------------------------------------------------------- reports
    @property
    def completed(self) -> int:
        return sum(t.completed for t in self.tenants.values())

    @property
    def rejected(self) -> int:
        return sum(t.rejected for t in self.tenants.values())

    @property
    def n_batches(self) -> int:
        return int(self._batches.value)

    @property
    def queue_depth_peak(self) -> int:
        return int(self._depth_peak.value)

    @property
    def mean_batch(self) -> float:
        n = sum(self.batch_size_hist.values())
        return (sum(k * v for k, v in self.batch_size_hist.items()) / n
                if n else 0.0)

    def throughput(self) -> float:
        """Completed requests per second of serving makespan."""
        if (self.first_submit_t is None or self.last_finish_t is None
                or self.last_finish_t <= self.first_submit_t):
            return 0.0
        return self.completed / (self.last_finish_t - self.first_submit_t)

    def all_latencies(self) -> List[float]:
        """Every retained latency sample, concatenated across tenants.

        NOTE this concatenation is *biased* once any tenant's reservoir has
        thinned: a tenant with 100k completions holds the same ~4096
        samples as one with 4096 completions, so its traffic is undercounted
        ~25x in any quantile of the concatenation (fleet p99 skews toward
        low-traffic tenants).  Use :meth:`fleet_percentile` for fleet
        quantiles; this list remains for mean-style uses and debugging."""
        out: List[float] = []
        for t in self.tenants.values():
            out.extend(t.latencies)
        return out

    def latency_pairs(self) -> List[Tuple[float, float]]:
        """``(latency, weight)`` pairs across tenants, each retained sample
        weighted by the ``completed / len(reservoir)`` observations it
        stands for.  This is the *exact-weight* fleet sample: concatenate
        these across per-host metrics **before** any histogram merge and a
        fold of already-folded registries can never re-thin a reservoir and
        double-weight its survivors (``Histogram.extend`` keeps only every
        8th incoming sample once full, so a merge-of-merges would otherwise
        inflate the weight of whichever host folded first)."""
        pairs: List[Tuple[float, float]] = []
        for t in self.tenants.values():
            w = t.latency_hist.weight_per_sample
            pairs.extend((v, w) for v in t.latencies)
        return pairs

    def fleet_percentile(self, q: float) -> float:
        """Fleet-wide latency percentile with per-tenant sample weighting:
        each retained sample counts as ``completed / len(reservoir)`` stream
        observations, so tenants whose reservoirs thinned at different
        rates contribute in proportion to their true traffic.  With no
        thinning anywhere, this equals ``percentile(all_latencies(), q)``
        exactly."""
        return weighted_percentile(self.latency_pairs(), q)

    def report(self) -> Dict:
        return {
            "completed": self.completed,
            "rejected": self.rejected,
            "throughput_rps": self.throughput(),
            "p50_ms": 1e3 * self.fleet_percentile(50.0),
            "p99_ms": 1e3 * self.fleet_percentile(99.0),
            "mean_batch": self.mean_batch,
            "n_batches": self.n_batches,
            "queue_depth_peak": self.queue_depth_peak,
            "tenants": {
                name: {
                    "completed": t.completed,
                    "rejected": t.rejected,
                    "p50_ms": 1e3 * t.p50,
                    "p99_ms": 1e3 * t.p99,
                    "mean_staleness_s": t.mean_staleness,
                    "snapshot_version": t.last_version,
                }
                for name, t in sorted(self.tenants.items())
            },
        }

    def snapshot(self) -> Dict:
        """The underlying registry snapshot (obs export surface)."""
        return self.registry.snapshot()
