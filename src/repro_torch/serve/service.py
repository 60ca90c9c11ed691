"""EnsembleServer: the serving front door.

Composes the admission-controlled :class:`MicroBatchQueue`, the eq.-(1)
:class:`AdaptiveWindow`, the packed-batch :class:`BatchEvaluator`, and
:class:`ServeMetrics` into a single clock-agnostic server:

* ``submit(tenant, x, now)`` enqueues one request and opportunistically
  dispatches any batches already due; it returns ``(accepted, responses)``
  where ``accepted=False`` signals admission-control rejection
  (backpressure) to the caller.
* ``advance(now)`` dispatches every batch whose window has expired (or that
  hit the size cap) up to ``now``; a batch dispatches no earlier than the
  previous batch finished (single-server discipline).
* ``drain()`` flushes the queue regardless of ``now``.

Timestamps are supplied by the caller, so the same server runs under a real
wall clock (the `serve_ensemble` launch driver) and under the simulated
clock of the closed-loop load benchmark.  Service time per dispatched batch
is either measured (wall-clock mode, default) or produced by an injected
``service_model(n_kernel) -> seconds`` (simulation mode), where
``n_kernel`` counts the requests that actually reached the vote kernels —
result-cache hits, in-batch duplicates of a pending kernel request, and
cold-tenant abstains cost no kernel time, so a warm cache shrinks the
modeled service time exactly as it shrinks the measured one.

A per-snapshot :class:`~repro_torch.serve.cache.ResultCache` is enabled by
``BatchConfig.cache_capacity > 0``; the server
attaches its invalidation hook to the registry so snapshots landing by
publish *or* gossip sweep that tenant's stale entries.

:class:`ShardedEnsembleServer` runs one such server per host of a
:class:`~repro_torch.serve.shard.ShardCluster`.  The per-(tenant, host)
policy table is not ported yet.
"""
from __future__ import annotations

import itertools
import math
import time
from typing import Callable, Iterator, List, Optional, Tuple

from repro_torch import obs
from repro_torch.kernels.ops import KernelPolicy
from repro_torch.serve.batching import (
    AdaptiveWindow, BatchConfig, MicroBatchQueue)
from repro_torch.serve.cache import ResultCache
from repro_torch.serve.engine import BatchEvaluator, Response
from repro_torch.device import resolve_device
from repro_torch.serve.metrics import ServeMetrics, weighted_percentile
from repro_torch.serve.registry import EnsembleRegistry

UNPORTED_POLICY_TABLE = ("policy_table is not ported yet; pass policy_for= "
                         "per tenant")


class EnsembleServer:
    def __init__(self, registry: EnsembleRegistry,
                 cfg: Optional[BatchConfig] = None, *,
                 service_model: Optional[Callable[[int], float]] = None,
                 policy: Optional[KernelPolicy] = None,
                 policy_for: Optional[
                     Callable[[str], Optional[KernelPolicy]]] = None,
                 policy_table=None,
                 rid_counter: Optional[Iterator[int]] = None,
                 host_id: Optional[str] = None,
                 device="cuda"):
        # policy_for: per-tenant kernel policies (None -> ``policy``), the
        # slice of the policy table the evaluator reads; the table itself
        # is not ported yet.  rid_counter: an id space shared with other
        # hosts of a fleet.
        if policy_table is not None:
            raise NotImplementedError(UNPORTED_POLICY_TABLE)
        self.cfg = cfg or BatchConfig()
        self.registry = registry
        self.host_id = host_id
        self.queue = MicroBatchQueue(self.cfg, rid_counter)
        self.window = AdaptiveWindow(self.cfg)
        cache = (ResultCache(self.cfg.cache_capacity)
                 if self.cfg.cache_capacity > 0 else None)
        self.cache = cache
        self.evaluator = BatchEvaluator(registry, policy=policy, cache=cache,
                                        policy_for=policy_for, device=device)
        self._unsubscribe = (cache.attach(registry) if cache is not None
                             else None)
        self.metrics = ServeMetrics()
        self.service_model = service_model
        self.on_completion: Optional[Callable[[float], None]] = None
        # SLO feed: called (tenant, finish_t, latency_s) per completion
        self.on_slo: Optional[Callable[[str, float, float], None]] = None
        self._busy_until = -math.inf     # single server: one batch in flight

    # ------------------------------------------------------------- intake
    def submit(self, tenant: str, x, now: float, ctx=None
               ) -> Tuple[bool, List[Response]]:
        """Enqueue one request.  Returns ``(accepted, responses)``:
        ``accepted`` is False when admission control rejected the request
        (backpressure — the caller must retry or shed it), and
        ``responses`` holds any batches that came due at or before ``now``
        (possibly including this request, if it filled a batch).

        ``ctx`` is a propagated trace context from a fleet front door;
        when tracing is on and none is given, this server is the front
        door and roots the request's trace itself with a ``serve.submit``
        point."""
        sub = None
        if ctx is None and obs.enabled():
            sub = obs.point("serve.submit", sim_t0=now, sim_t1=now,
                            tenant=tenant, host=self.host_id or "")
            ctx = sub.ctx
        out = self.advance(now)          # free queue slots already due
        req = self.queue.submit(tenant, x, now, ctx=ctx)
        if req is None:
            self.metrics.record_rejected(tenant)
            if sub is not None:
                sub.set(accepted=False)
        else:
            self.metrics.record_submit(now, self.queue.depth)
            if sub is not None:
                sub.set(rid=req.rid, accepted=True)
            out += self.advance(now)     # dispatch a batch this one filled
        return req is not None, out

    # ----------------------------------------------------------- dispatch
    def _window_due(self) -> Optional[float]:
        """Instant the head batch becomes dispatchable — its micro-batch
        window closing (or size cap filling) — *ignoring* server busyness.
        The gap between this and the actual dispatch instant is queueing
        delay behind the in-flight batch, which the request traces report
        separately from batching delay."""
        oldest = self.queue.oldest_t()
        if oldest is None:
            return None
        full_t = self.queue.full_batch_t()
        return full_t if full_t is not None else oldest + self.window.window_s

    def _next_due(self) -> Optional[float]:
        """Earliest instant the head batch may dispatch, or None if empty."""
        due = self._window_due()
        return None if due is None else max(due, self._busy_until)

    def advance(self, now: float) -> List[Response]:
        """Dispatch every batch due at or before ``now``."""
        out: List[Response] = []
        while True:
            window_due = self._window_due()
            if window_due is None:
                return out
            due = max(window_due, self._busy_until)
            if due > now:
                return out
            out.extend(self._dispatch(due, window_due))

    def drain(self) -> List[Response]:
        """Flush the queue: dispatch remaining batches as their windows (or
        the server) free up, regardless of the caller's clock."""
        return self.advance(math.inf)

    def close(self) -> None:
        """Detach this server's cache-invalidation subscription so a
        retired server doesn't stay pinned on a long-lived registry."""
        if self._unsubscribe is not None:
            self._unsubscribe()
            self._unsubscribe = None

    def _dispatch(self, at: float,
                  window_due: Optional[float] = None) -> List[Response]:
        # window_due <= at: `at` adds only the wait behind the in-flight
        # batch (single-server discipline).  drain()-style callers that
        # dispatch without a window bound collapse batching delay into
        # queueing delay by passing nothing.
        if window_due is None:
            window_due = at
        traced = obs.enabled()
        batch = self.queue.pop_batch()
        bsp = obs.span("serve.batch", sim_t=at, host=self.host_id or "",
                       size=len(batch))
        if self.service_model is not None:
            with obs.span("serve.kernel"):
                responses = self.evaluator.evaluate(batch)
            service_s = float(self.service_model(
                self.evaluator.last_eval.kernel_requests))
        else:
            t0 = time.perf_counter()
            with obs.span("serve.kernel"):
                responses = self.evaluator.evaluate(batch)
            service_s = time.perf_counter() - t0
        finish = at + service_s
        self._busy_until = finish
        self.metrics.record_batch(len(batch), self.window.units, finish)
        ctxs = {rq.rid: rq.ctx for rq in batch} if traced else {}
        for r in responses:
            latency = finish - r.t_submit
            self.window.record(latency)
            if self.on_completion is not None:   # autoscaler pressure feed
                self.on_completion(latency)
            if self.on_slo is not None:          # SLO error-budget feed
                self.on_slo(r.tenant, finish, latency)
            self.metrics.record_completion(
                r.tenant, latency,
                staleness_s=self.registry.staleness(r.tenant, finish),
                version=r.snapshot_version)
            if traced:
                # exact decomposition: batch_s (waiting for the window to
                # close) + queue_s (waiting for the server to free up) +
                # kernel_s (the batch's service time) == latency, whether
                # the request arrived before or after the window closed.
                # ctx= continues the request's own trace (rooted at its
                # serve.submit point, possibly on another host before a
                # reroute) while the stack parent stays the serve.batch
                # span that wall-contains the completion.
                obs.point(
                    "serve.request", sim_t0=r.t_submit, sim_t1=finish,
                    ctx=ctxs.get(r.rid), host=self.host_id or "",
                    rid=r.rid, tenant=r.tenant,
                    batch_s=max(0.0, window_due - r.t_submit),
                    queue_s=at - max(r.t_submit, window_due),
                    kernel_s=service_s, latency_s=latency)
        if traced:
            le = self.evaluator.last_eval
            bsp.set(window_units=self.window.units, service_s=service_s,
                    kernel_requests=le.kernel_requests,
                    cached=le.cached_requests, deduped=le.deduped_requests,
                    abstained=le.abstained_requests)
        bsp.end(sim_t=finish)
        return responses


class ShardedEnsembleServer:
    """Multi-host serving front door over a :class:`ShardCluster`.

    One :class:`EnsembleServer` (queue + window + evaluator + cache) runs
    per cluster host against that host's registry replica, each voting on
    ``device``.  ``submit`` routes each request to the tenant's rendezvous
    owner among *up* hosts; when the owner is marked down, routing falls
    over to the next host in rendezvous rank, which serves the tenant from
    its gossiped replica — the whole point of anti-entropy dissemination.
    Requests are rejected (``accepted=False``) only when every host is
    down or the routed host's admission control pushes back; a
    total-outage shed is charged to the fleet-level metrics (there is no
    host to charge), so the report never undercounts rejected load.

    Membership is elastic: :meth:`add_host` grows the fleet behind a
    gossip-warmed replica and :meth:`remove_host` drains a victim without
    dropping any accepted request — the
    :class:`~repro_torch.serve.autoscale.FleetAutoscaler` drives both from
    the queue-depth/p99 pressure signal.
    """

    def __init__(self, cluster, cfg: Optional[BatchConfig] = None, *,
                 service_model: Optional[Callable[[int], float]] = None,
                 policy: Optional[KernelPolicy] = None,
                 policy_table=None,
                 device="cuda"):
        if policy_table is not None:
            raise NotImplementedError(UNPORTED_POLICY_TABLE)
        self.cluster = cluster
        self.cfg = cfg or BatchConfig()
        self.policy = policy
        self.device = resolve_device(device)
        self.service_model = service_model
        self._rids = itertools.count()   # one id space across the fleet
        # fleet-level counters for load shed before any host is reached
        # (total outage): there is no per-host server to charge it to
        self.metrics = ServeMetrics()
        # scaled-in hosts live on in the report as (id, metrics, cache
        # stats) — not whole servers, so churn doesn't accrete evaluators
        # and cache contents for the fleet's lifetime
        self._retired: List[Tuple[str, ServeMetrics, Optional[object]]] = []
        self._slo = None                 # optional obs.slo.SLOMonitor
        self.servers: dict = {hid: self._make_server(hid)
                              for hid in cluster.hosts}

    def _make_server(self, host_id: str) -> EnsembleServer:
        server = EnsembleServer(self.cluster.hosts[host_id].registry,
                                self.cfg, service_model=self.service_model,
                                policy=self.policy, rid_counter=self._rids,
                                host_id=host_id, device=self.device)
        if self._slo is not None:
            server.on_slo = self._slo.record_completion
        return server

    def attach_slo(self, monitor) -> None:
        """Feed every fleet outcome into an
        :class:`repro_torch.obs.slo.SLOMonitor`: completions on whichever
        host serves them (hosts added later included), rejections/sheds at
        submit time."""
        self._slo = monitor
        for s in self.servers.values():
            s.on_slo = monitor.record_completion

    def server_for(self, tenant: str) -> Optional[EnsembleServer]:
        host = self.cluster.route(tenant)
        return self.servers[host.host_id] if host else None

    def host_id_taken(self, host_id: str) -> bool:
        """True if ``host_id`` is live, in the cluster, or retired —
        everything :meth:`add_host` would refuse (an id generator probes
        this instead of crashing on its first collision)."""
        return (host_id in self.servers or host_id in self.cluster.hosts
                or any(hid == host_id for hid, *_ in self._retired))

    def submit(self, tenant: str, x, now: float
               ) -> Tuple[bool, List[Response]]:
        server = self.server_for(tenant)
        if server is None:                     # total outage: shed the load
            self.metrics.record_rejected(tenant)
            if obs.enabled():
                obs.point("serve.submit", sim_t0=now, sim_t1=now,
                          tenant=tenant, host="", accepted=False)
            if self._slo is not None:
                self._slo.record(tenant, now, rejected=True)
            return False, []
        accepted, out = server.submit(tenant, x, now)
        if not accepted and self._slo is not None:
            self._slo.record(tenant, now, rejected=True)
        return accepted, out

    # ---------------------------------------------------------- membership
    def add_host(self, host_id: str, now: float = 0.0) -> EnsembleServer:
        """Scale-out: the cluster spins up a replica that warms via a
        gossip pull *before* it enters the rendezvous ring, then a fresh
        per-host server joins the fleet rid space.  A retired id cannot be
        reused — the fleet report keys per-host rows by id forever."""
        if any(hid == host_id for hid, *_ in self._retired):
            raise ValueError(
                f"host id {host_id!r} was scaled in earlier; retired ids "
                "stay reserved in the fleet report — pick a fresh id")
        self.cluster.add_host(host_id, now=now)
        server = self._make_server(host_id)
        self.servers[host_id] = server
        return server

    def remove_host(self, host_id: str, now: float = 0.0
                    ) -> Tuple[List[Response], int]:
        """Scale-in: dispatch the victim's due batches, reroute its residual
        queue along rendezvous rank onto surviving hosts (admission
        bypassed — those requests were already accepted), hand its registry
        window to a survivor, then drop the host.  Its metrics and cache
        counters stay in the fleet report.  Returns ``(responses, n)``:
        the drain-dispatched responses and the rerouted-request count."""
        victim = self.servers[host_id]
        if len(self.cluster.hosts) <= 1:
            raise ValueError(
                f"cannot scale in {host_id!r}: it is the cluster's last "
                "host (its registry window has nowhere to go)")
        others_up = any(h.up for hid, h in self.cluster.hosts.items()
                        if hid != host_id)
        if not others_up and len(victim.queue):
            raise ValueError(
                f"cannot scale in {host_id!r}: no surviving up host to "
                "take its queued requests")
        was_up = self.cluster.hosts[host_id].up
        del self.servers[host_id]
        self.cluster.mark_down(host_id)      # routing now skips the victim
        # a live victim dispatches what is already due before handing the
        # rest over; a host that was down was not serving — everything it
        # still holds reroutes rather than being "served" by a dead host
        responses = victim.advance(now) if was_up else []
        rerouted = 0
        for req in victim.queue.pop_all():
            self.server_for(req.tenant).queue.requeue(req)
            rerouted += 1
        victim.close()
        self._retired.append((host_id, victim.metrics,
                              victim.cache.stats if victim.cache else None))
        self.cluster.remove_host(host_id, now=now)
        return responses, rerouted

    def advance(self, now: float) -> List[Response]:
        out: List[Response] = []
        for s in self.servers.values():
            out.extend(s.advance(now))
        return out

    def drain(self) -> List[Response]:
        out: List[Response] = []
        for s in self.servers.values():
            out.extend(s.drain())
        return out

    def close(self) -> None:
        for s in self.servers.values():
            s.close()

    # -------------------------------------------------------------- report
    def _all_metrics(self) -> List[Tuple[str, str, ServeMetrics]]:
        """(host_id, status, metrics) for live and scaled-in hosts alike —
        a retired host's traffic must stay in the fleet totals."""
        out = []
        for hid, s in self.servers.items():
            host = self.cluster.hosts.get(hid)
            status = "up" if (host is not None and host.up) else "down"
            out.append((hid, status, s.metrics))
        out.extend((hid, "retired", m) for hid, m, _ in self._retired)
        return out

    def cache_stats(self) -> dict:
        """Fleet-wide result-cache counters summed over hosts (scaled-in
        hosts included)."""
        agg = {"hits": 0, "misses": 0, "fills": 0, "invalidated": 0,
               "evicted": 0}
        stats = [s.cache.stats for s in self.servers.values()
                 if s.cache is not None]
        stats.extend(st for _, _, st in self._retired if st is not None)
        for st in stats:
            for k in agg:
                agg[k] += getattr(st, k)
        n = agg["hits"] + agg["misses"]
        agg["hit_rate"] = agg["hits"] / n if n else 0.0
        return agg

    def report(self) -> dict:
        """Merged fleet report plus the per-host breakdown.  Merges the
        per-host :class:`ServeMetrics` (per-tenant reservoirs concatenated,
        ``last_version`` by max, histograms/counters summed, makespan by
        min-submit/max-finish) plus the fleet-level counters (total-outage
        rejections) across up, down, and scaled-in hosts."""
        merged = ServeMetrics()
        per_host = {}
        for hid, status, m in self._all_metrics():
            rep = m.report()
            rep["status"] = status
            per_host[hid] = rep
            self._merge_into(merged, m)
        self._merge_into(merged, self.metrics)   # outage shed, no host
        rep = merged.report()
        # fleet percentiles from the *pre-merge* per-host pairs: merging
        # re-thins full reservoirs (keeping every 8th incoming sample), so
        # quantiles over the merged reservoir would double-weight whatever
        # survived the second thinning; the exact-weight union never
        # re-thins
        pairs = self.metrics.latency_pairs()
        for _, _, m in self._all_metrics():
            pairs.extend(m.latency_pairs())
        if pairs:
            rep["p50_ms"] = 1e3 * weighted_percentile(pairs, 50.0)
            rep["p99_ms"] = 1e3 * weighted_percentile(pairs, 99.0)
        rep["per_host"] = per_host
        rep["cache"] = self.cache_stats()
        return rep

    @staticmethod
    def _merge_into(merged: ServeMetrics, m: ServeMetrics) -> None:
        for name, t in m.tenants.items():
            merged.tenant(name).merge_from(t)
        merged.batch_size_hist.update(m.batch_size_hist)
        merged.window_units_hist.update(m.window_units_hist)
        merged.registry.counter("serve.batches").inc(m.n_batches)
        merged.registry.gauge("serve.queue_depth_peak").max(
            m.queue_depth_peak)
        t0, t1 = m.first_submit_t, m.last_finish_t
        if t0 is not None:
            merged.first_submit_t = (t0 if merged.first_submit_t is None
                                     else min(merged.first_submit_t, t0))
        if t1 is not None:
            merged.last_finish_t = (t1 if merged.last_finish_t is None
                                    else max(merged.last_finish_t, t1))
