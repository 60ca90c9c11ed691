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
attaches its invalidation hook to the registry so a newly published
snapshot sweeps that tenant's stale entries.  The sharded multi-host
server and the per-(tenant, host) policy table are not ported yet.
"""
from __future__ import annotations

import math
import time
from typing import Callable, List, Optional, Tuple

from repro_torch import obs
from repro_torch.kernels.ops import KernelPolicy
from repro_torch.serve.batching import (
    AdaptiveWindow, BatchConfig, MicroBatchQueue)
from repro_torch.serve.cache import ResultCache
from repro_torch.serve.engine import BatchEvaluator, Response
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.registry import EnsembleRegistry


class EnsembleServer:
    def __init__(self, registry: EnsembleRegistry,
                 cfg: Optional[BatchConfig] = None, *,
                 service_model: Optional[Callable[[int], float]] = None,
                 policy: Optional[KernelPolicy] = None,
                 policy_for: Optional[
                     Callable[[str], Optional[KernelPolicy]]] = None,
                 policy_table=None,
                 device="cuda"):
        # policy_for: per-tenant kernel policies (None -> ``policy``), the
        # slice of the policy table the evaluator reads; the table itself
        # is not ported yet
        if policy_table is not None:
            raise NotImplementedError("policy_table is not ported yet; "
                                      "pass policy_for= per tenant")
        self.cfg = cfg or BatchConfig()
        self.registry = registry
        self.queue = MicroBatchQueue(self.cfg)
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
        self._busy_until = -math.inf     # single server: one batch in flight

    # ------------------------------------------------------------- intake
    def submit(self, tenant: str, x, now: float, ctx=None
               ) -> Tuple[bool, List[Response]]:
        """Enqueue one request.  Returns ``(accepted, responses)``:
        ``accepted`` is False when admission control rejected the request
        (backpressure — the caller must retry or shed it), and
        ``responses`` holds any batches that came due at or before ``now``
        (possibly including this request, if it filled a batch).

        ``ctx`` is a propagated trace context; when tracing is on and none
        is given, this server roots the request's trace itself with a
        ``serve.submit`` point."""
        sub = None
        if ctx is None and obs.enabled():
            sub = obs.point("serve.submit", sim_t0=now, sim_t1=now,
                            tenant=tenant, host="")
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
        bsp = obs.span("serve.batch", sim_t=at, host="",
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
                # serve.submit point) while the stack parent stays the
                # serve.batch span that wall-contains the completion.
                obs.point(
                    "serve.request", sim_t0=r.t_submit, sim_t1=finish,
                    ctx=ctxs.get(r.rid), host="",
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
