"""Event-driven asynchronous federated AdaBoost simulator.

This is the *faithful* implementation of the paper's algorithm and of the
baseline it compares against, with byte-accurate communication accounting
and a simulated wall-clock that models heterogeneous client compute rates,
link bandwidths, and dropouts.

Modes
-----
* ``baseline``  — synchronous distributed AdaBoost: every global round every
  (non-dropped) client trains one weak learner and synchronizes; the round
  completes at the pace of the slowest participant (straggler barrier); no
  weight compensation (stale learners from recovered dropouts enter at full
  vote weight).
* ``enhanced``  — the paper's algorithm: clients proceed at their own pace,
  buffer learners locally, synchronize every I_t rounds where I_t follows
  the adaptive rule (eq. 1), and the server folds buffered learners in with
  delayed weight compensation alpha~ = alpha * exp(-lambda * tau) (eq. 2).

Cost model
----------
Every per-round cost is asked of the client's
:class:`~repro_torch.sim.behavior.ClientBehavior` (the ``behavior_for`` hook):

* compute: ``behavior.compute_time(BASE_ROUND_S, t)`` simulated seconds per
  boosting round; the default :class:`~repro_torch.sim.behavior.LegacyBehavior`
  shim reproduces ``base_round_s * speed_k`` with
  speed_k ~ LogUniform[1, straggler_factor] bit-for-bit.
* uplink: ``bytes / (bandwidth/8 * 1e6) + latency`` per message with
  ``(latency, bandwidth) = behavior.link(t)``; one message per
  synchronization carrying the whole buffer (+ header).
* downlink: ensemble delta (learners merged since the client's last sync)
  broadcast back at sync; the synchronous baseline pays this every round
  for every client.
* availability: a round where ``behavior.availability(t)`` is False is
  missed (legacy shim: i.i.d. dropout with probability p); in baseline its
  learner arrives one round late (stale, uncompensated); in enhanced the
  buffer grows (stale, compensated) and the client stalls by
  ``behavior.stall_time`` — one compute round for the legacy shim, the
  rest of the window for an outage model.

Execution engines
-----------------
``engine="events"`` (the default) runs both modes on the
:mod:`repro_torch.core.events` priority-queue virtual clock: round completions,
stalls, sync triggers, message arrivals, and round barriers are all
events.  Client legs between syncs are *causally closed* — a client
observes server state only at its own sync, and its behavior draws depend
only on its own clock — so each leg's math is evaluated at schedule time
in exactly the legacy call order, which keeps results bit-for-bit
identical to ``engine="loop"`` (the retained client-at-a-time legacy
loops, kept as the golden parity oracle) at equal seeds.

``fleet=True`` (auto-enabled at >= ``FLEET_AUTO_CLIENTS`` clients)
switches the event core to the vectorized fleet profile
(:mod:`repro_torch.core.fleet`): stump fits are deferred and batched into
``stump_scan_batched`` launches, and per-sync server math runs vectorized
in numpy on the host.  Communication accounting is integer math and stays
exact; floating-point results match the per-client profile up to
summation order.  This is the profile that makes 100k+-client scenarios
tractable.

Device
------
Every client's ``x``, ``y`` and distribution ``D``, and the running
validation/test margins, live on the engine's ``device`` (the card by
default; asking for it without one raises).  Each weak-learner fit runs
there: a stump fit launches the ``stump_scan`` kernel, a logistic or MLP
fit takes its gradient steps with autograd.  Under the fleet profile the
clients keep their numpy shards and ``D=None``: the fleet stacks them on
the device itself, one copy per array.  A contribution audit
(:meth:`FederatedBoostEngine.attach_audit`) records every merge of the
per-client profile.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.paper_fedboost import FedBoostConfig
from repro_torch.core import events
from repro_torch.core.boosting import (
    Ensemble, update_distribution, weighted_error)
from repro_torch.core.buffers import (
    BufferEntry, ClientBuffer, entry_wire_bytes)
from repro_torch.core.compensation import (
    adaboost_alpha, compensate, staleness_scale)
from repro_torch.core.scheduling import HostScheduler
from repro_torch.device import resolve_device
from repro_torch.models.weak import WeakLearnerSpec, get_weak_learner
from repro_torch.sim.behavior import ClientBehavior, legacy_behaviors

F32 = torch.float32


def _mean(mask: torch.Tensor) -> torch.Tensor:
    """The f32 mean of a boolean mask as the JAX package's compiled program
    takes it: the count times the f32 reciprocal of the length, not the
    correctly rounded quotient.  The eq. (1) thresholds sit on multiples of
    1/n (theta2 = 0.01 is 6/600 on a 600-row validation set), so the
    rounding of the mean decides the interval rule there."""
    recip = float(np.float32(1.0) / np.float32(mask.numel()))
    return torch.sum(mask.to(F32)) * recip          # an f32 product


@dataclass
class RunMetrics:
    mode: str
    sim_time_s: float = 0.0
    uplink_bytes: int = 0
    downlink_bytes: int = 0
    n_messages: int = 0
    n_syncs: int = 0
    learners_merged: int = 0
    rounds_to_target: Optional[int] = None
    time_to_target: Optional[float] = None
    snapshots_published: int = 0
    rounds_unavailable: int = 0   # rounds lost to dropout/outage/deep fade
    val_error_curve: List[Tuple[float, int, float]] = field(default_factory=list)
    final_val_error: float = 1.0
    final_test_error: float = 1.0
    final_test_recall: float = 0.0

    @property
    def total_bytes(self) -> int:
        return self.uplink_bytes + self.downlink_bytes


@dataclass
class _Client:
    cid: int
    x: torch.Tensor
    y: torch.Tensor
    # D is None only under the fleet profile, which keeps the whole
    # fleet's distributions stacked in one tensor (repro_torch.core.fleet)
    D: Optional[torch.Tensor]
    behavior: ClientBehavior      # availability/compute/link model
    clock: float = 0.0
    local_round: int = 0
    buffer: Optional[ClientBuffer] = None
    known_interval: int = 1
    last_merged_idx: int = 0      # ensemble size at client's last sync

    def __post_init__(self) -> None:
        if self.buffer is None:
            self.buffer = ClientBuffer(self.cid)


class FederatedBoostEngine:
    """Runs one (mode, domain-dataset) federated boosting experiment."""

    BASE_ROUND_S = 1.0            # nominal compute seconds per boosting round
    LATENCY_S = 0.05
    # fleets at/above this size auto-select the vectorized fleet profile
    FLEET_AUTO_CLIENTS = 4096

    def __init__(self, cfg: FedBoostConfig, data: Dict, mode: str,
                 weak: Optional[WeakLearnerSpec] = None,
                 behavior_for: Optional[
                     Callable[[int], ClientBehavior]] = None,
                 engine: str = "events",
                 fleet: Optional[bool] = None,
                 device="cuda"):
        assert mode in ("baseline", "enhanced")
        assert engine in ("events", "loop")
        # engine="events": the event-queue virtual-clock core (default);
        # engine="loop": the legacy client-at-a-time loops, kept as the
        # bit-for-bit parity oracle.  fleet=None auto-selects the
        # vectorized fleet profile at FLEET_AUTO_CLIENTS+ clients; the
        # fleet profile always runs on the event core.
        n_fleet = len(data["clients"])
        self._fleet = (bool(fleet) if fleet is not None
                       else n_fleet >= self.FLEET_AUTO_CLIENTS)
        if self._fleet:
            engine = "events"
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mode = mode
        self.engine_kind = engine
        self.weak = weak or get_weak_learner(cfg.weak_learner)
        self.rng = np.random.RandomState(cfg.seed)
        # {clients: [(x,y)...], val:(x,y), test:(x,y)}, moved to the device;
        # the fleet profile keeps the client shards as they came and stacks
        # them on the device itself (one copy per client would cost two
        # copies each at 100k+ clients)
        self.data = {
            "clients": (list(data["clients"]) if self._fleet else
                        [self._to_device(x, y) for x, y in data["clients"]]),
            "val": self._to_device(*data["val"]),
            "test": self._to_device(*data["test"]),
        }
        self.scheduler = HostScheduler(cfg.scheduler)
        self.ensemble = Ensemble()
        self._owners: List[int] = []
        self._round_stamps: List[int] = []   # client-local round per learner
        self.metrics = RunMetrics(mode=mode)
        self._val_margin = None       # running sum alpha~*h over val set
        self._test_margin = None
        # the weak learners' random draws (the MLP's init; stump and
        # logistic fits draw nothing), seeded as the JAX package seeds its
        # key: one stream on the engine's device
        self._generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        # serving hook (attach_registry): snapshot publication mid-training
        self._registry = None
        self._tenant: Optional[str] = None
        self._publish_every = 1
        self._syncs_since_publish = 0
        self.audit = None               # obs.ContributionAudit when attached

        # behavior_for: cid -> ClientBehavior, the client-heterogeneity
        # hook.  None builds the LegacyBehavior shim from the cfg scalars.
        if behavior_for is None:
            shims = legacy_behaviors(cfg, n_fleet, self.rng,
                                     latency_s=self.LATENCY_S)
            behavior_for = lambda cid: shims[cid]
        self.behavior_for = behavior_for
        self.clients = []
        for cid, (x, y) in enumerate(self.data["clients"]):
            if self._fleet:
                self.clients.append(_Client(
                    cid=cid, x=x, y=y, D=None, behavior=behavior_for(cid)))
                continue
            n = x.shape[0]
            if cfg.balanced_init:
                # class-balanced D_0: standard boosting practice for rare-
                # positive domains (IoT anomaly / healthcare diagnosis) —
                # each class carries half the initial distribution mass
                pos = (y > 0).to(F32)
                npos = torch.clamp(torch.sum(pos), min=1.0)
                nneg = torch.clamp(n - npos, min=1.0)
                D = pos / (2 * npos) + (1 - pos) / (2 * nneg)
            else:
                D = torch.full((n,), 1.0 / n, dtype=F32, device=self.device)
            self.clients.append(_Client(
                cid=cid, x=x, y=y, D=D,
                behavior=behavior_for(cid),
                buffer=ClientBuffer(cid)))

    def _to_device(self, x, y) -> Tuple[torch.Tensor, torch.Tensor]:
        def move(a):
            t = (a.to(F32) if isinstance(a, torch.Tensor)
                 else torch.tensor(np.asarray(a), dtype=F32))
            return t.to(self.device).contiguous()
        return move(x), move(y)

    # ------------------------------------------------------- serving hook
    def attach_registry(self, registry, tenant: str,
                        publish_every: int = 1) -> None:
        """Publish an immutable ensemble snapshot after every
        ``publish_every``-th synchronization, stamped with the simulated
        clock — serving hot-swaps versions while training keeps running.

        ``registry`` is either a single-host
        :class:`~repro_torch.serve.registry.EnsembleRegistry` or a sharded
        :class:`~repro_torch.serve.shard.ShardCluster`: the cluster exposes
        the same ``publish`` surface and routes every snapshot to the
        tenant's rendezvous-owning shard, whose subscribers (result-cache
        invalidation, gossip digests) observe it immediately."""
        assert publish_every >= 1
        self._registry = registry
        self._tenant = tenant
        self._publish_every = publish_every
        self._syncs_since_publish = 0

    def attach_audit(self, audit=None):
        """Attach a :class:`repro_torch.obs.ContributionAudit`: every merge
        in either mode/engine records the contributing client's update
        magnitude, validation-error delta, staleness, and outcome.  Pure
        measurement — merge results are bit-identical with or without it.
        The vectorized fleet profile merges whole windows in one launch
        (no per-client error deltas), so audits are refused there."""
        if self._fleet:
            raise ValueError(
                "contribution audits need per-entry merges; the fleet "
                "profile merges vectorized windows — run with "
                "fleet=False to audit")
        if audit is None:
            audit = obs.ContributionAudit()
        self.audit = audit
        return audit

    @property
    def fleet_profile(self) -> bool:
        """Whether this engine runs the vectorized fleet path."""
        return self._fleet

    def publish(self, clock: float):
        """The publish() hook: snapshot the current global ensemble into
        the attached registry/cluster (the owning shard is notified via
        the routed publish); returns the published snapshot, or None when
        there is nothing to publish yet."""
        if self._registry is None or not self.ensemble.learners:
            return None
        with obs.span("train.publish", sim_t=clock, tenant=self._tenant,
                      n_learners=len(self.ensemble.learners)) as sp:
            snap = self._registry.publish(
                self._tenant, list(self.ensemble.learners),
                list(self.ensemble.alphas), clock=float(clock),
                train_progress=self.metrics.learners_merged,
                weak_name=self.weak.name,
                owners=list(self._owners),
                rounds=list(self._round_stamps))
            sp.set(version=getattr(snap, "version", None))
            sp.end_sim(clock)
        obs.count("train.publishes")
        self.metrics.snapshots_published += 1
        return snap

    def _maybe_publish(self, clock: float) -> None:
        if self._registry is None:
            return
        self._syncs_since_publish += 1
        if self._syncs_since_publish >= self._publish_every:
            self._syncs_since_publish = 0
            self.publish(clock)

    # ------------------------------------------------------------ helpers
    def _train_one(self, c: _Client) -> BufferEntry:
        with obs.span("train.fit", sim_t=c.clock, cid=c.cid,
                      round=c.local_round):
            params = self.weak.fit(c.x, c.y, c.D, self._generator)
        obs.count("train.fits")
        h = self.weak.predict(params, c.x)
        eps = float(weighted_error(c.D, c.y, h))
        alpha = float(adaboost_alpha(eps))
        # local distribution update with the local (uncompensated) alpha
        c.D, _ = update_distribution(c.D, alpha, c.y, h)
        entry = BufferEntry(params, eps, alpha, c.local_round)
        c.local_round += 1
        return entry

    def _entry_bytes(self, e: BufferEntry) -> int:
        # single source: repro_torch.core.buffers.entry_wire_bytes (the same
        # helper ClientBuffer.nbytes sums over)
        return entry_wire_bytes(e, self.weak.param_bytes)

    def _server_alpha(self, params) -> float:
        """Global vote weight from the learner's error on the server's
        validation distribution.  Local alphas are computed against heavily
        skewed client shards — a near-single-class shard yields eps ~ 0 and
        an unbounded alpha, letting degenerate learners dominate.  Server-
        side re-weighting is the standard distributed-AdaBoost remedy
        (cf. ref [4]'s scalable distributed AdaBoost); both modes use it, so
        the baseline/enhanced comparison isolates the paper's delta."""
        xv, yv = self.data["val"]
        h = self.weak.predict(params, xv)
        pred = torch.where(h > 0, 1.0, -1.0)
        miss = pred != yv
        if self.cfg.balanced_init:
            # balanced error for rare-positive domains: mean of per-class
            # error rates, so majority-voting stumps don't earn large alphas
            pos, neg = yv > 0, yv < 0
            counts = torch.stack([torch.sum(miss & pos), torch.sum(pos),
                                  torch.sum(miss & neg), torch.sum(neg)])
            mp, np_, mn, nn = counts.tolist()    # one copy to the host
            ep = torch.tensor(mp, dtype=F32) / torch.tensor(max(np_, 1),
                                                            dtype=F32)
            en = torch.tensor(mn, dtype=F32) / torch.tensor(max(nn, 1),
                                                            dtype=F32)
            eps = float(torch.clamp(0.5 * (ep + en), 0.02, 0.98))
        else:
            eps = float(torch.clamp(_mean(miss), 0.02, 0.98))
        return float(adaboost_alpha(eps))

    def _merge(self, entries: List[BufferEntry], sync_round: int,
               compensated: bool, owner: int = -1) -> None:
        audit = self.audit
        err_before = (self._val_error()
                      if (audit is not None and entries) else None)
        for e in entries:
            a = self._server_alpha(e.params)
            tau = max(0, sync_round - e.round_stamp)
            if compensated:
                raw = a
                a = float(compensate(a, tau, self.cfg.compensation))
                if obs.enabled():
                    obs.point("train.compensate", cid=owner, staleness=tau,
                              alpha_raw=raw, alpha=a)
            self.ensemble.add(e.params, a)
            self._owners.append(owner)
            self._round_stamps.append(e.round_stamp)
            self._fold_into_margins(e.params, a)
            self.metrics.learners_merged += 1
            if audit is not None:
                # _val_error is a pure read of the folded margins, so the
                # audited run merges bit-identically to the unaudited one
                err_after = self._val_error()
                audit.record(owner, magnitude=abs(a),
                             error_delta=err_before - err_after,
                             staleness=tau, outcome="merged")
                err_before = err_after

    def _fold_into_margins(self, params, alpha: float) -> None:
        xv, _ = self.data["val"]
        xt, _ = self.data["test"]
        hv = self.weak.predict(params, xv) * alpha
        ht = self.weak.predict(params, xt) * alpha
        self._val_margin = hv if self._val_margin is None else self._val_margin + hv
        self._test_margin = ht if self._test_margin is None else self._test_margin + ht

    def _val_error(self) -> float:
        _, yv = self.data["val"]
        if self._val_margin is None:
            return 1.0
        pred = torch.where(self._val_margin > 0, 1.0, -1.0)
        return float(_mean(pred != yv))

    def _client_catch_up(self, c: _Client) -> None:
        """Apply distribution updates for foreign learners received at sync.
        The client's own learners are skipped — it already applied them
        locally at training time.  ``cfg.catch_up_cap`` bounds the replay
        to the newest ``cap`` foreign learners (None = exact)."""
        lo = c.last_merged_idx
        hi = len(self.ensemble.learners)
        cap = self.cfg.catch_up_cap
        if cap is None:
            idxs = [i for i in range(lo, hi) if self._owners[i] != c.cid]
        else:
            # reverse scan: O(cap + own-entries), never O(window)
            idxs = []
            i = hi - 1
            while i >= lo and len(idxs) < cap:
                if self._owners[i] != c.cid:
                    idxs.append(i)
                i -= 1
            idxs.reverse()
        for i in idxs:
            h = self.weak.predict(self.ensemble.learners[i], c.x)
            c.D, _ = update_distribution(c.D, self.ensemble.alphas[i],
                                         c.y, h)
        c.last_merged_idx = hi

    def _record(self, t: float, err: Optional[float] = None) -> None:
        # the fleet profile passes its numpy-computed error to keep the
        # per-sync hot path off the device
        if err is None:
            err = self._val_error()
        m = self.metrics
        m.val_error_curve.append((t, m.learners_merged, err))
        if (self.cfg.target_error > 0 and err <= self.cfg.target_error
                and m.rounds_to_target is None):
            m.rounds_to_target = m.learners_merged
            m.time_to_target = t

    # ---------------------------------------------------------------- run
    def run(self) -> RunMetrics:
        if self._fleet:
            from repro_torch.core.fleet import FleetCore
            FleetCore(self).run()
        elif self.engine_kind == "events":
            if self.mode == "baseline":
                self._run_baseline_events()
            else:
                self._run_enhanced_events()
        elif self.mode == "baseline":
            self._run_baseline()
        else:
            self._run_enhanced()
        self._finalize()
        return self.metrics

    # baseline: synchronous rounds with straggler barrier ------------------
    def _run_baseline(self) -> None:
        cfg, m = self.cfg, self.metrics
        t = 0.0
        pending_late: List[Tuple[int, BufferEntry]] = []
        for r in range(cfg.n_rounds):
            rsp = obs.span("train.round", sim_t=t, round=r)
            on_time: List[Tuple[int, BufferEntry]] = []
            durations: List[float] = []
            # learners that arrived late from last round's dropouts merge now
            late, pending_late = pending_late, []
            for c in self.clients:
                dropped = not c.behavior.availability(t)
                e = self._train_one(c)
                dur = c.behavior.compute_time(self.BASE_ROUND_S, t)
                if dropped:
                    # misses the barrier; arrives next round, stale by 1,
                    # merged at FULL weight (no compensation in baseline)
                    m.rounds_unavailable += 1
                    pending_late.append((c.cid, e))
                    continue
                up = self._entry_bytes(e) + cfg.header_bytes
                m.uplink_bytes += up
                m.n_messages += 1
                durations.append(dur + self._tx_time(up, c, t))
                on_time.append((c.cid, e))
            # barrier: the round closes at the slowest participant
            t += max(durations) if durations else self.BASE_ROUND_S
            # last round's dropped messages are delivered now: charge their
            # uplink at delivery time (their transfer rides outside the
            # barrier, which only on-time participants set)
            for cid, e in late:
                m.uplink_bytes += self._entry_bytes(e) + cfg.header_bytes
                m.n_messages += 1
            merged_before = len(self.ensemble.learners)
            for cid, e in late + on_time:
                self._merge([e], r, compensated=False, owner=cid)
            # downlink: every client receives the merged delta every round
            delta = len(self.ensemble.learners) - merged_before
            pkg = delta * 16 + cfg.header_bytes
            for c in self.clients:
                m.downlink_bytes += pkg
                m.n_messages += 1
                self._client_catch_up(c)
            m.n_syncs += 1
            obs.count("train.syncs")
            obs.count("train.learners_merged", delta)
            self._maybe_publish(t)
            self._record(t)
            rsp.set(on_time=len(on_time), late=len(late),
                    merged=delta, val_error=m.val_error_curve[-1][2])
            rsp.end(sim_t=t)
        m.sim_time_s = self._flush_late(pending_late, t)

    def _flush_late(self, pending_late: List[Tuple[int, BufferEntry]],
                    t: float) -> float:
        """Deliver the final round's dropped-client messages after the last
        barrier: charge their uplink and fold them into the ensemble (stale
        by one, uncompensated — baseline semantics) instead of silently
        discarding trained-and-counted work.  No downlink or sync tick:
        training is over, nothing is broadcast back.  Returns the simulated
        time the last flush message landed."""
        cfg, m = self.cfg, self.metrics
        if not pending_late:
            return t
        t_flush = t
        for cid, e in pending_late:
            c = self.clients[cid]
            up = self._entry_bytes(e) + cfg.header_bytes
            m.uplink_bytes += up
            m.n_messages += 1
            t_flush = max(t_flush, t + self._tx_time(up, c, t))
        for cid, e in pending_late:
            self._merge([e], cfg.n_rounds, compensated=False, owner=cid)
        if obs.enabled():
            obs.point("train.late_flush", sim_t0=t_flush,
                      n=len(pending_late))
        self._record(t_flush)
        return t_flush

    # enhanced: asynchronous with adaptive intervals + compensation --------
    def _run_enhanced(self) -> None:
        cfg, m = self.cfg, self.metrics
        # event queue of (arrival_time, cid) sync messages
        events: List[Tuple[float, int, List[BufferEntry]]] = []
        for c in self.clients:
            c.known_interval = self.scheduler.current
        finished = [False] * len(self.clients)

        def advance(c: _Client) -> None:
            """Run client c until its next sync, pushing the sync event."""
            while c.local_round < cfg.n_rounds:
                dropped = not c.behavior.availability(c.clock)
                e = self._train_one(c)
                c.clock += c.behavior.compute_time(self.BASE_ROUND_S, c.clock)
                c.buffer.add(e.params, e.eps, e.alpha, e.round_stamp)
                if dropped:
                    # stall: the client loses wall-clock, but the dropout
                    # stalls the *message*, not the interval rule — a drop
                    # whose buffered learner fills I_t still syncs (after
                    # the time penalty) rather than deferring the trigger
                    # by a whole extra round.  The behavior decides the
                    # penalty: legacy charges one compute round, an outage
                    # model waits the window out.
                    m.rounds_unavailable += 1
                    c.clock += c.behavior.stall_time(self.BASE_ROUND_S,
                                                     c.clock)
                if len(c.buffer) >= c.known_interval:
                    self._push_sync(events, c)
                    return
            finished[c.cid] = True
            if len(c.buffer):             # flush the tail buffer
                self._push_sync(events, c)

        for c in self.clients:
            advance(c)

        t = 0.0
        while events:
            t, cid, payload = heapq.heappop(events)
            c = self.clients[cid]
            sync_round = c.local_round - 1
            ssp = obs.span(
                "train.sync", sim_t=t, cid=cid, n_entries=len(payload),
                staleness=max((max(0, sync_round - e.round_stamp)
                               for e in payload), default=0))
            merged_before = len(self.ensemble.learners)
            # staleness: rounds the entry waited since it was trained
            # (the freshest entry has stamp == local_round-1 -> tau = 0)
            self._merge(payload, sync_round=sync_round,
                        compensated=True, owner=c.cid)
            m.n_syncs += 1
            obs.count("train.syncs")
            obs.count("train.learners_merged",
                      len(self.ensemble.learners) - merged_before)
            # server observes the new global error and adapts the interval
            self.scheduler.observe(self._val_error())
            # downlink: ensemble delta since this client's last sync
            delta = len(self.ensemble.learners) - c.last_merged_idx
            pkg = delta * 16 + cfg.header_bytes
            m.downlink_bytes += pkg
            m.n_messages += 1
            self._client_catch_up(c)
            c.known_interval = self.scheduler.current
            obs.get_registry().gauge("train.interval").set(
                self.scheduler.current)
            self._maybe_publish(t)
            self._record(t)
            ssp.set(interval=self.scheduler.current,
                    val_error=m.val_error_curve[-1][2])
            ssp.end(sim_t=t)
            if not finished[cid]:
                advance(c)
        m.sim_time_s = max(t, max(c.clock for c in self.clients))

    # event-queue virtual-clock core (engine="events", the default) -------
    def _run_baseline_events(self) -> None:
        """Synchronous baseline on the event queue: each round is a TRIGGER
        (schedule the fleet's round of work), a set of ARRIVAL events (the
        on-time messages), and a BARRIER (merge + broadcast).  Per-client
        math runs at schedule time in client order — the exact legacy call
        order — and the barrier folds messages in client order (a
        synchronous server treats the round as one batch), so results are
        bit-for-bit identical to the loop engine at equal seeds."""
        cfg, m = self.cfg, self.metrics
        vc = events.VirtualClock()
        pending_late: List[Tuple[int, BufferEntry]] = []
        late: List[Tuple[int, BufferEntry]] = []
        arrived: List[Tuple[int, BufferEntry]] = []
        rsp = None
        t = 0.0
        vc.push(0.0, events.TRIGGER, payload=0)
        while vc:
            ev = vc.pop()
            if ev.kind == events.TRIGGER:
                r, t0 = ev.payload, ev.t
                rsp = obs.span("train.round", sim_t=t0, round=r)
                late, pending_late = pending_late, []
                arrived = []
                durations: List[float] = []
                for c in self.clients:
                    dropped = not c.behavior.availability(t0)
                    e = self._train_one(c)
                    dur = c.behavior.compute_time(self.BASE_ROUND_S, t0)
                    if dropped:
                        # misses the barrier; arrives next round, stale by
                        # 1, merged at FULL weight (no compensation here)
                        m.rounds_unavailable += 1
                        pending_late.append((c.cid, e))
                        if obs.enabled():
                            obs.point("train.stall", sim_t0=t0, cid=c.cid)
                        continue
                    up = self._entry_bytes(e) + cfg.header_bytes
                    m.uplink_bytes += up
                    m.n_messages += 1
                    d = dur + self._tx_time(up, c, t0)
                    durations.append(d)
                    vc.push(t0 + d, events.ARRIVAL, c.cid, e)
                close = t0 + (max(durations) if durations
                              else self.BASE_ROUND_S)
                vc.push(close, events.BARRIER, payload=r)
            elif ev.kind == events.ARRIVAL:
                arrived.append((ev.cid, ev.payload))
            elif ev.kind == events.BARRIER:
                r, t = ev.payload, ev.t
                # delivery-time charge for last round's dropped messages
                for cid, e in late:
                    m.uplink_bytes += self._entry_bytes(e) + cfg.header_bytes
                    m.n_messages += 1
                # merge in client order (not arrival order): the
                # synchronous server folds the whole round as one batch —
                # exactly what the legacy loop does
                arrived.sort(key=lambda ce: ce[0])
                merged_before = len(self.ensemble.learners)
                for cid, e in late + arrived:
                    self._merge([e], r, compensated=False, owner=cid)
                delta = len(self.ensemble.learners) - merged_before
                pkg = delta * 16 + cfg.header_bytes
                for c in self.clients:
                    m.downlink_bytes += pkg
                    m.n_messages += 1
                    self._client_catch_up(c)
                m.n_syncs += 1
                obs.count("train.syncs")
                obs.count("train.learners_merged", delta)
                self._maybe_publish(t)
                self._record(t)
                rsp.set(on_time=len(arrived), late=len(late), merged=delta,
                        val_error=m.val_error_curve[-1][2])
                rsp.end(sim_t=t)
                if r + 1 < cfg.n_rounds:
                    vc.push(t, events.TRIGGER, payload=r + 1)
        obs.count("train.events", vc.n_popped)
        m.sim_time_s = self._flush_late(pending_late, t)

    def _run_enhanced_events(self) -> None:
        """The paper's algorithm on the event queue.  Client legs between
        syncs are causally closed — a client observes server state only at
        its own sync, and its behavior draws depend only on its own clock —
        so each leg's math runs eagerly at schedule time (the legacy call
        order, preserving bit-for-bit parity) while its round completions,
        stalls, triggers, and the sync-message arrival become events.
        Arrivals pop in (t, kind, cid) order: the legacy heap's
        ``(arrival, cid)`` order exactly."""
        cfg, m = self.cfg, self.metrics
        vc = events.VirtualClock()
        for c in self.clients:
            c.known_interval = self.scheduler.current
        finished = [False] * len(self.clients)

        def advance(c: _Client) -> None:
            trace = obs.enabled()
            while c.local_round < cfg.n_rounds:
                dropped = not c.behavior.availability(c.clock)
                e = self._train_one(c)
                c.clock += c.behavior.compute_time(self.BASE_ROUND_S,
                                                   c.clock)
                if trace:
                    vc.push(c.clock, events.ROUND, c.cid)
                c.buffer.add(e.params, e.eps, e.alpha, e.round_stamp)
                if dropped:
                    # see _run_enhanced: the dropout stalls the *message*,
                    # not the interval rule
                    m.rounds_unavailable += 1
                    c.clock += c.behavior.stall_time(self.BASE_ROUND_S,
                                                     c.clock)
                    if trace:
                        vc.push(c.clock, events.STALL, c.cid)
                if len(c.buffer) >= c.known_interval:
                    if trace:
                        vc.push(c.clock, events.TRIGGER, c.cid)
                    arrival, payload = self._prepare_sync(c)
                    vc.push(arrival, events.ARRIVAL, c.cid, payload)
                    return
            finished[c.cid] = True
            if len(c.buffer):             # flush the tail buffer
                arrival, payload = self._prepare_sync(c)
                vc.push(arrival, events.ARRIVAL, c.cid, payload)

        for c in self.clients:
            advance(c)
        t = 0.0
        while vc:
            ev = vc.pop()
            if ev.kind == events.ROUND:
                obs.point("train.client_round", sim_t0=ev.t, cid=ev.cid)
                continue
            if ev.kind == events.STALL:
                obs.point("train.stall", sim_t0=ev.t, cid=ev.cid)
                continue
            if ev.kind == events.TRIGGER:
                obs.point("train.trigger", sim_t0=ev.t, cid=ev.cid)
                continue
            t, cid, payload = ev.t, ev.cid, ev.payload
            c = self.clients[cid]
            sync_round = c.local_round - 1
            ssp = obs.span(
                "train.sync", sim_t=t, cid=cid, n_entries=len(payload),
                staleness=max((max(0, sync_round - e.round_stamp)
                               for e in payload), default=0))
            merged_before = len(self.ensemble.learners)
            self._merge(payload, sync_round=sync_round,
                        compensated=True, owner=c.cid)
            m.n_syncs += 1
            obs.count("train.syncs")
            obs.count("train.learners_merged",
                      len(self.ensemble.learners) - merged_before)
            self.scheduler.observe(self._val_error())
            delta = len(self.ensemble.learners) - c.last_merged_idx
            pkg = delta * 16 + cfg.header_bytes
            m.downlink_bytes += pkg
            m.n_messages += 1
            self._client_catch_up(c)
            c.known_interval = self.scheduler.current
            obs.get_registry().gauge("train.interval").set(
                self.scheduler.current)
            self._maybe_publish(t)
            self._record(t)
            ssp.set(interval=self.scheduler.current,
                    val_error=m.val_error_curve[-1][2])
            ssp.end(sim_t=t)
            if not finished[cid]:
                advance(c)
        obs.count("train.events", vc.n_popped)
        m.sim_time_s = max(t, max(c.clock for c in self.clients))

    def _prepare_sync(self, c: _Client) -> Tuple[float, List[BufferEntry]]:
        """Relevance-filter the buffer, charge the uplink (sized through
        ``ClientBuffer.nbytes`` — the single wire-size source), and return
        the sync message's ``(arrival_time, payload)``."""
        cfg, m = self.cfg, self.metrics
        if cfg.relevance_filter > 0 and len(c.buffer) > 1:
            # beyond-paper: don't ship learners whose compensated weight is
            # negligible — the client can compute this locally before uplink
            now = c.local_round - 1
            entries = c.buffer.entries
            w = [abs(e.alpha) * staleness_scale(
                    max(0, now - e.round_stamp), cfg.compensation)
                 for e in entries]
            cut = cfg.relevance_filter * max(w)
            kept = [e for e, wi in zip(entries, w) if wi >= cut]
            c.buffer.entries = kept if kept else entries[-1:]
        nbytes = c.buffer.nbytes(self.weak.param_bytes) + cfg.header_bytes
        payload = c.buffer.flush()
        arrival = c.clock + self._tx_time(nbytes, c, c.clock)
        m.uplink_bytes += nbytes
        m.n_messages += 1
        return arrival, payload

    def _push_sync(self, events_heap, c: _Client) -> None:
        arrival, payload = self._prepare_sync(c)
        heapq.heappush(events_heap, (arrival, c.cid, payload))

    def _tx_time(self, nbytes: int, c: _Client, t: float) -> float:
        return c.behavior.link(t).tx_time(nbytes)

    def _finalize(self) -> None:
        m = self.metrics
        m.final_val_error = self._val_error()
        xt, yt = self.data["test"]
        if self._test_margin is not None:
            pred = torch.where(self._test_margin > 0, 1.0, -1.0)
            m.final_test_error = float(_mean(pred != yt))
            pos = yt > 0
            hit, npos = torch.stack([torch.sum((pred > 0) & pos),
                                     torch.sum(pos)]).tolist()
            m.final_test_recall = float(
                torch.tensor(hit, dtype=F32)
                / torch.tensor(max(npos, 1), dtype=F32))
