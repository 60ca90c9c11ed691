"""Sharded snapshot registry: rendezvous-hashed tenant ownership across N
simulated serving hosts, with anti-entropy gossip propagating publishes.

Topology
--------
Every host runs its own :class:`~repro_torch.serve.registry.EnsembleRegistry`.
A tenant's *owner* is chosen by rendezvous (highest-random-weight) hashing
over the up hosts — adding or draining a host only moves the tenants that
hashed to it, never reshuffles the rest.  Training publishes route to the
owner; gossip then replicates the snapshot everywhere, so any host can
serve any tenant after convergence and routing falls over to the next host
in rendezvous rank when the owner is marked down.

Gossip (anti-entropy, pull-on-miss)
-----------------------------------
Each round every up host contacts ``fanout`` random up peers and the pair
exchanges *digests* — per-tenant ``(version, content fingerprint)`` vectors.
Whoever is behind on a tenant pulls the peer's retained snapshot window and
``ingest``-s it (version stamps preserved, duplicates dropped), the
FLchain-style serverless dissemination of arXiv:2112.07938.  When both
sides claim the *same* version with *different* content — two publishers
raced, or a failover host re-published during a partition — the tie breaks
by the FedAsync staleness rule (arXiv:1903.03934): each candidate scores
``(1 + train_progress) * s(Δτ)`` with ``s(Δτ) = exp(-lam * Δτ)`` and
``Δτ = now - published_at``; the higher score wins on both hosts (ties
fall back to publish time, then fingerprint), so reconciliation is
symmetric and the cluster converges regardless of exchange order.
"""
from __future__ import annotations

import hashlib
import math
import random
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.serve.registry import EnsembleRegistry, EnsembleSnapshot


# ------------------------------------------------------------- rendezvous
def _score(host_id: str, tenant: str) -> int:
    h = hashlib.blake2b(f"{host_id}|{tenant}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


def rendezvous_rank(tenant: str, host_ids: Iterable[str]) -> List[str]:
    """Hosts ordered by rendezvous score for ``tenant`` (owner first)."""
    return sorted(host_ids, key=lambda h: _score(h, tenant), reverse=True)


def rendezvous_owner(tenant: str, host_ids: Iterable[str]) -> str:
    return max(host_ids, key=lambda h: _score(h, tenant))


# ----------------------------------------------------------------- gossip
@dataclass(frozen=True)
class GossipConfig:
    fanout: int = 1           # peers each host contacts per gossip round
    lam: float = 0.5          # staleness decay in s(dt) = exp(-lam * dt)
    history: int = 4          # per-host retained snapshot window
    seed: int = 0             # peer-selection RNG


def staleness_weight(delta_tau: float, lam: float) -> float:
    """FedAsync-style ``s(Δτ)``: exponential decay in snapshot age."""
    return math.exp(-lam * max(0.0, float(delta_tau)))


def reconcile_score(snap: EnsembleSnapshot, now: float, lam: float) -> float:
    """Rank of one candidate among concurrent same-version snapshots."""
    return (1.0 + snap.train_progress) * staleness_weight(
        now - snap.published_at, lam)


@dataclass
class ShardHost:
    """One simulated serving host: its registry replica + liveness flag."""
    host_id: str
    registry: EnsembleRegistry
    up: bool = True


@dataclass
class GossipStats:
    rounds: int = 0
    exchanges: int = 0
    pulled: int = 0           # snapshots ingested via pull-on-miss
    reconciled: int = 0       # concurrent same-version conflicts resolved


class ShardCluster:
    """N rendezvous-sharded registry hosts joined by an anti-entropy loop.

    The cluster quacks like an :class:`EnsembleRegistry` on the training
    side (``publish`` / ``publish_packed`` route to the tenant's owner, so
    the async engine's publish hook notifies the owning shard unchanged) and exposes routing/failover + the gossip pump to the
    serving side.
    """

    def __init__(self, n_hosts: int = 3, cfg: Optional[GossipConfig] = None,
                 host_ids: Optional[Sequence[str]] = None):
        self.cfg = cfg or GossipConfig()
        ids = (list(host_ids) if host_ids is not None
               else [f"host-{i}" for i in range(n_hosts)])
        if not ids or len(ids) != len(set(ids)):
            raise ValueError(f"host ids must be unique and non-empty: {ids}")
        self.hosts: Dict[str, ShardHost] = {
            hid: ShardHost(hid, self._make_registry(hid)) for hid in ids}
        self._rng = random.Random(self.cfg.seed)
        self.stats = GossipStats()

    def _make_registry(self, host_id: str) -> EnsembleRegistry:
        """Registry factory for one host replica — the hook subclasses
        override to back hosts with a different store (the chain-of-record
        registry, not ported yet, swaps in here)."""
        return EnsembleRegistry(history=self.cfg.history)

    # ------------------------------------------------------------ topology
    def host_ids(self, up_only: bool = True) -> List[str]:
        return [h for h, s in self.hosts.items() if s.up or not up_only]

    def owner(self, tenant: str) -> str:
        """The owning host among *up* hosts (failover-aware)."""
        up = self.host_ids()
        if not up:
            raise RuntimeError("no up hosts in cluster")
        return rendezvous_owner(tenant, up)

    def route(self, tenant: str) -> Optional[ShardHost]:
        """First up host in rendezvous rank, or None if all are down."""
        for hid in rendezvous_rank(tenant, self.hosts):
            if self.hosts[hid].up:
                return self.hosts[hid]
        return None

    def mark_down(self, host_id: str) -> None:
        self.hosts[host_id].up = False

    def mark_up(self, host_id: str) -> None:
        self.hosts[host_id].up = True

    # ------------------------------------------------- elastic membership
    def add_host(self, host_id: str, now: float = 0.0) -> ShardHost:
        """Scale-out: create a replica and *warm* it with an anti-entropy
        pull before it enters the rendezvous ring.  The new host stays
        ``up=False`` while warming, so ownership/routing never select a
        cold replica; rendezvous hashing guarantees that flipping it up
        only moves the tenants that hash to it.  Warm-up prefers up peers;
        with none (total outage — the autoscaler replacing a dead fleet)
        it pulls from the down replicas' stores instead, so the first
        routable host is never an empty one."""
        if host_id in self.hosts:
            raise ValueError(f"host {host_id!r} already in cluster")
        host = ShardHost(host_id, self._make_registry(host_id), up=False)
        peers = self.host_ids() or list(self.hosts)
        self.hosts[host_id] = host
        for peer_id in peers:
            self._anti_entropy(host, self.hosts[peer_id], now)
            self.stats.exchanges += 1
        host.up = True
        return host

    def remove_host(self, host_id: str, now: float = 0.0) -> None:
        """Remove a host permanently.  Its retained snapshot window is
        handed to a survivor first (anti-entropy exchange), so a publish
        that had not gossiped out yet — the victim may own tenants — is
        not lost with the replica; gossip then spreads it.  An up survivor
        is preferred, but a down replica suffices (it rejoins the ring
        holding the data); removing the *last* host raises instead of
        silently discarding the only copy."""
        victim = self.hosts[host_id]
        victim.up = False                        # leave the ring first
        survivors = self.host_ids() or [h for h in self.hosts
                                        if h != host_id]
        if not survivors:
            raise ValueError(
                f"cannot remove {host_id!r}: it is the cluster's last "
                "host and its registry window would be discarded")
        self._anti_entropy(victim, self.hosts[survivors[0]], now)
        self.stats.exchanges += 1
        del self.hosts[host_id]

    # ------------------------------------- registry facade (training side)
    def publish(self, tenant: str, learners, alphas, **kw) -> EnsembleSnapshot:
        return self.hosts[self.owner(tenant)].registry.publish(
            tenant, learners, alphas, **kw)

    def publish_packed(self, tenant: str, stump_params, alphas,
                       **kw) -> EnsembleSnapshot:
        return self.hosts[self.owner(tenant)].registry.publish_packed(
            tenant, stump_params, alphas, **kw)

    def latest(self, tenant: str) -> Optional[EnsembleSnapshot]:
        host = self.route(tenant)
        return host.registry.latest(tenant) if host else None

    def get(self, tenant: str, version: Optional[int] = None
            ) -> Optional[EnsembleSnapshot]:
        host = self.route(tenant)
        return host.registry.get(tenant, version) if host else None

    def staleness(self, tenant: str, now: float) -> float:
        host = self.route(tenant)
        return host.registry.staleness(tenant, now) if host else float("inf")

    def tenants(self) -> List[str]:
        seen = set()
        for h in self.hosts.values():
            seen.update(h.registry.tenants())
        return sorted(seen)

    def version_count(self, tenant: str) -> int:
        s = self.latest(tenant)
        return s.version if s else 0

    def rebase_clock(self, clock: float = 0.0) -> None:
        for h in self.hosts.values():
            h.registry.rebase_clock(clock)

    def subscribe(self, fn):
        """Subscribe ``fn`` on every host replica (publishes *and* gossip
        ingests fire, whichever host they land on).  Returns one handle
        that unsubscribes from all of them."""
        handles = [h.registry.subscribe(fn) for h in self.hosts.values()]

        def unsubscribe() -> None:
            for h in handles:
                h()
        return unsubscribe

    # -------------------------------------------------------------- gossip
    def digests(self) -> Dict[str, Dict[str, Tuple[int, str]]]:
        return {hid: h.registry.digest() for hid, h in self.hosts.items()
                if h.up}

    def converged(self) -> bool:
        """True when every up host holds an identical version vector (and
        identical latest content) for every tenant."""
        vecs = list(self.digests().values())
        return all(v == vecs[0] for v in vecs[1:]) if vecs else True

    def gossip_round(self, now: float = 0.0) -> GossipStats:
        """One anti-entropy round: every up host pulls from ``fanout``
        random up peers.  Returns cumulative stats."""
        up = self.host_ids()
        self.stats.rounds += 1
        pulled0, rec0 = self.stats.pulled, self.stats.reconciled
        traced = obs.enabled()
        with obs.span("gossip.round", sim_t=now, hosts=len(up)) as sp:
            for hid in up:
                peers = [p for p in up if p != hid]
                self._rng.shuffle(peers)
                for pid in peers[:self.cfg.fanout]:
                    p0, r0 = self.stats.pulled, self.stats.reconciled
                    self._anti_entropy(self.hosts[hid], self.hosts[pid], now)
                    self.stats.exchanges += 1
                    if traced:
                        # per-exchange cross-host edge inside the round's
                        # trace: host= is the puller, peer the source
                        obs.point("gossip.exchange", sim_t0=now, sim_t1=now,
                                  host=hid, peer=pid,
                                  pulled=self.stats.pulled - p0,
                                  reconciled=self.stats.reconciled - r0)
            sp.set(pulled=self.stats.pulled - pulled0,
                   reconciled=self.stats.reconciled - rec0)
            sp.end_sim(now)
        obs.count("gossip.rounds")
        obs.count("gossip.pulled", self.stats.pulled - pulled0)
        obs.count("gossip.reconciled", self.stats.reconciled - rec0)
        return self.stats

    def run_until_quiescent(self, now: float = 0.0, max_rounds: int = 64
                            ) -> int:
        """Gossip until the version vectors stop moving; returns the number
        of rounds taken (the convergence lag the benchmark reports)."""
        for r in range(1, max_rounds + 1):
            self.gossip_round(now)
            if self.converged():
                return r
        return max_rounds

    def _anti_entropy(self, a: ShardHost, b: ShardHost, now: float) -> None:
        da, db = a.registry.digest(), b.registry.digest()
        for tenant in set(da) | set(db):
            va, fa = da.get(tenant, (0, ""))
            vb, fb = db.get(tenant, (0, ""))
            if va < vb:
                self._pull(a, b, tenant, now)
            elif vb < va:
                self._pull(b, a, tenant, now)
            elif va and fa != fb:       # concurrent: same version, new bytes
                self._reconcile(a, b, tenant, now)

    def _pull(self, behind: ShardHost, ahead: ShardHost, tenant: str,
              now: float) -> None:
        """Pull-on-miss: the behind host ingests the peer's whole retained
        window (ingest dedupes versions it already holds)."""
        for snap in ahead.registry.history(tenant):
            if behind.registry.ingest(snap):
                self.stats.pulled += 1
        # the pair may still disagree on the shared top version's content
        if (behind.registry.latest(tenant).fingerprint
                != ahead.registry.latest(tenant).fingerprint):
            self._reconcile(behind, ahead, tenant, now)

    def _reconcile(self, a: ShardHost, b: ShardHost, tenant: str,
                   now: float) -> None:
        sa, sb = a.registry.latest(tenant), b.registry.latest(tenant)
        ka = (reconcile_score(sa, now, self.cfg.lam), sa.published_at,
              sa.fingerprint)
        kb = (reconcile_score(sb, now, self.cfg.lam), sb.published_at,
              sb.fingerprint)
        winner, loser_host = (sa, b) if ka >= kb else (sb, a)
        loser_host.registry.replace_latest(tenant, winner)
        self.stats.reconciled += 1
