"""ChainCluster: a serving fleet whose hosts sync from the chain of
record instead of gossiping registry windows.

Drop-in for :class:`~repro_torch.serve.shard.ShardCluster` (the harness and
:class:`~repro_torch.serve.service.ShardedEnsembleServer` drive it unchanged),
with the central-registry assumptions removed:

* ``publish``/``publish_packed`` do not route to an owning host — the
  trainer commits deltas straight to the shared :class:`Chain` through a
  non-voting committer node, so no host is a publish target that can be
  lost.
* a "gossip round" is each up host folding newly confirmed blocks; hosts
  agree by construction (the fold is deterministic), so the cluster
  converges in one round.
* ``add_host`` warms a brand-new node entirely from chain history —
  including the total-loss case where every previous host died.
* ``kill`` models an abrupt host death: the node leaves the committee
  (rotating the leader) and routing skips it; nothing is handed off
  because nothing needs to be.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.chain.core import Chain
from repro_torch.chain.registry import ChainRegistry
from repro_torch.serve.registry import EnsembleSnapshot
from repro_torch.serve.shard import GossipConfig, ShardCluster, ShardHost
from repro_torch.sim.behavior import BlockchainLedger


class ChainCluster(ShardCluster):
    """N chain-backed hosts; quacks as a ShardCluster + registry."""

    def __init__(self, n_hosts: int = 3, cfg: Optional[GossipConfig] = None,
                 host_ids: Optional[Sequence[str]] = None, *,
                 chain: Optional[Chain] = None,
                 block_interval_s: float = 0.05,
                 confirmations: int = 2, reorg_prob: float = 0.0,
                 committee_size: int = 3):
        cfg = cfg or GossipConfig()
        self.chain = chain or Chain(
            BlockchainLedger(np.random.RandomState(cfg.seed * 7919 + 977),
                             block_interval_s=block_interval_s),
            confirmations=confirmations, reorg_prob=reorg_prob,
            committee_size=committee_size, seed=cfg.seed)
        self._clock_epoch: Optional[float] = None
        super().__init__(n_hosts, cfg, host_ids)
        # the training side commits through a non-voting node: it holds no
        # state the chain cannot rebuild, and it never joins the committee
        self._committer = ChainRegistry(self.chain, node_id="trainer",
                                        history=self.cfg.history,
                                        participant=False)

    def _make_registry(self, host_id: str) -> ChainRegistry:
        return ChainRegistry(self.chain, node_id=host_id,
                             history=self.cfg.history)

    # ------------------------------------- registry facade (training side)
    def publish(self, tenant: str, learners, alphas, **kw
                ) -> Optional[EnsembleSnapshot]:
        snap = self._committer.publish(tenant, learners, alphas, **kw)
        self._sync_up_hosts()
        return snap

    def publish_packed(self, tenant: str, stump_params, alphas, **kw
                       ) -> Optional[EnsembleSnapshot]:
        snap = self._committer.publish_packed(tenant, stump_params, alphas,
                                              **kw)
        self._sync_up_hosts()
        return snap

    def provenance(self, tenant: str, version: Optional[int] = None
                   ) -> Tuple[Tuple[int, int, str], ...]:
        """Lineage of a served version, answerable from any node (they all
        fold the same confirmed prefix)."""
        host = self.route(tenant)
        node = host.registry if host is not None else self._committer
        return node.provenance(tenant, version)

    def _sync_up_hosts(self) -> int:
        pulled = 0
        for h in self.hosts.values():
            if h.up:
                pulled += h.registry.sync()
        return pulled

    # -------------------------------------------------------------- gossip
    def gossip_round(self, now: float = 0.0):
        """Chain-mode anti-entropy: every up host folds the blocks the
        chain confirmed by ``now``.  One round always converges."""
        up = self.host_ids()
        self.stats.rounds += 1
        with obs.span("gossip.round", sim_t=now, hosts=len(up)) as sp:
            self.chain.advance(float(now))
            pulled = self._sync_up_hosts()
            self.stats.pulled += pulled
            self.stats.exchanges += len(up)
            sp.set(pulled=pulled, reconciled=0)
            sp.end_sim(now)
        obs.count("gossip.rounds")
        obs.count("gossip.pulled", pulled)
        return self.stats

    def run_until_quiescent(self, now: float = 0.0, max_rounds: int = 64
                            ) -> int:
        """Settle the chain (mint everything pending at its recorded
        confirmation time) and fold it everywhere."""
        self.chain.finalize()
        self.gossip_round(now)
        return 1

    # ------------------------------------------------- elastic membership
    def add_host(self, host_id: str, now: float = 0.0) -> ShardHost:
        """Scale-out: the new node warms from chain history alone — no
        peer needed, even after a total fleet loss."""
        if host_id in self.hosts:
            raise ValueError(f"host {host_id!r} already in cluster")
        host = ShardHost(host_id, self._make_registry(host_id), up=False)
        self.hosts[host_id] = host
        host.registry.sync(now)
        if self._clock_epoch is not None:
            host.registry.rebase_clock(self._clock_epoch)
        host.up = True
        return host

    def remove_host(self, host_id: str, now: float = 0.0) -> None:
        """Remove a host permanently.  No survivor handoff: the chain is
        the durable copy, so even the last host may leave."""
        victim = self.hosts.pop(host_id)
        victim.up = False
        victim.registry.close()

    def kill(self, host_id: str) -> None:
        """Abrupt host death (no drain): routing skips it immediately and
        the committee rotates past it — aggregation, being a deterministic
        fold, continues identically under the next leader."""
        self.mark_down(host_id)
        self.hosts[host_id].registry.close()
        obs.count("chain.host_kills")

    def leader(self) -> Optional[str]:
        """The current committee leader (the node that stamps the next
        block) — the harness kills exactly this host mid-replay."""
        return self.chain.leader()

    def rebase_clock(self, clock: float = 0.0) -> None:
        self._sync_up_hosts()
        self._clock_epoch = float(clock)
        for h in self.hosts.values():
            h.registry.rebase_clock(clock)
        self._committer.rebase_clock(clock)
