"""ChainRegistry: an EnsembleRegistry-shaped view over the chain of record.

One instance is one *node*'s local view.  ``publish``/``publish_packed``
cut the ensemble delta since the node's last submission into per-client
:class:`~repro_torch.chain.core.ChainCommit`s and queue them on the shared
:class:`~repro_torch.chain.core.Chain`; every read (``latest``/``get``/
``digest``/...) first folds any newly confirmed blocks into the local
view.  The fold is a pure function of the confirmed prefix, so every node
— including one created *after* the publisher died — reconstructs
bit-identical :class:`EnsembleSnapshot`s with identical version stamps and
fingerprints: there is no central registry instance to lose.

``provenance(tenant, version)`` answers which client updates entered a
served version — the ``(cid, round, block_hash)`` triple per merged
learner — from chain history alone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.chain.core import Block, Chain, ChainCommit
from repro_torch.serve.registry import (EnsembleRegistry, EnsembleSnapshot,
                                        _host_params, pack_stumps)


class _TenantFold:
    """Accumulated confirmed state for one tenant: the growing ensemble
    plus the per-entry provenance ledger."""

    def __init__(self):
        self.rows: List[Tuple[float, ...]] = []       # packed stump rows
        self.learners: List = []                      # generic params (CPU)
        self.alphas: List[float] = []
        self.weak_name = "stump"
        self.train_progress = 0
        self.versions = 0
        self.provenance: List[Tuple[int, int, str]] = []
        self.version_entries: Dict[int, int] = {}     # version -> prefix len


class ChainRegistry:
    """Quacks as :class:`~repro_torch.serve.registry.EnsembleRegistry`
    (publish, publish_packed, latest, get, history, ingest, digest,
    subscribe, staleness, rebase_clock) while sourcing every snapshot from
    the chain's confirmed prefix."""

    def __init__(self, chain: Optional[Chain] = None, *,
                 node_id: str = "node-0", history: int = 4,
                 participant: bool = True):
        self.chain = chain or Chain()
        self.node_id = node_id
        self.participant = bool(participant)
        if self.participant:
            self.chain.join(node_id)
        self._view = EnsembleRegistry(history=history)
        self._folds: Dict[str, _TenantFold] = {}
        self._next_height = 1             # first unfolded block height
        self._submitted: Dict[str, int] = {}   # tenant -> entries committed

    # ------------------------------------------------------------- publish
    def publish(self, tenant: str, learners: Sequence,
                alphas: Sequence[float], *, clock: float = 0.0,
                train_progress: int = 0, weak_name: str = "stump",
                owners: Optional[Sequence[int]] = None,
                rounds: Optional[Sequence[int]] = None
                ) -> Optional[EnsembleSnapshot]:
        """Commit the delta since this node's last submission, one commit
        per contiguous owner run (clients commit their own deltas), then
        sync.  Returns the latest *confirmed* snapshot — possibly a stale
        version or None while the delta waits for inclusion: chain mode
        really does serve only confirmed state."""
        learners = list(learners)
        alphas = [float(a) for a in alphas]
        if len(learners) != len(alphas):
            raise ValueError(
                f"publish({tenant!r}): {len(learners)} learners vs "
                f"{len(alphas)} alphas — refusing a mismatched commit")
        base = self._submitted.get(tenant, 0)
        if len(learners) < base:
            raise ValueError(
                f"publish({tenant!r}): ensemble shrank below the "
                f"{base} entries already committed on chain")
        rows = (pack_stumps(learners).numpy() if weak_name == "stump"
                else None)
        for lo, hi in _owner_runs(owners, base, len(learners)):
            self._submit(tenant, ChainCommit(
                tenant=tenant,
                cid=int(owners[lo]) if owners is not None else -1,
                seq=self.chain.next_seq(),
                rounds=tuple(int(rounds[i]) for i in range(lo, hi)
                             ) if rounds is not None else (0,) * (hi - lo),
                alphas=tuple(alphas[lo:hi]),
                stump_rows=(tuple(map(tuple, rows[lo:hi]))
                            if rows is not None else None),
                learners=(tuple(_host_params(p) for p in learners[lo:hi])
                          if rows is None else ()),
                weak_name=weak_name,
                train_progress=int(train_progress),
                submitted_at=float(clock)), clock)
        self._submitted[tenant] = len(learners)
        self.sync(clock)
        return self._view.latest(tenant)

    def publish_packed(self, tenant: str, stump_params, alphas, *,
                       clock: float = 0.0, train_progress: int = 0,
                       owners: Optional[Sequence[int]] = None,
                       rounds: Optional[Sequence[int]] = None
                       ) -> Optional[EnsembleSnapshot]:
        """Commit a packed ``(T, 4)`` stump delta (the fed_mesh wire
        format) — same delta/commit semantics as :meth:`publish`."""
        rows = _host_f32(stump_params)
        alphas = [float(a) for a in _host_f32(alphas)]
        if rows.shape != (len(alphas), 4):
            raise ValueError(f"publish_packed({tenant!r}): stump_params "
                             f"{rows.shape} vs {len(alphas)} alphas")
        base = self._submitted.get(tenant, 0)
        if len(alphas) < base:
            raise ValueError(
                f"publish_packed({tenant!r}): ensemble shrank below the "
                f"{base} entries already committed on chain")
        for lo, hi in _owner_runs(owners, base, len(alphas)):
            self._submit(tenant, ChainCommit(
                tenant=tenant,
                cid=int(owners[lo]) if owners is not None else -1,
                seq=self.chain.next_seq(),
                rounds=tuple(int(rounds[i]) for i in range(lo, hi)
                             ) if rounds is not None else (0,) * (hi - lo),
                alphas=tuple(alphas[lo:hi]),
                stump_rows=tuple(map(tuple, rows[lo:hi])),
                train_progress=int(train_progress),
                submitted_at=float(clock)), clock)
        self._submitted[tenant] = len(alphas)
        self.sync(clock)
        return self._view.latest(tenant)

    def _submit(self, tenant: str, commit: ChainCommit, clock: float
                ) -> None:
        with obs.span("chain.commit", sim_t=clock, host=self.node_id,
                      tenant=tenant, cid=commit.cid,
                      n_entries=commit.n_entries,
                      node=self.node_id) as sp:
            if obs.enabled():
                # the commit carries this span's context onto the chain, so
                # the mint event and every node's fold link back to it —
                # ctx is outside the fingerprint, hashes are unchanged
                commit = dataclasses.replace(commit, ctx=sp.ctx)
            wait = self.chain.submit(commit, float(clock))
            sp.set(confirm_wait_s=wait, seq=commit.seq)
            sp.end_sim(clock + wait)
        obs.count("chain.commits")

    # ---------------------------------------------------------------- sync
    def sync(self, now: Optional[float] = None) -> int:
        """Fold newly confirmed blocks into the local view.  ``now``
        advances the shared chain clock first (mints due blocks); None
        only folds what other nodes already minted.  Returns the number
        of snapshots ingested — every read path calls this, so a node's
        view is always a pure function of the confirmed prefix."""
        if now is not None:
            self.chain.advance(float(now))
        blocks = [b for b in self.chain.confirmed_blocks()
                  if b.height >= self._next_height]
        if not blocks:
            return 0
        ingested = 0
        t0 = blocks[0].mined_at
        links = [c.ctx for b in blocks for c in b.commits
                 if c.ctx is not None] if obs.enabled() else None
        with obs.span("chain.aggregate", sim_t=t0, host=self.node_id,
                      link=links, node=self.node_id, blocks=len(blocks),
                      leader=self.chain.leader() or "") as sp:
            for b in blocks:
                ingested += self._fold_block(b)
                self._next_height = b.height + 1
            sp.set(snapshots=ingested)
            sp.end_sim(blocks[-1].mined_at)
        obs.count("chain.aggregates", ingested)
        return ingested

    def _fold_block(self, block: Block) -> int:
        """Fold one confirmed block: all commits for a tenant in one block
        aggregate into one new snapshot version (the committee's
        deterministic aggregation step)."""
        touched: Dict[str, _TenantFold] = {}
        for c in block.commits:
            fold = self._folds.setdefault(c.tenant, _TenantFold())
            fold.weak_name = c.weak_name
            fold.train_progress = max(fold.train_progress,
                                      c.train_progress)
            if c.stump_rows is not None:
                fold.rows.extend(c.stump_rows)
            fold.learners.extend(c.learners)
            fold.alphas.extend(c.alphas)
            fold.provenance.extend(
                (c.cid, r, block.hash) for r in c.rounds)
            touched[c.tenant] = fold
        for tenant, fold in touched.items():
            fold.versions += 1
            fold.version_entries[fold.versions] = len(fold.alphas)
            snap = EnsembleSnapshot(
                tenant=tenant, version=fold.versions,
                published_at=float(block.mined_at),
                train_progress=int(fold.train_progress),
                weak_name=fold.weak_name,
                alphas=torch.from_numpy(np.asarray(fold.alphas, np.float32)),
                stump_params=(torch.from_numpy(
                    np.asarray(fold.rows, np.float32))
                              if fold.weak_name == "stump" else None),
                learners=tuple(fold.learners))
            self._view.ingest(snap)
        return len(touched)

    # ---------------------------------------------------------- provenance
    def provenance(self, tenant: str, version: Optional[int] = None
                   ) -> Tuple[Tuple[int, int, str], ...]:
        """The ``(cid, round, block_hash)`` lineage of every learner in
        ``version`` (default: the latest), oldest first — answered from
        chain history alone."""
        self.sync()
        fold = self._folds.get(tenant)
        if fold is None:
            return ()
        if version is None:
            version = fold.versions
        n = fold.version_entries.get(int(version))
        if n is None:
            raise KeyError(
                f"no confirmed version {version} for tenant {tenant!r} "
                f"(chain holds 1..{fold.versions})")
        return tuple(fold.provenance[:n])

    # ------------------------------------------------------ registry quack
    def latest(self, tenant: str) -> Optional[EnsembleSnapshot]:
        self.sync()
        return self._view.latest(tenant)

    def get(self, tenant: str, version: Optional[int] = None
            ) -> Optional[EnsembleSnapshot]:
        self.sync()
        return self._view.get(tenant, version)

    def history(self, tenant: str) -> List[EnsembleSnapshot]:
        self.sync()
        return self._view.history(tenant)

    def tenants(self) -> List[str]:
        self.sync()
        return self._view.tenants()

    def version_count(self, tenant: str) -> int:
        self.sync()
        return self._view.version_count(tenant)

    def staleness(self, tenant: str, now: float) -> float:
        self.sync()
        return self._view.staleness(tenant, now)

    def digest(self) -> Dict[str, Tuple[int, str]]:
        self.sync()
        return self._view.digest()

    def ingest(self, snap: EnsembleSnapshot) -> bool:
        # interface compat (a chain node may be warmed from a plain
        # registry's window); the chain fold supersedes anything ingested
        return self._view.ingest(snap)

    def replace_latest(self, tenant: str, snap: EnsembleSnapshot
                       ) -> EnsembleSnapshot:
        return self._view.replace_latest(tenant, snap)

    def subscribe(self, fn):
        return self._view.subscribe(fn)

    def rebase_clock(self, clock: float = 0.0) -> None:
        self._view.rebase_clock(clock)

    def close(self) -> None:
        """This node leaves the committee (crash or drain); its view dies
        with it — the chain keeps every byte needed to rebuild."""
        if self.participant:
            self.chain.leave(self.node_id)


def _host_f32(a) -> np.ndarray:
    """``a`` (a tensor on any device, or anything ``np.asarray`` takes)
    as a host f32 numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float32)


def _owner_runs(owners: Optional[Sequence[int]], base: int, end: int
                ) -> List[Tuple[int, int]]:
    """Split ``[base, end)`` into contiguous same-owner runs (one commit
    per run keeps per-client attribution without reordering entries)."""
    if base >= end:
        return []
    if owners is None:
        return [(base, end)]
    runs = []
    lo = base
    for i in range(base + 1, end):
        if owners[i] != owners[lo]:
            runs.append((lo, i))
            lo = i
    runs.append((lo, end))
    return runs
