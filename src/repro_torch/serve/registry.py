"""Multi-tenant ensemble registry: immutable, versioned serving snapshots.

Training (the event-driven
:class:`~repro_torch.core.async_engine.FederatedBoostEngine`) publishes a
snapshot of the current global ensemble whenever it merges learners;
serving reads whatever the latest snapshot is.  Because a snapshot is a frozen value built *before*
the registry pointer is swapped (under a lock), readers never observe a
half-merged ensemble, and training never blocks on serving traffic.

Stump ensembles — the paper's weak learner — are stored packed as a
``(T, 4)`` float array (feature, threshold, polarity, spare) on the host,
which the serving batch gathers features from before one copy to the
card.  Generic weak learners (logistic / mlp) keep their params dicts and
go through the per-learner-predict + ``ensemble_vote_batched`` path
instead.  Snapshot tensors live on the CPU: a snapshot is a small
immutable record that serving reads on the host.
"""
from __future__ import annotations

import functools
import hashlib
import threading
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

F32 = torch.float32


@dataclass(frozen=True)
class EnsembleSnapshot:
    """One immutable published version of a tenant's ensemble."""
    tenant: str
    version: int               # monotonically increasing per tenant, from 1
    published_at: float        # publisher's clock (sim seconds or wall time)
    train_progress: int        # learners merged / rounds done when published
    weak_name: str             # weak-learner family ("stump" | "logistic" | ...)
    alphas: torch.Tensor       # (T,) f32 compensated vote weights (CPU)
    stump_params: Optional[torch.Tensor] = None  # (T, 4) packed stumps (CPU)
    learners: Tuple = ()       # generic params dicts (CPU), non-stump families

    @property
    def n_learners(self) -> int:
        return int(self.alphas.shape[0])

    @functools.cached_property
    def fingerprint(self) -> str:
        """Content digest (version/clock excluded): two concurrently gossiped
        snapshots claiming the same version number are 'the same' iff their
        fingerprints match — the shard reconciler compares these.  Cached
        per instance (cached_property writes straight into ``__dict__``,
        which the frozen dataclass allows) — gossip digests re-read it
        every exchange and the payload hash isn't free.  The bytes hashed,
        and their order, are the JAX package's, so the same learners give
        the same digest in both packages."""
        h = hashlib.blake2b(digest_size=12)
        h.update(self.weak_name.encode())
        h.update(np.int64(self.train_progress).tobytes())
        h.update(_f32_bytes(self.alphas))
        if self.stump_params is not None:
            h.update(_f32_bytes(self.stump_params))
        for p in self.learners:
            # the JAX package walks each dict's leaves in sorted key order
            for k in sorted(p):
                h.update(np.ascontiguousarray(p[k].numpy()).tobytes())
        return h.hexdigest()


def _f32_bytes(t: torch.Tensor) -> bytes:
    return np.ascontiguousarray(t.detach().cpu().numpy(), np.float32).tobytes()


def pack_stumps(learners: Sequence[Dict]) -> torch.Tensor:
    """Pack stump param dicts {feature, threshold, polarity} -> (T, 4) f32
    on the CPU, with one copy from the learners' device."""
    if not learners:
        return torch.zeros((0, 4), dtype=F32)
    cols = [torch.stack([torch.as_tensor(p[k]).to(F32) for p in learners])
            for k in ("feature", "threshold", "polarity")]
    packed = torch.stack(cols, dim=1).cpu()                      # (T, 3)
    return torch.cat([packed, torch.zeros((packed.shape[0], 1), dtype=F32)],
                     dim=1)


def _host_params(p: Dict) -> Dict[str, torch.Tensor]:
    """A learner's params dict as detached tensors on the CPU."""
    return {k: torch.as_tensor(v).detach().cpu() for k, v in p.items()}


class EnsembleRegistry:
    """Thread-safe tenant -> snapshot-history map (bounded history).

    ``publish*`` builds the immutable snapshot outside the lock and swaps it
    in atomically; ``latest``/``get`` return whatever version is current —
    serving hot-swaps ensembles without ever blocking a publisher.
    """

    def __init__(self, history: int = 4):
        assert history >= 1
        self._history = history
        self._lock = threading.Lock()
        self._snaps: Dict[str, List[EnsembleSnapshot]] = {}
        self._subscribers: List[Callable[[EnsembleSnapshot], None]] = []

    # ---------------------------------------------------------- subscribers
    def subscribe(self, fn: Callable[[EnsembleSnapshot], None]
                  ) -> Callable[[], None]:
        """Register ``fn(snapshot)`` to run after every snapshot that becomes
        a tenant's latest — local publishes, gossip ingests, and concurrent-
        version replacements alike.  Callbacks run outside the registry lock
        (a subscriber may read the registry), in subscription order; the
        result cache invalidates through exactly this hook.  Returns a
        zero-arg unsubscribe handle (idempotent) so short-lived servers
        don't pin their caches on a long-lived registry."""
        self._subscribers.append(fn)

        def unsubscribe() -> None:
            try:
                self._subscribers.remove(fn)
            except ValueError:
                pass
        return unsubscribe

    def _notify(self, snap: EnsembleSnapshot) -> None:
        for fn in self._subscribers:
            fn(snap)

    # ------------------------------------------------------------- publish
    def publish(self, tenant: str, learners: Sequence, alphas: Sequence[float],
                *, clock: float = 0.0, train_progress: int = 0,
                weak_name: str = "stump", owners: Optional[Sequence[int]] = None,
                rounds: Optional[Sequence[int]] = None) -> EnsembleSnapshot:
        """Publish from a list of weak-learner params + vote weights (the
        :class:`Ensemble` representation the async engine grows).

        ``owners``/``rounds`` are per-learner provenance metadata
        (contributing client id + client-local round).  The central
        registry ignores them — a snapshot here is already the aggregated
        truth; the chain-of-record registry, not ported yet, commits them."""
        learners = list(learners)
        alphas = torch.tensor([float(a) for a in alphas], dtype=F32)
        if len(learners) != alphas.shape[0]:
            raise ValueError(
                f"publish({tenant!r}): {len(learners)} learners vs "
                f"{alphas.shape[0]} alphas — refusing a mismatched snapshot")
        if weak_name == "stump":
            return self.publish_packed(
                tenant, pack_stumps(learners), alphas, clock=clock,
                train_progress=train_progress)
        return self._stamp(tenant, EnsembleSnapshot(
            tenant=tenant, version=0, published_at=float(clock),
            train_progress=int(train_progress), weak_name=weak_name,
            alphas=alphas, learners=tuple(_host_params(p) for p in learners)))

    def publish_packed(self, tenant: str, stump_params: torch.Tensor,
                       alphas: torch.Tensor, *, clock: float = 0.0,
                       train_progress: int = 0,
                       owners: Optional[Sequence[int]] = None,
                       rounds: Optional[Sequence[int]] = None
                       ) -> EnsembleSnapshot:
        """Publish a packed (T, 4) stump ensemble."""
        stump_params = torch.as_tensor(stump_params, dtype=F32).cpu()
        alphas = torch.as_tensor(alphas, dtype=F32).cpu()
        if stump_params.shape != (alphas.shape[0], 4):
            raise ValueError(f"stump_params {tuple(stump_params.shape)} vs "
                             f"alphas {tuple(alphas.shape)}")
        return self._stamp(tenant, EnsembleSnapshot(
            tenant=tenant, version=0, published_at=float(clock),
            train_progress=int(train_progress), weak_name="stump",
            alphas=alphas, stump_params=stump_params))

    def _stamp(self, tenant: str, snap: EnsembleSnapshot) -> EnsembleSnapshot:
        with self._lock:
            hist = self._snaps.setdefault(tenant, [])
            snap = replace(snap, version=(hist[-1].version + 1 if hist else 1))
            hist.append(snap)
            del hist[:-self._history]
        self._notify(snap)
        return snap

    # ---------------------------------------------------- gossip interface
    def digest(self) -> Dict[str, Tuple[int, str]]:
        """Version vector: tenant -> (latest version, content fingerprint).
        Anti-entropy peers exchange digests and pull only what they miss."""
        with self._lock:
            latest = {t: h[-1] for t, h in self._snaps.items() if h}
        return {t: (s.version, s.fingerprint) for t, s in latest.items()}

    def ingest(self, snap: EnsembleSnapshot) -> bool:
        """Adopt a snapshot made elsewhere (another host's, or one carried
        across from the JAX package), *keeping its version stamp* (unlike
        ``publish``, which assigns the next local version).  Out-of-date or
        already-held versions are dropped; returns True iff the registry
        changed.  Subscribers fire only when the snapshot became the
        tenant's new latest."""
        with self._lock:
            hist = self._snaps.setdefault(snap.tenant, [])
            if any(s.version == snap.version for s in hist):
                return False
            if hist and snap.version < hist[-1].version - self._history + 1:
                return False            # older than the retained window
            hist.append(snap)
            hist.sort(key=lambda s: s.version)
            del hist[:-self._history]
            became_latest = hist[-1] is snap
        if became_latest:
            self._notify(snap)
        return True

    def replace_latest(self, tenant: str,
                       snap: EnsembleSnapshot) -> EnsembleSnapshot:
        """Swap the tenant's latest snapshot for a concurrent same-version
        snapshot the gossip reconciler ranked higher.  The version number
        must match the current latest (reconciliation never moves the
        version vector backwards)."""
        with self._lock:
            hist = self._snaps.get(tenant)
            if not hist or hist[-1].version != snap.version:
                raise ValueError(
                    f"replace_latest({tenant!r}): version {snap.version} "
                    "is not the tenant's latest")
            hist[-1] = snap
        self._notify(snap)
        return snap

    # --------------------------------------------------------------- reads
    def latest(self, tenant: str) -> Optional[EnsembleSnapshot]:
        with self._lock:
            hist = self._snaps.get(tenant)
            return hist[-1] if hist else None

    def get(self, tenant: str, version: Optional[int] = None
            ) -> Optional[EnsembleSnapshot]:
        if version is None:
            return self.latest(tenant)
        with self._lock:
            for s in self._snaps.get(tenant, ()):
                if s.version == version:
                    return s
        return None

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._snaps)

    def history(self, tenant: str) -> List[EnsembleSnapshot]:
        """The retained snapshot window, oldest first (gossip peers pull
        whole windows so cross-host ``get(tenant, version)`` works too)."""
        with self._lock:
            return list(self._snaps.get(tenant, ()))

    def version_count(self, tenant: str) -> int:
        """Total versions ever published for a tenant (not history length)."""
        s = self.latest(tenant)
        return s.version if s else 0

    def staleness(self, tenant: str, now: float) -> float:
        """Seconds since the tenant's serving snapshot was published (the
        snapshot-freshness analogue of the paper's staleness tau)."""
        s = self.latest(tenant)
        return max(0.0, float(now) - s.published_at) if s else float("inf")

    def rebase_clock(self, clock: float = 0.0) -> None:
        """Re-stamp publish times onto a new clock epoch.  Training
        simulators and serving load generators run separate simulated
        clocks; rebasing at the hand-off keeps the staleness metric
        meaningful without mutating any published snapshot (new frozen
        snapshots are swapped in).

        Every history entry shifts by the same per-tenant delta that lands
        the latest snapshot exactly at ``clock``, so relative snapshot ages
        — and therefore ``get(tenant, version)``-based staleness math —
        stay consistent across clock epochs instead of only the latest
        entry being moved."""
        with self._lock:
            for tenant, hist in self._snaps.items():
                if not hist:
                    continue
                delta = float(clock) - hist[-1].published_at
                hist[:] = [replace(s, published_at=s.published_at + delta)
                           for s in hist]
