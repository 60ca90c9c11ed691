"""Per-snapshot result cache for the serving hot path.

Hot feature vectors recur (dashboards re-scoring the same device, retries,
reference rows), and an ensemble's margin for a given input is a pure
function of ``(tenant, snapshot version, feature block)`` — so the batch
evaluator memoizes it.  The key is exactly that triple, with the feature
block keyed by a content hash of its float32 bytes:

* a **hit** returns the margin the kernel produced when the entry was
  filled — bit-identical to re-running the vote, because padded kernel
  slots contribute exact zeros (the ``ensemble_vote`` padding contract),
  so batch composition never perturbs a tenant's margins;
* a **miss** falls through to the packed vote-kernel path and fills the
  cache after the vote.

Invalidation is subscription-driven: the cache registers on the registry's
(or sharded cluster's) publish hook, and when a newer version for a tenant
lands — local ``publish()`` or gossip ``ingest()`` alike — every entry of
*that tenant only* keyed below the new version is dropped atomically under
the cache lock.  Versioned keys already make stale hits impossible; the
invalidation sweep is what bounds memory and keeps the "exactly that
tenant" eviction property testable.  Capacity overflow evicts LRU.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np


def feature_hash(x) -> bytes:
    """Content hash of one feature vector (float32 canonical bytes)."""
    buf = np.ascontiguousarray(np.asarray(x), np.float32)
    return hashlib.blake2b(buf.tobytes(), digest_size=12).digest()


def fingerprint_key(f0, f1) -> bytes:
    """Cache key from the two uint32 xor-fold fingerprint lanes the fused
    ``stump_vote_fp_batched`` kernel emits per request column.  The ``fp``
    prefix keeps kernel-computed keys disjoint from :func:`feature_hash`
    keys (12 raw digest bytes), so a tenant toggling ``fused_fingerprint``
    mid-flight can never alias the two key spaces."""
    return (b"fp" + int(f0).to_bytes(4, "little")
            + int(f1).to_bytes(4, "little"))


CacheKey = Tuple[str, int, bytes]       # (tenant, snapshot version, x hash)


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    fills: int = 0
    invalidated: int = 0     # entries dropped by newer-version publishes
    evicted: int = 0         # entries dropped by LRU capacity pressure
    per_tenant_hits: Dict[str, int] = field(default_factory=dict)

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


class ResultCache:
    """Thread-safe LRU of ``(tenant, version, feature-hash) -> margin``."""

    def __init__(self, capacity: int = 65536):
        assert capacity >= 1
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: "OrderedDict[CacheKey, float]" = OrderedDict()
        self.stats = CacheStats()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -------------------------------------------------------------- lookup
    def lookup(self, tenant: str, version: int, xh: bytes
               ) -> Optional[float]:
        key = (tenant, int(version), xh)
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.stats.hits += 1
                t = self.stats.per_tenant_hits
                t[tenant] = t.get(tenant, 0) + 1
                return self._entries[key]
            self.stats.misses += 1
            return None

    def put(self, tenant: str, version: int, xh: bytes, margin: float
            ) -> None:
        key = (tenant, int(version), xh)
        with self._lock:
            if key not in self._entries:
                self.stats.fills += 1
            self._entries[key] = float(margin)
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.stats.evicted += 1

    # -------------------------------------------------------- invalidation
    def invalidate_through(self, tenant: str, version: int) -> int:
        """Atomically drop every entry of ``tenant`` keyed at or below
        ``version`` (other tenants' entries are untouched); returns the
        drop count.  Inclusive on purpose: when gossip reconciliation
        *replaces* a tenant's latest snapshot at the same version number
        (two publishers raced), entries filled from the discarded snapshot
        share its version key and must go too.  On a normal publish the
        inclusive bound is vacuous — nothing can be cached under a version
        that has only just become latest."""
        with self._lock:
            dead = [k for k in self._entries
                    if k[0] == tenant and k[1] <= version]
            for k in dead:
                del self._entries[k]
            self.stats.invalidated += len(dead)
        return len(dead)

    def attach(self, registry):
        """Subscribe invalidation to a registry (or registry-like sharded
        host): any snapshot that becomes a tenant's latest — publish,
        gossip ingest, or same-version reconciliation — sweeps that
        tenant's entries up to that version.  Returns the unsubscribe
        handle."""
        return registry.subscribe(
            lambda snap: self.invalidate_through(snap.tenant, snap.version))

    def keys(self) -> Tuple[CacheKey, ...]:
        with self._lock:
            return tuple(self._entries)
