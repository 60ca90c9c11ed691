"""Batched serving hot path: pack one micro-batch's requests across tenants
into padded (B, T, N) blocks and evaluate them in a single kernel launch.

Each slot b of the packed block is one tenant present in the batch: its
requests become the N sample columns, its ensemble the T learner rows, both
padded to the widest tenant (zero-alpha rows / dummy columns contribute
nothing).

Three paths:

* stump ensembles (the paper's weak learner): one host-side feature
  gather builds ``xsel[b,t,n] = x_b[n, feat_{b,t}]`` and the fused
  ``stump_vote_batched`` kernel computes margins + vote in one pass;
* under a ``fused_fingerprint`` kernel policy with a result cache
  attached, the one-launch ``stump_vote_fp_batched`` kernel additionally
  emits a per-request xor-fold feature fingerprint, which keys the result
  cache directly — no host-side ``feature_hash`` walk of any feature
  vector on the submit path;
* generic weak learners (logistic / mlp): each learner's predict builds
  its row of the (B, T, N) margin stack on the evaluator's device, and
  the ``ensemble_vote_batched`` kernel takes the weighted vote in one
  launch per group.  A tenant's learners cross to the device once per
  snapshot version, stacked one tensor per parameter.

The stump block is built on the host and crosses to the evaluator's
device in one copy per launch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ops import KernelPolicy
from repro_torch.models.weak import get_weak_learner
from repro_torch.serve.batching import Request
from repro_torch.serve.cache import ResultCache, feature_hash, fingerprint_key
from repro_torch.serve.registry import EnsembleRegistry, EnsembleSnapshot


@dataclass(frozen=True)
class Response:
    rid: int
    tenant: str
    margin: float               # ensemble margin H(x)
    label: float                # sign(H(x)) in {-1, +1}
    snapshot_version: int       # 0 = tenant had no published ensemble
    t_submit: float


@dataclass(frozen=True)
class EvalStats:
    """Per-batch split of where each request's margin came from."""
    kernel_requests: int = 0    # packed into the vote kernels
    cached_requests: int = 0    # answered from the result cache
    abstained_requests: int = 0  # cold tenants (no snapshot yet)
    deduped_requests: int = 0   # in-batch duplicates of a kernel request
    fp_hits: int = 0            # fused-path cache hits (kernel fingerprint)


class BatchEvaluator:
    """Evaluates micro-batches against the registry's latest snapshots.

    With a :class:`ResultCache` attached, each request is first looked up
    under ``(tenant, snapshot version, feature hash)`` *before* packing —
    hits skip the kernel entirely and misses fill the cache after the vote,
    so repeated hot feature vectors cost one hash instead of one kernel
    slot.  ``last_eval`` reports the kernel/cached/abstained split of the
    most recent batch.

    ``policy_for`` resolves a tenant's own kernel policy (None falls back
    to ``policy``); tenants resolving to distinct policies are packed into
    separate kernel launches.  The vote kernels run on ``device`` (the card
    by default; asking for it without one raises).
    """

    def __init__(self, registry: EnsembleRegistry, *,
                 policy: Optional[KernelPolicy] = None,
                 cache: Optional[ResultCache] = None,
                 policy_for: Optional[
                     Callable[[str], Optional[KernelPolicy]]] = None,
                 device="cuda"):
        self.registry = registry
        self.policy = policy
        self.policy_for = policy_for
        self.device = resolve_device(device)
        self.cache = cache
        self.last_eval = EvalStats()
        # cumulative launch/hash accounting (the fused-fingerprint path's
        # whole point is driving both down; tests pin the deltas)
        self.kernel_launches = 0
        self.host_hash_calls = 0
        self._fp_hits = 0
        # tenant -> (snapshot, its learners on the device), generic path
        self._device_learners: Dict[str, Tuple[EnsembleSnapshot, list]] = {}

    def evaluate(self, batch: Sequence[Request]) -> List[Response]:
        by_tenant: Dict[str, List[Request]] = {}
        for r in batch:
            by_tenant.setdefault(r.tenant, []).append(r)

        margins: Dict[int, float] = {}          # rid -> margin
        versions: Dict[str, int] = {}           # tenant -> snapshot served
        stump_group: List[Tuple[EnsembleSnapshot, List[Request]]] = []
        fused_group: List[Tuple[EnsembleSnapshot, List[Request]]] = []
        generic_group: List[Tuple[EnsembleSnapshot, List[Request]]] = []
        fills: List[Tuple[str, int, bytes, int]] = []  # cache misses to fill
        dupes: List[Tuple[int, int]] = []       # (dup rid, evaluated rid)
        n_cached = n_abstained = n_deduped = 0
        self._fp_hits = 0
        for tenant, reqs in by_tenant.items():
            snap = self.registry.latest(tenant)
            if snap is None or snap.n_learners == 0:
                versions[tenant] = 0
                n_abstained += len(reqs)
                for r in reqs:                  # cold tenant: abstain at 0
                    margins[r.rid] = 0.0
                continue
            versions[tenant] = snap.version
            policy = self._resolved_policy(tenant)
            if (self.cache is not None and snap.weak_name == "stump"
                    and policy is not None and policy.fused_fingerprint):
                # the kernel computes the cache key in-launch: skip the
                # host-side hash walk entirely and pack every request
                fused_group.append((snap, reqs))
                continue
            if self.cache is not None:          # consult before packing
                pending: List[Request] = []
                first_rid: Dict[bytes, int] = {}
                for r in reqs:
                    xh = feature_hash(r.x)
                    self.host_hash_calls += 1
                    hit = self.cache.lookup(tenant, snap.version, xh)
                    if hit is not None:
                        margins[r.rid] = hit
                        n_cached += 1
                    elif xh in first_rid:       # in-batch duplicate: one
                        dupes.append((r.rid, first_rid[xh]))  # kernel slot
                        n_deduped += 1
                    else:
                        first_rid[xh] = r.rid
                        fills.append((tenant, snap.version, xh, r.rid))
                        pending.append(r)
                reqs = pending
            if reqs:
                (stump_group if snap.weak_name == "stump"
                 else generic_group).append((snap, reqs))

        for sub in self._by_policy(fused_group):
            self._eval_stumps_fused(sub, margins)
        for sub in self._by_policy(stump_group):
            self._eval_stumps(sub, margins)
        for sub in self._by_policy(generic_group):
            self._eval_generic(sub, margins)
        for rid, src_rid in dupes:              # fan the one margin out
            margins[rid] = margins[src_rid]
        if self.cache is not None:              # fill after the vote
            for tenant, version, xh, rid in fills:
                self.cache.put(tenant, version, xh, margins[rid])
        self.last_eval = EvalStats(
            kernel_requests=len(batch) - n_cached - n_abstained - n_deduped,
            cached_requests=n_cached, abstained_requests=n_abstained,
            deduped_requests=n_deduped, fp_hits=self._fp_hits)

        return [Response(
            rid=r.rid, tenant=r.tenant, margin=margins[r.rid],
            label=1.0 if margins[r.rid] > 0 else -1.0,
            snapshot_version=versions[r.tenant],
            t_submit=r.t_submit) for r in batch]

    # ------------------------------------------------------ policy grouping
    def _resolved_policy(self, tenant: str) -> Optional[KernelPolicy]:
        if self.policy_for is not None:
            p = self.policy_for(tenant)
            if p is not None:
                return p
        return self.policy

    def _by_policy(self, group):
        """Partition one group into per-kernel-policy launches (policies
        compare by value).  Without a resolver this is a single launch."""
        if not group:
            return []
        if self.policy_for is None:
            return [group]
        parts: Dict[Optional[KernelPolicy], list] = {}
        for snap, reqs in group:
            parts.setdefault(self._resolved_policy(snap.tenant),
                             []).append((snap, reqs))
        return list(parts.values())

    # ----------------------------------------------------------- stump path
    def _pack_stumps(self, group):
        """Pad one stump group into the (B, T, N) kernel block on the host,
        then move it to the device in one copy.  Returns device views
        ``(xsel, thr, pol, alphas)``."""
        B = len(group)
        T = max(s.n_learners for s, _ in group)
        N = max(len(reqs) for _, reqs in group)
        n_x = B * T * N
        host = np.zeros(n_x + 3 * B * T, np.float32)
        xsel = host[:n_x].reshape(B, T, N)
        thr = host[n_x:n_x + B * T].reshape(B, T)
        pol = host[n_x + B * T:n_x + 2 * B * T].reshape(B, T)
        alf = host[n_x + 2 * B * T:].reshape(B, T)
        pol[:] = 1.0
        for b, (snap, reqs) in enumerate(group):
            t_b, n_b = snap.n_learners, len(reqs)
            sp = snap.stump_params.numpy()                   # (t_b, 4)
            x = np.stack([r.x for r in reqs])                # (n_b, F)
            feat = sp[:, 0].astype(np.int64)
            xsel[b, :t_b, :n_b] = x[:, feat].T               # (t_b, n_b)
            thr[b, :t_b] = sp[:, 1]
            pol[b, :t_b] = sp[:, 2]
            alf[b, :t_b] = snap.alphas.numpy()
        dev = torch.from_numpy(host).to(self.device)
        return (dev[:n_x].view(B, T, N),
                dev[n_x:n_x + B * T].view(B, T),
                dev[n_x + B * T:n_x + 2 * B * T].view(B, T),
                dev[n_x + 2 * B * T:].view(B, T))

    def _eval_stumps(self, group, margins: Dict[int, float]) -> None:
        xsel, thr, pol, alf = self._pack_stumps(group)
        self.kernel_launches += 1
        out = kops.stump_vote_batched(xsel, thr, pol, alf).cpu().numpy()
        for b, (_, reqs) in enumerate(group):
            for n, r in enumerate(reqs):
                margins[r.rid] = float(out[b, n])

    def _eval_stumps_fused(self, group, margins: Dict[int, float]) -> None:
        """One-launch path: the kernel emits margins *and* the cache key.

        Every request is packed (no pre-lookup — that would need a host
        hash); the fingerprint the kernel computed then answers hits from
        prior batches and fills misses.  A cached margin is bit-identical
        to the freshly computed one (padded slots are exact zeros), so
        serving the cache value on a hit keeps replay batches byte-stable."""
        xsel, thr, pol, alf = self._pack_stumps(group)
        self.kernel_launches += 1
        out, f0, f1 = kops.stump_vote_fp_batched(xsel, thr, pol, alf)
        out = out.cpu().numpy()
        f0 = f0.cpu().numpy().view(np.uint32)       # the lanes' uint32 bits
        f1 = f1.cpu().numpy().view(np.uint32)
        for b, (snap, reqs) in enumerate(group):
            tenant, version = snap.tenant, snap.version
            for n, r in enumerate(reqs):
                key = fingerprint_key(f0[b, n], f1[b, n])
                hit = self.cache.lookup(tenant, version, key)
                if hit is not None:             # prior batch or in-batch dup
                    self._fp_hits += 1
                    margins[r.rid] = hit
                else:
                    margins[r.rid] = float(out[b, n])
                    self.cache.put(tenant, version, key, margins[r.rid])

    # --------------------------------------------------------- generic path
    def _learners_on_device(self, snap: EnsembleSnapshot) -> list:
        """The snapshot's learners on the evaluator's device: one copy per
        parameter name (the learners stacked), kept until the tenant's next
        version, and per-learner views into the stacks."""
        held = self._device_learners.get(snap.tenant)
        if held is not None and held[0] is snap:
            return held[1]
        stacks = {k: torch.stack([p[k] for p in snap.learners]).to(
            self.device) for k in snap.learners[0]}
        learners = [{k: v[t] for k, v in stacks.items()}
                    for t in range(snap.n_learners)]
        self._device_learners[snap.tenant] = (snap, learners)
        return learners

    def _eval_generic(self, group, margins: Dict[int, float]) -> None:
        """Per-learner predicts build the (B, T, N) margin stack on the
        device (zero rows and columns pad it), then one
        ``ensemble_vote_batched`` launch takes every tenant's vote."""
        B = len(group)
        T = max(s.n_learners for s, _ in group)
        N = max(len(reqs) for _, reqs in group)
        m = torch.zeros((B, T, N), dtype=torch.float32, device=self.device)
        alf = np.zeros((B, T), np.float32)
        for b, (snap, reqs) in enumerate(group):
            predict = get_weak_learner(snap.weak_name).predict
            x = torch.from_numpy(np.stack(
                [np.asarray(r.x, np.float32) for r in reqs])).to(self.device)
            m[b, :snap.n_learners, :len(reqs)] = torch.stack(
                [predict(p, x) for p in self._learners_on_device(snap)])
            alf[b, :snap.n_learners] = snap.alphas.numpy()
        self.kernel_launches += 1
        out = kops.ensemble_vote_batched(
            m, torch.from_numpy(alf).to(self.device)).cpu().numpy()
        for b, (_, reqs) in enumerate(group):
            for n, r in enumerate(reqs):
                margins[r.rid] = float(out[b, n])
