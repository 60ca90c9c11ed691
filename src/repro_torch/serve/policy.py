"""Per-(tenant, host) serving policies with fleet-wide defaults.

One sharded fleet serves tenants with very different traffic shapes: a hot
dashboard tenant wants deep queues and big batches (throughput), a cold
alerting tenant wants minimum-latency single-request dispatch, and one
tenant may be pinned to the plain PyTorch version while the rest take the
CUDA kernels.  :class:`PolicyTable` resolves both knob sets per
``(tenant, host)``:

* the :class:`~repro_torch.serve.batching.BatchConfig` (queue budget,
  batch cap, window controller constants, cache capacity), and
* the :class:`~repro_torch.kernels.dispatch.KernelPolicy` driving backend
  dispatch for that tenant's vote kernels.

Resolution layers partial overrides, least to most specific::

    fleet default  <  host override  <  tenant override  <  (tenant, host)

Batch overrides are *field-wise* merges onto the default ``BatchConfig``
(a tenant that only sets ``queue_budget`` inherits everything else), so
the table stays sparse.  Tenant and pair scopes accept only the knobs a
request actually resolves per tenant — ``queue_budget``/``max_batch``
(plus a kernel policy); window/cache/controller fields are host-server
state and are rejected there rather than silently ignored.  Kernel
resolution returns the most specific non-``None`` policy.
``batch_for``/``kernel_for`` are memoized per ``(tenant, host)`` — they
sit on the per-request admission path.

The JSON form (``--policy-table`` of ``launch/serve_ensemble.py``) is the
JAX package's, so one file serves both packages::

    {"default":        {"max_batch": 64},
     "default_kernel": {"backend": "cuda"},
     "hosts":   {"host-0": {"batch": {"queue_budget": 1024}}},
     "tenants": {"iot":    {"batch": {"max_batch": 128},
                            "kernel": {"backend": "torch"}}},
     "pairs":   {"iot@host-0": {"batch": {"max_batch": 32}}}}

``kernel`` specs take ``backend`` (``torch`` or ``cuda``, or one of the
JAX package's names through the dispatcher's aliases: ``xla`` is
``torch``, ``mosaic`` is ``cuda``) and/or ``calibration`` (a table written
by :meth:`KernelPolicy.save`), plus the optional boolean
``fused_fingerprint`` opting the tenant into the one-launch
``stump_vote_fp_batched`` serving path (kernel-computed cache keys, no
host-side feature hashing).
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from pathlib import Path
from typing import Dict, Optional, Tuple

from repro_torch.kernels.dispatch import KernelPolicy
from repro_torch.serve.batching import BatchConfig

_BATCH_FIELDS = {f.name for f in dataclasses.fields(BatchConfig)}
# the only BatchConfig knobs consulted per (tenant, host) request — the
# rest (window controller, cache, admission total) are host-server state
_PER_TENANT_FIELDS = {"queue_budget", "max_batch"}
_PAIR_SEP = "@"                 # "tenant@host" keys in the JSON form


def _checked(batch: Dict, scope: str = "host") -> Dict:
    unknown = sorted(set(batch) - _BATCH_FIELDS)
    if unknown:
        raise ValueError(f"unknown BatchConfig field(s) {unknown}; "
                         f"choose from {sorted(_BATCH_FIELDS)}")
    if "scheduler" in batch:
        raise ValueError("the eq.-(1) scheduler constants are fleet-wide; "
                         "override target_p99_s/adapt_every instead")
    if scope != "host":
        host_only = sorted(set(batch) - _PER_TENANT_FIELDS)
        if host_only:
            raise ValueError(
                f"{host_only} only take effect at host/default scope "
                f"(per-tenant resolution consults "
                f"{sorted(_PER_TENANT_FIELDS)}); refusing a silently "
                f"ignored override at {scope} scope")
    return dict(batch)


def _kernel_from_spec(spec: Optional[Dict]) -> Optional[KernelPolicy]:
    if spec is None:
        return None
    extra = sorted(set(spec) - {"backend", "calibration", "fused_fingerprint"})
    if extra:
        raise ValueError(f"unknown kernel-policy key(s) {extra}")
    fused = bool(spec.get("fused_fingerprint", False))
    if not fused and not any(spec.get(k) for k in ("backend", "calibration")):
        # an empty spec would masquerade as "the most specific layer" and
        # silently mask broader pins — reject it like any no-op override
        raise ValueError("kernel spec needs 'backend', 'calibration' and/or "
                         "'fused_fingerprint' (omit the key entirely to "
                         "inherit)")
    if spec.get("calibration"):
        policy = KernelPolicy.load(spec["calibration"])
        policy.fused_fingerprint = fused
        if spec.get("backend"):
            policy = KernelPolicy(backend=spec["backend"], table=policy.table,
                                  fused_fingerprint=fused)
        return policy
    return KernelPolicy(backend=spec.get("backend"), fused_fingerprint=fused)


class PolicyTable:
    """Layered ``(tenant, host) -> (BatchConfig, KernelPolicy)`` resolver."""

    def __init__(self, default: Optional[BatchConfig] = None,
                 default_kernel: Optional[KernelPolicy] = None):
        self.default = default or BatchConfig()
        self.default_kernel = default_kernel
        # scope -> key -> (batch field overrides, kernel policy or None)
        self._hosts: Dict[str, Tuple[Dict, Optional[KernelPolicy]]] = {}
        self._tenants: Dict[str, Tuple[Dict, Optional[KernelPolicy]]] = {}
        self._pairs: Dict[Tuple[str, str],
                          Tuple[Dict, Optional[KernelPolicy]]] = {}
        self._batch_cache: Dict[Tuple[Optional[str], Optional[str]],
                                BatchConfig] = {}
        self._kernel_cache: Dict[Tuple[Optional[str], Optional[str]],
                                 Optional[KernelPolicy]] = {}

    def with_default(self, default: BatchConfig,
                     default_kernel: Optional[KernelPolicy] = None
                     ) -> "PolicyTable":
        """A copy of this table with a different fleet default — how an
        explicitly passed ``BatchConfig`` composes with a table: the
        explicit config becomes the base every override layers onto."""
        out = PolicyTable(default, default_kernel or self.default_kernel)
        out._hosts = dict(self._hosts)
        out._tenants = dict(self._tenants)
        out._pairs = dict(self._pairs)
        return out

    # -------------------------------------------------------------- writes
    def _invalidate(self) -> None:
        self._batch_cache.clear()
        self._kernel_cache.clear()

    def set_host(self, host: str, *,
                 kernel: Optional[KernelPolicy] = None, **batch) -> None:
        self._hosts[host] = (_checked(batch), kernel)
        self._invalidate()

    def set_tenant(self, tenant: str, *,
                   kernel: Optional[KernelPolicy] = None, **batch) -> None:
        self._tenants[tenant] = (_checked(batch, "tenant"), kernel)
        self._invalidate()

    def set_pair(self, tenant: str, host: str, *,
                 kernel: Optional[KernelPolicy] = None, **batch) -> None:
        self._pairs[(tenant, host)] = (_checked(batch, "pair"), kernel)
        self._invalidate()

    # ------------------------------------------------------------- resolve
    def _layers(self, tenant: Optional[str], host: Optional[str]):
        """Applicable (batch, kernel) layers, least to most specific."""
        out = []
        if host is not None and host in self._hosts:
            out.append(self._hosts[host])
        if tenant is not None and tenant in self._tenants:
            out.append(self._tenants[tenant])
        if (tenant is not None and host is not None
                and (tenant, host) in self._pairs):
            out.append(self._pairs[(tenant, host)])
        return out

    def batch_for(self, tenant: Optional[str] = None,
                  host: Optional[str] = None) -> BatchConfig:
        """Effective BatchConfig for one scope (``None`` = any).  Host-level
        knobs (window controller, host queue budget) resolve with
        ``tenant=None``; per-request admission resolves the full pair."""
        key = (tenant, host)
        hit = self._batch_cache.get(key)
        if hit is None:
            merged: Dict = {}
            for batch, _ in self._layers(tenant, host):
                merged.update(batch)
            hit = (dataclasses.replace(self.default, **merged) if merged
                   else self.default)
            self._batch_cache[key] = hit
        return hit

    def kernel_for(self, tenant: Optional[str] = None,
                   host: Optional[str] = None) -> Optional[KernelPolicy]:
        """Most specific kernel policy for the scope, or the fleet default
        (which may be ``None`` — the caller's own policy then applies)."""
        key = (tenant, host)
        if key not in self._kernel_cache:
            hit = self.default_kernel
            for _, kernel in reversed(self._layers(tenant, host)):
                if kernel is not None:
                    hit = kernel
                    break
            self._kernel_cache[key] = hit
        return self._kernel_cache[key]

    # ---------------------------------------------------------------- JSON
    @staticmethod
    def _spec_pair(spec: Dict) -> Tuple[Dict, Optional[KernelPolicy]]:
        extra = sorted(set(spec) - {"batch", "kernel"})
        if extra:
            raise ValueError(f"unknown policy-entry key(s) {extra}; "
                             "expected 'batch' and/or 'kernel'")
        return _checked(spec.get("batch", {})), _kernel_from_spec(
            spec.get("kernel"))

    @classmethod
    def load(cls, path) -> "PolicyTable":
        raw = json.loads(Path(path).read_text())
        default = BatchConfig(**_checked(raw.get("default", {})))
        table = cls(default, _kernel_from_spec(raw.get("default_kernel")))
        for host, spec in raw.get("hosts", {}).items():
            batch, kernel = cls._spec_pair(spec)
            table.set_host(host, kernel=kernel, **batch)
        for tenant, spec in raw.get("tenants", {}).items():
            batch, kernel = cls._spec_pair(spec)
            table.set_tenant(tenant, kernel=kernel, **batch)
        for pair, spec in raw.get("pairs", {}).items():
            tenant, sep, host = pair.partition(_PAIR_SEP)
            if not sep or not tenant or not host:
                raise ValueError(f"pair key {pair!r} must be 'tenant@host'")
            batch, kernel = cls._spec_pair(spec)
            table.set_pair(tenant, host, kernel=kernel, **batch)
        return table

    def save(self, path) -> None:
        base = BatchConfig()
        if self.default.scheduler != base.scheduler:
            warnings.warn(
                "PolicyTable.save: the default BatchConfig carries "
                "non-default eq.-(1) scheduler constants, which the JSON "
                "form does not serialize — a reloaded table runs the "
                "stock SERVE_SCHEDULER window controller",
                RuntimeWarning, stacklevel=2)

        def diff(cfg: BatchConfig) -> Dict:
            return {f: getattr(cfg, f) for f in _BATCH_FIELDS
                    if f != "scheduler"
                    and getattr(cfg, f) != getattr(base, f)}

        def spec(batch: Dict, kernel: Optional[KernelPolicy]) -> Dict:
            out: Dict = {}
            if batch:
                out["batch"] = batch
            if kernel is not None:
                if kernel.table:
                    # a calibration table has no stable path to point back
                    # at; only the backend pin survives a save/load cycle
                    warnings.warn(
                        "PolicyTable.save: kernel policy carries a "
                        "calibration table, which is not serialized — "
                        "only the backend pin is kept; re-point the "
                        "'calibration' key at the table's JSON instead",
                        RuntimeWarning, stacklevel=3)
                kspec: Dict = {}
                if kernel.backend is not None:
                    kspec["backend"] = kernel.backend
                if getattr(kernel, "fused_fingerprint", False):
                    kspec["fused_fingerprint"] = True
                if kspec:
                    out["kernel"] = kspec
            return out

        doc: Dict = {"default": diff(self.default)}
        default_spec = spec({}, self.default_kernel)
        if "kernel" in default_spec:
            doc["default_kernel"] = default_spec["kernel"]
        doc["hosts"] = {h: spec(b, k) for h, (b, k) in self._hosts.items()}
        doc["tenants"] = {t: spec(b, k)
                          for t, (b, k) in self._tenants.items()}
        doc["pairs"] = {f"{t}{_PAIR_SEP}{h}": spec(b, k)
                        for (t, h), (b, k) in self._pairs.items()}
        Path(path).write_text(json.dumps(doc, indent=2, sort_keys=True))
