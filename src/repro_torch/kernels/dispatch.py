"""Kernel-backend dispatch with shape-bucketed calibration.

Every public kernel entry point in :mod:`repro_torch.kernels.ops` routes
through :func:`dispatch`.  Two backends implement the same numerical
contract:

* ``torch`` — the plain PyTorch versions in :mod:`repro_torch.kernels.ref`,
  run on whatever device the call's tensors lie on.  Always available.
* ``cuda``  — the hand-written kernels (``csrc/*.cu``) behind the launch
  code in :mod:`repro_torch.kernels.ops`, built at first use.  Available
  exactly when the call's tensors lie on a CUDA device.

A call's device is the one device its tensors lie on (inputs on several
devices raise).  Backend choice is re-resolved on *every* call, in
priority order::

    explicit ``backend=`` argument
    > ``KernelPolicy(backend=...)`` forced policy
    > the ``REPRO_TORCH_KERNEL_BACKEND`` environment variable
    > the policy's calibration table (per (kernel, shape-bucket) winner)
    > platform default ("cuda" for CUDA tensors, "torch" for CPU tensors)

The variable is not the JAX package's ``REPRO_KERNEL_BACKEND``: a process
may import both packages, and each reads its own.  A candidate that is
unavailable for the call (``cuda`` asked for on CPU tensors) falls through
to the next priority with a one-shot RuntimeWarning.  That is the only
fall-through: a ``cuda`` kernel that fails to build or launch raises.

Backend names take the JAX package's aliases, so a policy table or
calibration table written for it loads here with each pin keeping its
role: ``xla``, ``ref``, ``jnp``, ``fallback`` and ``plain`` name the
oracle (``torch``); ``mosaic``, ``pallas_mosaic``, ``tpu`` and ``gpu`` name
the kernel (``cuda``).  ``interpret`` and ``pallas`` pin an interpreter,
which has no meaning here, and are refused like an unknown name.

Shapes are bucketed as the JAX package buckets them: each dimension
rounded up to the block boundary its padded Pallas call would use under
the reference layout (``DEFAULT_LAYOUTS``), so a table written by either
package names the same buckets.  Neither backend here has a block layout:
the CUDA kernels pick their split from the shape and the card's SM count
(``ops.scan_split``, ``ops.dist_split``), so both behave like the JAX
package's ``xla`` backend.  :meth:`KernelPolicy.calibrate_call` measures
each available backend once, with the empty layout;
:func:`_with_layout` records in ``layout_choices`` the layout the JAX
package would launch with and strips the layout kwargs before the backend
runs; a loaded table's layouts are kept and saved back, and never reach a
kernel.  ``save``/``load`` persist the table to JSON (schema v2; v1
backend-only tables load with empty layouts; default
``artifacts/torch_backend_calibration.json``).

Under :func:`repro_torch.obs.profiling_enabled`, :func:`dispatch` also
records a ``kernel.<name>`` span, ``kernel.launches``, ``kernel.compile_s``
for the first launch of a (kernel, bucket, backend) (which holds the
``nvcc`` build at first use) and ``kernel.wall_s`` after that, with the
card synchronized before and after the timed call.  Off that path nothing
synchronizes.
"""
from __future__ import annotations

import functools
import json
import os
import statistics
import time
import warnings
from pathlib import Path
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch

from repro_torch import obs
from repro_torch.kernels import ref

ENV_VAR = "REPRO_TORCH_KERNEL_BACKEND"
# the JAX package's variable: a table it wrote names it, and the port reads
# its own in its place
REFERENCE_ENV_VAR = "REPRO_KERNEL_BACKEND"
DEFAULT_CALIBRATION_PATH = "artifacts/torch_backend_calibration.json"
CALIBRATION_SCHEMA_VERSION = 2

# (measured_on, running_on) pairs already warned about: the cross-platform
# calibration warning fires once per process per pair
_PLATFORM_WARNED: set = set()

Bucket = Tuple[int, ...]
Layout = Dict[str, int]                 # block-shape kwargs of one launch
LayoutKey = Tuple[Tuple[str, int], ...]  # canonical (sorted items) form

# The JAX package's block-shape kwargs.  The ops wrappers take them (None by
# default) so that its callers' code runs here; they reach no kernel.
LAYOUT_KWARGS = ("block_t", "block_n", "block_q", "block_k")

# The JAX package's reference layouts: buckets are computed against them.
DEFAULT_LAYOUTS: Dict[str, Layout] = {
    "stump_scan": {"block_n": 256},
    "stump_scan_batched": {"block_n": 256},
    "ensemble_vote": {"block_t": 128, "block_n": 512},
    "ensemble_vote_batched": {"block_t": 128, "block_n": 512},
    "stump_vote_batched": {"block_t": 128, "block_n": 512},
    "stump_vote_fp_batched": {"block_t": 128, "block_n": 512},
    "flash_attention": {"block_q": 128, "block_k": 128},
    "dist_update": {"block_n": 1024},
}


def layout_key(layout) -> LayoutKey:
    """Canonical hashable form of a layout (dict or item tuple -> sorted
    ``((kwarg, int), ...)``)."""
    if not layout:
        return ()
    items = layout.items() if isinstance(layout, dict) else layout
    return tuple(sorted((str(k), int(v)) for k, v in items))


class CalEntry(NamedTuple):
    """One calibration-table value: the winning backend and its layout."""
    backend: str
    layout: LayoutKey = ()


def _entry(value) -> CalEntry:
    """Normalize a calibration-table value to :class:`CalEntry`: a bare
    backend name (the v1 form), a CalEntry, a ``(backend, layout)`` pair or
    a ``{"backend": ..., "layout": ...}`` dict."""
    if isinstance(value, CalEntry):
        return CalEntry(canonical(value.backend), layout_key(value.layout))
    if isinstance(value, str):
        return CalEntry(canonical(value))
    if isinstance(value, dict):
        return CalEntry(canonical(value["backend"]),
                        layout_key(value.get("layout")))
    backend, layout = value
    return CalEntry(canonical(backend), layout_key(layout))


# ---------------------------------------------------------------------------
# shape helpers and buckets (the JAX package's, so that both name the same
# bucket for the same shapes)
# ---------------------------------------------------------------------------

def ceil_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def next_pow2(n: int) -> int:
    return 1 << (max(int(n), 1) - 1).bit_length()


def vote_blocks(T: int, N: int, block_t: int, block_n: int) -> Tuple[int, int]:
    """The JAX package's effective (block_t, block_n) for the vote kernels:
    the next power of two covering the problem, capped at the layout."""
    bt = min(block_t, max(8, next_pow2(T)))
    bn = min(block_n, max(128, next_pow2(N)))
    return bt, bn


def _largest_divisor_leq(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= ``cap`` (>= 1)."""
    for d in range(min(int(cap), int(n)), 0, -1):
        if n % d == 0:
            return d
    return 1


def _flash_blocks(T: int, block_q: int, block_k: int) -> Tuple[int, int]:
    return (_largest_divisor_leq(T, block_q), _largest_divisor_leq(T, block_k))


# The bucketers key an lru_cache on the shapes (a torch.Size is a tuple): a
# bucket is a pure function of them, and the dispatcher needs one on every
# launch.
@functools.lru_cache(maxsize=4096)
def _scan_bucket(x_shape, thr_shape) -> Bucket:
    N, F = x_shape
    return (ceil_to(N, 256), ceil_to(F, 8), ceil_to(thr_shape[1], 8))


@functools.lru_cache(maxsize=4096)
def _scan_batched_bucket(x_shape, thr_shape) -> Bucket:
    B, N, F = x_shape
    bn = min(256, max(8, next_pow2(N)))
    return (next_pow2(B), ceil_to(N, bn), ceil_to(F, 8),
            ceil_to(thr_shape[2], 8))


@functools.lru_cache(maxsize=4096)
def _vote_bucket(m_shape) -> Bucket:
    T, N = m_shape
    bt, bn = vote_blocks(T, N, 128, 512)
    return (ceil_to(T, bt), ceil_to(N, bn))


@functools.lru_cache(maxsize=4096)
def _vote_batched_bucket(m_shape) -> Bucket:
    B, T, N = m_shape
    bt, bn = vote_blocks(T, N, 128, 512)
    return (next_pow2(B), ceil_to(T, bt), ceil_to(N, bn))


@functools.lru_cache(maxsize=4096)
def _flash_bucket(q_shape) -> Bucket:
    B, H, T, d = q_shape
    bq, _bk = _flash_blocks(T, 128, 128)
    return (next_pow2(B * H), ceil_to(T, bq), ceil_to(d, 128))


@functools.lru_cache(maxsize=4096)
def _dist_bucket(d_shape) -> Bucket:
    N = d_shape[0]
    bn = min(1024, max(256, next_pow2(N)))
    return (ceil_to(N, bn),)


def _bucket_stump_scan(x, y, w, thresholds, **_):
    return _scan_bucket(x.shape, thresholds.shape)


def _bucket_stump_scan_batched(x, y, w, thresholds, **_):
    return _scan_batched_bucket(x.shape, thresholds.shape)


def _bucket_ensemble_vote(margins, alphas, **_):
    return _vote_bucket(margins.shape)


def _bucket_vote_batched(margins, alphas, **_):
    return _vote_batched_bucket(margins.shape)


def _bucket_stump_vote_batched(xsel, thr, pol, alphas, **_):
    return _vote_batched_bucket(xsel.shape)


def _bucket_flash_attention(q, k, v, **_):
    return _flash_bucket(q.shape)


def _bucket_dist_update(alpha, D, y, h, **_):
    return _dist_bucket(D.shape)


_BUCKETERS: Dict[str, Callable[..., Bucket]] = {
    "stump_scan": _bucket_stump_scan,
    "stump_scan_batched": _bucket_stump_scan_batched,
    "ensemble_vote": _bucket_ensemble_vote,
    "ensemble_vote_batched": _bucket_vote_batched,
    "stump_vote_batched": _bucket_stump_vote_batched,
    "stump_vote_fp_batched": _bucket_stump_vote_batched,
    "flash_attention": _bucket_flash_attention,
    "dist_update": _bucket_dist_update,
}


def bucket_of(kernel: str, args: Sequence, kwargs: Optional[dict] = None
              ) -> Bucket:
    """The shape bucket one call lowers to (the JAX package's padded kernel
    shape under its reference layout)."""
    return _BUCKETERS[kernel](*args, **(kwargs or {}))


def bucket_label(bucket: Bucket) -> str:
    """Render a shape bucket as a metrics label ("256x8x8")."""
    return "x".join(str(int(d)) for d in bucket)


def _one_device(tensors: Sequence[torch.Tensor]) -> torch.device:
    """The one device every tensor lies on; tensors on several raise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(
            f"kernel inputs span devices {sorted(map(str, devs))}")
    return devs.pop()


def _device_type(dev: torch.device) -> str:
    """``cpu`` or ``cuda``; another device type raises."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev.type


def tensors_device(tensors: Sequence[torch.Tensor]) -> str:
    """The type of the one device every tensor lies on, ``cpu`` or
    ``cuda``; tensors on several devices, or on another type, raise."""
    return _device_type(_one_device(tensors))


def call_device(kernel: str, args: Sequence, kwargs: Optional[dict] = None
                ) -> torch.device:
    """The one device of a call's tensors (``dist_update``'s alpha, a
    number or a one-element tensor anywhere, aside; ``flash_attention``'s
    ``out`` included); tensors on several devices raise."""
    tensors = args[1:] if kernel == "dist_update" else args
    out = kwargs.get("out") if kwargs else None
    return _one_device(tensors if out is None else (*tensors, out))


def platform() -> str:
    """This process's platform: ``cuda`` where a card is visible, else
    ``cpu`` (what a calibration table records as ``measured_on``)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------

def _torch_flash_attention(q, k, v, *, causal=True, out=None):
    res = ref.flash_attention_ref(q, k, v, causal=causal)
    return res if out is None else out.copy_(res)


_TORCH_IMPLS: Dict[str, Callable] = {
    "stump_scan": ref.stump_scan_ref,
    "stump_scan_batched": ref.stump_scan_batched_ref,
    "ensemble_vote": ref.ensemble_vote_ref,
    "ensemble_vote_batched": ref.ensemble_vote_batched_ref,
    "stump_vote_batched": ref.stump_vote_batched_ref,
    "stump_vote_fp_batched": ref.stump_vote_fp_batched_ref,
    "flash_attention": _torch_flash_attention,
    "dist_update": ref.dist_update_ref,
}

# kernel -> its launch code; filled by repro_torch.kernels.ops, which the
# package's __init__ imports, so it is filled before any call
CUDA_IMPLS: Dict[str, Callable] = {}


class TorchBackend:
    """The plain PyTorch versions, on the call's device: always there."""
    name = "torch"

    def available(self, device: str) -> bool:
        return True

    def run(self, kernel: str, *args, **kwargs):
        return _TORCH_IMPLS[kernel](*args, **kwargs)


class CudaBackend:
    """The hand-written CUDA kernels: CUDA tensors only."""
    name = "cuda"

    def available(self, device: str) -> bool:
        return device == "cuda"

    def run(self, kernel: str, *args, **kwargs):
        return CUDA_IMPLS[kernel](*args, **kwargs)


BACKENDS: Dict[str, object] = {b.name: b for b in (TorchBackend(),
                                                   CudaBackend())}

_ALIASES = {"xla": "torch", "ref": "torch", "jnp": "torch",
            "fallback": "torch", "plain": "torch",
            "mosaic": "cuda", "pallas_mosaic": "cuda", "tpu": "cuda",
            "gpu": "cuda"}


def canonical(name: str) -> str:
    key = str(name).strip().lower()
    key = _ALIASES.get(key, key)
    if key not in BACKENDS:
        raise KeyError(
            f"unknown kernel backend {name!r}: expected one of "
            f"{sorted(BACKENDS)} (or aliases {sorted(_ALIASES)})")
    return key


def platform_default(device: str = "cpu") -> str:
    """The backend a call on ``device`` tensors takes when nothing pins
    one: the kernel on the card, the plain version elsewhere."""
    return "cuda" if device == "cuda" else "torch"


def available_backends(device: Optional[str] = None) -> List[str]:
    """Backends available for ``device`` tensors (default: the
    platform's)."""
    device = platform() if device is None else device
    return [n for n, b in sorted(BACKENDS.items()) if b.available(device)]


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------

class KernelPolicy:
    """Per-call backend selection with a shape-bucketed calibration table.

    ``backend=`` forces one backend policy-wide (still subject to
    availability).  ``table`` maps ``(kernel, bucket) -> CalEntry`` (bare
    backend names are accepted and normalized) — filled by
    :meth:`calibrate_call` or loaded from JSON.  Resolution consults, in
    order: the per-call explicit argument, the forced ``backend``, the
    ``env_var`` environment variable (read on every call), the calibration
    table, then the platform default of the call's device.

    ``fused_fingerprint`` opts a serving tenant into the one-launch
    ``stump_vote_fp_batched`` path (``serve/engine.py``); the dispatcher
    itself ignores it.

    ``choices`` records the backend dispatched per (kernel, bucket) and
    ``layout_choices`` the JAX package's layout for it; the dispatch cache
    is keyed on every resolution input (the live env value and the call's
    device type included), so a repeated same-bucket call skips
    re-resolution without ever pinning a stale choice.
    """

    def __init__(self, backend: Optional[str] = None,
                 table: Optional[Dict[Tuple[str, Bucket], object]] = None,
                 env_var: Optional[str] = ENV_VAR,
                 fused_fingerprint: bool = False):
        self.backend = canonical(backend) if backend is not None else None
        self.table: Dict[Tuple[str, Bucket], CalEntry] = {}
        for (kern, bucket), value in (table or {}).items():
            self.table[(kern, tuple(bucket))] = _entry(value)
        self.env_var = env_var
        self.fused_fingerprint = bool(fused_fingerprint)
        self.choices: Dict[Tuple[str, Bucket], str] = {}
        self.layout_choices: Dict[Tuple[str, Bucket], Layout] = {}
        self.cache_hits = 0
        self._cache: Dict[tuple, object] = {}
        self._warned: set = set()
        # platform the loaded calibration table was measured on (None for
        # in-process tables; set by load())
        self.measured_on: Optional[str] = None

    # ------------------------------------------------------------ resolve
    def _env_backend(self) -> Optional[str]:
        if not self.env_var:
            return None
        return os.environ.get(self.env_var) or None

    def resolve_name(self, kernel: str, bucket: Bucket, *,
                     explicit: Optional[str] = None,
                     device: Optional[str] = None) -> str:
        """Backend name for one (kernel, bucket) call on ``device`` tensors
        (default: the platform's), skipping candidates that are
        unavailable there."""
        device = platform() if device is None else device
        entry = self.table.get((kernel, tuple(bucket)))
        for cand in (explicit, self.backend, self._env_backend(),
                     entry.backend if entry is not None else None):
            if cand is None:
                continue
            name = canonical(cand)
            if BACKENDS[name].available(device):
                return name
            if name not in self._warned:
                self._warned.add(name)
                warnings.warn(
                    f"kernel backend '{name}' is unavailable for "
                    f"'{device}' tensors; falling back",
                    RuntimeWarning, stacklevel=3)
        return platform_default(device)

    def resolve(self, kernel: str, bucket: Bucket, *,
                explicit: Optional[str] = None,
                device: Optional[str] = None):
        """Backend object for one call, via the dispatch cache."""
        device = platform() if device is None else device
        return self._plan(kernel, tuple(bucket), explicit, device)[0]

    def _plan(self, kernel: str, bucket: Bucket, explicit: Optional[str],
              device) -> Tuple[object, Layout]:
        """``(backend, the JAX package's layout)`` for one call on
        ``device`` (a device type or a ``torch.device``), via the dispatch
        cache, recording the choice.  The key holds every resolution input
        — the live env value and the call's device too — so neither an env
        change nor a call on another device is masked by a cached
        choice."""
        key = (kernel, bucket, explicit, self.backend, self._env_backend(),
               device)
        hit = self._cache.get(key)
        if hit is None:
            if not isinstance(device, str):
                device = _device_type(device)
            be = BACKENDS[self.resolve_name(kernel, bucket,
                                            explicit=explicit,
                                            device=device)]
            layout = dict(DEFAULT_LAYOUTS.get(kernel, {}))
            layout.update(self.layout_for(kernel, bucket, be.name))
            hit = self._cache[key] = (be, layout)
        else:
            self.cache_hits += 1
        self.choices[(kernel, bucket)] = hit[0].name
        return hit

    # ------------------------------------------------------------- layout
    def layout_for(self, kernel: str, bucket: Bucket, backend: str
                   ) -> Layout:
        """The table's layout for one (kernel, bucket), where its winner is
        the backend resolved (recorded, never launched: see the module
        docstring)."""
        entry = self.table.get((kernel, tuple(bucket)))
        if entry is not None and entry.backend == backend and entry.layout:
            return dict(entry.layout)
        return {}

    # -------------------------------------------------------- calibration
    def record(self, kernel: str, bucket: Bucket, backend: str,
               layout: Optional[Layout] = None) -> None:
        self.table[(kernel, tuple(bucket))] = CalEntry(canonical(backend),
                                                       layout_key(layout))
        self._cache.clear()

    def calibrate_call(self, kernel: str, *args, reps: int = 5,
                       backends: Optional[Sequence[str]] = None, **kwargs
                       ) -> Tuple[Bucket, Dict[Tuple[str, LayoutKey],
                                               List[float]]]:
        """Time every backend available for the call's device (one warm-up
        launch, which builds the kernels at first use, then ``reps`` timed
        launches, the card synchronized around each), record the median
        winner for the call's bucket, and return ``(bucket, {(backend, ()):
        [seconds]})``.  No backend has a block layout, so each is measured
        once, with the empty layout."""
        bucket = bucket_of(kernel, args, kwargs)
        base = {k: v for k, v in kwargs.items()
                if k not in LAYOUT_KWARGS and v is not None}
        device = _device_type(call_device(kernel, args, kwargs))
        sync = _sync_for(args)
        names = backends if backends is not None else sorted(BACKENDS)
        samples: Dict[Tuple[str, LayoutKey], List[float]] = {}
        for name in names:
            be = BACKENDS[canonical(name)]
            if not be.available(device):
                continue
            be.run(kernel, *args, **base)
            sync()
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                be.run(kernel, *args, **base)
                sync()
                ts.append(time.perf_counter() - t0)
            samples[(be.name, ())] = ts
        if not samples:
            raise ValueError(
                f"no backend to calibrate {kernel!r}: none of {list(names)} "
                f"is available for '{device}' tensors (available: "
                f"{available_backends(device)})")
        wname, wlayout = min(
            samples, key=lambda k: statistics.median(samples[k]))
        self.record(kernel, bucket, wname, dict(wlayout))
        return bucket, samples

    # -------------------------------------------------------- persistence
    def save(self, path: str = DEFAULT_CALIBRATION_PATH,
             measured_on: Optional[str] = None) -> str:
        """Persist the calibration table (JSON, schema v2: every entry
        carries its winning backend and layout, and the table records the
        platform it was measured on); returns the path written."""
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        data = {
            "version": CALIBRATION_SCHEMA_VERSION,
            "env_var": self.env_var,
            "backend": self.backend,
            "measured_on": (measured_on if measured_on is not None
                            else platform()),
            "table": [{"kernel": k, "bucket": list(b), "backend": e.backend,
                       "layout": dict(e.layout)}
                      for (k, b), e in sorted(self.table.items())],
        }
        p.write_text(json.dumps(data, indent=2) + "\n")
        return str(p)

    @classmethod
    def load(cls, path: str = DEFAULT_CALIBRATION_PATH) -> "KernelPolicy":
        """Load a persisted table, the JAX package's included (its backend
        names through the aliases, its env variable read as the port's).
        Schema v1 (backend-only entries, no ``version``) loads with empty
        layouts; a newer schema is refused.  A table measured on another
        platform warns once per process: its winners may not transfer."""
        data = json.loads(Path(path).read_text())
        version = int(data.get("version", 1))
        if version > CALIBRATION_SCHEMA_VERSION:
            raise ValueError(
                f"calibration table {path!r} has schema v{version}; this "
                f"build reads up to v{CALIBRATION_SCHEMA_VERSION}")
        measured_on = data.get("measured_on")
        here = platform()
        if (measured_on and measured_on != here and data.get("table")
                and (measured_on, here) not in _PLATFORM_WARNED):
            _PLATFORM_WARNED.add((measured_on, here))
            warnings.warn(
                f"calibration table {path!r} was measured on "
                f"'{measured_on}' but this process runs on '{here}'; its "
                f"winners may not transfer — calibrate again here "
                f"(KernelPolicy.calibrate_call) to re-measure",
                RuntimeWarning, stacklevel=2)
        env_var = data.get("env_var", ENV_VAR)
        pol = cls(backend=data.get("backend"),
                  table={(e["kernel"], tuple(e["bucket"])):
                         CalEntry(canonical(e["backend"]),
                                  layout_key(e.get("layout")))
                         for e in data.get("table", [])},
                  env_var=ENV_VAR if env_var == REFERENCE_ENV_VAR
                  else env_var)
        pol.measured_on = measured_on
        return pol


_DEFAULT_POLICY = KernelPolicy()


def default_policy() -> KernelPolicy:
    """The process-wide policy used when no ``policy=`` is passed."""
    return _DEFAULT_POLICY


def set_default_policy(policy: KernelPolicy) -> KernelPolicy:
    """Swap the process-wide default policy; returns the previous one."""
    global _DEFAULT_POLICY
    old, _DEFAULT_POLICY = _DEFAULT_POLICY, policy
    return old


# ---------------------------------------------------------------------------
# dispatch entry (the single funnel behind every ops.py wrapper)
# ---------------------------------------------------------------------------

def _sync_for(args: Sequence) -> Callable[[], None]:
    """A function that waits for the card of a call on CUDA tensors (a
    no-op for any other device)."""
    t = args[-1]
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        return lambda: torch.cuda.synchronize(t.device)
    return lambda: None


_LAYOUT_SET = frozenset(LAYOUT_KWARGS)


def _with_layout(kwargs: Optional[dict], layout: Layout
                 ) -> Tuple[dict, Layout]:
    """Split one call's kwargs: the rest, without any layout kwarg (no
    backend here takes one), and the layout the JAX package would launch
    it with — explicit caller kwargs over ``layout`` (the table's layout
    over ``DEFAULT_LAYOUTS``).  ``None`` layout kwargs (the ops wrappers'
    default) count as absent."""
    rest: dict = {}
    explicit = None
    for k, v in (kwargs or {}).items():
        if k not in _LAYOUT_SET:
            rest[k] = v
        elif v is not None:
            explicit = dict(layout) if explicit is None else explicit
            explicit[k] = int(v)
    return rest, (layout if explicit is None else explicit)


def dispatch(kernel: str, args: Sequence, kwargs: Optional[dict] = None, *,
             policy: Optional[KernelPolicy] = None,
             backend: Optional[str] = None):
    """Resolve a backend for this call and run it."""
    pol = policy if policy is not None else _DEFAULT_POLICY
    bucket = _BUCKETERS[kernel](*args)
    be, layout = pol._plan(kernel, bucket, backend,
                           call_device(kernel, args, kwargs))
    kwargs, layout = _with_layout(kwargs, layout)
    pol.layout_choices[(kernel, bucket)] = layout
    if not obs.profiling_enabled():
        return be.run(kernel, *args, **kwargs)
    # profiling path: timing a launch means waiting for the card, so this
    # runs only while obs profiling is switched on
    blabel = bucket_label(bucket)
    sync = _sync_for(args)
    with obs.span(f"kernel.{kernel}", backend=be.name, bucket=blabel):
        sync()
        t0 = time.perf_counter()
        out = be.run(kernel, *args, **kwargs)
        sync()
        dt = time.perf_counter() - t0
    reg = obs.get_registry()
    labels = dict(kernel=kernel, bucket=blabel, backend=be.name)
    # the first profiled launch of a (kernel, bucket, backend) pays the
    # build (nvcc at first use) inside the timed region — keep it out of
    # the steady-state wall_s histogram (calibration_check reads p50s)
    seen = getattr(reg, "_kernel_seen", None)
    if seen is None:
        seen = set()
        setattr(reg, "_kernel_seen", seen)
    first = (kernel, blabel, be.name) not in seen
    seen.add((kernel, blabel, be.name))
    reg.counter("kernel.launches", **labels).inc()
    if first:
        reg.histogram("kernel.compile_s", **labels).observe(dt)
    else:
        reg.histogram("kernel.wall_s", **labels).observe(dt)
    return out


def calibration_check(policy: Optional[KernelPolicy] = None,
                      registry=None, *, min_count: int = 5
                      ) -> List[Dict[str, object]]:
    """Check the calibration table against observed launch timings.

    For every (kernel, bucket) the policy has a calibrated winner for,
    compare the winner's observed p50 wall time (the ``kernel.wall_s``
    histograms profiled dispatches record; first launches land in
    ``kernel.compile_s``) against every other backend observed on the same
    bucket.  Backends with fewer than ``min_count`` observations are
    ignored.  Returns one flag dict per entry where a non-winner was
    measurably faster, with the per-backend observation ``counts``.
    Entries with no cross-backend observations are skipped."""
    pol = policy if policy is not None else _DEFAULT_POLICY
    reg = registry if registry is not None else obs.get_registry()
    min_count = max(1, int(min_count))
    observed: Dict[Tuple[str, str], Dict[str, object]] = {}
    for name, labels, h in reg.histograms():
        if name != "kernel.wall_s" or h.count < min_count:
            continue
        key = (labels.get("kernel", ""), labels.get("bucket", ""))
        observed.setdefault(key, {})[labels.get("backend", "")] = h
    flags: List[Dict[str, object]] = []
    for (kern, bucket), entry in sorted(pol.table.items()):
        winner = entry.backend
        hists = observed.get((kern, bucket_label(bucket)))
        if not hists or winner not in hists or len(hists) < 2:
            continue
        best = min(hists, key=lambda b: hists[b].p50)
        if best != winner and hists[best].p50 < hists[winner].p50:
            flags.append({
                "kernel": kern, "bucket": bucket_label(bucket),
                "calibrated": winner,
                "calibrated_p50_s": hists[winner].p50,
                "observed_best": best,
                "observed_best_p50_s": hists[best].p50,
                "counts": {b: hists[b].count for b in sorted(hists)},
            })
    return flags
