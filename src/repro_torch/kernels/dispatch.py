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
package names the same buckets.

Calibration is a layout autotune, as in the JAX package, over the port's
own launch knobs.  The CUDA kernels pick their launch from the shape and
the card's SM count (``ops.scan_split``, ``ops.dist_split``, the
launchers in ``csrc/``); ``LAYOUT_GRIDS`` lists, for each kernel, the
launches a caller may ask for instead, as knobs (``CUDA_LAYOUT_KWARGS``:
the scan's block width ``cols`` and ``blocks`` a column group, the
batched scan's ``threads`` and row ``depth``, the votes' ``deep`` loads,
the stump votes' ``tile_c`` and ``groups``, ``dist_update``'s ``cluster``
route and ``threads``, flash's ``stages``).  Each grid
starts with ``{}``, the launcher's own choice; a knob a layout leaves out
keeps the launcher's choice given the others.  Knob names never meet the
JAX package's block-shape kwargs (``LAYOUT_KWARGS``), so a Pallas layout
read from one of its tables is never taken for a CUDA one.
:meth:`KernelPolicy.calibrate_call` times the ``cuda`` backend over the
kernel's grid (or ``layouts=``, a part of it), skipping a member that
cannot run the call's bucket (``layout_applies``), and ``torch`` once with
``{}``; it records the median winner as ``CalEntry(backend, layout)``,
where a member displaces ``{}`` only by beating it by more than the spread
of ``{}``'s own reps (on the host clock, small kernels differ by less than
the launch's noise).
:func:`dispatch` splits a call's kwargs three ways: the JAX package's
layout kwargs, stripped and recorded in ``layout_choices`` as the layout
it would launch with; the CUDA knobs; the rest.  The CUDA layout of a
launch is the caller's explicit knobs over the table's layout (where the
entry's winner is the backend resolved and its layout a member of the
kernel's grid) over ``{}``, recorded in ``cuda_layout_choices``; the
``torch`` backend takes no knob, and a call that gives knobs and resolves
to it raises.  A layout the launcher cannot run is
refused with its CUDA error and raises; it is never replaced by the
launcher's own choice.  A JAX-written table's Pallas layouts are kept and
saved back, and never reach a kernel; an entry that mixes the two kinds
of key is refused.  ``save``/``load`` persist the table to JSON (schema
v2; v1 backend-only tables load with empty layouts; default
``artifacts/torch_backend_calibration.json``).

While :func:`repro_torch.obs.active` (a tracer installed or a torch
profiler running), :func:`dispatch` opens a ``kernel.<name>`` span at its
entry, around the bucketer, the plan, the layout split and the launch,
timed on the current CUDA stream where a tracer is installed and the
call's tensors lie on a card, and counts ``kernel.launches``.  The first
call of a (kernel, bucket, backend) puts its host seconds (which hold the
``nvcc`` build at first use) into ``kernel.compile_s``; each later one
puts them into ``kernel.dispatch_s``, and its device seconds into
``kernel.device_s``: on a card once :func:`repro_torch.obs.resolve` has
read the span's events, on the CPU the host seconds (the call has run
when it returns).
Nothing on the path waits for the card; with neither on, a call costs
one check more than the launch.
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

# The port's launch knobs (see ops for what each one sets): names of their
# own, so that a layout is either the JAX package's or the port's.
CUDA_LAYOUT_KWARGS = ("cols", "blocks", "threads", "depth", "deep", "tile_c",
                      "groups", "cluster", "stages")

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

# The cuda backend's sweep grid per kernel: first the launcher's own
# choice, then at most six launches a caller may ask for, none of them
# naming a shape.  A member equal to the launcher's choice at some shape
# (a small problem, or a knob that is one dtype's own) just measures the
# same launch twice there.
_VOTE_GRID = [{}, {"deep": 0}, {"deep": 1}]
_STUMP_VOTE_GRID = [{}, {"tile_c": 1}, {"tile_c": 2}, {"tile_c": 4},
                    {"deep": 0}, {"deep": 1},
                    {"tile_c": 2, "deep": 1, "groups": 2}]
LAYOUT_GRIDS: Dict[str, List[Layout]] = {
    "stump_scan": [{}, {"cols": 1}, {"cols": 4}, {"cols": 16}, {"cols": 64},
                   {"cols": 8, "blocks": 16}, {"cols": 8, "blocks": 66}],
    "stump_scan_batched": [{}, {"threads": 32}, {"threads": 128},
                           {"threads": 256}, {"depth": 4},
                           {"threads": 256, "depth": 4}],
    "ensemble_vote": _VOTE_GRID,
    "ensemble_vote_batched": _VOTE_GRID,
    "stump_vote_batched": _STUMP_VOTE_GRID,
    "stump_vote_fp_batched": _STUMP_VOTE_GRID,
    "flash_attention": [{}, {"stages": 2}],
    "dist_update": [{}, {"cluster": 0}, {"cluster": 1}, {"threads": 256},
                    {"threads": 1024}, {"cluster": 0, "threads": 256}],
}


def layout_key(layout) -> LayoutKey:
    """Canonical hashable form of a layout (dict or item tuple -> sorted
    ``((kwarg, int), ...)``)."""
    if not layout:
        return ()
    items = layout.items() if isinstance(layout, dict) else layout
    return tuple(sorted((str(k), int(v)) for k, v in items))


def layout_label(layout) -> str:
    """Render a layout for logs ("cols=8,blocks=16"; "-" for ``{}``)."""
    items = layout if isinstance(layout, tuple) else layout_key(layout)
    return ",".join(f"{k}={v}" for k, v in items) or "-"


_LAYOUT_SET = frozenset(LAYOUT_KWARGS)
_CUDA_SET = frozenset(CUDA_LAYOUT_KWARGS)


def is_cuda_layout(layout) -> bool:
    """True for a non-empty layout of the port's knobs only; a layout that
    mixes them with other keys raises ValueError."""
    keys = {k for k, _ in layout_key(layout)}
    cuda = keys & _CUDA_SET
    if cuda and keys - _CUDA_SET:
        raise ValueError(f"layout {layout_label(layout)} mixes CUDA launch "
                         f"knobs {sorted(cuda)} with other keys "
                         f"{sorted(keys - _CUDA_SET)}")
    return bool(cuda)


def in_grid(kernel: str, layout) -> bool:
    """True where ``layout`` is a member of the kernel's cuda grid."""
    key = layout_key(layout)
    return any(layout_key(m) == key for m in LAYOUT_GRIDS.get(kernel, ()))


# kernel -> (bucket, layout) -> whether that grid member can run every
# shape of the bucket; filled by repro_torch.kernels.ops (a kernel absent
# here runs every member at every bucket)
CUDA_LAYOUT_APPLIES: Dict[str, Callable[[Bucket, Layout], bool]] = {}


def layout_applies(kernel: str, bucket: Bucket, layout) -> bool:
    """Whether the cuda launch ``layout`` can run every raw shape of
    ``bucket`` (decided on the bucket, so a winner recorded for it holds
    for each of them)."""
    check = CUDA_LAYOUT_APPLIES.get(kernel)
    return check is None or bool(check(tuple(bucket), dict(layout)))


class CalEntry(NamedTuple):
    """One calibration-table value: the winning backend and its layout."""
    backend: str
    layout: LayoutKey = ()


def _entry(value) -> CalEntry:
    """Normalize a calibration-table value to :class:`CalEntry`: a bare
    backend name (the v1 form), a CalEntry, a ``(backend, layout)`` pair or
    a ``{"backend": ..., "layout": ...}`` dict.  A layout that mixes the
    JAX package's keys with CUDA knobs raises ValueError."""
    if isinstance(value, str):
        return CalEntry(canonical(value))
    if isinstance(value, CalEntry):
        backend, layout = value
    elif isinstance(value, dict):
        backend, layout = value["backend"], value.get("layout")
    else:
        backend, layout = value
    is_cuda_layout(layout)                 # a mixed layout raises
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

    ``choices`` records the backend dispatched per (kernel, bucket),
    ``layout_choices`` the JAX package's layout for it and
    ``cuda_layout_choices`` the launch knobs it ran with (``{}``: the
    launcher's own choice; always ``{}`` on ``torch``).  The dispatch
    cache holds each plan's backend and both layouts and is keyed on every
    resolution input (the live env value and the call's device type
    included; :meth:`record` clears it), so a repeated same-bucket call
    skips re-resolution without ever pinning a stale choice.
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
        self.cuda_layout_choices: Dict[Tuple[str, Bucket], Layout] = {}
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
              device) -> Tuple[object, Layout, Layout]:
        """``(backend, the JAX package's layout, the table's CUDA layout)``
        for one call on ``device`` (a device type or a ``torch.device``),
        via the dispatch cache, recording the choice.  The key holds every
        resolution input — the live env value and the call's device too —
        so neither an env change nor a call on another device is masked by
        a cached choice."""
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
            hit = self._cache[key] = (
                be, layout, self.cuda_layout_for(kernel, bucket, be.name))
        else:
            self.cache_hits += 1
        self.choices[(kernel, bucket)] = hit[0].name
        return hit

    # ------------------------------------------------------------- layout
    def layout_for(self, kernel: str, bucket: Bucket, backend: str
                   ) -> Layout:
        """The table's JAX-package layout for one (kernel, bucket), where
        its winner is the backend resolved (recorded, never launched: see
        the module docstring)."""
        entry = self.table.get((kernel, tuple(bucket)))
        if (entry is not None and entry.backend == backend and entry.layout
                and not is_cuda_layout(entry.layout)):
            return dict(entry.layout)
        return {}

    def cuda_layout_for(self, kernel: str, bucket: Bucket, backend: str
                        ) -> Layout:
        """The table's CUDA launch layout for one (kernel, bucket): its
        layout where the winner is the backend resolved (not ``torch``)
        and the layout a member of the kernel's grid, else ``{}``.  A CUDA
        layout outside the grid warns once and is not launched."""
        entry = self.table.get((kernel, tuple(bucket)))
        if (backend == "torch" or entry is None or entry.backend != backend
                or not is_cuda_layout(entry.layout)):
            return {}
        if in_grid(kernel, entry.layout):
            return dict(entry.layout)
        if (kernel, entry.layout) not in self._warned:
            self._warned.add((kernel, entry.layout))
            warnings.warn(
                f"calibration table: {kernel} layout "
                f"{layout_label(entry.layout)} is not in LAYOUT_GRIDS; "
                f"launching the launcher's own choice (calibrate again)",
                RuntimeWarning, stacklevel=4)
        return {}

    # -------------------------------------------------------- calibration
    def record(self, kernel: str, bucket: Bucket, backend: str,
               layout: Optional[Layout] = None) -> None:
        self.table[(kernel, tuple(bucket))] = CalEntry(canonical(backend),
                                                       layout_key(layout))
        self._cache.clear()

    def calibrate_call(self, kernel: str, *args, reps: int = 5,
                       backends: Optional[Sequence[str]] = None,
                       layouts: Optional[Sequence[Layout]] = None, **kwargs
                       ) -> Tuple[Bucket, Dict[Tuple[str, LayoutKey],
                                               List[float]]]:
        """Time every backend available for the call's device over its
        layouts, record the ``(backend, layout)`` median winner for the
        call's bucket, and return ``(bucket, {(backend, layout_key):
        [seconds]})``.  Backend by backend, each layout takes one warm-up
        launch (which builds the kernels at first use); then each of
        ``reps`` rounds times one launch of every layout of the backend in
        turn, the card synchronized around each, so that a drift of either
        clock weighs on every layout alike (and no layout's launch follows
        the plain version's, whose host work slows the next launch).
        Within a backend a member wins over ``{}`` only where its median
        beats ``{}``'s by more than the spread (max - min) of ``{}``'s own
        reps: these are host times, and at a few microseconds of kernel the
        launch's noise would otherwise pick members the card runs no
        faster.

        ``torch`` has no launch layout and is measured once with ``{}``;
        another backend sweeps ``layouts`` (default: the kernel's
        ``LAYOUT_GRIDS`` entry; each must be a member of it), skipping, with
        a printed line, a member that cannot run the call's bucket
        (:func:`layout_applies`)."""
        bucket = bucket_of(kernel, args, kwargs)
        base = {k: v for k, v in kwargs.items()
                if k not in _LAYOUT_SET and k not in _CUDA_SET
                and v is not None}
        grid = LAYOUT_GRIDS.get(kernel, [{}])
        if layouts is not None:
            grid = [dict(lay) for lay in layouts]
            for lay in grid:
                if not in_grid(kernel, lay):
                    raise ValueError(
                        f"{kernel} layout {layout_label(lay)} is not in "
                        f"LAYOUT_GRIDS[{kernel!r}]")
        dev = call_device(kernel, args, kwargs)
        device = _device_type(dev)
        sync = ((lambda: torch.cuda.synchronize(dev)) if device == "cuda"
                else (lambda: None))
        names = backends if backends is not None else sorted(BACKENDS)
        samples: Dict[Tuple[str, LayoutKey], List[float]] = {}
        for name in names:
            be = BACKENDS[canonical(name)]
            if not be.available(device):
                continue
            runs = []                               # (layout key, kwargs)
            for layout in ([{}] if be.name == "torch" else grid):
                if not layout_applies(kernel, bucket, layout):
                    print(f"calibrate {kernel} bucket "
                          f"{bucket_label(bucket)}: {be.name} layout "
                          f"{layout_label(layout)} skipped (it cannot run "
                          f"this bucket)", flush=True)
                    continue
                call_kwargs = dict(base, **layout)
                be.run(kernel, *args, **call_kwargs)
                sync()
                runs.append((layout_key(layout), call_kwargs))
                samples[(be.name, layout_key(layout))] = []
            for _ in range(reps):
                for key, call_kwargs in runs:
                    t0 = time.perf_counter()
                    be.run(kernel, *args, **call_kwargs)
                    sync()
                    samples[(be.name, key)].append(time.perf_counter() - t0)
        if not samples:
            raise ValueError(
                f"no backend to calibrate {kernel!r}: none of {list(names)} "
                f"is available for '{device}' tensors (available: "
                f"{available_backends(device)})")
        med = {k: statistics.median(ts) for k, ts in samples.items()}
        best: Dict[str, LayoutKey] = {}
        for name, key in sorted(med, key=med.get):
            best.setdefault(name, key)
        for name, key in best.items():
            own = samples.get((name, ()))
            if key and own and med[(name, ())] - med[(name, key)] <= (
                    max(own) - min(own)):
                best[name] = ()
        wname = min(best, key=lambda n: med[(n, best[n])])
        self.record(kernel, bucket, wname, dict(best[wname]))
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
        layouts; a newer schema is refused, and so is an entry whose layout
        mixes the JAX package's keys with CUDA knobs (ValueError).  A table
        measured on another platform warns once per process: its winners
        may not transfer."""
        data = json.loads(Path(path).read_text())
        version = int(data.get("version", 1))
        if version > CALIBRATION_SCHEMA_VERSION:
            raise ValueError(
                f"calibration table {path!r} has schema v{version}; this "
                f"build reads up to v{CALIBRATION_SCHEMA_VERSION}")
        entries = {(e["kernel"], tuple(e["bucket"])):
                   _entry((e["backend"], e.get("layout")))
                   for e in data.get("table", [])}
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
        pol = cls(backend=data.get("backend"), table=entries,
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

def _with_layout(kwargs: Optional[dict], layout: Layout, cuda: Layout
                 ) -> Tuple[dict, Layout, Layout]:
    """Split one call's kwargs three ways: the rest; the layout the JAX
    package would launch it with, explicit caller kwargs over ``layout``
    (the table's layout over ``DEFAULT_LAYOUTS``), stripped (no backend
    here takes one); and the CUDA launch knobs, explicit caller knobs over
    ``cuda`` (the table's CUDA layout, or ``{}``).  ``None`` values (the
    ops wrappers' default) count as absent."""
    rest: dict = {}
    explicit = knobs = None
    for k, v in (kwargs or {}).items():
        if k in _LAYOUT_SET:
            if v is not None:
                explicit = dict(layout) if explicit is None else explicit
                explicit[k] = int(v)
        elif k in _CUDA_SET:
            if v is not None:
                knobs = dict(cuda) if knobs is None else knobs
                knobs[k] = int(v)
        else:
            rest[k] = v
    return (rest, layout if explicit is None else explicit,
            cuda if knobs is None else knobs)


def _plan_call(pol: KernelPolicy, kernel: str, args: Sequence,
               kwargs: Optional[dict], backend: Optional[str],
               device: torch.device) -> Tuple[object, Bucket, dict]:
    """The call's backend, bucket and launch kwargs, its layouts
    recorded."""
    bucket = _BUCKETERS[kernel](*args)
    be, layout, cuda = pol._plan(kernel, bucket, backend, device)
    if be.name == "torch":
        knobs = sorted(k for k, v in (kwargs or {}).items()
                       if k in _CUDA_SET and v is not None)
        if knobs:
            raise ValueError(
                f"{kernel}: launch knobs {knobs} given to a call that "
                f"resolves to the torch backend, which takes none")
    kwargs, layout, cuda = _with_layout(kwargs, layout, cuda)
    pol.layout_choices[(kernel, bucket)] = layout
    if cuda:
        kwargs = {**kwargs, **cuda}
    pol.cuda_layout_choices[(kernel, bucket)] = cuda
    return be, bucket, kwargs


def dispatch(kernel: str, args: Sequence, kwargs: Optional[dict] = None, *,
             policy: Optional[KernelPolicy] = None,
             backend: Optional[str] = None):
    """Resolve a backend and its launch layout for this call and run it."""
    pol = policy if policy is not None else _DEFAULT_POLICY
    device = call_device(kernel, args, kwargs)
    if not obs.active():
        be, _, kwargs = _plan_call(pol, kernel, args, kwargs, backend, device)
        return be.run(kernel, *args, **kwargs)
    on_card = device.type == "cuda"
    # the device time serves an installed tracer's readers (obs_report,
    # calibration_check); a profiler alone sees the kernels on its own
    timed = on_card and obs.enabled()
    with obs.span(f"kernel.{kernel}", device=timed) as sp:
        be, bucket, kwargs = _plan_call(pol, kernel, args, kwargs, backend,
                                        device)
        blabel = bucket_label(bucket)
        sp.set(backend=be.name, bucket=blabel)
        out = be.run(kernel, *args, **kwargs)
    reg = obs.get_registry()
    labels = dict(kernel=kernel, bucket=blabel, backend=be.name)
    # the first call of a (kernel, bucket, backend) pays the build (nvcc
    # at first use) on the host: keep it out of the steady-state
    # histograms (calibration_check reads their p50s)
    seen = getattr(reg, "_kernel_seen", None)
    if seen is None:
        seen = set()
        setattr(reg, "_kernel_seen", seen)
    first = (kernel, blabel, be.name) not in seen
    seen.add((kernel, blabel, be.name))
    reg.counter("kernel.launches", **labels).inc()
    if first:
        reg.histogram("kernel.compile_s", **labels).observe(sp.t1 - sp.t0)
    else:
        reg.histogram("kernel.dispatch_s", **labels).observe(sp.t1 - sp.t0)
        device_s = reg.histogram("kernel.device_s", **labels)
        if timed:
            sp.device_sink = device_s
        elif not on_card:       # a CPU call has run when it returns
            device_s.observe(sp.t1 - sp.t0)
    return out


def calibration_check(policy: Optional[KernelPolicy] = None,
                      registry=None, *, min_count: int = 5
                      ) -> List[Dict[str, object]]:
    """Check the calibration table against observed launch timings.

    For every (kernel, bucket) the policy has a calibrated winner for,
    compare the winner's observed p50 device time (the ``kernel.device_s``
    histograms that traced dispatches on a card fill once
    :func:`repro_torch.obs.resolve` has run; first launches land in
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
        if name != "kernel.device_s" or h.count < min_count:
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
