"""Per-device cost of one step, counted op by op at dispatch.

This takes the place of the JAX package's ``launch/hlo_analysis.py``.
The port compiles no HLO: a step runs eagerly, on DTensors whose local
shards are fake tensors in the dry run (nothing is allocated or computed)
or real ones on a card, and :class:`CostMode`, a ``TorchDispatchMode``,
sees every op on a local shard.  It lets DTensor ops through (returning
``NotImplemented``, so DTensor desugars them into local ops and
functional collectives first) and skips the ops DTensor runs on fake
tensors of its own to propagate shapes.  So every count is per device,
with the shapes taken from the local shards, and a Python loop (a layer
stack, an SSD chunk loop) is counted as it runs: there is no loop body to
correct, so the reference's ``flops_loop_body_once``, ``bytes_raw`` and
``n_computations`` have no counterpart and are left out.

The counts, with the reference's conventions:

* ``flops_corrected``: 2 * prod(result) * prod(contracted) per matmul
  (``mm``, ``addmm``, ``bmm``, ``baddbmm``; an einsum reaches one of
  these), dots only, plus the flash kernel's custom op by its registered
  formula (the causal half of the score matrix); the record's
  ``dot_rows`` splits it by op, operand shapes and issuing frame;
* ``bytes_accessed_corrected``: operand + result bytes of every op but
  views and metadata queries (eager ops are not fused, so this counts
  what an unfused step moves);
* ``collectives``: every functional collective by the reference's kind
  (all-gather, all-reduce, reduce-scatter, all-to-all,
  collective-permute), with its count and result bytes, and
  ``collective_bytes_total``;
* ``peak_live_bytes``: the most bytes of local storage alive at once,
  counting the arguments the caller registers (:meth:`CostMode.hold`)
  and every op's outputs until they are freed.

Each collective is also listed with the innermost frame of the port that
issued it (``models/attention.py:attn_apply``), which
``launch/inspect_combo.py`` ranks in place of HLO ``op_name`` metadata,
and so is each matmul in ``dot_rows``.  A backward op runs from the
autograd engine, below the frame that called ``backward``, so the mode
also tags each forward op's autograd node with its issuer, and a
backward op is listed under the issuer of the forward op it
differentiates, as ``models/mamba.py:_cb (backward)``.
"""
from __future__ import annotations

import os
import sys
import weakref
from typing import Dict, List

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collective op -> the reference's kind
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}

_DOTS = ("mm", "addmm", "bmm", "baddbmm")
_SKIP = ("detach", "alias", "lift_fresh", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "device", "dim", "is_same_size")
_PROPAGATION_FILE = os.path.join("distributed", "tensor",
                                 "_sharding_prop.py")
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flop_ops():
    ops = {getattr(torch.ops.aten, n) for n in _DOTS}
    from repro_torch.kernels import ops as kops
    ops.add(kops.FLASH_OP)
    return ops


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(getattr(tree, "leaves", None) or tree.parameters())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def issuer() -> str:
    """The innermost frame of the port's model or kernel code on the
    stack, as ``models/attention.py:attn_apply``; else the innermost
    frame of the port."""
    f = sys._getframe(1)
    fallback = "?"
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(_PKG) and not path.endswith(
                ("cost_analysis.py", "sharding_ctx.py")):
            rel = os.path.relpath(path, _PKG)
            where = f"{rel}:{f.f_code.co_name}"
            if rel.startswith(("models", "kernels")):
                return where
            if fallback == "?":
                fallback = where
        f = f.f_back
    return fallback


def _dot_issuer() -> str:
    """:func:`issuer`; where that is no model or kernel frame (a backward
    op, run from the autograd engine), the issuer the running autograd
    node was tagged with (:class:`_ForwardIssuers`), marked
    ``(backward)``."""
    who = issuer()
    if who.startswith(("models", "kernels")):
        return who
    node = torch._C._current_autograd_node()
    if node is not None and "issuer" in node.metadata:
        return node.metadata["issuer"] + " (backward)"
    return who + (f" ({node.name()})" if node is not None else "")


class _ForwardIssuers(TorchFunctionMode):
    """Tags the autograd nodes each op run under it made (its output's
    node and every untagged node behind it: a composite op such as a 3-d
    ``matmul`` makes several) with the op's :func:`issuer`, for
    :func:`_dot_issuer` to read in the backward."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.is_grad_enabled():
            who = None
            stack = [t.grad_fn for t in _tensors(out)]
            while stack:
                node = stack.pop()
                if node is None or "issuer" in node.metadata:
                    continue
                who = who or issuer()
                node.metadata["issuer"] = who
                stack.extend(f for f, _ in node.next_functions)
        return out


def _in_propagation() -> bool:
    """Whether DTensor's sharding propagation is on the stack: it runs
    the op on global-shaped fake tensors (in the active fake mode, when
    there is one) to learn the output's shape, work no device does."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATION_FILE):
            return True
        f = f.f_back
    return False


class CostMode(TorchDispatchMode):
    """Counts the per-device cost of the ops run under it (module doc).
    ``fake_mode`` is the dry run's ``FakeTensorMode`` (None for a real
    run): a fake tensor of any other mode is DTensor's shape propagation
    and is not counted."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self._issuers = _ForwardIssuers()
        self._flop_ops = _flop_ops()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.coll = {c: {"count": 0, "bytes": 0} for c in COLLECTIVES}
        self.coll_rows: List[Dict] = []
        # (op, operand shapes, issuer) -> [count, flops]
        self.dot_rows: Dict[tuple, list] = {}
        self.live = 0
        self.peak = 0
        self._held = weakref.WeakValueDictionary()
        self.n_ops = 0

    # ------------------------------------------------------------ memory
    def hold(self, tree) -> None:
        """Count the storages of ``tree``'s tensors (a DTensor's local
        shard) as live from now until they are freed."""
        for t in _tensors(tree):
            if hasattr(t, "to_local"):
                t = t.to_local()
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = st
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __enter__(self):
        self._issuers.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._issuers.__exit__(*exc)
        return out

    # ---------------------------------------------------------- dispatch
    def _foreign(self, tensors) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor
        return any(isinstance(t, FakeTensor) and t.fake_mode
                   is not self.fake_mode for t in tensors)


    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if (self._foreign(ins) or self._foreign(outs)
                or _in_propagation()):
            return out
        self.n_ops += 1
        packet = func.overloadpacket
        name = packet.__name__
        ns = func.namespace
        if packet in self._flop_ops:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            key = (name, tuple(tuple(t.shape) for t in ins), _dot_issuer())
            row = self.dot_rows.setdefault(key, [0, 0.0])
            row[0] += 1
            row[1] += f
        if ns == "_c10d_functional" and name in _COLLECTIVE_KIND:
            kind = _COLLECTIVE_KIND[name]
            b = sum(_nbytes(t) for t in outs)
            self.coll[kind]["count"] += 1
            self.coll[kind]["bytes"] += b
            self.coll_rows.append({
                "kind": kind, "bytes": b,
                "dtype": str(outs[0].dtype).replace("torch.", "")
                if outs else "", "shape": [list(t.shape) for t in outs],
                "issuer": issuer()})
        elif not (func.is_view or name in _SKIP or not outs
                  or name == "wait_tensor"):
            self.bytes_accessed += sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out

    # ------------------------------------------------------------ record
    def by_issuer(self) -> Dict[str, list]:
        """"kind dtype issuer" -> [count, bytes] over the collectives."""
        out: Dict[str, list] = {}
        for r in self.coll_rows:
            row = out.setdefault(f"{r['kind']} {r['dtype']} {r['issuer']}",
                                 [0, 0])
            row[0] += 1
            row[1] += r["bytes"]
        return out

    def record(self) -> Dict:
        return {
            "flops_corrected": float(self.flops),
            "dot_rows": [[op, [list(t) for t in shapes], who, n, f]
                         for (op, shapes, who), (n, f)
                         in self.dot_rows.items()],
            "bytes_accessed_corrected": float(self.bytes_accessed),
            "collectives": {k: dict(v) for k, v in self.coll.items()},
            "collective_bytes_total": float(
                sum(v["bytes"] for v in self.coll.values())),
            "peak_live_bytes": int(self.peak),
            "collectives_by_issuer": self.by_issuer(),
            "n_ops": self.n_ops,
        }

