"""Activation-sharding context: lets model code pin activation placements
(batch -> data axes, vocab/heads -> model axis) without a hard dependency
on the launch layer.

A port of the JAX package's ``sharding_ctx.py`` over DTensor.  The dry run
(``launch/dryrun.py``) and a launcher on a mesh install a context (the
mesh, its batch axes, model axis and FSDP axis); the model's forward
passes call :func:`constrain` at the reference's anchor points (embedding
output, per-layer carry, logits, the MoE's routing and dispatch).
``constrain`` redistributes a DTensor to the kind's placements, the
counterpart of ``jax.lax.with_sharding_constraint``: DTensor propagates
its own layouts op by op, and the anchors stop that drift where the
reference stops XLA's.  Without a context, or for a plain tensor, it
returns its argument unchanged, so every path without a mesh runs exactly
as before.

Each redistribution an anchor forces, and each one a ``local_map`` region
forces on its inputs (:func:`local_region`), is counted by kind in the
context's ``"redistributions"`` dict, which the dry run records, so drift
shows.  :func:`follow` puts a plain tensor the model makes inside (a rope
table, positions, a mask, a zero cache or accumulator) onto the mesh of
the DTensor it meets, replicated, so a DTensor never meets a plain
tensor.
"""
from __future__ import annotations

import contextlib
import types
from typing import Callable, Optional, Sequence, Tuple

import torch

# process-wide, not thread-local: autograd runs a CUDA backward (and the
# layers a checkpoint recomputes in it) on a device thread of its own
_STATE = types.SimpleNamespace(ctx=None)

# kind -> the tensor dim the model axis shards (None: no model dim)
_MODEL_DIM = {"btd": None, "btv": 2, "bv": 1, "bd": None, "b2": None,
              "b3": None, "b4": None}
KINDS = tuple(_MODEL_DIM)


def current() -> Optional[dict]:
    return _STATE.ctx


@contextlib.contextmanager
def activation_sharding(batch_axes: Tuple[str, ...] = ("data",),
                        model_axis: str = "model",
                        batch_shardable: bool = True,
                        mesh=None, fsdp_axis: Optional[str] = "data"):
    """Install a context: the batch dim shards over ``batch_axes`` (when
    ``batch_shardable``), vocab and heads over ``model_axis``; ``mesh`` is
    the DeviceMesh the model's DTensors lie on."""
    prev = current()
    _STATE.ctx = {"batch": batch_axes if batch_shardable else None,
                  "model": model_axis, "mesh": mesh, "fsdp": fsdp_axis,
                  "all_batch_axes": batch_axes, "redistributions": {}}
    try:
        yield _STATE.ctx
    finally:
        _STATE.ctx = prev


def current_mesh():
    ctx = current()
    return ctx.get("mesh") if ctx else None


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def count(kind: str, n: int = 1) -> None:
    """Add ``n`` to the context's redistribution count of ``kind``."""
    ctx = current()
    if ctx is not None:
        red = ctx["redistributions"]
        red[kind] = red.get(kind, 0) + n


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements_for(mesh, shape: Sequence[int], spec: Sequence) -> list:
    """DTensor placements, one a mesh dim, for a tensor of ``shape`` whose
    dim i shards over the mesh axes ``spec[i]`` (a name, a tuple of names
    major to minor, or None).  An axis whose size does not divide the dim
    is dropped, as the reference's ``_guard`` drops it; an axis of one
    device is ``Replicate()``, the same layout."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        n = 1
        for a in axes:
            n *= sizes[a]
        if not axes or shape[dim] % n:
            continue
        for a in axes:
            if sizes[a] > 1:
                out[names.index(a)] = Shard(dim)
    return out


def kind_spec(kind: str, ndim: int) -> Tuple:
    """The context's spec for an activation of ``kind``: the batch axes on
    dim 0, the model axis on the kind's vocab dim, None elsewhere."""
    ctx = current()
    spec = [None] * ndim
    spec[0] = ctx["batch"]
    mdim = _MODEL_DIM[kind]
    if mdim is not None:
        spec[mdim] = ctx["model"]
    return tuple(spec)


def constrain(x, kind: str):
    """kind: 'btd' (batch, seq, d_model) | 'btv' (batch, seq, vocab) |
    'bv' (batch, vocab) | 'bd' (batch, d_model) | 'b2' | 'b3' | 'b4'
    (batch-sharded, rank 2-4).  A DTensor under a context is redistributed
    to the kind's placements (counted); anything else is returned as
    is."""
    ctx = current()
    if ctx is None or not is_dtensor(x):
        return x
    target = placements_for(x.device_mesh, x.shape,
                            kind_spec(kind, x.dim()))
    if list(x.placements) == target:
        return x
    count(kind)
    x = _sum_partials(x)
    return x.redistribute(x.device_mesh, target)


def follow(t: torch.Tensor, ref) -> torch.Tensor:
    """``t``, a plain tensor the model made, replicated onto the mesh of
    ``ref`` where ``ref`` is a DTensor; else ``t`` itself."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def settle(x, kind: Optional[str] = "partial"):
    """A DTensor whose pending reductions (``Partial`` placements) are
    carried out: the all-reduce after a row-parallel product (``kind``
    None: not a redistribution the layout forced, so not counted), or
    after a gather from a vocab-sharded tensor (counted under ``kind``);
    anything else as is."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    if kind is not None:
        count(kind)
    x = _sum_partials(x)
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def _plain_sum(p) -> bool:
    from torch.distributed.tensor import Partial
    return type(p) is Partial and p.reduce_op == "sum"


class _AllReduceSum(torch.autograd.Function):
    """All-reduce (sum) over mesh dims whose result every rank then holds
    alike: each rank's partial gets the result's gradient as is (the
    transpose of the reference's ``psum``; DTensor's own redistribution
    would hand the gradient back as a pending sum, which makes the
    backward products gather their weights)."""

    @staticmethod
    def forward(ctx, x, groups):
        from torch.distributed import _functional_collectives as funcol
        for g in groups:
            x = funcol.wait_tensor(funcol.all_reduce(x, "sum", g))
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PartialSum(torch.autograd.Function):
    """All-reduce (sum) of partial contributions whose result feeds work
    each device does on its own shard: the gradient of each contribution
    is the sum of every device's gradient of the result."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as funcol
        ctx.group = group
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(g, "sum",
                                                    ctx.group)), None


def _sum_partials(x):
    """x with every plain ``Partial(sum)`` placement reduced to
    ``Replicate`` by :class:`_AllReduceSum` (others left as they are)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    pl = list(x.placements)
    dims = [i for i, p in enumerate(pl) if _plain_sum(p)]
    if not dims:
        return x
    mesh = x.device_mesh
    out = [Replicate() if i in dims else p for i, p in enumerate(pl)]
    groups = [(mesh, i) for i in dims]
    return local_map(lambda t: _AllReduceSum.apply(t, groups),
                     out_placements=out, in_placements=(pl,),
                     in_grad_placements=(out,), device_mesh=mesh)(x)


def same_layout(fn: Callable, x):
    """``fn`` on a DTensor's local shard, its result a DTensor of ``x``'s
    placements: for an op that works along dims ``x`` does not split
    (which the caller knows); ``fn(x)`` for anything else."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor.experimental import local_map
    pl = list(x.placements)
    return local_map(fn, out_placements=pl, in_placements=(pl,),
                     device_mesh=x.device_mesh)(x)


def local_region(fn: Callable, in_specs: Sequence, out_specs: Sequence,
                 *args):
    """Run ``fn`` on the local shards of ``args`` where the first is a
    DTensor (``local_map``): arg i is first redistributed to ``in_specs[i]``
    (a spec as :func:`placements_for` takes it, or None for a non-tensor),
    each redistribution counted under ``"local_map"`` (gradients by
    :func:`_grad_placements`); ``fn``'s outputs are DTensors of
    ``out_specs``, each the placements arg i took (an int i) or a list
    of placements.  Without a DTensor ``fn`` runs on the tensors as they
    are."""
    if not args or not is_dtensor(args[0]):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    mesh = args[0].device_mesh
    moved = []
    in_pl = []
    for a, spec in zip(args, in_specs):
        if spec is None or not isinstance(a, torch.Tensor):
            moved.append(a)
            in_pl.append(None)
            continue
        a = follow(a, args[0])
        pl = placements_for(mesh, a.shape, spec)
        if list(a.placements) != pl:
            count("local_map")
            a = a.redistribute(mesh, pl)
        moved.append(a)
        in_pl.append(pl)
    out_pl = tuple(in_pl[s] if isinstance(s, int) else s
                   for s in out_specs)

    def body(*local):
        out = fn(*[_ContiguousGrad.apply(t)
                   if isinstance(t, torch.Tensor) and t.requires_grad
                   else t for t in local])
        if isinstance(out, torch.Tensor):
            return out.contiguous()
        return tuple(o.contiguous() for o in out)

    wrapped = local_map(body, out_placements=out_pl if len(out_pl) > 1
                        else out_pl[0], in_placements=tuple(in_pl),
                        in_grad_placements=_grad_placements(in_pl),
                        device_mesh=mesh)
    return wrapped(*moved)


def _grad_placements(in_pl):
    """Each input's gradient layout: where a region splits its work over
    a mesh dim (some input is sharded on it), an input whole on that dim
    gets from each device only the part its share of the work reads, so
    its gradient is a pending sum (``Partial``) there."""
    from torch.distributed.tensor import Partial
    split = {d for pl in in_pl if pl is not None
             for d, p in enumerate(pl) if p.is_shard()}
    return tuple(None if pl is None else
                 [Partial() if d in split and p.is_replicate() else p
                  for d, p in enumerate(pl)] for pl in in_pl)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: a region's
    input gradients leave it in the layout DTensor's views assume."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()
