"""Per-architecture sharding policy, as DTensor placements.

A port of the JAX package's ``launch/shardings.py``: Megatron-style tensor
parallelism over the ``model`` axis + (optional) FSDP over ``data`` on the
other weight dim, chosen per tensor by *divisibility*.  Every rule goes
through :func:`_guard`, which drops an axis assignment whose dimension
isn't divisible by the mesh axis size, or that repeats an axis already
used.

Specs are :class:`P`, a tuple of one entry a tensor dim (a mesh axis name,
a tuple of names major to minor, or None), so a test compares them entry
for entry with the reference's ``PartitionSpec``; :func:`to_placements`
turns one into DTensor placements.  A mesh here is a ``DeviceMesh`` or
anything with ``mesh_dim_names`` and ``shape`` (axis sizes in that
order), or with a ``shape`` mapping of axis name to size as the
reference's meshes have; the rules read nothing else.

The port keeps one module a layer (``Transformer.blocks``,
``EncDec.enc_layers``/``dec_layers``), where the reference stacks each
layer's leaf over a leading layer axis: a layer's leaf gets the
reference's spec of its stacked leaf with that leading ``None`` dropped,
and a cache leaf likewise.  The params are named as
``named_parameters()`` names them (``blocks.3.attn.wq``), which
``convert.lm_leaf`` maps to the reference's stacked leaves.

Variants (the reference's §Perf knobs) modulate the policy:
  * ``kv_shard_seq``  — decode caches shard the sequence dim over ``data``
    when the batch can't use it (long_500k), instead of replicating.
  * ``no_fsdp``       — weights sharded over ``model`` only.
  * (MoE expert-parallel lives in the model config: moe.sharding.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.configs.base import ArchConfig, ShapeConfig

class P(tuple):
    """A partition spec: one entry a tensor dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    fsdp: bool = True
    kv_shard_seq: bool = False        # variant: shard cache seq over data
    moe_expert_parallel: bool = False  # variant: experts over model axis
    moe_tensor_sm: bool = False       # variant: explicit bf16 all-reduce
    moe_capacity: float = 0.0         # variant: override capacity factor (0=keep)
    kv_seq_model: bool = False        # variant: shard decode cache SEQ over model
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    fsdp_axis: str = "data"


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size for a DeviceMesh or a stand-in (module doc)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def _axes(entry) -> Tuple[str, ...]:
    """The axis names a spec's entries name."""
    if isinstance(entry, tuple) and not isinstance(entry, P):
        return entry
    if isinstance(entry, P):
        return tuple(a for e in entry for a in _axes(e))
    return () if entry is None else (entry,)


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= _axis_size(mesh, n)
        return out
    return axis_sizes(mesh)[name]


def _guard(mesh, shape: Tuple[int, ...], spec: Tuple) -> P:
    """Drop axis assignments whose dim isn't divisible by the axis size,
    or that repeat an axis already used."""
    used = set()
    out = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        if any(a in used for a in axes):
            out.append(None)
            continue
        if dim % _axis_size(mesh, ax) != 0:
            out.append(None)
            continue
        used.update(axes)
        out.append(ax)
    return P(*out)


def _leaf_spec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh,
               pol: ShardingPolicy) -> P:
    """The reference's rules, in its order, for one param of ``shape``
    (a layer's leaf unstacked)."""
    name = path[-1]
    in_moe = "moe" in path
    m, f = pol.model_axis, (pol.fsdp_axis if pol.fsdp else None)

    def mk(*spec):
        return _guard(mesh, shape, spec)

    if name == "embed":
        return mk(m, f)
    if name == "lm_head":
        return mk(f, m)
    if name == "enc_pos":
        return mk(None, None)
    if name in ("final_norm", "enc_norm", "norm", "norm1", "norm2", "norm_x",
                "dt_bias", "conv_b", "A_log", "D"):
        return P(*([None] * len(shape)))
    if name in ("bq", "bk", "bv"):
        return mk(m)
    if in_moe and name in ("w_gate", "w_up"):
        if pol.moe_expert_parallel:
            return mk(m, f, None)       # (E->model, D->data, F)
        return mk(None, f, m)           # (E, D->data, F->model)
    if in_moe and name == "w_down":
        if pol.moe_expert_parallel:
            return mk(m, None, f)
        return mk(None, m, f)
    if name == "router":
        return mk(f, None)
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "wz", "wx",
                "wB", "wC", "wdt"):
        return mk(f, m)                 # (in -> data, out -> model)
    if name in ("wo", "w_down"):
        return mk(m, f)                 # (in -> model, out -> data)
    if name == "conv_w":
        return mk(None, m)
    # fallback: replicate
    return P(*([None] * len(shape)))


def param_specs(params, mesh, pol: ShardingPolicy) -> Dict[str, P]:
    """Param name -> P for every param of the model's ``params`` module
    (a meta module, from ``Model.abstract_params``, allocates nothing)."""
    return {name: _leaf_spec(tuple(name.split(".")), tuple(t.shape), mesh,
                             pol)
            for name, t in params.named_parameters()}


# ---------------------------------------------------------------------------
# inputs / caches
# ---------------------------------------------------------------------------

def _batch_entry(shape: ShapeConfig, mesh, pol: ShardingPolicy):
    batch_ok = shape.global_batch % _axis_size(mesh, pol.batch_axes) == 0
    return pol.batch_axes if batch_ok else None, batch_ok


def input_spec_tree(cfg: ArchConfig, shape: ShapeConfig, mesh,
                    pol: ShardingPolicy) -> Dict[str, P]:
    b, _ = _batch_entry(shape, mesh, pol)
    out: Dict[str, P] = {}
    if shape.mode == "train":
        out["tokens"] = P(b, None)
        out["labels"] = P(b, None)
    elif shape.mode == "prefill":
        out["tokens"] = P(b, None)
    else:
        out["tokens"] = P(b, None)
        out["pos"] = P()
    if cfg.frontend == "audio":
        out["frames"] = P(b, None, None)
    return out


def _cache_leaf(name: str, shp: Tuple[int, ...], b, batch_ok: bool, mesh,
                pol: ShardingPolicy) -> P:
    m = pol.model_axis
    if name in ("k", "v"):
        # (B, S, H, hd)
        if pol.kv_seq_model:
            # flash-decode layout: sequence over model, batch over data
            return _guard(mesh, shp, (b, m, None, None))
        seq_ax = (pol.batch_axes if (pol.kv_shard_seq and not batch_ok)
                  else None)
        return _guard(mesh, shp, (b, seq_ax, m, m))
    if name == "ssm":
        # (B, H, hd, N)
        return _guard(mesh, shp, (b, m, None, None))
    if name == "conv":
        # (B, k-1, conv_dim)
        return _guard(mesh, shp, (b, None, m))
    return P(*([None] * len(shp)))


def cache_specs(cfg: ArchConfig, abstract_caches, shape: ShapeConfig, mesh,
                pol: ShardingPolicy):
    """Decode-cache specs in the caches' own structure (a list of per-layer
    dicts, or {"self": [...], "cross": [...]} for an encoder-decoder).

    Priority per KV-cache leaf (B, S, Hkv, hd): batch -> data when
    divisible; kv-heads -> model when divisible, else head_dim -> model;
    with ``kv_shard_seq`` and an unshardable batch (long_500k B=1), the
    sequence dim shards over data instead of idling the axis."""
    b, batch_ok = _batch_entry(shape, mesh, pol)

    def tree(node):
        if isinstance(node, dict) and all(not isinstance(v, (dict, list))
                                          for v in node.values()):
            return {k: _cache_leaf(k, tuple(v.shape), b, batch_ok, mesh,
                                   pol) for k, v in node.items()}
        if isinstance(node, dict):
            return {k: tree(v) for k, v in node.items()}
        return [tree(v) for v in node]

    return tree(abstract_caches)


def to_placements(mesh, spec: Sequence) -> List:
    """DTensor placements, one a mesh dim, for a spec (each axis of size
    above 1 a tensor dim names becomes ``Shard(dim)``, every other
    ``Replicate()``: the two are the same layout on an axis of one
    device); the spec is taken as given, so it must have passed
    :func:`_guard`."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if sizes[a] > 1:
                out[names.index(a)] = Shard(dim)
    return out


def local_shape(mesh, shape: Sequence[int], spec: Sequence
                ) -> Tuple[int, ...]:
    """One device's shard of a ``shape`` tensor laid out by ``spec``."""
    return tuple(d // _axis_size(mesh, e) for d, e in
                 zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))))


def local_nbytes(mesh, t, spec) -> int:
    """Bytes of one device's shard of tensor ``t`` (a meta tensor will
    do) laid out by ``spec``."""
    n = 1
    for d in local_shape(mesh, t.shape, spec):
        n *= d
    return n * t.element_size()
