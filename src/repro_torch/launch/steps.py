"""Step-function factories for the dry run: build (fn, abstract inputs,
in/out specs) for one (architecture x input-shape x mesh x policy)
combination.

A port of the JAX package's ``launch/steps.py``.  The abstract arguments
are meta tensors (a meta params module, meta optimizer moments, meta
caches and inputs); :func:`place` lays them out on a mesh as DTensors,
each local shard an empty tensor (fake under a ``FakeTensorMode`` for the
dry run) or drawn from a generator (a real run).  The step functions take
the params module whose parameters are those DTensors:

* train: ``(params, opt_state, step, batch) -> (new params, new opt
  state, step + 1, {"loss", "ce", "aux"})``, the loss's gradients by
  ``torch.autograd`` and the port's AdamW (the reference's dry-run
  optimizer, bf16 moments);
* prefill: ``(params, batch) -> (last logits, caches)``;
* decode: ``(params, caches, batch) -> (logits, caches)``.  The port's
  decode takes the cache position as a host int; a fake ``pos`` has no
  value, so the decode step of a dry run reads ``seq_len // 2``
  (:func:`_host_pos`).  The work of a decode step does not depend on it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import shardings as sh
from repro_torch.launch.shardings import P
from repro_torch.models.model_api import Model, input_specs
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.sharding_ctx import settle

BF16 = torch.bfloat16


def apply_policy_to_cfg(cfg: ArchConfig, pol: sh.ShardingPolicy
                        ) -> ArchConfig:
    if cfg.moe is None:
        return cfg
    moe = cfg.moe
    if pol.moe_expert_parallel:
        moe = dataclasses.replace(moe, sharding="expert")
    elif pol.moe_tensor_sm:
        moe = dataclasses.replace(moe, sharding="tensor_sm")
    if pol.moe_capacity > 0:
        moe = dataclasses.replace(moe, capacity_factor=pol.moe_capacity)
    return dataclasses.replace(cfg, moe=moe)


def _batch_entry(shape: ShapeConfig, mesh, pol: sh.ShardingPolicy):
    ok = shape.global_batch % sh._axis_size(mesh, pol.batch_axes) == 0
    return pol.batch_axes if ok else None


def _host_pos(pos, default: int) -> int:
    """A decode position as a host int: the value of a real tensor (a
    DTensor's local one), ``default`` for a fake or meta one."""
    from torch._subclasses.fake_tensor import FakeTensor
    from repro_torch.sharding_ctx import is_dtensor
    if is_dtensor(pos):
        pos = pos.to_local()
    if isinstance(pos, FakeTensor) or pos.is_meta:
        return default
    return int(pos)


def build(cfg: ArchConfig, shape: ShapeConfig, mesh,
          pol: sh.ShardingPolicy, *, param_dtype=BF16, remat: bool = True
          ) -> Dict:
    """Returns dict with fn, args (abstract), in_specs, out_specs and the
    arch config after the policy (``cfg``)."""
    cfg = apply_policy_to_cfg(cfg, pol)
    model = Model(cfg, device="meta")
    aparams = model.abstract_params(param_dtype)
    pspecs = sh.param_specs(aparams, mesh, pol)
    ispecs = input_specs(cfg, shape)
    ispec_tree = sh.input_spec_tree(cfg, shape, mesh, pol)
    b = _batch_entry(shape, mesh, pol)
    names = [n for n, _ in aparams.named_parameters()]
    plist = [pspecs[n] for n in names]

    if shape.mode == "train":
        opt = adamw(cosine_schedule(3e-4, 100, 10_000), b2=0.95,
                    weight_decay=0.1, state_dtype=BF16)
        aopt = opt.init(list(aparams.parameters()))
        astep = torch.empty((), dtype=torch.int32, device="meta")

        def train_step(params, opt_state, step, batch):
            leaves = params.leaves
            loss, metrics = model.loss(params, batch, remat=remat)
            # a replicated leaf's gradient is a sum over the batch shards:
            # the data-parallel all-reduce (a sharded one was
            # reduce-scattered by Unshard's backward)
            grads = [settle(g, None) for g in
                     torch.autograd.grad(loss, leaves)]
            with torch.no_grad():
                new_params, new_opt = opt.update(grads, leaves, opt_state,
                                                 step)
            return new_params, new_opt, step + 1, {
                k: settle(v.detach(), None) for k, v in
                (("loss", loss), ("ce", metrics["ce"]),
                 ("aux", metrics["aux"]))}

        return {
            "cfg": cfg, "model": model, "policy": pol,
            "batch_split": b is not None, "fn": train_step,
            "args": (aparams, aopt, astep, ispecs),
            "in_specs": (pspecs, {"m": plist, "v": plist}, P(), ispec_tree),
            "out_specs": (plist, {"m": plist, "v": plist}, P(),
                          {"loss": P(), "ce": P(), "aux": P()}),
        }

    if shape.mode == "prefill":
        def prefill_step(params, batch):
            return model.prefill(params, batch)

        acaches = model.abstract_caches(shape.global_batch, shape.seq_len)
        cspecs = sh.cache_specs(cfg, acaches, shape, mesh, pol)
        return {
            "cfg": cfg, "model": model, "policy": pol,
            "batch_split": b is not None, "fn": prefill_step,
            "args": (aparams, ispecs),
            "in_specs": (pspecs, ispec_tree),
            "out_specs": (P(b, "model"), cspecs),
        }

    # decode: one token against a seq_len cache
    def decode_fn(params, caches, batch):
        pos = _host_pos(batch["pos"], shape.seq_len // 2)
        return model.decode_step(params, batch["tokens"], caches, pos)

    acaches = model.abstract_caches(shape.global_batch, shape.seq_len)
    cspecs = sh.cache_specs(cfg, acaches, shape, mesh, pol)
    return {
        "cfg": cfg, "model": model, "policy": pol,
        "batch_split": b is not None, "fn": decode_fn,
        "args": (aparams, acaches, ispecs),
        "in_specs": (pspecs, cspecs, ispec_tree),
        "out_specs": (P(b, "model"), cspecs),
    }


# ---------------------------------------------------------------------------
# laying the abstract arguments out on a mesh
# ---------------------------------------------------------------------------

def _fill(t: torch.Tensor, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Draw ``t``'s values in place: floats N(0, 0.02), ints uniform in
    [0, 64) (token ids valid for every arch's vocab), nothing for a fake
    or empty tensor."""
    if gen is None or t.numel() == 0:
        return t
    if t.is_floating_point():
        t.copy_(torch.randn(t.shape, generator=gen, device=t.device)
                * 0.02)
    else:
        t.copy_(torch.randint(0, 64, t.shape, generator=gen,
                              device=t.device))
    return t


def place_tensor(t: torch.Tensor, mesh, spec, device,
                 gen: Optional[torch.Generator] = None):
    """A DTensor of ``t``'s global shape and dtype laid out by ``spec`` on
    ``mesh``, its local shard a new tensor on ``device`` (drawn from
    ``gen`` where given)."""
    from torch.distributed.tensor import DTensor
    local = sh.local_shape(mesh, t.shape, spec)
    shard = _fill(torch.empty(local, dtype=t.dtype, device=device), gen)
    return DTensor.from_local(shard, mesh, sh.to_placements(mesh, spec),
                              run_check=False, shape=t.shape,
                              stride=_contiguous_stride(t.shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


class Unshard(nn.Module):
    """FSDP's gather at each use of a weight: the weight with its
    ``fsdp_axis`` sharding replaced by replication (an all-gather over
    that axis; its backward reduce-scatters the gradient), every other
    axis kept.  Registered as a parametrization, so ``lp.attn.wq`` reads
    the gathered weight and the stored shard stays what the policy
    says."""

    def __init__(self, mesh, fsdp_axis: str):
        super().__init__()
        self.mesh = mesh
        self.dim = list(mesh.mesh_dim_names).index(fsdp_axis)

    def forward(self, w):
        from torch.distributed.tensor import Replicate
        pl = list(w.placements)
        if not pl[self.dim].is_shard():
            return w
        pl[self.dim] = Replicate()
        return w.redistribute(self.mesh, pl)


def place_params(aparams: nn.Module, pspecs: Dict[str, P], mesh, device,
                 gen: Optional[torch.Generator] = None,
                 requires_grad: bool = False,
                 fsdp_axis: Optional[str] = None) -> nn.Module:
    """``aparams`` (a meta module) with each parameter replaced, in place,
    by a DTensor parameter laid out by its spec; with ``fsdp_axis``, a
    parameter sharded over it is read through :class:`Unshard`.  The
    stored parameters, in name order, are ``params.leaves``, their names
    ``params.leaf_names``."""
    from torch.nn.utils import parametrize
    leaves = []
    names = [n for n, _ in aparams.named_parameters()]
    for name, p in list(aparams.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = aparams.get_submodule(mod_name) if mod_name else aparams
        w = nn.Parameter(place_tensor(p, mesh, pspecs[name], device, gen),
                         requires_grad=requires_grad)
        mod._parameters[leaf] = w
        leaves.append(w)
        if fsdp_axis is not None and fsdp_axis in sh._axes(pspecs[name]):
            parametrize.register_parametrization(
                mod, leaf, Unshard(mesh, fsdp_axis), unsafe=True)
    aparams.leaves = leaves
    aparams.leaf_names = names
    return aparams


def place_tree(tree, specs, mesh, device,
               gen: Optional[torch.Generator] = None):
    """A dict/list tree of meta tensors laid out leaf by leaf by the spec
    tree of the same structure."""
    if isinstance(tree, torch.Tensor):
        return place_tensor(tree, mesh, specs, device, gen)
    if isinstance(tree, dict):
        return {k: place_tree(v, specs[k], mesh, device, gen)
                for k, v in tree.items()}
    return [place_tree(v, s, mesh, device, gen) for v, s in zip(tree, specs)]


def place_args(built: Dict, mesh, device,
               gen: Optional[torch.Generator] = None) -> List:
    """The built step's abstract arguments laid out on ``mesh``: the
    params module (parameters requiring grad for a train step), then each
    other argument by its spec tree."""
    args, specs = built["args"], built["in_specs"]
    train = len(args) == 4
    pol = built["policy"]
    # gather FSDP shards only where the batch is split over their axis;
    # with a batch the axis cannot split (long_500k's one row) every
    # device would repeat the whole product, so the weights stay split
    # and the products sum partial contractions instead
    gather = pol.fsdp and built["batch_split"]
    params = place_params(args[0], specs[0], mesh, device, gen,
                          requires_grad=train,
                          fsdp_axis=pol.fsdp_axis if gather else None)
    rest = [place_tree(a, s, mesh, device, gen)
            for a, s in zip(args[1:], specs[1:])]
    if train:
        # the moments start at zero, as ``adamw``'s init makes them
        for leaf in _leaves(rest[0]):
            if gen is not None:
                leaf.to_local().zero_()
        if gen is not None:
            rest[1].to_local().zero_()
    return [params] + rest


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return list(tree.leaves)
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [x for v in tree for x in _leaves(v)]


def local_bytes(tree) -> int:
    """Bytes of one device's local shards over a tree of DTensors (plain
    tensors count whole; a module counts its parameters)."""
    total = 0
    for t in _leaves(tree):
        loc = t.to_local() if hasattr(t, "to_local") else t
        total += loc.numel() * loc.element_size()
    return total


def local_params(model, params: nn.Module, requires_grad: bool = False
                 ) -> nn.Module:
    """A plain params module (the model's, on the meta device, each
    parameter replaced) holding the local shards of ``params``, the
    DTensor module :func:`place_params` made: on a one-device mesh each
    shard is the whole tensor, so the plain path reads the same values
    (no copy is made)."""
    plain = model.abstract_params()
    local = dict(zip(params.leaf_names, params.leaves))
    for name, _ in list(plain.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = plain.get_submodule(mod_name) if mod_name else plain
        mod._parameters[leaf] = nn.Parameter(
            local[name].to_local().detach(), requires_grad=requires_grad)
    return plain
