"""The port's sharding policy (``launch/shardings.py``) and activation
context (``sharding_ctx.py``) against the JAX package's, on the CPU.

Spec parity needs no devices on either side: the reference's rules read
only a mesh's axis sizes (a stub with ``.shape`` and ``.axis_names``), the
port's the same through a stub with ``.mesh_dim_names``.  For every arch
in ``configs/`` x every applicable shape x the meshes 16x16, 2x16x16,
64x4 and 32x8 x every ``VARIANTS`` entry:

* every param's spec equals the reference's spec of its stacked leaf with
  the leading layer axis dropped (``convert._lm_path`` maps the names);
* ``input_spec_tree`` and ``cache_specs`` are equal leaf for leaf (a
  cache leaf of layer i against slot i % p of the reference's stacked
  caches, lead dropped);
* one device's argument bytes (params, for training the bf16 moments and
  the step, the inputs, for decoding the caches) from the port's local
  shard shapes equal, to the byte, those the reference's spec trees and
  abstract shapes give.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import registry as jreg  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro.launch.steps import apply_policy_to_cfg as japply  # noqa: E402
from repro.models import model_api as japi  # noqa: E402

from repro_torch import sharding_ctx  # noqa: E402
from repro_torch.configs import registry as reg  # noqa: E402
from repro_torch.convert import _lm_path  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.launch.dryrun import VARIANTS  # noqa: E402
from repro_torch.launch.steps import apply_policy_to_cfg  # noqa: E402
from repro_torch.models.model_api import (  # noqa: E402
    Model, input_specs)

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "64x4": (("data", "model"), (64, 4)),
          "32x8": (("data", "model"), (32, 8))}


def _meshes(name):
    axes, sizes = MESHES[name]
    jmesh = SimpleNamespace(shape=dict(zip(axes, sizes)), axis_names=axes)
    pmesh = SimpleNamespace(mesh_dim_names=axes, shape=sizes)
    return jmesh, pmesh


def _policies(variant, axes):
    kw = {k: v for k, v in VARIANTS[variant].items()
          if not k.startswith("mesh_")}
    batch = tuple(a for a in ("pod", "data") if a in axes)
    return (jsh.ShardingPolicy(batch_axes=batch, **kw),
            sh.ShardingPolicy(batch_axes=batch, **kw))


def _norm(spec):
    """A spec as a tuple of entries, a one-axis tuple as its name."""
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(e)
    return tuple(out)


def _local_bytes(shape, spec, sizes, itemsize):
    n = 1
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    for d, e in zip(shape, spec):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        k = 1
        for a in axes:
            k *= sizes[a]
        assert d % k == 0
        n *= d // k
    return n * itemsize


def _jax_leaf(tree, path):
    for key in path:
        tree = tree[int(key)] if isinstance(tree, (tuple, list)) else \
            tree[key]
    return tree


@pytest.fixture(scope="module")
def abstract():
    """Per arch: the reference's abstract params and the port's meta
    params, built once (the reference's qwen3-moe takes ~10 s)."""
    out = {}
    for name in reg.ARCHS:
        out[name] = (japi.Model(jreg.get_arch(name)).abstract_params(),
                     Model(reg.get_arch(name), device="meta")
                     .abstract_params())
    return out


def _param_bytes_and_check(jparams, pparams, cfg, jmesh, pmesh, jpol, pol,
                           itemsize_of):
    """Compare every param's spec; return (the reference's bytes, the
    port's bytes) of one device's params under ``itemsize_of(dtype)``."""
    jspecs = jsh.param_specs(jparams, jmesh, jpol)
    pspecs = sh.param_specs(pparams, pmesh, pol)
    sizes = jmesh.shape
    p = cfg.pattern_period
    pbytes = 0
    for name, t in pparams.named_parameters():
        path, index = _lm_path(name, p)
        jspec = _norm(_jax_leaf(jspecs, path))
        if index is not None:
            assert jspec[0] is None, (name, jspec)
            jspec = jspec[1:]
        assert _norm(pspecs[name]) == jspec, (name, pspecs[name], jspec)
        pbytes += _local_bytes(t.shape, pspecs[name], sizes,
                               itemsize_of(t.dtype))
    jbytes = 0
    for (path, leaf), (_, spec) in zip(
            jax.tree_util.tree_flatten_with_path(jparams)[0],
            jax.tree_util.tree_flatten_with_path(
                jspecs, is_leaf=lambda v: isinstance(
                    v, jax.sharding.PartitionSpec))[0]):
        jbytes += _local_bytes(leaf.shape, spec, sizes,
                               itemsize_of(leaf.dtype))
    return jbytes, pbytes


def _itemsize(dtype):
    return np.dtype(dtype).itemsize if not isinstance(dtype, torch.dtype) \
        else torch.empty((), dtype=dtype).element_size()


@pytest.mark.parametrize("arch", sorted(reg.ARCHS))
def test_specs_and_argument_bytes_equal_the_reference(arch, abstract):
    jparams, pparams = abstract[arch]
    base = reg.get_arch(arch)
    jbase = jreg.get_arch(arch)
    n = 0
    for shape_name, shape in reg.SHAPES.items():
        if not reg.shape_applicable(base, shape):
            continue
        jshape = jreg.get_shape(shape_name)
        jcaches = pcaches = None
        if shape.mode == "decode":
            jcaches = japi.Model(jbase).abstract_caches(shape.global_batch,
                                                        shape.seq_len)
            pcaches = Model(base, device="meta").abstract_caches(
                shape.global_batch, shape.seq_len)
        for mesh_name in MESHES:
            jmesh, pmesh = _meshes(mesh_name)
            sizes = jmesh.shape
            for variant in VARIANTS:
                jpol, pol = _policies(variant, jmesh.axis_names)
                cfg = apply_policy_to_cfg(base, pol)
                jcfg = japply(jbase, jpol)
                assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
                jb, pb = _param_bytes_and_check(
                    jparams, pparams, cfg, jmesh, pmesh, jpol, pol,
                    _itemsize)
                assert pb == jb, (arch, shape_name, mesh_name, variant)
                if shape.mode == "train":
                    # bf16 moments m, v laid out as the params, and the step
                    mb_j, mb_p = _param_bytes_and_check(
                        jparams, pparams, cfg, jmesh, pmesh, jpol, pol,
                        lambda d: 2)
                    jb += 2 * mb_j + 4
                    pb += 2 * mb_p + 4
                # inputs
                jin = jsh.input_spec_tree(jcfg, jshape, jmesh, jpol)
                pin = sh.input_spec_tree(cfg, shape, pmesh, pol)
                assert {k: _norm(v) for k, v in pin.items()} == \
                    {k: _norm(v) for k, v in jin.items()}
                jx = japi.input_specs(jcfg, jshape)
                px = input_specs(cfg, shape)
                for k in jx:
                    jb += _local_bytes(jx[k].shape, jin[k], sizes,
                                       np.dtype(jx[k].dtype).itemsize)
                    pb += _local_bytes(px[k].shape, pin[k], sizes,
                                       px[k].element_size())
                if pcaches is not None:
                    jb_c, pb_c = _cache_check(cfg, jcfg, shape, jshape,
                                              jcaches, pcaches, jmesh,
                                              pmesh, jpol, pol)
                    jb += jb_c
                    pb += pb_c
                assert pb == jb, (arch, shape_name, mesh_name, variant)
                n += 1
    print(f"{arch}: {n} (shape, mesh, variant) combinations equal")


def _cache_check(cfg, jcfg, shape, jshape, jcaches, pcaches, jmesh, pmesh,
                 jpol, pol):
    jspecs = jsh.cache_specs(jcfg, jcaches, jshape, jmesh, jpol)
    pspecs = sh.cache_specs(cfg, pcaches, shape, pmesh, pol)
    sizes = jmesh.shape
    jb = pb = 0
    if cfg.is_encoder_decoder:
        pairs = [(pcaches[part][i][leaf], pspecs[part][i][leaf],
                  jspecs[part][leaf], (part, leaf))
                 for part in ("self", "cross")
                 for i in range(cfg.n_layers) for leaf in ("k", "v")]
    else:
        p = cfg.pattern_period
        pairs = [(c[leaf], pspecs[i][leaf], jspecs[i % p][leaf], i)
                 for i, c in enumerate(pcaches) for leaf in c]
    for t, spec, jspec, where in pairs:
        jspec = _norm(jspec)
        assert jspec[0] is None
        assert _norm(spec) == jspec[1:], (where, spec, jspec)
        pb += _local_bytes(t.shape, spec, sizes, t.element_size())
    for (_, leaf), (_, spec) in zip(
            jax.tree_util.tree_flatten_with_path(jcaches)[0],
            jax.tree_util.tree_flatten_with_path(
                jspecs, is_leaf=lambda v: isinstance(
                    v, jax.sharding.PartitionSpec))[0]):
        jb += _local_bytes(leaf.shape, spec, sizes,
                           np.dtype(leaf.dtype).itemsize)
    return jb, pb


def test_to_placements_and_local_shape():
    from torch.distributed.tensor import Replicate, Shard
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                           shape=(2, 16, 16))
    spec = sh.P(("pod", "data"), None, "model")
    assert sh.to_placements(mesh, spec) == [Shard(0), Shard(0), Shard(2)]
    assert sh.local_shape(mesh, (64, 3, 32), spec) == (2, 3, 2)
    assert sh.to_placements(mesh, sh.P()) == [Replicate()] * 3
    # the guard drops an axis that does not divide, and a repeated one
    assert sh._guard(mesh, (6, 32, 32), ("data", "model", "model")) == \
        sh.P(None, "model", None)


def test_constrain_is_a_no_op_without_a_context_or_a_dtensor():
    x = torch.arange(6.0).reshape(1, 2, 3)
    assert sharding_ctx.current() is None
    for kind in sharding_ctx.KINDS:
        if kind in ("b2",):
            continue
        y = sharding_ctx.constrain(x, kind)
        assert y is x
    with sharding_ctx.activation_sharding(("data",), "model") as ctx:
        # a plain tensor under a context is returned as is, uncounted
        assert sharding_ctx.constrain(x, "btd") is x
        assert ctx["redistributions"] == {}
        assert sharding_ctx.current()["batch"] == ("data",)
    assert sharding_ctx.current() is None
    assert sharding_ctx.follow(x, x) is x
    assert sharding_ctx.settle(x) is x
