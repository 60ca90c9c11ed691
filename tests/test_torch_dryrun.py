"""The port's dry run (``launch/{mesh,steps,cost_analysis,dryrun}.py``,
``sharding_ctx``, the MoE's ``tensor_sm`` branch and the flash kernel's
op) against the JAX package's, on the CPU.

* FLOPs: the reference's ``steps.build`` + ``hlo_analysis.analyze`` runs
  in a subprocess on 1 and on 4 placeholder devices (meshes 1x1 and 2x2)
  for reduced qwen1.5-0.5b, qwen3-moe, mamba2, whisper-base and an
  8-layer Jamba period at train 2 x 256, prefill 2 x 256 and decode 2
  against 256, and mamba2 and Jamba at a one-row decode; the port traces
  the same steps on fake meshes of its own.  At 1x1 the port's
  per-device count equals the reference's ``flops_corrected`` within
  1e-3 for train and decode, once the differences worked out from the
  config alone are taken off: a one-row decode's matrix-vector products
  and the SSD scan's backward products (the port's rows held to that
  count exactly).  For prefill the flash calls count exactly the op's
  formula and the gap is exactly the flash layers' chunked softmax dots
  (the reference's LM stack never runs its flash kernel, ROADMAP C6)
  less that formula.  At 2x2 the port's per-device count times 4 is at
  least its 1x1 count, and the ops that are split take exactly a quarter
  of their 1x1 count; ``-rP`` prints both packages' 2x2 counts.  The
  output bytes plus 8 B an output leaf equal the reference's.
* ``tensor_sm``: two gloo ranks on a (1, 2) mesh run one reduced qwen3-moe
  MoE layer in bf16; its output matches the port's dense path without a
  mesh and the reference's ``shard_map`` branch on 2 placeholder devices
  within ``BF16_TOL`` of the output's largest magnitude (the partial sums
  are rounded to bf16 before the all-reduce, as the variant means to).
* The flash op: fake shapes and dtypes, its FLOP formula, heads split over
  a fake 1x4 mesh reaching it as (B, H/4, T, d), and on CPU tensors the
  same bits as the wrapper called with ``out=`` as before.
* The record, the long_500k skip rule and the CLI's exit code.

The fake process group is process-global: every test that starts one
destroys it (``_fake_group``).  The reference runs only in subprocesses:
``repro.launch.dryrun`` sets ``XLA_FLAGS`` when imported.
"""
import contextlib
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ShapeConfig, reduced  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.launch import dryrun, mesh as pmesh  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# (name, reduced's keywords, fields replaced after): whisper at d_model 96
# has 3 heads, which 2 devices cannot split (its decode cross-attention
# then splits the head dim); Jamba at 8 layers keeps its whole period
ARCHS = (("qwen1.5-0.5b", {}, {}), ("qwen3-moe-30b-a3b", {}, {}),
         ("mamba2-1.3b", {}, {}), ("whisper-base", {"d_model": 96}, {}),
         ("jamba-1.5-large-398b", {"n_layers": 8},
          {"attn_every": 8, "attn_offset": 4}))
MODES = ("train", "prefill", "decode")
# a long decode's one row (long_500k's batch), which no data axis splits
LONG_ARCHS = ("mamba2-1.3b", "jamba-1.5-large-398b")
B, T = 2, 256
FLOP_REL = 1e-3
BF16_TOL = 2e-2


def _src_env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)
    env.pop("REPRO_TORCH_KERNEL_BACKEND", None)
    return env


@contextlib.contextmanager
def _fake_group(world: int):
    """The ``fake`` process group at ``world`` ranks for the block, then
    destroyed, so no other test sees a default group."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    pmesh.start_fake_group(world)
    try:
        yield
    finally:
        pmesh.release()


def _cfg(name, rkw, over):
    import dataclasses
    return dataclasses.replace(reduced(get_arch(name), **rkw), **over)


def _shapes(name):
    """mode label -> ShapeConfig of the arch's FLOP cases."""
    out = {m: ShapeConfig("t", T, B, m) for m in MODES}
    if name in LONG_ARCHS:
        out["long"] = ShapeConfig("t", T, 1, "decode")
    return out


def _cpu_mesh(data, model):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", (data, model),
                            mesh_dim_names=("data", "model"))


REFERENCE_FLOPS = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax
    from jax.sharding import AxisType, Mesh
    from repro.configs.base import reduced, ShapeConfig
    from repro.configs.registry import get_arch
    from repro.launch import shardings as sh
    from repro.launch.steps import build
    from repro.launch.hlo_analysis import analyze
    from repro.sharding_ctx import activation_sharding
    out = {}
    for d, m in ((1, 1), (2, 2)):
        devs = np.array(jax.devices()[:d * m]).reshape(d, m)
        mesh = Mesh(devs, ("data", "model"),
                    axis_types=(AxisType.Auto,) * 2)
        pol = sh.ShardingPolicy(batch_axes=("data",))
        for arch, rkw, over in %(archs)r:
            cfg = dataclasses.replace(reduced(get_arch(arch), **rkw), **over)
            modes = [(m, %(B)d, m) for m in %(modes)r]
            if arch in %(long)r:
                modes.append(("long", 1, "decode"))
            for mode, b, kind in modes:
                built = build(cfg, ShapeConfig("t", %(T)d, b, kind),
                              mesh, pol, remat=True)
                with mesh, activation_sharding(("data",), "model",
                                               batch_shardable=b %% d == 0,
                                               mesh=mesh, fsdp_axis="data"):
                    c = jax.jit(built["fn"],
                                in_shardings=sh.to_named(
                                    mesh, built["in_shardings"]),
                                out_shardings=sh.to_named(
                                    mesh, built["out_shardings"])
                                ).lower(*built["args"]).compile()
                    leaves = jax.tree.leaves(jax.eval_shape(
                        built["fn"], *built["args"]))
                out[f"{d}x{m}/{arch}/{mode}"] = {
                    "flops": analyze(c.as_text())["flops_corrected"],
                    "out_bytes": c.memory_analysis().output_size_in_bytes,
                    "leaves": len(leaves)}
    print(json.dumps(out))
""") % dict(archs=ARCHS, modes=MODES, T=T, B=B, long=LONG_ARCHS)


@pytest.fixture(scope="module")
def reference_flops():
    out = subprocess.run([sys.executable, "-c", REFERENCE_FLOPS],
                         env=_src_env(JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port_flops(data, model):
    """"arch/mode" -> (the record, {issuing frame: flops}, the flops of
    matrix-vector rows: products whose first operand has one row, the
    count's dot rows)."""
    out = {}
    with _fake_group(data * model):
        mesh = _cpu_mesh(data, model)
        pol = sh.ShardingPolicy(batch_axes=("data",))
        for arch, rkw, over in ARCHS:
            cfg = _cfg(arch, rkw, over)
            for mode, shape in _shapes(arch).items():
                res = dryrun.trace_step(cfg, shape, mesh, pol, device="cpu")
                frames, vec = {}, 0.0
                for (op, shapes, who), (_, f) in \
                        res["mode"].dot_rows.items():
                    frames[who] = frames.get(who, 0.0) + f
                    if op != "flash_attention" and np.prod(
                            shapes[0][:-1]) == 1:
                        vec += f
                out[f"{arch}/{mode}"] = (res["record"], frames, vec,
                                         res["mode"].dot_rows)
    return out


def _chunks(cfg) -> tuple:
    """(mamba layers, chunk length, chunks) of a step over T, as
    ``mamba._ssd`` cuts it."""
    from repro_torch.models.transformer import layer_kinds
    L = min(cfg.mamba.chunk, T)
    while T % L:
        L //= 2
    return sum(k == "mamba" for k, _ in layer_kinds(cfg)), L, T // L


def _scan_backward(cfg, b: int) -> tuple:
    """The SSD scan's backward products in a train step of batch ``b`` a
    device, from the config alone: ({(lhs, rhs) shapes: count} that the
    port's autograd runs, the FLOPs the reference's differentiated
    ``lax.scan`` counts beyond them).  Autograd runs both products of the
    intra-chunk term (scores (bH, L, L) @ x (bH, L, P)) and the inter-
    chunk term's product into C on every chunk; that term's product into
    the carried state on every chunk but the first (the initial state is
    zeros, with no gradient), and the state update's two (x^T (bH, P, L)
    @ w.B (bH, L, N)) on every chunk but the last (its final state is
    unused).  The scan differentiates every chunk alike, so counts those
    three products once more a layer; and XLA contracts the state
    update's x over the head dim as one more product (2.b.L.H.P a chunk)
    where the port multiplies and sums."""
    from collections import Counter
    m = cfg.mamba
    n, L, C = _chunks(cfg)
    H, P, N = m.expand * cfg.d_model // m.head_dim, m.head_dim, m.d_state
    bh = b * H
    rows = Counter()
    rows[(bh, L, P), (bh, P, L)] += n * C            # into the scores
    rows[(bh, L, L), (bh, L, P)] += n * C            # into x
    rows[(b, L, H * P), (b, H * P, N)] += n * C      # into C
    rows[(b, N, L), (b, L, H * P)] += n * (C - 1)    # into the state
    rows[(bh, P, N), (bh, N, L)] += n * (C - 1)      # into x^T
    rows[(bh, L, P), (bh, P, N)] += n * (C - 1)      # into w.B
    skipped = n * (2 * b * N * L * H * P + 2 * (2 * bh * P * N * L))
    return dict(rows), skipped + n * C * 2 * b * L * H * P


def _prefill_flash(cfg, b: int) -> tuple:
    """(the flash calls' FLOPs by the op's formula, what the reference's
    chunked softmax computes in their place beyond that) in a prefill of
    T, batch ``b`` a device, from the config alone: every attention layer
    of the stack causal over T (the formula counts the causal half of the
    (T, T) square, the chunked softmax both products over all of it), and
    whisper's encoder layers unmasked over its frames (both count the
    whole square)."""
    from repro_torch.models.transformer import layer_kinds
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    n = sum(k == "attn" for k, _ in layer_kinds(cfg))
    S = cfg.encoder_seq
    formula = 4 * b * H * hd * (T * (T + 1) // 2)
    chunked = 2 * (2 * b * H * T * T * hd)
    square = 4 * b * H * S * S * hd
    return (n * formula + cfg.n_encoder_layers * square,
            n * (chunked - formula))


# Frames whose products the dry run's splits keep from repeating on the 2x2
# mesh: per device, a quarter of the 1x1 count.  (The SSD's C.B^T split
# over the state channels, the decode router's over the experts, the
# one-row decode's q heads over the idle data axis and the head dim over
# the model axis, a cross-attention query's head dim.)
SPLIT_FRAMES = {
    ("mamba2-1.3b", "train"): ("models/mamba.py:_cb",
                               "models/mamba.py:_cb (backward)"),
    ("mamba2-1.3b", "prefill"): ("models/mamba.py:_cb",),
    ("jamba-1.5-large-398b", "train"): ("models/mamba.py:_cb",
                                        "models/mamba.py:_cb (backward)"),
    ("jamba-1.5-large-398b", "prefill"): ("models/mamba.py:_cb",),
    ("jamba-1.5-large-398b", "decode"): ("models/moe.py:_router_product",),
    ("jamba-1.5-large-398b", "long"): ("models/moe.py:_router_product",
                                       "models/attention.py:_attend_row"),
    ("qwen3-moe-30b-a3b", "decode"): ("models/moe.py:_router_product",),
    # at 1x1 the cross-attention's one query row takes the chunked
    # softmax whole, at 2x2 the one-row core as the self-attention's
    # decode does: (the 1x1 frames, the 2x2 frames)
    ("whisper-base", "decode"): ((("models/attention.py:_sdpa_chunked",
                                   "models/attention.py:_attend_row"),
                                  ("models/attention.py:_attend_row",)),),
}


def test_flops_equal_the_reference_per_device(reference_flops):
    """At 1x1 the port's count equals the reference's within FLOP_REL;
    prefill's flash calls count exactly :func:`_prefill_flash`'s formula
    and the reference exactly its C6 gap more; a one-row decode's count is
    above it by exactly its matrix-vector products, which XLA's CPU
    compiler rewrites as multiplies and reductions (no ``dot`` left to
    count); an SSD train step runs exactly :func:`_scan_backward`'s
    backward products and the reference counts its extra.  At 2x2 the
    frames of
    ``SPLIT_FRAMES`` take a quarter of their 1x1 count per device, and no
    case takes less than a quarter of its 1x1 count."""
    one = _port_flops(1, 1)
    four = _port_flops(2, 2)
    for arch, rkw, over in ARCHS:
        cfg = _cfg(arch, rkw, over)
        for mode in _shapes(arch):
            key = f"{arch}/{mode}"
            rec, frames, vec, rows = one[key]
            got = rec["flops_corrected"]
            want = reference_flops[f"1x1/{key}"]["flops"]
            flash = sum(f for (op, _, _), (_, f) in rows.items()
                        if op == "flash_attention")
            gap = 0.0
            if mode == "long":
                assert vec > 0, key
                got -= vec
            else:
                assert vec == 0, key
            scan = 0.0
            if mode == "train" and cfg.mamba is not None:
                want_rows, scan = _scan_backward(cfg, B)
                assert {s: n for (_, s, who), (n, _) in rows.items()
                        if who == "models/mamba.py:_ssd_chunk_scan "
                        "(backward)"} == want_rows, key
            got += scan
            if mode == "prefill":
                formula, gap = _prefill_flash(cfg, B)
                assert flash == formula, (key, flash, formula)
                assert want - got == gap, (key, got, want, gap)
            else:
                assert flash == 0, key
                assert abs(got - want) <= FLOP_REL * want, (key, got, want)
            rec4, frames4, _, _ = four[key]
            got4 = rec4["flops_corrected"]
            assert got4 * 4 >= rec["flops_corrected"], (key, got4)
            for frame in SPLIT_FRAMES.get((arch, mode), ()):
                f1, f4 = ((frame,), (frame,)) if isinstance(frame, str) \
                    else frame
                n1 = sum(frames.get(f, 0.0) for f in f1)
                n4 = sum(frames4.get(f, 0.0) for f in f4)
                assert all(frames.get(f, 0.0) > 0 for f in f1), (key, f1)
                assert n4 * 4 == n1, (key, f4, n4, n1)
            print(f"{key}: 1x1 port {rec['flops_corrected']:.6e} ref "
                  f"{want:.6e} (C6 gap {gap:.4e}, matrix-vector "
                  f"{vec:.4e}, scan {scan:.4e}); 2x2 per device port "
                  f"{got4:.6e} ref "
                  f"{reference_flops[f'2x2/{key}']['flops']:.6e}")


def test_output_bytes_are_the_references_less_a_pointer_a_leaf(
        reference_flops):
    """Every case's output bytes a device, on 1x1 and 2x2, plus 8 B for
    each leaf of the step's output in the JAX package (its compiled
    output is a tuple whose table holds a pointer a leaf; the port's
    outputs carry no such table) equal the reference's
    ``output_size_in_bytes``."""
    for data, model in ((1, 1), (2, 2)):
        with _fake_group(data * model):
            mesh = _cpu_mesh(data, model)
            pol = sh.ShardingPolicy(batch_axes=("data",))
            for arch, rkw, over in ARCHS:
                cfg = _cfg(arch, rkw, over)
                for mode, shape in _shapes(arch).items():
                    want = reference_flops[f"{data}x{model}/{arch}/{mode}"]
                    rec = dryrun.trace_step(cfg, shape, mesh, pol,
                                            device="cpu")["record"]
                    got = rec["memory_analysis"]["output_size_in_bytes"]
                    assert got + 8 * want["leaves"] == want["out_bytes"], (
                        data, model, arch, mode, got, want)


REFERENCE_MOE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import dataclasses, numpy as np, jax, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.configs.base import reduced
    from repro.configs.registry import get_arch
    from repro.models import moe
    from repro.sharding_ctx import activation_sharding
    z = np.load(sys.argv[1])
    cfg = reduced(get_arch("qwen3-moe-30b-a3b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, sharding="tensor_sm"))
    mesh = jax.make_mesh((1, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    p = {"router": jnp.asarray(z["router"]), "w_gate": bf(z["w_gate"]),
         "w_up": bf(z["w_up"]), "w_down": bf(z["w_down"])}
    specs = {"router": P("data", None), "w_gate": P(None, "data", "model"),
             "w_up": P(None, "data", "model"),
             "w_down": P(None, "model", "data")}
    x = bf(z["x"])
    with mesh, activation_sharding(("data",), "model", batch_shardable=True,
                                   mesh=mesh, fsdp_axis="data"):
        f = jax.jit(lambda p, x: moe.moe_apply(p, x, cfg, cfg.act),
                    in_shardings=({k: NamedSharding(mesh, s)
                                   for k, s in specs.items()},
                                  NamedSharding(mesh, P("data", None, None))))
        out, aux = f(p, x)
    np.savez(sys.argv[2], out=np.asarray(out.astype(jnp.float32)),
             aux=np.asarray(aux))
""")

GLOO_MOE = textwrap.dedent("""
    import sys, dataclasses, numpy as np, torch, torch.distributed as dist
    from torch import nn
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import mesh as pm, shardings as sh
    from repro_torch.models import moe
    from repro_torch.sharding_ctx import activation_sharding
    rank, port, src, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                            sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    mesh = pm.make_host_mesh(1, 2, device="cpu")
    z = np.load(src)
    cfg = reduced(get_arch("qwen3-moe-30b-a3b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, sharding="tensor_sm"))
    pol = sh.ShardingPolicy(batch_axes=("data",))
    p = nn.ParameterDict()
    for k in ("router", "w_gate", "w_up", "w_down"):
        t = torch.from_numpy(z[k])
        if k != "router":
            t = t.to(torch.bfloat16)
        spec = sh._leaf_spec(("blocks", "0", "moe", k), tuple(t.shape),
                             mesh, pol)
        p[k] = nn.Parameter(distribute_tensor(
            t, mesh, sh.to_placements(mesh, spec)), requires_grad=False)
    x = distribute_tensor(torch.from_numpy(z["x"]).to(torch.bfloat16),
                          mesh, sh.to_placements(mesh, ("data",)))
    with activation_sharding(("data",), "model", mesh=mesh,
                             fsdp_axis="data") as ctx:
        y, aux = moe.moe_apply(p, x, cfg, cfg.act)
        y = y.full_tensor()
        aux = aux.full_tensor()
    if rank == 0:
        np.savez(out, out=y.float().numpy(), aux=aux.numpy(),
                 red=np.array(sum(ctx["redistributions"].values())))
    dist.destroy_process_group()
""")


GLOO_STEPS = textwrap.dedent("""
    import sys, numpy as np, torch, torch.distributed as dist
    from repro_torch.configs.base import reduced, ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun, mesh as pm, shardings as sh
    from repro_torch.launch import steps
    from repro_torch.sharding_ctx import settle
    rank, port, arch, out, data, B, model = (
        int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4],
        int(sys.argv[5]), int(sys.argv[6]), int(sys.argv[7]))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=data * model, rank=rank)
    mesh = pm.make_host_mesh(data, model, device="cpu")
    cfg = reduced(get_arch(arch))
    if arch == "whisper-base":
        # 3 heads on 2 devices, 63 frames: the queries' split, padded
        import dataclasses
        cfg = dataclasses.replace(reduced(get_arch(arch), d_model=96),
                                  encoder_seq=63)
    pol = sh.ShardingPolicy(batch_axes=("data",))
    res = {}
    # one seed on both ranks: a replicated leaf draws the same values
    gen = torch.Generator().manual_seed(0)
    pre = dryrun.trace_step(cfg, ShapeConfig("p", 64, B, "prefill"), mesh,
                            pol, device="cpu", fake=False, gen=gen,
                            param_dtype=torch.float32)
    res["prefill"] = pre["outputs"][0].full_tensor().numpy()
    for k, v in pre["args"][1].items():
        res[k] = v.full_tensor().float().numpy() if k == "frames" \
            else v.full_tensor().numpy()
    # one decode step at position 64 against the prefill's caches
    from torch.distributed.tensor import Replicate, distribute_tensor
    dshape = ShapeConfig("d", 64, B, "decode")
    ispec = steps.build(cfg, dshape, mesh, pol)["in_specs"][2]
    tok = torch.from_numpy(res["tokens"][:, -1:])
    batch = {"tokens": distribute_tensor(
                 tok, mesh, sh.to_placements(mesh, ispec["tokens"])),
             "pos": distribute_tensor(torch.tensor(64, dtype=torch.int32),
                                      mesh, [Replicate(), Replicate()])}
    dec = dryrun.trace_step(cfg, dshape, mesh, pol, device="cpu",
                            fake=False, args=[pre["args"][0],
                                              pre["outputs"][1], batch])
    res["decode"] = dec["outputs"][0].full_tensor().numpy()
    shape = ShapeConfig("t", 64, B, "train")
    built = steps.build(cfg, shape, mesh, pol, param_dtype=torch.float32)
    args = steps.place_args(built, mesh, "cpu", gen)
    params, batch = args[0], args[3]
    with dryrun.step_context(shape, mesh, pol):
        loss, _ = built["model"].loss(params, batch)
        grads = [settle(g, None) for g in
                 torch.autograd.grad(loss, params.leaves)]
    res["loss"] = loss.full_tensor().detach().numpy()
    for k, v in batch.items():
        res["b/" + k] = v.full_tensor().float().numpy() if k == "frames" \
            else v.full_tensor().numpy()
    for n, p, g in zip(params.leaf_names, params.leaves, grads):
        res["p/" + n] = p.full_tensor().detach().numpy()
        res["g/" + n] = g.full_tensor().numpy()
    for n, p in zip(pre["args"][0].leaf_names, pre["args"][0].leaves):
        res["pp/" + n] = p.full_tensor().numpy()
    if rank == 0:
        np.savez(out, **res)
    dist.destroy_process_group()
""")

STEP_TOL = 1e-5
# decode reads bf16 caches: a prefill key or value the sharded sums round
# to the other side of a bf16 step moves the decode logits by more than
# the f32 order does (whisper's cross caches: 1.9e-5)
DECODE_TOL = 1e-4


# (arch, data axis size of the two ranks, batch): batch 1 on (2, 1) is a
# batch the data axis cannot split, whose weights keep their FSDP split
# and whose decode splits its q heads over the idle data axis; on (1, 2)
# the SSD's C.B^T splits over the state channels, the MoE router's
# decode product over the experts and its weight gradient by columns,
# and Jamba's one kv head takes the head-dim split
GLOO_CASES = (("qwen1.5-0.5b", 1, 2), ("mamba2-1.3b", 1, 2),
              ("qwen3-moe-30b-a3b", 1, 2), ("llama4-scout-17b-a16e", 1, 2),
              ("whisper-base", 1, 2), ("mamba2-1.3b", 2, 2),
              ("qwen3-moe-30b-a3b", 2, 2), ("mamba2-1.3b", 2, 1),
              ("qwen3-moe-30b-a3b", 2, 1), ("jamba-1.5-large-398b", 1, 2),
              ("jamba-1.5-large-398b", 2, 1), ("qwen1.5-0.5b", 2, 1))


# (arch, data axis size, batch) on a (data, 2) mesh of four gloo ranks:
# Jamba's one-row decode splits its one kv head's dim over the model axis
# and its q heads over the idle data axis at once
GLOO4_CASES = (("jamba-1.5-large-398b", 2, 1),)


def _gloo(d, cases, model):
    """Every case's gloo ranks on a (data, ``model(data)``) mesh, started
    together: case -> the npz its rank 0 wrote."""
    procs, outs = [], {}
    for arch, data, batch in cases:
        port, out = _free_port(), d / f"{arch}-{data}-{batch}.npz"
        outs[arch, data, batch] = out
        procs += [subprocess.Popen([sys.executable, "-c", GLOO_STEPS,
                                    str(r), str(port), arch, str(out),
                                    str(data), str(batch),
                                    str(model(data))],
                                   env=_src_env(OMP_NUM_THREADS="1"),
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
                  for r in range(data * model(data))]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    return outs


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    return _gloo(tmp_path_factory.mktemp("gloo"), GLOO_CASES,
                 lambda data: 2 // data)


@pytest.fixture(scope="module")
def gloo4_runs(tmp_path_factory):
    return _gloo(tmp_path_factory.mktemp("gloo4"), GLOO4_CASES,
                 lambda data: 2)


@pytest.mark.parametrize("arch,data,rows", GLOO4_CASES)
def test_four_gloo_ranks_give_the_mesh_free_path(arch, data, rows,
                                                 gloo4_runs):
    """As :func:`test_two_gloo_ranks_give_the_mesh_free_path` on a (2, 2)
    mesh of four gloo ranks."""
    _hold_to_plain(np.load(gloo4_runs[arch, data, rows]), arch,
                   f"({data}, 2), batch {rows}", 4)


@pytest.mark.parametrize("arch,data,rows", GLOO_CASES)
def test_two_gloo_ranks_give_the_mesh_free_path(arch, data, rows,
                                                gloo_runs):
    """The sharded step on a real mesh of two gloo ranks, (1, 2) or (2,
    1), f32 params, batch 2 (or 1, which the data axis cannot split): the prefill's logits, one decode step's against its
    caches, the loss and every gradient (heads and d_ff over the model
    axis or the batch over the data axis, the vocab-parallel embedding
    and cross entropy, Mamba's head-split scan and its gated norm, the
    MoE regions; reduced llama4-scout's one kv head on two devices takes
    the kv cut in prefill and the head-dim split in decode, a 3-head
    whisper with 63 frames the queries' split, padded) equal the plain
    path's on the gathered params within ``STEP_TOL`` of each one's
    largest magnitude (the sums run in another order; decode within
    ``DECODE_TOL``).  The SSD's C.B^T split over the state channels, the
    MoE router's decode product split over the experts and its weight
    gradient by columns, and a one-row decode's q heads split over the
    idle data axis (qwen1.5, and Jamba's one kv head) are among them."""
    _hold_to_plain(np.load(gloo_runs[arch, data, rows]), arch,
                   f"({data}, {2 // data}), batch {rows}", 2)


def _hold_to_plain(z, arch, label, ranks):
    import dataclasses
    from torch import nn
    from repro_torch.models.model_api import Model
    cfg = reduced(get_arch(arch))
    if arch == "whisper-base":
        cfg = dataclasses.replace(reduced(get_arch(arch), d_model=96),
                                  encoder_seq=63)
    model = Model(cfg, device="cpu")

    def plain(prefix, grad):
        params = model.abstract_params(torch.float32)
        for name, _ in list(params.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = params.get_submodule(mod_name) if mod_name else params
            mod._parameters[leaf] = nn.Parameter(
                torch.from_numpy(z[prefix + name]), requires_grad=grad)
        return params

    def close(got, want, label, tol=STEP_TOL):
        got, want = np.asarray(got), np.asarray(want)
        scale = max(np.abs(want).max(), 1e-30)
        gap = np.abs(got - want).max() / scale
        assert gap <= tol, (label, gap)
        return gap

    pp = plain("pp/", False)
    with torch.no_grad():
        pb = {"tokens": torch.from_numpy(z["tokens"])}
        if "frames" in z.files:
            pb["frames"] = torch.from_numpy(z["frames"]).to(torch.bfloat16)
        want, caches = model.prefill(pp, pb)
        dwant, _ = model.decode_step(
            pp, torch.from_numpy(z["tokens"][:, -1:]), caches, 64)
    gaps = [close(z["prefill"], want.numpy(), "prefill"),
            close(z["decode"], dwant.numpy(), "decode", DECODE_TOL)]
    params = plain("p/", True)
    batch = {k[2:]: torch.from_numpy(z[k]) for k in z.files
             if k.startswith("b/")}
    if "frames" in batch:
        batch["frames"] = batch["frames"].to(torch.bfloat16)
    loss, _ = model.loss(params, batch)
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    gaps.append(close(z["loss"], loss.detach().numpy(), "loss"))
    for n, g in zip(names, grads):
        gaps.append(close(z["g/" + n], g.numpy(), n))
    print(f"{arch} on {label}: prefill, decode, loss and {len(names)} "
          f"gradients on {ranks} gloo ranks within {max(gaps):.2e} of the "
          f"plain path")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_tensor_sm_matches_the_dense_path_and_the_reference(tmp_path):
    from repro_torch.models import moe
    cfg = reduced(get_arch("qwen3-moe-30b-a3b"))
    m = cfg.moe
    rng = np.random.default_rng(0)
    D, E, Fe = cfg.d_model, m.num_experts, m.d_ff_expert
    z = {"router": rng.normal(0, D ** -0.5, (D, E)).astype(np.float32),
         "w_gate": rng.normal(0, D ** -0.5, (E, D, Fe)).astype(np.float32),
         "w_up": rng.normal(0, D ** -0.5, (E, D, Fe)).astype(np.float32),
         "w_down": rng.normal(0, Fe ** -0.5, (E, Fe, D)).astype(np.float32),
         "x": rng.normal(0, 1, (2, 64, D)).astype(np.float32)}
    src = tmp_path / "moe.npz"
    np.savez(src, **z)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", GLOO_MOE, str(r),
                               str(port), str(src), str(tmp_path / "sm")],
                              env=_src_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    ref = subprocess.run([sys.executable, "-c", REFERENCE_MOE, str(src),
                          str(tmp_path / "ref")],
                         env=_src_env(JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=300)
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    assert ref.returncode == 0, ref.stderr[-3000:]
    sm = np.load(tmp_path / "sm.npz")
    jx = np.load(tmp_path / "ref.npz")

    from torch import nn
    dense = nn.ParameterDict({
        k: nn.Parameter(torch.from_numpy(z[k]) if k == "router" else
                        torch.from_numpy(z[k]).to(torch.bfloat16),
                        requires_grad=False)
        for k in ("router", "w_gate", "w_up", "w_down")})
    want, aux = moe.moe_apply(dense, torch.from_numpy(z["x"]).to(
        torch.bfloat16), cfg, cfg.act)
    want = want.float().numpy()
    scale = np.abs(want).max()
    gap_dense = np.abs(sm["out"] - want).max() / scale
    gap_ref = np.abs(sm["out"] - jx["out"]).max() / scale
    print(f"tensor_sm vs dense {gap_dense:.3e}, vs reference "
          f"{gap_ref:.3e} of max |out| {scale:.3f}; forced "
          f"redistributions {int(sm['red'])}")
    assert gap_dense <= BF16_TOL and gap_ref <= BF16_TOL
    np.testing.assert_allclose(sm["aux"], aux.numpy(), rtol=1e-5)
    np.testing.assert_allclose(sm["aux"], jx["aux"], rtol=1e-5)


def test_flash_op_fake_shapes_flops_and_bits():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    Bq, H, Tq, d = 2, 4, 33, 16
    with FakeTensorMode():
        for dt in (torch.float32, torch.bfloat16):
            q = torch.empty(Bq, H, Tq, d, dtype=dt)
            kv = torch.empty(Bq, 2, Tq, d, dtype=dt)
            o = ops.FLASH_OP(q, kv, kv, True)
            assert o.shape == q.shape and o.dtype == dt
            assert o.transpose(1, 2).is_contiguous()
    g = torch.Generator().manual_seed(0)
    q = torch.randn(Bq, Tq, H, d, generator=g)
    k = torch.randn(Bq, Tq, 2, d, generator=g)
    v = torch.randn(Bq, Tq, 2, d, generator=g)
    for causal in (True, False):
        with FlopCounterMode(display=False) as fc:
            got = attention._flash(q, k, v, causal=causal)
        pairs = Tq * (Tq + 1) // 2 if causal else Tq * Tq
        assert fc.get_total_flops() == 4 * Bq * H * d * pairs
        # the call path before the op: the wrapper writing a (B,T,H,d)
        # buffer through out=
        before = torch.empty(q.shape, dtype=q.dtype)
        ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal,
                            out=before.transpose(1, 2))
        assert torch.equal(got, before) and got.is_contiguous()


def test_heads_split_over_a_fake_mesh_reach_the_op_per_device():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.sharding_ctx import activation_sharding
    seen = []

    def core(q, k, v):
        seen.append((tuple(q.transpose(1, 2).shape), tuple(k.shape)))
        return attention._flash(q, k, v)

    with _fake_group(4):
        mesh = _cpu_mesh(1, 4)
        fake = FakeTensorMode()
        with fake, activation_sharding(("data",), "model", mesh=mesh):
            Bq, Tq, H, Hkv, d = 2, 64, 8, 2, 32
            # the data axis has one device: its layout is Replicate()
            q = DTensor.from_local(torch.empty(Bq, Tq, H // 4, d), mesh,
                                   [Replicate(), Shard(2)], run_check=False)
            kv = DTensor.from_local(torch.empty(Bq, Tq, Hkv, d), mesh,
                                    [Replicate(), Replicate()],
                                    run_check=False)
            out = attention.attention_region(core, q, kv, kv)
            assert out.shape == (Bq, Tq, H, d)
            assert out.placements == (Replicate(), Shard(2))
    # each device's 2 q heads read the one kv head of their group
    assert seen == [((Bq, H // 4, Tq, d), (Bq, Tq, 1, d))]


def test_input_stand_ins_and_concrete_inputs_agree():
    from repro_torch.models.model_api import concrete_inputs, input_specs
    for arch in ("qwen1.5-0.5b", "whisper-base"):
        cfg = reduced(get_arch(arch))
        for mode in MODES:
            shape = ShapeConfig("t", 16, 2, mode)
            spec = input_specs(cfg, shape)
            got = concrete_inputs(cfg, shape,
                                  torch.Generator().manual_seed(0))
            assert set(got) == set(spec)
            for k, t in spec.items():
                assert t.is_meta and got[k].shape == t.shape, (arch, k)
                assert got[k].dtype == t.dtype, (arch, k)
            assert 0 <= int(got["tokens"].min()) and \
                int(got["tokens"].max()) < cfg.vocab_size
            if mode == "decode":
                assert int(got["pos"]) == 8


def test_record_skip_rule_and_cli_exit(tmp_path):
    cfg = reduced(get_arch("qwen1.5-0.5b"))
    try:
        rec = dryrun.run_one("qwen1.5-0.5b", "train_4k", multi_pod=False,
                             device="cpu", art_dir=str(tmp_path), cfg=cfg)
    finally:
        pmesh.release()
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == 256 and rec["flops_corrected"] > 0
    assert rec["trace_s"] > 0 and rec["peak_live_bytes"] > 0
    for k in ("argument_size_in_bytes", "output_size_in_bytes"):
        assert rec["memory_analysis"][k] > 0
    # the argument bytes are the local shards the specs give
    mesh = type("M", (), {"mesh_dim_names": ("data", "model"),
                          "shape": (16, 16)})()
    pol = sh.ShardingPolicy(batch_axes=("data",))
    built = steps.build(cfg, dryrun.get_shape("train_4k"), mesh, pol)
    specs = built["in_specs"]
    want = sum(sh.local_nbytes(mesh, t, specs[0][n])
               for n, t in built["args"][0].named_parameters()) * 3 + 4
    want += sum(sh.local_nbytes(mesh, t, specs[3][k])
                for k, t in built["args"][3].items())
    assert rec["memory_analysis"]["argument_size_in_bytes"] == want
    assert json.loads((tmp_path / "qwen1.5-0.5b__train_4k__pod16x16__"
                       "baseline.json").read_text())["status"] == "ok"
    skip = dryrun.run_one("qwen1.5-0.5b", "long_500k", multi_pod=True,
                          device="cpu", art_dir=str(tmp_path))
    assert skip["status"] == "skipped"
    # a cuda mesh on a torch without CUDA is an error and exit code 1,
    # never a quiet trace on the CPU
    import torch.distributed as dist
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                     "--force", "--out-dir", str(tmp_path)])
    assert e.value.code == 1 and not dist.is_initialized()
    rec = json.loads((tmp_path / "qwen1.5-0.5b__decode_32k__pod16x16__"
                      "baseline.json").read_text())
    assert rec["status"] == "error" and rec["device"] == "cuda"


@pytest.mark.cuda
def test_prefill_on_a_one_rank_nccl_mesh_takes_the_kernel_bit_equal():
    """Reduced qwen1.5-0.5b prefill (2 x 128, bf16 params as ``build``
    makes them) on a (1, 1) mesh over a one-rank NCCL group: one flash
    launch a layer, and the logits bit-equal to the plain
    ``Model.prefill`` on the same params without a mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist
    from repro_torch.kernels import build
    build.load()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        mesh = pmesh.make_host_mesh(1, 1, device="cuda")
        cfg = reduced(get_arch("qwen1.5-0.5b"))
        pol = sh.ShardingPolicy(batch_axes=("data",))
        gen = torch.Generator("cuda").manual_seed(0)
        shape = ShapeConfig("t", 128, 2, "prefill")
        ops.reset_launches()
        res = dryrun.trace_step(cfg, shape, mesh, pol, device="cuda",
                                fake=False, gen=gen)
        launches = ops.LAUNCHES["flash_attention"]
        logits = res["outputs"][0].to_local()
        params = res["args"][0]
        plain = {n: p.to_local() for n, p in zip(params.leaf_names,
                                                 params.leaves)}
    finally:
        dist.destroy_process_group()
    from repro_torch.models.model_api import Model
    model = Model(cfg, device="cuda")
    ref_params = model.init(None, torch.bfloat16)
    with torch.no_grad():
        for n, p in ref_params.named_parameters():
            p.copy_(plain[n])
    want, _ = model.prefill(ref_params, {"tokens": res["args"][1][
        "tokens"].to_local()})
    assert launches == cfg.n_layers
    assert torch.equal(logits, want)
