"""Multi-pod dry run: trace every (architecture x input-shape x mesh)
combination against the production mesh and record its per-device cost,
memory and collective statistics.

A port of the JAX package's ``launch/dryrun.py`` over PyTorch's own SPMD.
The production mesh (``launch/mesh.py``) is a ``DeviceMesh`` over the
``"fake"`` process group at 256 or 512 ranks, this process rank 0; the
params, optimizer state, inputs and caches are DTensors laid out by the
per-leaf policy (``launch/shardings.py``), their local shards fake tensors
under a ``FakeTensorMode``, so nothing is allocated and no kernel runs.
The step (``launch/steps.py``) runs once, eagerly, under the activation
context (``sharding_ctx.activation_sharding``), and
``launch/cost_analysis.py`` counts each local op: the record is one
device's.  It writes::

    artifacts/dryrun_torch/<arch>__<shape>__<mesh>__<variant>.json

(a parameter, ``art_dir``), skipped when present unless ``force``::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

The mesh's device type is ``cuda`` (fake card tensors) unless ``--device
cpu`` is given, as the CPU tests give it: a PyTorch built without CUDA
cannot make a ``cuda`` mesh, and the dry run then fails rather than
quietly tracing on the CPU.

The record keeps the reference's fields where the quantity exists
(``status``, ``n_devices``, ``memory_analysis.argument_size_in_bytes`` and
``output_size_in_bytes`` from the local shards, ``flops_corrected``,
``bytes_accessed_corrected``, ``collectives``,
``collective_bytes_total``), and adds ``peak_live_bytes``,
``redistributions`` (by anchor kind, ``local_map`` and ``out``: each
redistribution the step forced) and ``trace_s``, the wall time of the
trace.  The reference's ``flops_per_device``/``cost_analysis_keys`` (XLA's
own cost analysis), ``temp_size_in_bytes``, ``hlo_bytes`` and the
lower/compile times have no counterpart: there is no compiled artifact.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, Optional

from repro_torch.configs.registry import (
    ARCHS, SHAPES, get_arch, get_shape, shape_applicable)
from repro_torch.launch import shardings as sh

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")

# sharding-policy variants, as the reference's
VARIANTS: Dict[str, Dict] = {
    "baseline": {},
    "kv_shard_seq": {"kv_shard_seq": True},
    "no_fsdp": {"fsdp": False},
    "moe_expert_parallel": {"moe_expert_parallel": True},
    "moe_bf16_psum": {"moe_tensor_sm": True},
    "moe_cap1": {"moe_capacity": 1.0},
    "moe_ep_cap1": {"moe_expert_parallel": True, "moe_capacity": 1.0},
    "kv_seq_model": {"kv_seq_model": True},
    "serve_nofsdp": {"fsdp": False},
    "serve_opt": {"fsdp": False, "kv_seq_model": True},
    "mesh64x4": {"mesh_data": 64, "mesh_model": 4},
    "mesh32x8": {"mesh_data": 32, "mesh_model": 8},
    "mesh64x4_ep_cap1": {"mesh_data": 64, "mesh_model": 4,
                         "moe_expert_parallel": True, "moe_capacity": 1.0},
    "mesh32x8_ep_cap1": {"mesh_data": 32, "mesh_model": 8,
                         "moe_expert_parallel": True, "moe_capacity": 1.0},
    "mesh32x8_cap1": {"mesh_data": 32, "mesh_model": 8, "moe_capacity": 1.0},
    "no_remat": {},          # handled via remat flag below
}


def policy_for(variant: str, mesh) -> sh.ShardingPolicy:
    """The variant's policy on ``mesh`` (its batch axes from the mesh)."""
    from repro_torch.launch.mesh import batch_axes
    vkw = {k: v for k, v in VARIANTS[variant].items()
           if not k.startswith("mesh_")}
    return sh.ShardingPolicy(batch_axes=batch_axes(mesh), **vkw)


def mesh_split(variant: str):
    """(data, model) sizes of the variant's production mesh."""
    vkw = VARIANTS[variant]
    return vkw.get("mesh_data", 16), vkw.get("mesh_model", 16)


def _redistribute_outputs(out, specs, mesh):
    """Each DTensor output laid out as its out spec asks (counted under
    ``out`` where it moves), as ``jit``'s out shardings do."""
    from repro_torch.sharding_ctx import count, is_dtensor
    if is_dtensor(out):
        target = sh.to_placements(mesh, sh._guard(mesh, out.shape, specs))
        if list(out.placements) == target:
            return out
        count("out")
        return out.redistribute(mesh, target)
    if isinstance(out, dict):
        return {k: _redistribute_outputs(v, specs[k], mesh)
                for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_redistribute_outputs(v, s, mesh)
                         for v, s in zip(out, specs))
    return out


def step_context(shape, mesh, pol: sh.ShardingPolicy):
    """The activation context a step of ``shape`` runs under on ``mesh``:
    the policy's batch axes (when the batch divides them), model axis and
    FSDP axis."""
    from repro_torch.sharding_ctx import activation_sharding
    batch_ok = shape.global_batch % sh._axis_size(mesh, pol.batch_axes) == 0
    return activation_sharding(pol.batch_axes, pol.model_axis,
                               batch_shardable=batch_ok, mesh=mesh,
                               fsdp_axis=pol.fsdp_axis if pol.fsdp else None)


def trace_step(cfg, shape, mesh, pol: sh.ShardingPolicy, *,
               remat: bool = True, device: str = "cuda",
               fake: bool = True, gen=None, param_dtype=None,
               args=None) -> Dict:
    """Build the step for (cfg, shape, mesh, pol), lay its arguments out on
    ``mesh`` and run it once under the activation context and a
    :class:`~repro_torch.launch.cost_analysis.CostMode`.  With ``fake``
    the local shards are fake tensors on ``device`` (the dry run); without,
    real ones drawn from ``gen`` (a real run on the card), or ``args``
    where given (DTensors laid out as the step's in specs, e.g. a
    prefill's caches for a decode step).  Returns {"record", "outputs",
    "args", "built", "mode"}."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import steps
    from repro_torch.launch.cost_analysis import CostMode
    import contextlib

    kw = {} if param_dtype is None else {"param_dtype": param_dtype}
    built = steps.build(cfg, shape, mesh, pol, remat=remat, **kw)
    fake_mode = FakeTensorMode() if fake else None
    in_fake = fake_mode if fake else contextlib.nullcontext()
    if args is None:
        with in_fake:
            args = steps.place_args(built, mesh, device, gen)
    rec = {"memory_analysis": {
        "argument_size_in_bytes": steps.local_bytes(args)}}
    fn, out_specs = built["fn"], built["out_specs"]

    def step(*a):
        return _redistribute_outputs(fn(*a), out_specs, mesh)

    mode = CostMode(fake_mode)
    mode.hold(args)
    t0 = time.time()
    with step_context(shape, mesh, pol) as ctx, in_fake, mode:
        out = step(*args)
        if not fake and torch.cuda.is_available():
            torch.cuda.synchronize()
    rec["trace_s"] = round(time.time() - t0, 3)
    rec["memory_analysis"]["output_size_in_bytes"] = steps.local_bytes(out)
    rec.update(mode.record())
    rec["redistributions"] = dict(ctx["redistributions"])
    return {"record": rec, "outputs": out, "args": args, "built": built,
            "mode": mode}


def run_one(arch_name: str, shape_name: str, *, multi_pod: bool,
            variant: str = "baseline", force: bool = False,
            device: str = "cuda", art_dir: Optional[str] = None,
            cfg=None) -> Dict:
    """Trace one combination on the production mesh and write its record
    (``cfg`` overrides the registered arch, e.g. a depth cut).  A trace
    that raises gives ``status: "error"`` with the traceback."""
    from repro_torch.launch.mesh import make_production_mesh
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    art_dir = art_dir or ART_DIR
    os.makedirs(art_dir, exist_ok=True)
    path = os.path.join(
        art_dir, f"{arch_name}__{shape_name}__{mesh_name}__{variant}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg = cfg or get_arch(arch_name)
    shape = get_shape(shape_name)
    if not shape_applicable(cfg, shape):
        rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
               "variant": variant, "status": "skipped",
               "reason": "full-attention arch at 524k decode (DESIGN.md)"}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec

    data_sz, model_sz = mesh_split(variant)
    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
           "variant": variant, "device": device}
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, data=data_sz,
                                    model=model_sz, device=device)
        rec["n_devices"] = mesh.size()
        pol = policy_for(variant, mesh)
        res = trace_step(cfg, shape, mesh, pol,
                         remat=variant != "no_remat", device=device)
        rec.update(res["record"])
        rec["status"] = "ok"
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        combos = [(args.arch, args.shape)]

    from repro_torch.launch.mesh import release
    ok = err = skip = 0
    try:
        for a, s in combos:
            rec = run_one(a, s, multi_pod=args.multi_pod,
                          variant=args.variant, force=args.force,
                          device=args.device, art_dir=args.out_dir)
            st = rec["status"]
            ok += st == "ok"
            err += st == "error"
            skip += st == "skipped"
            msg = rec.get("error", "")[:120]
            gf = rec.get("flops_corrected", 0) / 1e9
            cb = rec.get("collective_bytes_total", 0) / 1e6
            print(f"[{st:7s}] {a:26s} {s:12s} {rec['mesh']:10s} "
                  f"{rec.get('trace_s', 0):7.1f}s  {gf:10.1f} GF/dev  "
                  f"{cb:10.1f} MB coll  {msg}", flush=True)
    finally:
        release()
    print(f"done: {ok} ok, {skip} skipped, {err} errors")
    if err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
