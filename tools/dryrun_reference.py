#!/usr/bin/env python3
"""The JAX package's dry run (``repro.launch.dryrun``) on the combinations
of ``chip_smoke.py`` phase 17.1, on the CPU: the numbers its
``DRYRUN_REFERENCE`` holds.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/dryrun_reference.py

Each combination runs ``python -m repro.launch.dryrun --arch A --shape S
[--multi-pod] --variant V --force`` in a process of its own (the module
fixes 512 placeholder devices when JAX starts), which writes the
reference's record under ``artifacts/dryrun/``; this script reads it
back and prints one JSON object: "arch/shape/mesh/variant" -> status,
n_devices, flops_corrected, the argument and output bytes of
``memory_analysis``, ``output_leaves`` (the leaves of the step's output,
from ``jax.eval_shape`` in another process of its own: the compiled
output's tuple table holds a pointer, 8 B, for each),
collective_bytes_total and the bytes of each collective kind, and the
compile seconds.  It runs the JAX package and is not part of the port.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COMBOS = (("qwen1.5-0.5b", "train_4k", False, "baseline"),
          ("qwen1.5-0.5b", "decode_32k", True, "baseline"),
          ("qwen3-moe-30b-a3b", "train_4k", False, "moe_bf16_psum"),
          ("jamba-1.5-large-398b", "long_500k", False, "baseline"),
          ("whisper-base", "decode_32k", False, "baseline"))

LEAVES = """
import sys, jax
from repro.launch import dryrun        # fixes 512 placeholder devices
from repro.configs.registry import get_arch, get_shape
from repro.launch import shardings as sh
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import build
arch, shape, multi_pod, variant = (sys.argv[1], sys.argv[2],
                                   sys.argv[3] == "1", sys.argv[4])
vkw = dict(dryrun.VARIANTS[variant])
mesh = make_production_mesh(multi_pod=multi_pod,
                            data=vkw.pop("mesh_data", 16),
                            model=vkw.pop("mesh_model", 16))
pol = sh.ShardingPolicy(batch_axes=("pod", "data") if multi_pod
                        else ("data",), **vkw)
built = build(get_arch(arch), get_shape(shape), mesh, pol,
              remat=variant != "no_remat")
print(len(jax.tree.leaves(jax.eval_shape(built["fn"], *built["args"]))))
"""


def run(arch: str, shape: str, multi_pod: bool, variant: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    cmd = [sys.executable, "-m", "repro.launch.dryrun", "--arch", arch,
           "--shape", shape, "--variant", variant, "--force"]
    if multi_pod:
        cmd.append("--multi-pod")
    t0 = time.time()
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         cwd=ROOT)
    if out.returncode != 0:
        raise SystemExit(f"{' '.join(cmd)} failed:\n{out.stdout[-2000:]}"
                         f"\n{out.stderr[-2000:]}")
    mesh = "pod2x16x16" if multi_pod else "pod16x16"
    rec = json.loads((ROOT / "artifacts" / "dryrun" /
                      f"{arch}__{shape}__{mesh}__{variant}.json").read_text())
    ma = rec.get("memory_analysis", {})
    leaves = subprocess.run([sys.executable, "-c", LEAVES, arch, shape,
                             "1" if multi_pod else "0", variant], env=env,
                            capture_output=True, text=True, cwd=ROOT)
    if leaves.returncode != 0:
        raise SystemExit(f"output leaves of {arch} {shape}:\n"
                         f"{leaves.stderr[-2000:]}")
    return {"status": rec["status"], "n_devices": rec.get("n_devices"),
            "flops_corrected": rec.get("flops_corrected"),
            "argument_size_in_bytes": ma.get("argument_size_in_bytes"),
            "output_size_in_bytes": ma.get("output_size_in_bytes"),
            "output_leaves": int(leaves.stdout.split()[-1]),
            "collective_bytes_total": rec.get("collective_bytes_total"),
            "collectives": {k: v["bytes"] for k, v in
                            rec.get("collectives", {}).items()
                            if v["count"]},
            "compile_s": rec.get("compile_s"),
            "wall_s": round(time.time() - t0, 1)}


def main() -> None:
    out = {}
    for arch, shape, multi_pod, variant in COMBOS:
        mesh = "pod2x16x16" if multi_pod else "pod16x16"
        out[f"{arch}/{shape}/{mesh}/{variant}"] = run(arch, shape,
                                                      multi_pod, variant)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
