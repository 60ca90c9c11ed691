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
``memory_analysis``, collective_bytes_total and the bytes of each
collective kind, and the compile seconds.  It runs the JAX package and is
not part of the port.
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
          ("qwen3-moe-30b-a3b", "train_4k", False, "moe_bf16_psum"))


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
    return {"status": rec["status"], "n_devices": rec.get("n_devices"),
            "flops_corrected": rec.get("flops_corrected"),
            "argument_size_in_bytes": ma.get("argument_size_in_bytes"),
            "output_size_in_bytes": ma.get("output_size_in_bytes"),
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
