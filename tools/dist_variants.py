#!/usr/bin/env python3
"""``dist_update``'s design choices timed beside the shipped kernel, in one
process on one CUDA card.

    python3 tools/dist_variants.py

At the kernel API path's N = 8,192 and at 4,194,304 (alpha 0.7 as a
number), each row is the device time a call (``chip_smoke.device_ms``,
every device operation of the call), twice in turns:

- splits other than ``ops.dist_split``'s, launched through the private
  ``ops._dist_update_launch``: at 8,192 a cluster of 1, 2 or 4 blocks and
  a cooperative grid of 32 or 128 blocks; at 4,194,304 the grid of one
  block an SM at 256 or 1024 threads, and two blocks an SM of 256;
- copies of ``csrc/dist_update.cu`` with one choice changed, built with
  the package's ``nvcc`` flags into ``build/dist_variants/``: one whole
  vector a thread in flight on the grid (``batch1``), four (``batch4``),
  loads and stores without the streaming hints (``cached``), and, for
  timing only, the cluster route with no exchange between blocks (each
  block takes its own sum as Z: wrong results, ``no_exchange``).

Every variant but ``no_exchange`` must agree with the plain version (D'
within 1e-6, Z within 1e-6 relative).  Prints the card's ``nvidia-smi``
line, a line a shape and round, and one JSON object as the last line.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs                                   # noqa: E402
from repro_torch.kernels import build, ops, ref           # noqa: E402

SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "dist_update.cu"
OUT = ROOT / "build" / "dist_variants"


def cluster_block(src: str) -> str:
    """The cluster route's exchange, from its barrier to the grid's."""
    start = src.index("    // every block of the cluster has started")
    return src[start:src.index("  } else {", start)]


def source_variants(src: str) -> dict:
    """name -> (replacements, results checked)."""
    batch = "constexpr int kBatch = 2;"
    return {
        "batch1": ([(batch, "constexpr int kBatch = 1;")], True),
        "batch4": ([(batch, "constexpr int kBatch = 4;")], True),
        "cached": ([("__ldcs(", "__ldg("),
                    ("__stcs(reinterpret_cast<float4*>(out) + v, q);",
                     "reinterpret_cast<float4*>(out)[v] = q;")], True),
        "no_exchange": ([(cluster_block(src), "    total = part;\n")],
                        False),
    }


def build_variants() -> dict:
    """Compile every copy at once; name -> (launcher, results checked)."""
    src = SRC.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, (reps, checked) in source_variants(src).items():
        text = src
        for a, b in reps:
            if a not in text:
                raise RuntimeError(f"{name}: {a[:40]!r} not in the source")
            text = text.replace(a, b)
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(text)
        procs.append((name, checked, so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", str(cu), "-o",
             str(so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, checked, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.dist_update_launch.argtypes = build.SIGNATURES[
            "dist_update_launch"]
        libs[name] = (lib.dist_update_launch, checked)
    return libs


def grid(nv: int, blocks: int, threads: int) -> ref.DistSplit:
    tile = -(-nv // blocks)
    return ref.DistSplit(False, -(-nv // tile), threads, tile,
                         min(tile, ops.DIST_HELD))


def cluster(nv: int, blocks: int) -> ref.DistSplit:
    tile = -(-nv // blocks)
    return ref.DistSplit(True, blocks, min(1024, max(32, 1 << (
        tile - 1).bit_length())), tile, tile)


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    shipped = build.load().dist_update_launch
    libs = build_variants()
    print(cs.nvidia_smi(), flush=True)
    sms = ops._sms(0)
    gen = torch.Generator(device="cuda").manual_seed(5)
    result = {}
    for N in (8192, 4_194_304):
        D, y, h = cs.dist_inputs(gen, N)
        want, wz = ref.dist_update_ref(0.7, D, y, h)
        nv = -(-N // 4)
        split = ops.dist_split(N, sms)
        if split.cluster:
            others = {f"cluster{b}": cluster(nv, b) for b in (1, 2, 4)}
            others.update({f"grid{b}": grid(nv, b, 64) for b in (32, 128)})
        else:
            others = {f"grid_{t}": grid(nv, sms, t) for t in (256, 1024)}
            others["grid2x_256"] = grid(nv, 2 * sms, 256)
        runs = {"shipped": (shipped, split, True)}
        runs.update({k: (shipped, s, True) for k, s in others.items()})
        runs.update({k: (fn, split, checked)
                     for k, (fn, checked) in libs.items()})
        calls = {}
        for name, (fn, s, checked) in runs.items():
            out, Z, parts = ops._dist_outputs(N, s, D.device)
            args = (None, 0.7, D.data_ptr(), y.data_ptr(), h.data_ptr(),
                    out.data_ptr(), Z.data_ptr(), parts, N, *s,
                    ops._stream(D))

            def call(fn=fn, args=args, name=name):
                if fn(*args) != 0:
                    raise RuntimeError(f"{name}: launch failed")
            call()
            torch.cuda.synchronize()
            if checked and not (
                    float((out - want).abs().max()) <= 1e-6
                    and float((Z - wz).abs() / wz) <= 1e-6):
                raise AssertionError(f"N={N} {name}: disagrees with the "
                                     f"plain version")
            calls[name] = (call, list(s))
        times = {k: [] for k in calls}
        for rnd in range(2):
            order = list(calls) if rnd == 0 else list(calls)[::-1]
            for k in order:
                times[k].append(cs.device_ms(calls[k][0], 20, None))
            print(f"N={N} round {rnd}: " + " ".join(
                f"{k} {times[k][rnd]:.4f}" for k in calls), flush=True)
        result[str(N)] = {k: {"split": calls[k][1], "kernel_ms": times[k]}
                          for k in calls}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
