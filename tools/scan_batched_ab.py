#!/usr/bin/env python3
"""The batched stump scan's device time against an older commit's, in one
process on one CUDA card.

    mkdir -p build/parent
    git archive <commit> src/repro_torch/kernels/csrc/stump_scan.cu \\
        | tar -x -C build/parent
    python3 tools/scan_batched_ab.py \\
        build/parent/src/repro_torch/kernels/csrc/stump_scan.cu

The older source must export ``stump_scan_batched_launch(x, y, w, thr,
err, B, N, F, T, vec, threads, depth, stream)``, the one-thread-a-row
route alone.  It is built with the package's ``nvcc`` flags into
``build/scan_batched_ab/``.  At three shapes (B, N, F, T):

- ``mesh`` (10, 43575, 54, 16): ``fed_mesh``'s fit on NIID-Bench covtype
  over ten parties, where this package takes the split;
- ``fleet`` (100000, 4, 48, 16): a fit wave of the fleet profile;
- ``large`` (4096, 333, 64, 16): a batch of large shards;

both kernels are launched through ``ctypes`` on preallocated outputs, and
timed by ``torch.profiler`` device time in turns (old, new, new, old,
``--rounds`` times).  The old kernel must give the plain version's bits
and the new one ``ref.scan_batched_in_kernel_order``'s (and the plain
version's: these weights are exact in any order).  At ``mesh`` it also
times splits built by hand and passed to the launcher: every cluster size
1..8 at blocks of 8 features, and blocks of 4 and 16 features at the
picked cluster size.  Prints the card's
``nvidia-smi`` line, the split kernel's ``ptxas`` lines, a line a
measurement, and one JSON object as the last line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs                                   # noqa: E402
from repro_torch.kernels import build, ops, ref           # noqa: E402

SHAPES = {"mesh": (10, 43575, 54, 16), "fleet": (100000, 4, 48, 16),
          "large": (4096, 333, 64, 16)}
KERNEL = "stump_scan_batched_kernel"


def build_old(src: Path) -> ctypes.CDLL:
    out = ROOT / "build" / "scan_batched_ab"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "old_stump_scan.so"
    p = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                        str(src), "-o", str(lib_path)],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{p.stdout}{p.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.stump_scan_batched_launch.argtypes = [P] * 5 + [L] + [I] * 6 + [P]
    return lib


def inputs(gen, B, N, F, T):
    """x, labels of +-1, weights in [0, 1) with a third of the rows and one
    slot at zero, thresholds on data values; all on the card."""
    dev = "cuda"
    x = torch.randn((B, N, F), generator=gen, device=dev)
    y = torch.where(torch.rand((B, N), generator=gen, device=dev) < 0.5,
                    1.0, -1.0)
    w = torch.rand((B, N), generator=gen, device=dev)
    w[:, 1::3] = 0.0
    w[B // 2] = 0.0
    rows = torch.randint(0, N, (B, F, T), generator=gen, device=dev)
    thr = torch.gather(x.transpose(1, 2), 2, rows).contiguous()
    return x, y, w, thr


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_source", type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    old_fn = build_old(args.old_source).stump_scan_batched_launch
    new_fn = build.load().stump_scan_batched_launch
    print(cs.nvidia_smi(), flush=True)
    for line in build.ptxas_log.splitlines():
        if "stump_scan_batched" in line or "Used" in line:
            print("ptxas", line.strip(), flush=True)
    sms = ops._sms(0)
    stream = ops._stream(torch.zeros(1, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(31)
    result = {"card": cs.nvidia_smi(), "sms": sms, "shapes": {}}
    for label, (B, N, F, T) in SHAPES.items():
        x, y, w, thr = inputs(gen, B, N, F, T)
        split = ops.scan_batched_split(B, N, F, T, sms)
        vec = int(ops.scan_vec(T, thr))
        ptrs = [a.data_ptr() for a in (x, y, w, thr)]
        out_old = torch.empty_like(thr)
        out_new = torch.empty_like(thr)

        def launch(fn, out, *knobs):
            rc = fn(*ptrs, out.data_ptr(), B, N, F, T, vec, *knobs, stream)
            if rc != 0:
                raise RuntimeError(f"{label}: CUDA error {rc}")

        def old():
            launch(old_fn, out_old, 0, 0)

        def new(s=split):
            launch(new_fn, out_new, 0, 0, *(s or (0, 0, 0, 0)))

        old()
        new()
        want = ref.stump_scan_batched_ref(x, y, w, thr)
        torch.cuda.synchronize()
        if not torch.equal(out_old, want):
            raise AssertionError(f"{label}: old kernel not the plain bits")
        if not torch.equal(out_new, want):
            raise AssertionError(f"{label}: new kernel not the plain bits")
        if split is not None:
            host = [a.cpu() for a in (x, y, w, thr)]
            emulated = ref.scan_batched_in_kernel_order(*host, split)
            if not torch.equal(out_new.cpu(), emulated):
                raise AssertionError(f"{label}: not the emulated order")
        times = {"old": [], "new": []}
        for _ in range(args.rounds):
            for name in ("old", "new", "new", "old"):
                fn = old if name == "old" else new
                times[name].append(cs.device_ms(fn, args.reps, KERNEL))
        r = {k: dict(median=statistics.median(v), min=min(v), max=max(v))
             for k, v in times.items()}
        r["ratio"] = r["old"]["median"] / r["new"]["median"]
        r["split"] = None if split is None else list(split)
        r["bound_ms"] = cs.scan_batched_bound(x, y, w, thr)[0]
        print(f"{label} {(B, N, F, T)} split {r['split']}: old "
              f"{r['old']['median']:.4f} ms [{r['old']['min']:.4f}, "
              f"{r['old']['max']:.4f}] new {r['new']['median']:.4f} ms "
              f"[{r['new']['min']:.4f}, {r['new']['max']:.4f}] ratio "
              f"{r['ratio']:.3f}", flush=True)
        if label == "mesh":
            sweep = {}
            layouts = [{"cols": 8, "blocks": g}
                       for g in range(1, ops.SCAN_MAX_CLUSTER + 1)]
            layouts += [{"cols": c, "blocks": split.blocks} for c in (4, 16)]
            for lay in layouts:
                chunks = ops.SCAN_THREADS // lay["cols"] * lay["blocks"]
                s = ref.ScanSplit(-(-N // chunks), chunks, lay["blocks"],
                                  lay["cols"])
                new(s)
                torch.cuda.synchronize()
                if not torch.equal(out_new, want):
                    raise AssertionError(f"mesh {lay}: not the plain bits")
                key = ",".join(f"{k}={v}" for k, v in lay.items())
                sweep[key] = dict(split=list(s), ms=statistics.median([
                    cs.device_ms(lambda s=s: new(s), args.reps, KERNEL)
                    for _ in range(args.rounds)]))
                print(f"mesh {key} {list(s)}: {sweep[key]['ms']:.4f} ms",
                      flush=True)
            r["sweep"] = sweep
        result["shapes"][label] = r
        del x, y, w, thr, out_old, out_new, want
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
