#!/usr/bin/env python3
"""The single-slot stump scan's event time against an older commit's, in
one process on one CUDA card.

    mkdir -p build/parent
    git archive <commit> src/repro_torch/kernels/csrc/stump_scan.cu \\
        | tar -x -C build/parent
    python3 tools/scan_event_ab.py \\
        build/parent/src/repro_torch/kernels/csrc/stump_scan.cu

The older source must export ``stump_scan_launch(x, y, w, thr, err, B, N,
F, T, stream)``, as the scan did before its rows were split (one block a
feature).  It is built with the package's ``nvcc`` flags into
``build/scan_event_ab/``.  At the slice-1 path's shape (333, 64, 16) the
script times, in turns (the order rotates and reverses from round to
round):

- ``old``: the old wrapper's steps (device check, shape checks, ``_f32``
  x4, ``torch.empty``, the library imported and loaded, the device
  context, the ``ctypes`` call) launching the old kernel;
- ``new`` and ``new_again``: ``ops.stump_scan`` (the same code twice:
  their difference is the spread between identical variants);
- ``old_launch`` and ``new_launch``: each kernel's ``ctypes`` launch alone
  on a preallocated output;
- ``floor``: one ``add_`` on a one-element tensor.

Each is timed by CUDA events, each call alone from an idle card (as
``chip_smoke.cuda_ms`` does: host work before the launch plus the kernel),
and on the host's clock, calls back to back (``chip_smoke.host_us``).  Each
kernel's device time comes from ``torch.profiler``.  Both kernels must give
the plain version's bits.  Prints the card's ``nvidia-smi`` line, a line a
variant, and one JSON object as the last line.
"""
from __future__ import annotations

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

SHAPE = (333, 64, 16)


def event_us(variants, rounds: int = 15, calls: int = 40) -> dict:
    """Event microseconds a call of each of ``variants``, each call alone
    from an idle card, in turns: per round the median of ``calls`` calls;
    per variant the median, least and most of the round medians."""
    names = list(variants)
    times = {k: [] for k in names}
    for r in range(rounds):
        order = names[r % len(names):] + names[:r % len(names)]
        for k in (order if r % 2 == 0 else order[::-1]):
            fn = variants[k]
            fn()
            torch.cuda.synchronize()
            per = []
            for _ in range(calls):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                per.append(a.elapsed_time(b) * 1e3)
            times[k].append(statistics.median(per))
    return {k: dict(median=statistics.median(v), min=min(v), max=max(v))
            for k, v in times.items()}


def build_old(src: Path) -> ctypes.CDLL:
    out = ROOT / "build" / "scan_event_ab"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "old_stump_scan.so"
    p = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                        str(src), "-o", str(lib_path)],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{p.stdout}{p.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.stump_scan_launch.argtypes = [P] * 5 + [I] * 4 + [P]
    return lib


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    old_lib = build_old(Path(sys.argv[1]))
    new_fn = build.load().stump_scan_launch
    old_fn = old_lib.stump_scan_launch
    print(cs.nvidia_smi(), flush=True)
    N, F, T = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, y, w, thr = cs.scan_inputs(gen, N, F, T)
    want = ref.stump_scan_ref(x, y, w, thr)
    split = ops.scan_split(N, F, T, ops._sms(x.get_device()))
    vec = int(ops.scan_vec(T, thr))
    stream = ops._stream(x)
    out_old = torch.empty_like(thr)
    out_new = torch.empty_like(thr)
    ptrs = (x.data_ptr(), y.data_ptr(), w.data_ptr(), thr.data_ptr())

    def old():
        # the wrapper as it was, step by step, launching the old kernel
        if ops._on_cpu(x, y, w, thr):
            raise AssertionError("scan inputs are on the CPU")
        if y.shape != (N,) or w.shape != (N,) or thr.shape != (F, T):
            raise ValueError("shapes")
        xx, yy, ww = ops._f32("x", x), ops._f32("y", y), ops._f32("w", w)
        tt = ops._f32("thresholds", thr)
        err = torch.empty((F, T), dtype=torch.float32, device=xx.device)
        from repro_torch.kernels.build import load
        load()
        with ops._on_device(xx):
            ops._launch("stump_scan", old_fn, xx.data_ptr(), yy.data_ptr(),
                        ww.data_ptr(), tt.data_ptr(), err.data_ptr(), 1, N,
                        F, T, ops._stream(xx))
        return err

    def new():
        return ops.stump_scan(x, y, w, thr)

    def old_launch():
        if old_fn(*ptrs, out_old.data_ptr(), 1, N, F, T, stream) != 0:
            raise RuntimeError("old stump_scan launch failed")

    def new_launch():
        if new_fn(*ptrs, out_new.data_ptr(), None, N, F, T, *split, vec,
                  stream) != 0:
            raise RuntimeError("stump_scan launch failed")

    one = torch.zeros((1,), device="cuda")
    variants = {"old": old, "new": new, "new_again": new,
                "old_launch": old_launch, "new_launch": new_launch,
                "floor": lambda: one.add_(1.0)}
    for name in ("old", "new"):
        if not torch.equal(variants[name](), want):
            raise AssertionError(f"{name}: not the plain version's bits")
    old_launch()
    new_launch()
    torch.cuda.synchronize()
    if not (torch.equal(out_old, want) and torch.equal(out_new, want)):
        raise AssertionError("a bare launch: not the plain version's bits")
    events = event_us(variants)
    hosts = cs.host_us(variants)
    device = {"old": cs.device_ms(old_launch, 20, "stump_scan") * 1e3,
              "new": cs.device_ms(new_launch, 20, cs.SCAN_KERNELS) * 1e3,
              "floor": cs.device_ms(variants["floor"], 20, None) * 1e3}
    for k in variants:
        e, h = events[k], hosts[k]
        print(f"{k}: event_us median {e['median']:.2f} "
              f"[{e['min']:.2f}, {e['max']:.2f}] host_us median "
              f"{h['median']:.2f} [{h['min']:.2f}, {h['max']:.2f}]",
              flush=True)
    print("device_us " + " ".join(f"{k} {v:.2f}" for k, v in device.items()),
          flush=True)
    print(json.dumps({"shape": list(SHAPE), "split": list(split),
                      "event_us": events, "host_us": hosts,
                      "device_us": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
