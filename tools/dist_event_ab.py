#!/usr/bin/env python3
"""``dist_update``'s event time against an older commit's, in one process
on one CUDA card.

    mkdir -p build/parent
    git archive <commit> src/repro_torch/kernels/csrc/dist_update.cu \\
        | tar -x -C build/parent
    python3 tools/dist_event_ab.py \\
        build/parent/src/repro_torch/kernels/csrc/dist_update.cu

The older source must export ``dist_update_launch(alpha, D, y, h, out, z,
partials, n, stream)`` (alpha a device pointer) and
``dist_update_partials(n)``, as the three-launch design did.  It is built
with the package's ``nvcc`` flags into ``build/dist_event_ab/``.  At the
kernel API path's N = 8,192 and at 4,194,304, alpha 0.7 given as a number,
the script times, in turns (the order rotates and reverses from round to
round):

- ``old``: the old wrapper's steps (alpha copied to the card, device and
  shape checks, ``_f32`` x3, ``torch.empty`` of D', ``torch.zeros`` of Z,
  the library imported and loaded, ``torch.empty`` of the partials, the
  device context, the ``ctypes`` call) launching the old kernels;
- ``new`` and ``new_again``: ``ops.dist_update`` (the same code twice:
  their difference is the spread between identical variants);
- ``old_launch`` and ``new_launch``: each launcher's ``ctypes`` call alone
  on preallocated outputs and alpha on the card;
- ``floor``: one ``add_`` on a one-element tensor.

Each is timed by CUDA events, each call alone from an idle card (as
``chip_smoke.cuda_ms`` does: host work before the launch plus the device
work), and on the host's clock, calls back to back
(``chip_smoke.host_us``).  The device time a call of ``old``, ``new`` and
the two bare launches is every device operation the call makes, traced
by ``torch.profiler``.  Both must agree with the plain version (D' within
1e-6, Z within 1e-6 relative).  Prints the card's ``nvidia-smi`` line, a
line a variant and shape, and one JSON object as the last line.
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
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs                                   # noqa: E402
from repro_torch.kernels import build, ops, ref           # noqa: E402
from scan_event_ab import event_us                        # noqa: E402

SHAPES = (8192, 4_194_304)
F32 = torch.float32


def build_old(src: Path) -> ctypes.CDLL:
    out = ROOT / "build" / "dist_event_ab"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "old_dist_update.so"
    p = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                        str(src), "-o", str(lib_path)],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{p.stdout}{p.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    P, L = ctypes.c_void_p, ctypes.c_longlong
    lib.dist_update_launch.argtypes = [P] * 7 + [L, P]
    lib.dist_update_partials.argtypes = [L]
    lib.dist_update_partials.restype = L
    return lib


def agree(got, z, want, wz) -> bool:
    return (float((got - want).abs().max()) <= 1e-6
            and float((z - wz).abs() / wz) <= 1e-6)


def one_shape(N: int, old_lib: ctypes.CDLL, new_fn) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(N)
    D, y, h = cs.dist_inputs(gen, N)
    alpha = 0.7
    want, wz = ref.dist_update_ref(alpha, D, y, h)
    dev = D.get_device()
    stream = ops._stream(D)
    a_card = torch.tensor(alpha, device=D.device)
    old_fn = old_lib.dist_update_launch
    out_old = torch.empty_like(D)
    z_old = torch.zeros((), dtype=F32, device=D.device)
    parts_old = torch.empty((old_lib.dist_update_partials(N),),
                            dtype=torch.float64, device=D.device)
    split = ops.dist_split(N, ops._sms(dev))
    out_new, z_new, parts_new = ops._dist_outputs(N, split, D.device)
    ptrs = (D.data_ptr(), y.data_ptr(), h.data_ptr())

    def old():
        # the wrapper as it was, step by step, launching the old kernels
        a = torch.as_tensor(alpha, dtype=F32, device=D.device)
        if ops._on_cpu(a, D, y, h):
            raise AssertionError("dist_update inputs are on the CPU")
        if D.dim() != 1 or y.shape != (N,) or h.shape != (N,):
            raise ValueError("shapes")
        DD, yy, hh = ops._f32("D", D), ops._f32("y", y), ops._f32("h", h)
        out = torch.empty((N,), dtype=F32, device=DD.device)
        Z = torch.zeros((), dtype=F32, device=DD.device)
        from repro_torch.kernels.build import load
        load()
        partials = torch.empty((old_lib.dist_update_partials(N),),
                               dtype=torch.float64, device=DD.device)
        with ops._on_device(DD):
            ops._launch("dist_update", old_fn, a.data_ptr(), DD.data_ptr(),
                        yy.data_ptr(), hh.data_ptr(), out.data_ptr(),
                        Z.data_ptr(), partials.data_ptr(), N,
                        ops._stream(DD))
        return out, Z

    def new():
        return ops.dist_update(alpha, D, y, h)

    def old_launch():
        if old_fn(a_card.data_ptr(), *ptrs, out_old.data_ptr(),
                  z_old.data_ptr(), parts_old.data_ptr(), N, stream) != 0:
            raise RuntimeError("old dist_update launch failed")

    def new_launch():
        if new_fn(None, alpha, *ptrs, out_new.data_ptr(), z_new.data_ptr(),
                  parts_new, N, *split, stream) != 0:
            raise RuntimeError("dist_update launch failed")

    one = torch.zeros((1,), device="cuda")
    variants = {"old": old, "new": new, "new_again": new,
                "old_launch": old_launch, "new_launch": new_launch,
                "floor": lambda: one.add_(1.0)}
    for name in ("old", "new"):
        if not agree(*variants[name](), want, wz):
            raise AssertionError(f"{name}: disagrees with the plain version")
    old_launch()
    new_launch()
    torch.cuda.synchronize()
    if not (agree(out_old, z_old, want, wz)
            and agree(out_new, z_new, want, wz)):
        raise AssertionError("a bare launch disagrees with the plain version")
    events = event_us(variants)
    hosts = cs.host_us(variants, rounds=9)
    device = {k: cs.device_ms(variants[k], 20, None) * 1e3
              for k in ("old", "new", "old_launch", "new_launch", "floor")}
    ops_a_call = {k: {name: n / 10 for name, n in
                      cs.device_ops(variants[k], 10).items()}
                  for k in ("old", "new")}
    for k in variants:
        e, hu = events[k], hosts[k]
        print(f"N={N} {k}: event_us median {e['median']:.2f} "
              f"[{e['min']:.2f}, {e['max']:.2f}] host_us median "
              f"{hu['median']:.2f} [{hu['min']:.2f}, {hu['max']:.2f}]",
              flush=True)
    print(f"N={N} device_us " + " ".join(f"{k} {v:.2f}"
                                         for k, v in device.items()),
          flush=True)
    print(f"N={N} device operations a call: {ops_a_call}", flush=True)
    return {"split": list(split), "event_us": events, "host_us": hosts,
            "device_us": device, "device_ops": ops_a_call}


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    old_lib = build_old(Path(sys.argv[1]))
    new_fn = build.load().dist_update_launch
    print(cs.nvidia_smi(), flush=True)
    result = {str(N): one_shape(N, old_lib, new_fn) for N in SHAPES}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
