#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as it ends; any fault raises and the script exits
nonzero (there is no CPU fall-back):

1. device: the card's name and power limit;
2. build: the CUDA kernels compiled from ``src/repro_torch/kernels/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at a large shape, with CUDA-event times, the
   plain version's time, the card's lower bound for the same work and,
   for the two generic votes, the event and device time of the one
   PyTorch call that computes the same function, the host work of the
   wrapper cut into its parts, two calls bit-equal, and columns alone and
   packed in a batch bit-equal; ``stump_scan`` bit-equal to its plain
   version and to ``ref.scan_in_kernel_order`` at the launcher's split and
   at half and twice its chunks, each timed, with the bound's share, the
   TB/s, the FP64 pipe's floor at the SM clock ``nvidia-smi`` reads, the
   wrapper's host work by part, and the launch floor (the device time of
   one elementwise op on a one-element tensor); the stump votes at the
   path's shape, a large one and the path's shape on the 4-byte route,
   bit-equal to the CPU emulation of their order
   (``ref.stump_vote_in_kernel_order``) and to each other, lanes bit-equal
   to the plain version's, each launcher variant (a copy of
   ``stump_vote.cu`` with one choice fixed, built into ``build/``) timed
   and held to the shipped bits, columns alone and packed bit-equal, and
   the wrappers' host work by part; ``dist_update`` at the kernel API
   path's N and a large N with every device operation of a call traced
   (one kernel), Z and D' bit-equal to the CPU emulation of its order
   (``ref.dist_update_in_kernel_order``) at alpha 0, the route
   ``ops.dist_split`` does not take timed beside it, and the wrapper's
   host work by part;
4. train: edge_vision at full size in both modes and iot at full size,
   enhanced, all on the card, publishing into one registry; each run is
   then repeated on the CPU in lockstep, handed the card's stump at every
   fit: the CPU's own pick on the card's inputs must be that stump (or tie
   it to within rounding), and every counter must agree; a run of the CPU
   on its own is set beside the card's, and where the two first pick
   apart is printed;
5. serve: 2048 requests (25% repeats) from both tenants' test sets through
   ``EnsembleServer``, one tenant on the fused fingerprint path, then the
   same batches again through the CPU plain path; the stump votes' launch
   shapes are counted, and the commonest is then measured as in phase 3;
6. profile: one more training run and serve under torch.profiler, for the
   card's busy time by kernel;
7. fleet: the vectorized fleet profile on ``mobile_100k``'s 100,000
   clients.  (1) ``stump_scan_batched`` against its plain version on the
   card, on the scenario's first fit wave and on a large-shard batch, bit
   for bit on both load routes, each timed, with the FP64 pipe's floor;
   (2) the scenario at full width through ``run_scenario``, legacy trace,
   seed 0, both modes, cut from 4 rounds to 2: baseline counters and clock
   must equal the JAX package's, enhanced ones are printed beside its;
   (3) the same scenario and cut at 4,096 clients on the card, then on
   the CPU in lockstep; (4) the enhanced full-width run's wall split and
   the card's busy share over a profiled window;
8. generic learners: edge_vision at full size with the logistic and the
   MLP learner, both modes, 25 rounds, on the card (the enhanced runs
   publish), each repeated on the CPU in lockstep, handed the card's
   params at every fit: every counter must agree, and the CPU's own fit
   on the card's inputs must give the card's params within 1e-4 or be
   ill-conditioned; then 2048 requests (25% repeats) from both tenants
   through ``EnsembleServer`` on the generic path, then the same batches
   through the CPU plain path; then one MLP run, cut to 5 rounds, and
   serve under torch.profiler;
9. the kernel API path: ``ensemble_vote`` and ``dist_update`` through
   ``repro_torch.kernels.ops`` at ``benchmarks/kernel_bench.py``'s shapes;
10. LM serve: qwen1.5-0.5b at full width (24 layers, d_model 1024, vocab
   151,936) through the port's ``generate``: batch 4, a 512-token prompt,
   32 greedy tokens, f32 params from the port's init; ``flash_attention``
   must launch once per layer of the prefill; then the same params on the
   CPU replay the prefill and every decode step in lockstep, fed the
   card's tokens;
11. serving at scale: iot/gilbert at its registered size (4,000 x 24, 24
   clients, 20 rounds) through ``run_scenario`` on the card, trained,
   published into a 2-host sharded cluster, gossiped and replayed to the
   autoscaled fleet for 1.5 s under the analytic service model: every
   field of the replay report but the snapshot version must equal the JAX
   package's recorded run, the version the enhanced run's publishes, and
   ``stump_scan`` and ``stump_vote_batched`` must launch; then the same
   arrivals through two fleets over copies of the trained cluster, on the
   card and on the CPU's plain path (rid, tenant and version equal,
   margins within rtol/atol 1e-5, both reports equal the first); the
   arrivals again on the card with the measured service time (p50/p99,
   wall, the vote's event time at its commonest launch shape); the JAX
   package's autoscale churn traffic on the card, equal to its recorded
   run and loss-free; and the enhanced run again with tracing on and an
   audit attached, bit-equal to the first.

Phase 3 also holds ``flash_attention`` to its plain version at the LM
path's shape, a large one, a ragged T, d 80 and 128, ``causal=False``,
bf16 at the path's shape, a large one and d 128, and the path's own
(B,T,H,d) views written into a (B,T,H,d) buffer, with
``scaled_dot_product_attention`` timed beside it; it counts the tensor-core
instructions (HGMMA, HMMA) of each flash kernel in the built library's SASS.
Launch counts are zeroed just before phase 4 and read just after phase 5,
and zeroed again just before each later path (7.2, 8, 9, 10, 11) and read
just after it (phase 11's main path is its step 1).
The last lines are the kernels JSON, the card's ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import hashlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
F64_OPS_PER_S = 34e12           # H100 SXM f64 outside the tensor cores
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12         # H100 SXM TF32 tensor cores, dense
TOL = 1e-5                      # kernel vs plain: summation order only
ROUNDING = 1e-6                 # two stumps' exact errors this close tie


def close(got, want, l1=None) -> bool:
    """Within rtol/atol 1e-5 (the f32 sums differ in order only).  With
    ``l1`` (the sum of the summed terms' magnitudes) the absolute slack is
    1e-5 of it instead: a long sum that cancels to near zero carries the
    rounding of its partial sums, which no order avoids."""
    if l1 is None:
        return bool(torch.allclose(got, want, rtol=TOL, atol=TOL))
    return bool(((got - want).abs() <= TOL * (1.0 + l1)).all())

KERNEL_INFO = {
    "stump_scan": ("src/repro_torch/kernels/csrc/stump_scan.cu",
                   "src/repro/kernels/stump_scan.py:41"),
    "stump_scan_batched": ("src/repro_torch/kernels/csrc/stump_scan.cu",
                           "src/repro/kernels/dispatch.py:245"),
    "stump_vote_batched": ("src/repro_torch/kernels/csrc/stump_vote.cu",
                           "src/repro/kernels/ensemble_vote.py:203"),
    "stump_vote_fp_batched": ("src/repro_torch/kernels/csrc/stump_vote.cu",
                              "src/repro/kernels/ensemble_vote.py:168"),
    "ensemble_vote_batched": ("src/repro_torch/kernels/csrc/ensemble_vote.cu",
                              "src/repro/kernels/ensemble_vote.py:88"),
    "ensemble_vote": ("src/repro_torch/kernels/csrc/ensemble_vote.cu",
                      "src/repro/kernels/ensemble_vote.py:48"),
    "dist_update": ("src/repro_torch/kernels/csrc/dist_update.cu",
                    "src/repro/kernels/dist_update.py:44"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:75"),
}


T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print one line, stamped with the seconds since the script began."""
    print(f"[{time.perf_counter() - T0:6.1f} s] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event-timed calls,
    after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int, name_has) -> float:
    """Device time (ms) per call of the CUDA kernels whose name contains
    ``name_has`` (a string, a tuple of strings for a call that launches
    several kernels, or None for every device operation of the call), over
    ``reps`` calls traced by torch.profiler: the kernels alone, without the
    host time around their launch.  The profiler now and then drops a
    kernel from a trace (late in a full run, 19 of 20 calls traced, every
    kernel alike), so a call's time is the mean device time of a traced
    kernel times the kernels a call launches (the traced count over the
    calls, rounded), and a shortfall is logged.  A trace that holds no such
    kernel is taken again, up to three times; NaN after that."""
    from torch.profiler import ProfilerActivity, profile
    names = ("",) if name_has is None else (
        (name_has,) if isinstance(name_has, str) else tuple(name_has))
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = n = 0
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA and \
                    any(k in evt.name for k in names):
                total += evt.device_time_total
                n += 1
        if n:
            per_call = max(1, round(n / reps))
            if n != per_call * reps:
                log(f"  device_ms {name_has}: {n} kernels traced for {reps} "
                    f"calls")
            return total / n * per_call / 1e3
    return float("nan")


def bound_ms(nbytes: float, ops_f32: float, ops_f64: float = 0.0,
             ops_bf16: float = 0.0, ops_tf32: float = 0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops_f32 / F32_OPS_PER_S + ops_f64 / F64_OPS_PER_S
             + ops_bf16 / BF16_OPS_PER_S + ops_tf32 / TF32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ phase 3
def scan_inputs(gen, N, F, T):
    dev = "cuda"
    x = torch.randn((N, F), generator=gen, device=dev)
    y = torch.where(torch.rand((N,), generator=gen, device=dev) < 0.5,
                    1.0, -1.0)
    w = torch.rand((N,), generator=gen, device=dev)
    w = w / w.sum()
    # thresholds placed exactly on data values: the strict `>` edge
    rows = torch.randint(0, N, (F, T), generator=gen, device=dev)
    thr = x.T.gather(1, rows).contiguous()
    return x, y, w, thr


def vote_inputs(gen, B, T, N, pad_t):
    dev = "cuda"
    xsel = torch.randn((B, T, N), generator=gen, device=dev)
    thr = torch.randn((B, T), generator=gen, device=dev)
    # some features exactly on their threshold: sign(0 + 1e-12) edge
    xsel[:, ::7, ::5] = thr[:, ::7, None]
    pol = torch.where(torch.rand((B, T), generator=gen, device=dev) < 0.5,
                      1.0, -1.0)
    alphas = torch.rand((B, T), generator=gen, device=dev)
    alphas[:, T - pad_t:] = 0.0                  # the batch's T padding
    return xsel, thr, pol, alphas


# the stump votes' phase-3 shapes (B, T, N, padding rows): the serving
# path's, a large one, and the path's shape on the 4-byte route
STUMP_CASES = (("main", (2, 300, 64, 20)), ("large", (8, 1024, 4096, 24)),
               ("scalar", (2, 300, 61, 20)))
# the profiler's name of each stump kernel (every instantiation)
STUMP_KERNELS = {"stump_vote_batched": "stump_vote_kernel<false",
                 "stump_vote_fp_batched": "stump_vote_kernel<true"}


def stump_vote_cost(name, B, T, N):
    """(bytes, f32-rate operations) of one stump vote: xsel and the three
    row vectors read once, the margins (and the two lanes) written; a
    subtract, an add, two compares and two multiplies a cell (and xor,
    multiply, xor a cell a lane, 32-bit integer operations)."""
    nbytes = 4 * B * T * N + 3 * 4 * B * T + 4 * B * N
    ops_vote = 6.0 * B * T * N
    if name == "stump_vote_fp_batched":
        return nbytes + 2 * 4 * B * N, ops_vote + 6.0 * B * T * N
    return nbytes, ops_vote


def stump_vote_row(name, call, plain, plain_reps, B, T, N):
    """One stump vote's measurements: event and device ms, the plain
    version's event ms, the bound, its share and the TB/s, beside the
    launch floor; two calls must give the same bits."""
    nbytes, nops = stump_vote_cost(name, B, T, N)
    b, by = bound_ms(nbytes, nops)
    ms = cuda_ms(call, 50)
    kernel_ms = device_ms(call, 20, STUMP_KERNELS[name])
    first, again = call(), call()
    torch.cuda.synchronize()
    first = first if isinstance(first, tuple) else (first,)
    again = again if isinstance(again, tuple) else (again,)
    for u, v in zip(first, again):
        if not torch.equal(u.view(torch.int32), v.view(torch.int32)):
            raise AssertionError(f"{name} {(B, T, N)}: two calls differ")
    return dict(ms=ms, kernel_ms=kernel_ms, host_ms=ms - kernel_ms,
                plain_ms=cuda_ms(plain, plain_reps), bound_ms=b,
                bound_by=by, bound_share=b / kernel_ms,
                tb_per_s=nbytes / kernel_ms / 1e9,
                launch_floor_ms=LAUNCH_FLOOR["kernel_ms"], library_ms=None)


def check_stump_shape(gen, label, B, T, N, pad) -> dict:
    """Both stump votes at one shape: within the tolerance of the plain
    version, bit-equal to the CPU emulation of their order
    (``ref.stump_vote_in_kernel_order``) and to each other, the lanes
    bit-equal to the plain version's; then timed (:func:`stump_vote_row`)
    and each launcher variant timed and held to the shipped bits
    (:func:`stump_variant_ms`)."""
    from repro_torch.kernels import ops, ref
    args = vote_inputs(gen, B, T, N, pad)
    got = ops.stump_vote_batched(*args)
    want = ref.stump_vote_batched_ref(*args)
    gm, g0, g1 = ops.stump_vote_fp_batched(*args)
    wm, w0, w1 = ref.stump_vote_fp_batched_ref(*args)
    emul = ref.stump_vote_in_kernel_order(*(host(a) for a in args))
    torch.cuda.synchronize()
    l1 = None if label != "large" else args[3].abs().sum(1, keepdim=True)
    errs = {"stump_vote_batched": float((got - want).abs().max()),
            "stump_vote_fp_batched": float((gm - wm).abs().max())}
    if not (close(got, want, l1) and close(gm, wm, l1)):
        raise AssertionError(f"stump votes {label}: max err {errs}")
    if not (torch.equal(g0, w0) and torch.equal(g1, w1)):
        raise AssertionError(f"fingerprint lanes {label} not bit-equal")
    bits = lambda v: v.contiguous().view(torch.int32)           # noqa: E731
    if not (torch.equal(bits(got.cpu()), bits(emul))
            and torch.equal(bits(gm), bits(got))):
        raise AssertionError(
            f"stump votes {label}: not the emulation's bits (max diff "
            f"{float((got.cpu() - emul).abs().max())}, fp kernel "
            f"{float((gm - got).abs().max())})")
    variants = stump_variant_ms(args, got, g0, g1)
    rows = {}
    for name, call, plain, reps in (
            ("stump_vote_batched", lambda: ops.stump_vote_batched(*args),
             lambda: ref.stump_vote_batched_ref(*args), 10),
            ("stump_vote_fp_batched",
             lambda: ops.stump_vote_fp_batched(*args),
             lambda: ref.stump_vote_fp_batched_ref(*args), 3)):
        r = rows[name] = dict(
            shape=[B, T, N], max_abs_err=errs[name], emulation_bit_equal=True,
            variant_kernel_ms={v: ms[name] for v, ms in variants.items()},
            **stump_vote_row(name, call, plain, reps, B, T, N))
        if name == "stump_vote_fp_batched":
            r["lanes_bit_equal"] = True
        log(f"kernel {name} {label} {r['shape']}: "
            f"max_abs_err={r['max_abs_err']:.3g} bit-equal to the emulation; "
            f"ms={r['ms']:.4f} kernel_ms={r['kernel_ms']:.4f} "
            f"host_ms={r['host_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
            f"bound_share={r['bound_share']:.4f} TB/s={r['tb_per_s']:.3f} "
            f"launch_floor_ms={r['launch_floor_ms']:.4f}")
        log(f"  {name} {label} variants (device ms, shipped bits): " +
            " ".join(f"{v}={ms:.4f}"
                     for v, ms in r["variant_kernel_ms"].items()))
    if label == "main":
        for name in rows:
            rows[name]["host_us"] = stump_host_work(
                args, name == "stump_vote_fp_batched")
            log(f"  {name} host_us(median[min,max])=" + ",".join(
                f"{k}:{v['median']:.2f}[{v['min']:.2f},{v['max']:.2f}]"
                for k, v in rows[name]["host_us"].items()))
    return rows


def check_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {"stump_scan": check_scan(gen)}
    for label, (B, T, N, pad) in STUMP_CASES:
        for name, r in check_stump_shape(gen, label, B, T, N, pad).items():
            results.setdefault(name, {})[label] = r
    stump_batch_invariance(gen)
    return results


# Launcher variants of stump_vote.cu: (the line of ``launch`` that makes
# the choice, its replacement).  "deep"/"stream" fix the loads in flight
# (a whole chunk / half a chunk), "one_stage" one stage a round, "wide"
# the 128-column tile at every shape.
STUMP_VARIANT_LINES = {
    "deep": ("  const bool deep = B * tiles(C) <= sms;",
             "  const bool deep = true;"),
    "stream": ("  const bool deep = B * tiles(C) <= sms;",
               "  const bool deep = false;"),
    "one_stage": ("  const bool two = C < 4 && deep && a.T > kStageRows;",
                  "  const bool two = false;"),
    "wide": ("  while (C > 1 && B * tiles(C / 2) <= sms) C /= 2;", ""),
}
_STUMP_VARIANTS = {}


def stump_variants() -> dict:
    """Copies of ``stump_vote.cu`` with one launcher choice fixed
    (``STUMP_VARIANT_LINES``), built side by side into
    ``build/stump_vote_variants`` (one ``nvcc`` each, all started
    together) on first call and bound with ``ctypes``."""
    import ctypes
    from repro_torch.kernels import build
    if _STUMP_VARIANTS:
        return _STUMP_VARIANTS
    src = (build.CSRC / "stump_vote.cu").read_text()
    out_dir = ROOT / "build" / "stump_vote_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (line, repl) in STUMP_VARIANT_LINES.items():
        if line not in src:
            raise AssertionError(f"stump_vote.cu: the {name} choice moved")
        cu = out_dir / f"{name}.cu"
        cu.write_text(src.replace(line, repl))
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", str(cu), "-o",
             str(out_dir / f"{name}.so")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} stump vote:\n{out}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for fn in ("stump_vote_launch", "stump_vote_fp_launch"):
            getattr(lib, fn).argtypes = build.SIGNATURES[fn]
        _STUMP_VARIANTS[name] = lib
    return _STUMP_VARIANTS


def stump_variant_ms(args, want, want0, want1) -> dict:
    """Each launcher variant's device ms at these inputs, both kernels,
    each held to the shipped kernels' bits (margins and lanes)."""
    x, th, p, a = args
    B, T, N = x.shape
    stream = torch._C._cuda_getCurrentRawStream(0)
    ptrs = (x.data_ptr(), th.data_ptr(), p.data_ptr(), a.data_ptr())
    rows = {}
    for name, lib in stump_variants().items():
        out = torch.empty_like(want)
        f0, f1 = torch.empty_like(want0), torch.empty_like(want1)

        def plain():
            if lib.stump_vote_launch(*ptrs, out.data_ptr(), B, T, N, stream):
                raise RuntimeError(f"{name} stump vote launch failed")

        def fp():
            if lib.stump_vote_fp_launch(*ptrs, out.data_ptr(), f0.data_ptr(),
                                        f1.data_ptr(), B, T, N, stream):
                raise RuntimeError(f"{name} stump vote launch failed")
        rows[name] = {}
        for kname, call in (("stump_vote_batched", plain),
                            ("stump_vote_fp_batched", fp)):
            out.zero_()
            call()
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"{kname} {(B, T, N)}: the {name} "
                                     f"variant differs from the shipped bits")
            if kname == "stump_vote_fp_batched" and not (
                    torch.equal(f0, want0) and torch.equal(f1, want1)):
                raise AssertionError(f"{(B, T, N)}: the {name} variant's "
                                     f"lanes differ")
            rows[name][kname] = device_ms(call, 20, STUMP_KERNELS[kname])
    return rows


def stump_batch_invariance(gen):
    """The same 3 columns, T 300 and 1024, alone (B 1, N 3: 32-column
    tiles, two stages a round) and packed among others into
    (8, T + 24, 4096) behind 24 zero-alpha padding rows whose thr and pol
    hold NaN (every other row) and random values (128-column tiles, the
    16-byte route, half a chunk a round), through both wrappers: equal bit
    for bit, and to the CPU emulation of the order."""
    from repro_torch.kernels import ops, ref
    at = ((1, 0), (4, 2049), (7, 4095))          # (b, n) of each column
    for T in (300, 1024):
        x, th, p, a = vote_inputs(gen, 8, T + 24, 4096, 24)
        th[:, T::2] = float("nan")
        p[:, T::2] = float("nan")
        ax, ath, ap, aa = vote_inputs(gen, 1, T, 3, 0)
        for j, (b, n) in enumerate(at):
            x[b, :T, n] = ax[0, :, j]
            th[b, :T], p[b, :T], a[b, :T] = ath[0], ap[0], aa[0]
        out = ops.stump_vote_batched(x, th, p, a)
        out_fp = ops.stump_vote_fp_batched(x, th, p, a)[0]
        got = {"alone": ops.stump_vote_batched(ax, ath, ap, aa)[0],
               "alone fp": ops.stump_vote_fp_batched(ax, ath, ap, aa)[0][0],
               "packed": torch.stack([out[b, n] for b, n in at]),
               "packed fp": torch.stack([out_fp[b, n] for b, n in at])}
        torch.cuda.synchronize()
        emul = ref.stump_vote_in_kernel_order(
            *(host(v) for v in (ax, ath, ap, aa)))[0]
        ref_bits = emul.view(torch.int32)
        for name, g in got.items():
            if not torch.equal(g.cpu().view(torch.int32), ref_bits):
                raise AssertionError(f"stump batch invariance T {T}: {name} "
                                     f"{g.tolist()} != emulation "
                                     f"{emul.tolist()}")
        if not torch.isfinite(out).all():
            raise AssertionError("stump batch invariance: NaN padding leaked")
        log(f"stump vote batch invariance T {T}: {', '.join(got)} equal bit "
            f"for bit to the CPU emulation ({emul.tolist()})")


def stump_host_work(args, fp: bool) -> dict:
    """A stump vote wrapper's host work at the path shape, cut into its
    parts (:func:`host_us`): the wrapper, twice under two names (their
    difference is the spread between identical variants), the device
    check, the shape checks and ``_f32`` x4 (``ops._vote_args``), the
    output allocation(s) as the wrapper makes them, the ``ctypes`` launch
    alone on preallocated outputs, the stream, and ``ops._on_device``;
    for the fp wrapper also its three outputs as three ``torch.empty``
    and the whole wrapper as it was with them.  The wrapper's launches
    count in ``ops.LAUNCHES``, which phase 4 zeroes."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.build import load
    x, th, p, a = args
    B, T, N = x.shape
    dev = x.device
    lib = load()
    stream = ops._stream(x)
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    f0 = torch.empty((B, N), dtype=torch.int32, device=dev)
    f1 = torch.empty((B, N), dtype=torch.int32, device=dev)
    ptrs = (x.data_ptr(), th.data_ptr(), p.data_ptr(), a.data_ptr())
    if fp:
        wrapper = lambda: ops.stump_vote_fp_batched(*args)   # noqa: E731
        launch = lambda: lib.stump_vote_fp_launch(           # noqa: E731
            *ptrs, out.data_ptr(), f0.data_ptr(), f1.data_ptr(), B, T, N,
            stream)
        alloc = lambda: ops._fp_outputs(B, N, dev)          # noqa: E731
    else:
        wrapper = lambda: ops.stump_vote_batched(*args)      # noqa: E731
        launch = lambda: lib.stump_vote_launch(              # noqa: E731
            *ptrs, out.data_ptr(), B, T, N, stream)
        alloc = lambda: torch.empty((B, N), device=dev)      # noqa: E731

    def on_device():
        with ops._on_device(x):
            pass
    variants = {"wrapper": wrapper, "wrapper_again": wrapper,
                "on_cpu": lambda: ops._on_cpu(*args),
                "checks": lambda: ops._vote_args(*args), "alloc": alloc,
                "launch": launch, "stream": lambda: ops._stream(x),
                "on_device": on_device}
    if fp:
        three_empty = lambda: [                              # noqa: E731
            torch.empty((B, N), dtype=d, device=dev)
            for d in (torch.float32, torch.int32, torch.int32)]

        def wrapper_before():
            """The fp wrapper as it was: three ``torch.empty``."""
            if ops._on_cpu(*args):
                raise AssertionError("stump inputs are on the CPU")
            _, _, _, xs, ts, ps, als = ops._vote_args(*args)
            o, g0, g1 = three_empty()
            with ops._on_device(xs):
                ops._launch("stump_vote_fp_batched",
                            load().stump_vote_fp_launch, xs.data_ptr(),
                            ts.data_ptr(), ps.data_ptr(), als.data_ptr(),
                            o.data_ptr(), g0.data_ptr(), g1.data_ptr(),
                            B, T, N, ops._stream(xs))
            return o, g0, g1
        variants.update(three_empty=three_empty,
                        wrapper_before=wrapper_before)
    return host_us(variants)


def sm_clock_mhz() -> float:
    """The SM clock ``nvidia-smi`` reads now (MHz): read right after a
    timed loop, it is the clock under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[0])


def fp64_floor_ms(cell_rows: float, mhz: float) -> float:
    """The FP64 pipe's least time for one DADD issue a cell a row: the
    H100's 64 FP64 lanes an SM at the SM clock ``mhz``."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return cell_rows / (sms * 64 * mhz * 1e6) * 1e3


LAUNCH_FLOOR = {}


def launch_floor() -> dict:
    """The device and event time of one PyTorch elementwise op on a
    one-element CUDA tensor, traced and timed as the kernels are: the
    least a launch shows; a yardstick only."""
    one = torch.zeros((1,), device="cuda")
    fn = lambda: one.add_(1.0)                  # noqa: E731
    LAUNCH_FLOOR.update(ms=cuda_ms(fn, 50), kernel_ms=device_ms(fn, 20, None))
    log(f"launch_floor_ms={LAUNCH_FLOOR['kernel_ms']:.4f} (device; event "
        f"{LAUNCH_FLOOR['ms']:.4f}): one add_ on a one-element tensor")
    return LAUNCH_FLOOR


def scan_host_work(x, y, w, thr) -> dict:
    """The ``stump_scan`` wrapper's host work at the path shape, cut into
    its parts (:func:`host_us`): the wrapper, twice under two names (their
    difference is the spread between identical variants), and each part
    alone: the shape checks and ``_f32`` x4, the split, the output
    (``torch.empty_like``), the import and ``load()``, the stream, the
    device context, and the ``ctypes`` launch on a preallocated output
    with the arguments as the wrapper passes them."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.build import load
    N, F = x.shape
    T = thr.shape[1]
    dev = x.get_device()
    split = ops.scan_split(N, F, T, ops._sms(dev))
    vec = int(ops.scan_vec(T, thr))
    out = torch.empty_like(thr)
    fn = load().stump_scan_launch
    stream = ops._stream(x)

    def checks():
        ops._on_cpu(x, y, w, thr)
        if y.shape != (N,) or w.shape != (N,) or thr.shape != (F, T):
            raise ValueError("shapes")
        ops._f32("x", x)
        ops._f32("y", y)
        ops._f32("w", w)
        ops._f32("thresholds", thr)

    def import_load():
        from repro_torch.kernels.build import load
        return load().stump_scan_launch

    def on_device():
        with ops._on_device(x):
            pass

    def launch():
        if fn(x.data_ptr(), y.data_ptr(), w.data_ptr(), thr.data_ptr(),
              out.data_ptr(), None, N, F, T, *split, vec, stream) != 0:
            raise RuntimeError("stump_scan launch failed")

    call = lambda: ops.stump_scan(x, y, w, thr)          # noqa: E731
    return host_us({
        "wrapper": call, "wrapper_again": call, "checks": checks,
        "split": lambda: ops.scan_split(N, F, T, ops._sms(dev)),
        "empty_like": lambda: torch.empty_like(thr),
        "import_load": import_load, "stream": lambda: ops._stream(x),
        "on_device": on_device, "launch": launch})


def neighbour_splits(N, F, T, split):
    """The splits beside the launcher's: half the chunks (half the blocks
    a column group, or at one block twice the columns a block) and twice
    the chunks (twice the blocks), each block as wide as before."""
    from repro_torch.kernels import ref

    def make(cols, blocks):
        chunks = 256 // cols * blocks
        return ref.ScanSplit(max(1, -(-N // chunks)), chunks, blocks, cols)
    smaller = (make(split.cols, split.blocks // 2) if split.blocks > 1
               else make(split.cols * 2, 1) if split.cols < 256 else None)
    return {"smaller": smaller,
            "larger": make(split.cols, split.blocks * 2)}


# the single scan's kernels: the pass over the rows, and the second pass
# over the block sums where a column group takes more than one block
SCAN_KERNELS = ("stump_scan_kernel", "stump_scan_combine_kernel")


def check_scan(gen) -> dict:
    """Phase 3 for ``stump_scan`` at the path's shape and a large one: the
    kernel bit-equal to its plain version and to
    ``ref.scan_in_kernel_order`` (the CPU emulation of its order) at the
    launcher's split and at half and twice its chunks
    (:func:`neighbour_splits`), each split's device time; event and device
    time, the bytes and operations bound, its share and the TB/s, the
    FP64 pipe's floor at the SM clock under load, the launch floor, and
    at the path shape the wrapper's host work by part."""
    from repro_torch.kernels import ops, ref
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    floor = launch_floor()
    results = {}
    for label, (N, F, T) in (("main", (333, 64, 16)),
                             ("large", (24000, 64, 16))):
        x, y, w, thr = scan_inputs(gen, N, F, T)
        hx = [host(a) for a in (x, y, w, thr)]
        split = ops.scan_split(N, F, T, sms)
        want = ref.stump_scan_ref(x, y, w, thr)
        got = ops.stump_scan(x, y, w, thr)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        nbytes = 4 * (N * F + 2 * N + F * T) + 4 * F * T
        # two f32 compares per (n, f, t), one f64 add per miss
        misses = int(((x[:, :, None] > thr[None]) != (y > 0)[:, None, None])
                     .sum())
        b, by = bound_ms(nbytes, 2.0 * N * F * T, misses)
        splits = {}
        for name, sp in (("launcher", split),
                         *neighbour_splits(N, F, T, split).items()):
            if sp is None:
                continue
            call = (lambda sp=sp: ops._stump_scan_launch(x, y, w, thr, sp))
            out = call()
            torch.cuda.synchronize()
            emul = ref.scan_in_kernel_order(*hx, sp)
            if not (torch.equal(out, want) and torch.equal(out.cpu(), emul)):
                raise AssertionError(
                    f"stump_scan {label} split {tuple(sp)}: not bit-equal "
                    f"(plain {float((out - want).abs().max())}, emulation "
                    f"{float((out.cpu() - emul).abs().max())})")
            k_ms = device_ms(call, 20, SCAN_KERNELS)
            splits[name] = dict(split=list(sp), kernel_ms=k_ms,
                                bound_share=b / k_ms,
                                tb_per_s=nbytes / k_ms / 1e9)
        call = lambda: ops.stump_scan(x, y, w, thr)          # noqa: E731
        ms = cuda_ms(call, 50)
        kernel_ms = device_ms(call, 20, SCAN_KERNELS)
        mhz = sm_clock_mhz()
        r = results[label] = dict(
            shape=[N, F, T], split=list(split), max_abs_err=err,
            bit_equal=True, ms=ms, kernel_ms=kernel_ms,
            host_ms=ms - kernel_ms,
            plain_ms=cuda_ms(lambda: ref.stump_scan_ref(x, y, w, thr), 10),
            bound_ms=b, bound_by=by, bound_share=b / kernel_ms,
            tb_per_s=nbytes / kernel_ms / 1e9, sm_mhz=mhz,
            fp64_floor_ms=fp64_floor_ms(N * F * T, mhz),
            launch_floor_ms=floor["kernel_ms"], library_ms=None,
            splits=splits)
        if label == "main":
            r["host_us"] = scan_host_work(x, y, w, thr)
        log(f"kernel stump_scan {label} {r['shape']} split {tuple(split)}: "
            f"bit-equal to the plain version and the emulation; "
            f"ms={ms:.4f} kernel_ms={kernel_ms:.4f} "
            f"host_ms={r['host_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={b:.6f} ({by}) bound_share={r['bound_share']:.4f} "
            f"TB/s={r['tb_per_s']:.3f} fp64_floor_ms={r['fp64_floor_ms']:.6f} "
            f"(SM {mhz:.0f} MHz) launch_floor_ms={floor['kernel_ms']:.4f}")
        for name, sr in splits.items():
            log(f"  stump_scan {label} split {name} {tuple(sr['split'])}: "
                f"kernel_ms={sr['kernel_ms']:.4f} "
                f"bound_share={sr['bound_share']:.4f} "
                f"TB/s={sr['tb_per_s']:.3f}")
        if "host_us" in r:
            log("  stump_scan host_us(median[min,max])=" + ",".join(
                f"{k}:{v['median']:.2f}[{v['min']:.2f},{v['max']:.2f}]"
                for k, v in r["host_us"].items()))
    return results


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in units in the last place between two f32
    tensors of one sign (here: positive weights)."""
    return int((a.view(torch.int32).long() - b.view(torch.int32).long())
               .abs().max())


def vote_row(call, lib, plain, B, T, N):
    """The measurements of one vote case: ``call()`` the kernel's wrapper,
    ``lib()`` the one PyTorch call computing the same function, ``plain()``
    the plain version.  The kernel and the library call are timed in turns
    (kernel, library, library, kernel; the mean of the two medians), event
    times before any profiler session, as the other rows are.  Two calls
    must give the same bits."""
    nbytes = 4 * (B * T * N + B * T + B * N)
    b, by = bound_ms(nbytes, 2.0 * B * T * N)
    ms, lib_ms = cuda_ms(call, 25), cuda_ms(lib, 25)
    lib_ms, ms = (lib_ms + cuda_ms(lib, 25)) / 2, (ms + cuda_ms(call, 25)) / 2
    kernel_ms = device_ms(call, 20, "ensemble_vote_kernel")
    lib_kernel_ms = device_ms(lib, 20, None)
    lib_kernel_ms = (lib_kernel_ms + device_ms(lib, 20, None)) / 2
    kernel_ms = (kernel_ms + device_ms(call, 20, "ensemble_vote_kernel")) / 2
    first, again = call(), call()
    torch.cuda.synchronize()
    if not torch.equal(first.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"vote {(B, T, N)}: two calls differ")
    return dict(ms=ms, kernel_ms=kernel_ms, host_ms=ms - kernel_ms,
                plain_ms=cuda_ms(plain, 20), bound_ms=b, bound_by=by,
                tb_per_s=nbytes / kernel_ms / 1e9, bound_share=b / kernel_ms,
                library_ms=lib_ms, library_kernel_ms=lib_kernel_ms)


def host_us(variants, rounds: int = 15, calls: int = 200) -> dict:
    """Host microseconds a call of each of ``variants`` (name -> function),
    timed in turns: each round runs every variant ``calls`` times back to
    back on the host's clock, in an order that rotates and reverses from
    round to round.  The kernels launched are shorter than the host work
    between them, so the host sets the pace.  Per variant: the median,
    the least and the most over the rounds."""
    names = list(variants)
    times = {k: [] for k in names}
    for r in range(rounds):
        order = names[r % len(names):] + names[:r % len(names)]
        for k in (order if r % 2 == 0 else order[::-1]):
            fn = variants[k]
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            times[k].append((t1 - t0) / calls * 1e6)
    return {k: dict(median=statistics.median(v), min=min(v), max=max(v))
            for k, v in times.items()}


def vote_host_work(m, a, batched: bool) -> dict:
    """The vote wrapper's host work at a path shape, cut into its parts
    (:func:`host_us`): the whole wrapper, twice under two names (their
    difference is the spread between identical variants), the wrapper as
    it was before it skipped ``torch.cuda.device`` on the current card,
    the ``ctypes`` launch alone on a preallocated output, ``torch.empty``
    of the output, entering and leaving ``torch.cuda.device`` and
    ``ops._on_device`` (what every wrapper now enters in its place), and
    the device and dtype checks (``ops._on_cpu``, ``ops._f32``)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.build import load
    call = (lambda: ops.ensemble_vote_batched(m, a)) if batched else \
        (lambda: ops.ensemble_vote(m, a))
    shape = (m.shape[0], m.shape[2]) if batched else (m.shape[1],)
    out = torch.empty(shape, dtype=torch.float32, device=m.device)
    fn = (load().ensemble_vote_batched_launch if batched
          else load().ensemble_vote_launch)
    args = ((m.data_ptr(), a.data_ptr(), out.data_ptr()) + tuple(m.shape)
            + (torch._C._cuda_getCurrentRawStream(0),))

    def checks():
        ops._on_cpu(m, a)
        ops._f32("margins", m)
        ops._f32("alphas", a)

    def device_ctx():
        with torch.cuda.device(m.device):
            pass

    def on_device():
        with ops._on_device(m):
            pass

    def wrapper_before():
        if ops._on_cpu(m, a):
            raise AssertionError("vote inputs are on the CPU")
        if a.shape != m.shape[:-1]:
            raise ValueError(f"alphas must be {m.shape[:-1]}")
        mm, aa = ops._f32("margins", m), ops._f32("alphas", a)
        res = torch.empty(shape, dtype=torch.float32, device=mm.device)
        from repro_torch.kernels.build import load
        with torch.cuda.device(mm.device):
            ops._launch(key, getattr(load(), key + "_launch"), mm.data_ptr(),
                        aa.data_ptr(), res.data_ptr(), *m.shape,
                        ops._stream(mm))
        return res
    key = "ensemble_vote_batched" if batched else "ensemble_vote"
    return host_us({
        "wrapper": call, "wrapper_again": call,
        "wrapper_before": wrapper_before, "launch": lambda: fn(*args),
        "empty": lambda: torch.empty(shape, dtype=torch.float32,
                                     device=m.device),
        "device_ctx": device_ctx, "on_device": on_device,
        "checks": checks})


VOTE_DEPTH_LINE = "  const bool deep = B * tiles <= sms;"


def vote_depths(gen) -> dict:
    """Device ms of the vote kernel at each load depth, at the four phase-3
    shapes: copies of ``ensemble_vote.cu`` with the launcher's depth
    choice replaced by a constant (a whole chunk a round, or half a chunk
    at two blocks an SM) are built side by side into ``build/vote_depth``
    and launched through ``ctypes``; each gives the shipped kernel's bits.
    The shipped launcher picks the first where the column tiles are at
    most one an SM."""
    import ctypes
    from repro_torch.kernels import build, ops
    src = (build.CSRC / "ensemble_vote.cu").read_text()
    if VOTE_DEPTH_LINE not in src:
        raise AssertionError("ensemble_vote.cu: the depth choice moved")
    out_dir = ROOT / "build" / "vote_depth"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, value in (("deep", "true"), ("stream", "false")):
        cu = out_dir / f"{name}.cu"
        cu.write_text(src.replace(VOTE_DEPTH_LINE,
                                  f"  const bool deep = {value};"))
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", str(cu), "-o",
             str(out_dir / f"{name}.so")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} vote:\n{out}")
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")
                         ).ensemble_vote_batched_launch
        fn.argtypes = build.SIGNATURES["ensemble_vote_batched_launch"]
        fns[name] = fn
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for B, T, N in ((2, 300, 64), (8, 1024, 4096), (1, 256, 8192),
                    (1, 1024, 65536)):
        m = torch.rand((B, T, N), generator=gen, device="cuda") * 2 - 1
        a = torch.rand((B, T), generator=gen, device="cuda")
        want = ops.ensemble_vote_batched(m, a)
        row = {"shipped": "deep" if B * -(-N // 128) <= sms else "stream"}
        for name, fn in fns.items():
            out = torch.empty_like(want)
            stream = torch._C._cuda_getCurrentRawStream(0)

            def call():
                rc = fn(m.data_ptr(), a.data_ptr(), out.data_ptr(), B, T, N,
                        stream)
                if rc != 0:
                    raise RuntimeError(f"{name} vote: CUDA error {rc}")
            call()
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"vote {(B, T, N)}: {name} depth differs")
            row[name] = device_ms(call, 20, "ensemble_vote_kernel")
        rows[f"{B}x{T}x{N}"] = row
        log(f"vote depth {(B, T, N)}: shipped {row['shipped']}; device ms "
            f"deep {row['deep']:.4f} stream {row['stream']:.4f}")
    return rows


def vote_batch_invariance(gen):
    """The same 3 columns, T 300 and 1024, alone (B 1, N 3: the scalar
    route, a whole chunk of loads a round) and packed among others into
    (8, T + 24, 4096) with 24 zero padding rows (the 16-byte route, 256
    tiles: half a chunk a round), through both wrappers: equal bit for
    bit."""
    from repro_torch.kernels import ops
    dev = "cuda"
    at = ((1, 0), (4, 2049), (7, 4095))          # (b, n) of each column
    for T in (300, 1024):
        m = torch.rand((8, T + 24, 4096), generator=gen, device=dev) * 2 - 1
        a = torch.rand((8, T + 24), generator=gen, device=dev)
        m[:, T:] = 0.0
        a[:, T:] = 0.0
        alone_a = torch.rand((1, T), generator=gen, device=dev)
        alone_m = torch.stack([m[b, :T, n] for b, n in at], 1)[None]
        for b, _ in at:
            a[b, :T] = alone_a[0]
        out = ops.ensemble_vote_batched(m, a)
        got = {"alone": ops.ensemble_vote_batched(alone_m, alone_a)[0],
               "alone single": ops.ensemble_vote(alone_m[0], alone_a[0]),
               "packed": torch.stack([out[b, n] for b, n in at])}
        torch.cuda.synchronize()
        ref_bits = got["alone"].view(torch.int32)
        for name, g in got.items():
            if not torch.equal(g.view(torch.int32), ref_bits):
                raise AssertionError(f"vote batch invariance T {T}: {name} "
                                     f"{g.tolist()} != alone "
                                     f"{got['alone'].tolist()}")
        log(f"vote batch invariance T {T}: {', '.join(got)} equal bit for "
            f"bit ({got['alone'].tolist()})")


def check_generic_kernels():
    """Phase 3 for the generic learners' kernels: ``ensemble_vote_batched``
    at the generic serving batch's shape and a large one, ``ensemble_vote``
    and ``dist_update`` at ``benchmarks/kernel_bench.py``'s shapes and
    large ones, each against its plain version on the card, with
    ``library_ms`` the one PyTorch call that computes the same function
    (``dist_update`` has none; :func:`check_dist_update` has its row) and,
    for the votes, its device time
    (``library_kernel_ms``), the achieved TB/s, the share of the bytes
    bound, the host work before the launch (event - device) and, at the
    path shapes, its parts (:func:`vote_host_work`), two calls bit-equal,
    the batch invariance of :func:`vote_batch_invariance` and each load
    depth's device time (:func:`vote_depths`).  The large votes' inputs
    (134 and 268 MB) exceed the 50 MB L2, so each call reads HBM; the path
    shapes' sit in L2, as the evaluator's just-written margins do."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(3)
    dev = "cuda"
    results = {}
    for label, (B, T, N, pad) in (("main", (2, 300, 64, 20)),
                                  ("large", (8, 1024, 4096, 24))):
        m = torch.rand((B, T, N), generator=gen, device=dev) * 2.0 - 1.0
        m[:, ::4] = torch.sign(m[:, ::4])          # stump-like rows too
        alf = torch.rand((B, T), generator=gen, device=dev)
        m[:, T - pad:] = 0.0                         # the batch's T padding
        alf[:, T - pad:] = 0.0
        l1 = None if label == "main" else alf.abs().sum(1, keepdim=True)
        got = ops.ensemble_vote_batched(m, alf)
        want = ref.ensemble_vote_batched_ref(m, alf)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not close(got, want, l1):
            raise AssertionError(f"ensemble_vote_batched {label}: max err "
                                 f"{err}")
        lib = lambda: torch.bmm(alf[:, None, :], m)[:, 0]   # noqa: E731
        if not close(lib(), want, l1):
            raise AssertionError("torch.bmm disagrees with the plain version")
        results.setdefault("ensemble_vote_batched", {})[label] = dict(
            shape=[B, T, N], max_abs_err=err, **vote_row(
                lambda: ops.ensemble_vote_batched(m, alf), lib,
                lambda: ref.ensemble_vote_batched_ref(m, alf), B, T, N))
        if label == "main":
            results["ensemble_vote_batched"][label]["host_us"] = \
                vote_host_work(m, alf, True)
    for label, (T, N) in (("main", (256, 8192)), ("large", (1024, 65536))):
        # kernel_bench's inputs: sign margins, normal vote weights
        m = torch.sign(torch.randn((T, N), generator=gen, device=dev))
        alf = torch.randn((T,), generator=gen, device=dev)
        # signed weights: a column's sum cancels, and the rounding of its
        # partial sums scales with sum |alpha_t| (as at the large votes)
        l1 = alf.abs().sum()
        got = ops.ensemble_vote(m, alf)
        want = ref.ensemble_vote_ref(m, alf)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not close(got, want, l1):
            raise AssertionError(f"ensemble_vote {label}: max err {err}")
        results.setdefault("ensemble_vote", {})[label] = dict(
            shape=[T, N], max_abs_err=err, **vote_row(
                lambda: ops.ensemble_vote(m, alf), lambda: alf @ m,
                lambda: ref.ensemble_vote_ref(m, alf), 1, T, N))
        if label == "main":
            results["ensemble_vote"][label]["host_us"] = \
                vote_host_work(m, alf, False)
    vote_batch_invariance(gen)
    results["ensemble_vote_batched"]["main"]["depth_kernel_ms"] = \
        vote_depths(gen)
    results["dist_update"] = check_dist_update(gen)
    for name, by_shape in results.items():
        for label, r in by_shape.items():
            lib = r["library_ms"]
            if name == "dist_update":
                extra = dist_extra(r)
            else:
                extra = (f" library_kernel_ms={r['library_kernel_ms']:.4f}"
                         f" host_ms={r['host_ms']:.4f}"
                         f" TB/s={r['tb_per_s']:.3f}"
                         f" bound_share={r['bound_share']:.3f}")
                if "host_us" in r:
                    extra += " host_us(median[min,max])=" + ",".join(
                        f"{k}:{v['median']:.2f}[{v['min']:.2f},"
                        f"{v['max']:.2f}]" for k, v in r["host_us"].items())
            log(f"kernel {name} {label} {r['shape']}: "
                f"max_abs_err={r['max_abs_err']:.3g} ms={r['ms']:.4f} "
                f"kernel_ms={r['kernel_ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
                f"({r['bound_by']}) library_ms="
                + ("none" if lib is None else f"{lib:.4f}") + extra)
    return results


# ------------------------------------------------------------ dist_update
DIST_KERNEL = "dist_update_kernel"


def device_ops(fn, reps: int) -> dict:
    """Every device operation of ``reps`` calls of ``fn`` (kernels, fills,
    copies), traced by torch.profiler: name -> operations traced.  The
    profiler now and then drops one from a trace (:func:`device_ms`)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    counts = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            counts[evt.name] = counts.get(evt.name, 0) + 1
    return counts


def dist_inputs(gen, N):
    """``benchmarks/kernel_bench.py``'s inputs: a softmax distribution,
    sign labels and margins."""
    D = torch.softmax(torch.randn((N,), generator=gen, device="cuda"), 0)
    y = torch.sign(torch.randn((N,), generator=gen, device="cuda"))
    h = torch.sign(torch.randn((N,), generator=gen, device="cuda"))
    return D, y, h


def dist_not_taken(N, split, sms):
    """The route :func:`ops.dist_split` does not take at N: a cooperative
    grid where it takes the cluster, else the grid computing every w again
    after the barrier (nothing kept on chip)."""
    from repro_torch.kernels import ops, ref
    if not split.cluster:
        return "grid, w computed again", split._replace(held=0)
    nv = -(-N // 4)
    tile = -(-nv // sms)
    threads = min(ops.DIST_GRID_THREADS, max(32, 1 << (tile - 1).bit_length()))
    return "grid", ref.DistSplit(False, -(-nv // tile), threads, tile, tile)


def dist_host_work(D, y, h) -> dict:
    """The ``dist_update`` wrapper's host work, cut into its parts
    (:func:`host_us`): the wrapper with alpha a number, twice under two
    names (their difference is the spread between identical variants), and
    with alpha a CUDA tensor; the device and shape checks and ``_f32`` x3,
    alpha as the launcher takes it, the split, the one allocation of D', Z
    and the block sums, the import and ``load()``, the stream, the device
    context, and the ``ctypes`` launch on preallocated outputs.  Beside
    them what the wrapper before did and no longer does: alpha copied to
    the card (``torch.as_tensor``, a blocking copy from pageable memory)
    and Z zeroed (``torch.zeros``)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.build import load
    N = D.shape[0]
    dev = D.get_device()
    split = ops.dist_split(N, ops._sms(dev))
    out, Z, parts = ops._dist_outputs(N, split, D.device)
    fn = load().dist_update_launch
    stream = ops._stream(D)
    a_card = torch.tensor(0.7, device=D.device)
    args = (None, 0.7, D.data_ptr(), y.data_ptr(), h.data_ptr(),
            out.data_ptr(), Z.data_ptr(), parts, N, *split, stream)

    def checks():
        ops._on_cpu(D, y, h)
        if D.dim() != 1 or y.shape != (N,) or h.shape != (N,):
            raise ValueError("shapes")
        ops._f32("D", D)
        ops._f32("y", y)
        ops._f32("h", h)

    def import_load():
        from repro_torch.kernels.build import load
        return load().dist_update_launch

    def on_device():
        with ops._on_device(D):
            pass

    def launch():
        if fn(*args) != 0:
            raise RuntimeError("dist_update launch failed")

    call = lambda: ops.dist_update(0.7, D, y, h)         # noqa: E731
    return host_us({
        "wrapper": call, "wrapper_again": call,
        "wrapper_cuda_alpha": lambda: ops.dist_update(a_card, D, y, h),
        "checks": checks, "alpha": lambda: ops._alpha_arg(0.7, D.device),
        "split": lambda: ops.dist_split(N, ops._sms(dev)),
        "alloc": lambda: ops._dist_outputs(N, split, D.device),
        "import_load": import_load, "stream": lambda: ops._stream(D),
        "on_device": on_device, "launch": launch,
        "old_alpha_copy": lambda: torch.as_tensor(0.7, dtype=torch.float32,
                                                  device=D.device),
        "old_zeros": lambda: torch.zeros((), dtype=torch.float32,
                                         device=D.device)}, rounds=9)


def check_dist_update(gen) -> dict:
    """Phase 3 for ``dist_update`` at the kernel API path's N = 8,192 and
    at 4,194,304, alpha 0.7 as a number (as phase 9 passes it): D' within
    1e-6 and Z within 1e-6 relative of the plain version, w within 2 ulp;
    Z and D' bit-equal to ``ref.dist_update_in_kernel_order`` (the CPU
    emulation of the kernel's order) at alpha = 0, where w is D on both;
    two calls and alpha as a CUDA tensor bit-equal; every device operation
    of a call traced (one kernel, no fill, no copy); the event and device
    time, the TB/s and the share of the bytes bound; the route
    :func:`ops.dist_split` does not take, forced through the private
    launcher and timed; a same-bytes yardstick (``torch.addcmul``: 12
    bytes read and 4 written a sample, not eq. 4); the plain version's
    time; at the path shape the host work by part."""
    from repro_torch.kernels import ops, ref
    sms = ops._sms(0)
    out = {}
    for label, N in (("main", 8192), ("large", 4_194_304)):
        D, y, h = dist_inputs(gen, N)
        alpha = 0.7
        split = ops.dist_split(N, sms)
        call = lambda: ops.dist_update(alpha, D, y, h)     # noqa: E731
        got, z = call()
        want, wz = ref.dist_update_ref(alpha, D, y, h)
        again, z2 = ops.dist_update(torch.tensor(alpha, device="cuda"), D,
                                    y, h)
        got0, z0 = ops.dist_update(0.0, D, y, h)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        z_rel = float((z - wz).abs() / wz)
        a32 = torch.tensor(alpha, device="cuda")
        w_ulps = ulps(got, (D * torch.exp(-a32 * y * h)) / (z + 1e-30))
        want0, wz0 = ref.dist_update_in_kernel_order(0.0, D.cpu(), y.cpu(),
                                                     h.cpu(), split)
        bits_ok = (torch.equal(again.view(torch.int32), got.view(torch.int32))
                   and torch.equal(z2.view(torch.int32), z.view(torch.int32))
                   and torch.equal(z0.cpu().view(torch.int32),
                                   wz0.view(torch.int32))
                   and torch.equal(got0.cpu().view(torch.int32),
                                   want0.view(torch.int32)))
        if not (err <= 1e-6 and z_rel <= 1e-6 and w_ulps <= 2 and bits_ok):
            raise AssertionError(f"dist_update {label}: D' err {err}, Z rel "
                                 f"{z_rel}, w {w_ulps} ulp, bits {bits_ok}")
        traced = device_ops(call, 20)       # one kernel a call, no other
        if len(traced) != 1 or DIST_KERNEL not in next(iter(traced)) \
                or not 19 <= sum(traced.values()) <= 20:
            raise AssertionError(f"dist_update {label}: device operations "
                                 f"of 20 calls {traced}")
        # D, y, h read and D' written (16 bytes a sample, Z's 4 beside);
        # 2 multiplies, an exp, an add into Z and a divide a sample
        nbytes = 16.0 * N + 4
        b, by = bound_ms(nbytes, 5.0 * N)
        ms = cuda_ms(call, 50)
        kernel_ms = device_ms(call, 20, None)
        kernel_ms = (kernel_ms + device_ms(call, 20, None)) / 2
        route, other = dist_not_taken(N, split, sms)
        o_got, o_z = ops._dist_update_launch(alpha, D, y, h, other)
        torch.cuda.synchronize()
        o_err = float((o_got - want).abs().max())
        o_rel = float((o_z - wz).abs() / wz)
        if not (o_err <= 1e-6 and o_rel <= 1e-6):
            raise AssertionError(f"dist_update {label} {route}: D' err "
                                 f"{o_err}, Z rel {o_rel}")
        if other._replace(held=split.held) == split and not (
                torch.equal(o_got, got) and torch.equal(o_z, z)):
            raise AssertionError(f"dist_update {label}: w computed again "
                                 f"is not w kept, bit for bit")
        o_ms = device_ms(lambda: ops._dist_update_launch(alpha, D, y, h,
                                                         other), 20, None)
        yard = torch.empty_like(D)
        yard_ms = device_ms(lambda: torch.addcmul(D, y, h, out=yard), 20,
                            None)
        out[label] = dict(
            shape=[N], split=list(split), max_abs_err=err, z_rel_err=z_rel,
            w_ulps=w_ulps, ms=ms, kernel_ms=kernel_ms, host_ms=ms - kernel_ms,
            device_ops_in_20_calls=traced,
            tb_per_s=nbytes / kernel_ms / 1e9,
            bound_share=b / kernel_ms,
            not_taken=dict(route=route, split=list(other), kernel_ms=o_ms,
                           max_abs_err=o_err, z_rel_err=o_rel),
            addcmul_kernel_ms=yard_ms,
            plain_ms=cuda_ms(lambda: ref.dist_update_ref(alpha, D, y, h), 20),
            bound_ms=b, bound_by=by, library_ms=None)
        if label == "main":
            out[label]["host_us"] = dist_host_work(D, y, h)
    return out


def dist_extra(r) -> str:
    """The ``dist_update`` row's fields beyond the common ones."""
    nt = r["not_taken"]
    extra = (f" z_rel_err={r['z_rel_err']:.3g} w_ulps={r['w_ulps']}"
             f" split={r['split']}"
             f" device_ops_in_20_calls={r['device_ops_in_20_calls']}"
             f" host_ms={r['host_ms']:.4f} TB/s={r['tb_per_s']:.3f}"
             f" bound_share={r['bound_share']:.3f}"
             f" not_taken=({nt['route']} {nt['split']}"
             f" kernel_ms={nt['kernel_ms']:.4f})"
             f" addcmul_kernel_ms={r['addcmul_kernel_ms']:.4f}")
    if "host_us" in r:
        extra += " host_us(median[min,max])=" + ",".join(
            f"{k}:{v['median']:.2f}[{v['min']:.2f},{v['max']:.2f}]"
            for k, v in r["host_us"].items())
    return extra


# f32 at 2e-4 (the JAX package's flash tolerance, tests/test_kernels.py:83:
# sums over up to T keys in another order), bf16 at 3e-2 (the inputs' and
# the output's rounding)
FLASH_CASES = (  # label: (B, H, T, d, causal, dtype)
    ("main", (4, 16, 512, 64, True, torch.float32)),
    ("large", (2, 16, 8192, 64, True, torch.float32)),
    ("ragged", (4, 16, 200, 64, True, torch.float32)),
    ("d80", (4, 16, 512, 80, True, torch.float32)),
    ("d128", (4, 16, 512, 128, True, torch.float32)),
    ("full", (4, 16, 512, 64, False, torch.float32)),
    ("bf16", (4, 16, 512, 64, True, torch.bfloat16)),
    ("bf16_large", (2, 16, 8192, 64, True, torch.bfloat16)),
    ("bf16_d128", (4, 16, 512, 128, True, torch.bfloat16)),
    # the LM path's layout: (B,T,H,d) buffers seen as (B,H,T,d), the
    # result written into a (B,T,H,d) buffer
    ("strided", (4, 16, 512, 64, True, torch.float32)),
)


def check_flash_attention():
    """Phase 3 for ``flash_attention``: the kernel against its plain version
    on the card at the LM path's prefill shape and the other cases of
    ``FLASH_CASES``, each result also bit-equal to a second call's, with
    ``library_ms`` the time of ``scaled_dot_product_attention`` on the
    same inputs (never called by the port) and ``library_kernel_ms`` its
    device time.  The bound counts q, k, v read
    and out written once, and the product work these inputs need: 2 BH T^2 d
    under causality (half of QK^T and of PV), 4 BH T^2 d without, at the
    bf16 tensor-core rate for bf16 inputs and, for f32 ones, as the
    cheapest route to an f32-accurate result on this card: three TF32
    products for each (split TF32) at the TF32 tensor-core rate."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(5)
    results = {}
    for label, (B, H, T, d, causal, dtype) in FLASH_CASES:
        if label == "strided":
            q, k, v = (torch.randn((B, T, H, d), generator=gen, device="cuda")
                       .to(dtype).transpose(1, 2) for _ in range(3))
            buf = torch.empty((B, T, H, d), dtype=dtype, device="cuda")

            def call():
                return ops.flash_attention(q, k, v, causal=causal,
                                           out=buf.transpose(1, 2))
        else:
            q, k, v = (torch.randn((B, H, T, d), generator=gen,
                                   device="cuda").to(dtype)
                       for _ in range(3))

            def call():
                return ops.flash_attention(q, k, v, causal=causal)
        got = call().clone()
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = 2e-4 if dtype == torch.float32 else 3e-2
        if not (got.dtype == dtype and torch.allclose(
                got.float(), want.float(), rtol=tol, atol=tol)):
            raise AssertionError(f"flash_attention {label}: max err {err}")
        if not torch.equal(call(), got):
            raise AssertionError(f"flash_attention {label}: two calls differ")
        work = (2.0 if causal else 4.0) * B * H * T * T * d
        f32 = dtype == torch.float32
        b, by = bound_ms(4 * B * H * T * d * got.element_size(), 0.0,
                         ops_bf16=0.0 if f32 else work,
                         ops_tf32=3.0 * work if f32 else 0.0)
        large = "large" in label
        reps = 10 if large else 50
        results[label] = dict(
            shape=[B, H, T, d], causal=causal, dtype=str(dtype)[6:],
            max_abs_err=err, tol=tol, ms=cuda_ms(call, reps),
            kernel_ms=device_ms(call, min(reps, 20),
                                "flash_attention_kernel"),
            plain_ms=cuda_ms(
                lambda: ref.flash_attention_ref(q, k, v, causal=causal),
                3 if large else 10),
            bound_ms=b, bound_by=by,
            library_ms=cuda_ms(lambda: sdpa(q, k, v, is_causal=causal),
                               reps),
            library_kernel_ms=device_ms(
                lambda: sdpa(q, k, v, is_causal=causal), min(reps, 20),
                None))
        del q, k, v, got, want
    for label, r in results.items():
        log(f"kernel flash_attention {label} {r['shape']} "
            f"causal={r['causal']} {r['dtype']}: "
            f"max_abs_err={r['max_abs_err']:.3g} (tol {r['tol']}) "
            f"ms={r['ms']:.4f} kernel_ms={r['kernel_ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
            f"({r['bound_by']}) library_ms={r['library_ms']:.4f} "
            f"library_kernel_ms={r['library_kernel_ms']:.4f}")
    flash_sass()
    return results


def flash_sass() -> None:
    """One line per instance of ``flash_attention_kernel`` in the built
    library: its HGMMA (wgmma) and HMMA (mma.sync) instructions, from
    ``cuobjdump -sass`` where the toolkit has it.  A bf16 instance without
    HGMMA or an f32 one without HMMA fails the phase."""
    import re
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        log("sass: cuobjdump not found; tensor-core instructions not counted")
        return
    sass = subprocess.run([tool, "-sass", str(build.build())],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"flash_attention_kernelI(f|13__nv_bfloat16)"
                          r"Li(\d+)E", line)
            name = None if m is None else (
                "float" if m.group(1) == "f" else "bf16", int(m.group(2)))
            if name:
                counts[name] = {"HGMMA": 0, "HMMA": 0}
        elif name:
            for op in ("HGMMA", "HMMA"):
                counts[name][op] += f" {op}." in line
    if not counts:
        raise AssertionError("sass: no flash_attention_kernel in the library")
    for (dtype, D), c in sorted(counts.items()):
        log(f"sass flash_attention_kernel<{dtype}, {D}>: "
            f"HGMMA={c['HGMMA']} HMMA={c['HMMA']}")
        if c["HGMMA" if dtype == "bf16" else "HMMA"] == 0:
            raise AssertionError(f"sass: flash_attention_kernel<{dtype}, "
                                 f"{D}> has no tensor-core instruction")


# ------------------------------------------------------------ phase 4
def _key(p):
    return (int(p["feature"]), float(p["threshold"]), float(p["polarity"]))


def _exact_err(x, y, w, thr, key):
    """Stump ``key``'s weighted error on these inputs, summed in f64."""
    x, y, w, thr = (a.double().numpy() for a in (x, y, w, thr))
    miss = np.where(x[:, :, None] > thr[None], 1.0, -1.0) != y[:, None, None]
    err = np.einsum("n,nft->ft", w, miss)
    f, th, pol = key
    t = int(np.nonzero(thr[f] == th)[0][0])
    return err[f, t] if pol > 0 else 1.0 - err[f, t]


class FitLog:
    """The port's own stump learner, keeping each fit's inputs and pick
    where they lie (no copy to the host while the run goes on)."""

    def __init__(self):
        from repro_torch.models.weak import WeakLearnerSpec, get_weak_learner
        self.base = get_weak_learner("stump")
        self.fits = []
        self.spec = WeakLearnerSpec("stump", self.fit, self.base.predict,
                                    self.base.param_bytes)

    def fit(self, x, y, w, generator=None):
        p = self.base.fit(x, y, w, generator)
        self.fits.append((x, y, w.clone(), p))
        return p

    def on_cpu(self):
        shards = {}                      # one host copy per client shard
        host = lambda t: shards.setdefault(t.data_ptr(), t.cpu())
        return [(host(x), host(y), w.cpu(), {k: v.cpu() for k, v in p.items()})
                for x, y, w, p in self.fits]


def lockstep_on_cpu(cfg, data, mode, fits, label):
    """The same run on the CPU, handed the card's stump at every fit.

    Each fit's inputs must be the card's (x and y equal, the distribution
    within 1e-4 relative: the card's exp and log differ from the CPU's in
    the last bits), and the CPU's own pick on the card's inputs must be
    the card's stump or tie it to within ``ROUNDING`` in exact arithmetic:
    that holds ``stump_scan`` to its plain version at every fit of the
    main path.  Returns the run's metrics and the number of ties."""
    from repro_torch.core import FederatedBoostEngine
    from repro_torch.models.weak import WeakLearnerSpec, get_weak_learner
    from repro_torch.models.weak import stump_thresholds
    base = get_weak_learner("stump")
    replay = iter(enumerate(fits))
    ties = []

    def fit(x, y, w, generator=None):
        i, (gx, gy, gw, gp) = next(replay)
        if not (torch.equal(x, gx) and torch.equal(y, gy)):
            raise AssertionError(f"{label}: fit #{i} is on another client "
                                 f"shard than the card's")
        if not torch.allclose(w, gw, rtol=1e-4, atol=1e-9):
            raise AssertionError(f"{label}: distribution at fit #{i} differs "
                                 f"by {float((w - gw).abs().max())}")
        mine = base.fit(gx, gy, gw)
        if _key(mine) != _key(gp):
            thr = stump_thresholds(gx)
            gap = (_exact_err(gx, gy, gw, thr, _key(gp))
                   - _exact_err(gx, gy, gw, thr, _key(mine)))
            if abs(gap) > ROUNDING:
                raise AssertionError(f"{label}: fit #{i} card {_key(gp)} vs "
                                     f"cpu {_key(mine)}, exact gap {gap}")
            ties.append(i)
        return gp
    spec = WeakLearnerSpec("stump", fit, base.predict, base.param_bytes)
    m = FederatedBoostEngine(cfg, data, mode, weak=spec, device="cpu").run()
    if next(replay, None) is not None:
        raise AssertionError(f"{label}: the cpu run made fewer fits")
    return m, len(ties)


def first_split(cfg, data, mode, card_fits):
    """The CPU's own run beside the card's: None where every pick agrees,
    else (fit index, exact gap between the card's and the CPU's pick on
    the card's inputs, the largest relative difference of the two
    distributions there).  Both sum stump errors in f64, so the runs split
    only where the devices' exp and log, moving the distribution in its
    last bits, turn a near-tie."""
    from repro_torch.core import FederatedBoostEngine
    from repro_torch.models.weak import stump_thresholds
    cpu = FitLog()
    FederatedBoostEngine(cfg, data, mode, weak=cpu.spec, device="cpu").run()
    for i, ((gx, gy, gw, gp), (cx, _, cw, cp)) in enumerate(
            zip(card_fits, cpu.fits)):
        if _key(gp) != _key(cp) or not torch.equal(gx, cx):
            thr = stump_thresholds(gx)
            gap = (_exact_err(gx, gy, gw, thr, _key(gp))
                   - _exact_err(gx, gy, gw, thr, _key(cp)))
            rel = float(((gw - cw).abs() / gw.clamp_min(1e-30)).max()
                        if gx.shape == cx.shape else float("nan"))
            return i, gap, rel
    return None


def train(registry):
    from repro_torch import obs
    from repro_torch.configs.paper_fedboost import FedBoostConfig
    from repro_torch.core import FederatedBoostEngine
    from repro_torch.data import make_domain_data
    from repro_torch.sim.scenarios import DOMAINS

    runs = []
    datas = {}
    plan = [("edge_vision", "baseline", 25, "edge_vision_baseline"),
            ("edge_vision", "enhanced", 25, "edge_vision"),
            ("iot", "enhanced", 10, "iot")]
    for domain, mode, rounds, tenant in plan:
        dom = DOMAINS[domain]
        data = datas.setdefault(domain, make_domain_data(dom, seed=0))
        cfg = FedBoostConfig(
            n_clients=dom.n_clients, n_rounds=rounds, seed=0,
            straggler_factor=dom.straggler_factor,
            dropout_prob=dom.dropout_prob, link_mbps=dom.link_mbps,
            balanced_init=(domain == "iot"))
        log_ = FitLog()
        t0 = time.perf_counter()
        eng = FederatedBoostEngine(cfg, data, mode, weak=log_.spec,
                                   device="cuda")
        if eng.device.type != "cuda" or eng.clients[0].x.device.type != "cuda":
            raise AssertionError("engine data is not on the card")
        eng.attach_registry(registry, tenant)
        m = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append((domain, mode, cfg, m, log_))
        log(f"train {domain} {mode} {rounds} rounds on cuda: "
            f"bytes={m.total_bytes} msgs={m.n_messages} syncs={m.n_syncs} "
            f"merged={m.learners_merged} published={m.snapshots_published} "
            f"sim_time_s={m.sim_time_s!r} val_err={m.final_val_error:.4f} "
            f"test_err={m.final_test_error:.4f} wall_s={wall:.2f}")
        for v in (m.final_val_error, m.final_test_error, m.sim_time_s):
            if not math.isfinite(v):
                raise AssertionError(f"non-finite metric in {domain} {mode}")
        if not m.final_val_error < 0.35:
            raise AssertionError(f"{domain} {mode} did not learn")
    fits = int(obs.get_registry().counter("train.fits").value)
    if fits != sum(len(r[4].fits) for r in runs):
        raise AssertionError(f"train.fits {fits} != fits logged")
    # every run again on the CPU in lockstep with the card's picks: integer
    # accounting and the event clock agree exactly, errors to one sample
    keys = ("uplink_bytes", "downlink_bytes", "n_messages", "n_syncs",
            "learners_merged", "rounds_unavailable", "sim_time_s")
    for domain, mode, cfg, m_gpu, log_ in runs:
        label = f"{domain} {mode}"
        m_cpu, ties = lockstep_on_cpu(cfg, datas[domain], mode,
                                      log_.on_cpu(), label)
        diff = {k: (getattr(m_gpu, k), getattr(m_cpu, k)) for k in keys
                if getattr(m_gpu, k) != getattr(m_cpu, k)}
        if diff:
            raise AssertionError(f"{label}: cuda vs cpu counters {diff}")
        one = 1.0 / len(datas[domain]["test"][1]) + 1e-6
        d_err = max(abs(m_gpu.final_test_error - m_cpu.final_test_error),
                    abs(m_gpu.final_val_error - m_cpu.final_val_error))
        log(f"train check {label}: cpu lockstep counters equal the card's; "
            f"{len(log_.fits)} fits, cpu pick == card pick at "
            f"{len(log_.fits) - ties} (rounding ties {ties}); test error "
            f"cuda {m_gpu.final_test_error:.4f} cpu "
            f"{m_cpu.final_test_error:.4f}")
        if d_err > one:
            raise AssertionError(f"{label}: cuda vs cpu errors differ by "
                                 f"{d_err}")
        split = first_split(cfg, datas[domain], mode, log_.on_cpu())
        log(f"train check {label}: the cpu's own run "
            + ("picks as the card's at every fit" if split is None else
               f"splits from the card's at fit #{split[0]}: exact gap "
               f"{split[1]:.3g} on the card's inputs, distributions "
               f"{split[2]:.3g} apart (relative)"))
    return datas, fits


# ------------------------------------------------------------ phase 5
def recording_stump_shapes():
    """Wrap the two stump vote wrappers in ``ops`` so that each call
    records its (B, T, N); returns the counts (kernel -> Counter of
    shapes) and a function that restores the wrappers."""
    from collections import Counter
    from repro_torch.kernels import ops
    shapes = {name: Counter() for name in STUMP_KERNELS}
    saved = {name: getattr(ops, name) for name in STUMP_KERNELS}

    def wrap(name, fn):
        def call(xsel, *rest):
            shapes[name][tuple(xsel.shape)] += 1
            return fn(xsel, *rest)
        return call
    for name, fn in saved.items():
        setattr(ops, name, wrap(name, fn))

    def restore():
        for name, fn in saved.items():
            setattr(ops, name, fn)
    return shapes, restore


def serve(registry, datas):
    """Phase 5; returns the stump votes' launch shapes (kernel -> Counter
    of (B, T, N))."""
    from repro_torch.kernels.ops import KernelPolicy
    from repro_torch.serve import (BatchConfig, BatchEvaluator,
                                   EnsembleServer, ResultCache)

    fused = KernelPolicy(fused_fingerprint=True)
    policy_for = lambda tenant: fused if tenant == "iot" else None
    registry.rebase_clock(0.0)
    server = EnsembleServer(registry, BatchConfig(max_batch=64,
                                                  cache_capacity=4096),
                            policy_for=policy_for, device="cuda")
    batches = []
    evaluate = server.evaluator.evaluate

    def recording(batch):
        out = evaluate(batch)
        batches.append((list(batch), out, server.evaluator.last_eval.fp_hits))
        return out
    server.evaluator.evaluate = recording

    rng = np.random.RandomState(1)
    tenants = ("edge_vision", "iot")
    sent = []                                  # (tenant, row) per request
    fresh = {t: 0 for t in tenants}
    for _ in range(2048):
        if sent and rng.rand() < 0.25:         # a repeat of an earlier one
            sent.append(sent[rng.randint(len(sent))])
            continue
        t = tenants[rng.randint(2)]
        sent.append((t, fresh[t] % len(datas[t]["test"][1])))
        fresh[t] += 1
    responses = []
    shapes, restore = recording_stump_shapes()
    try:
        t0 = time.perf_counter()
        for tenant, row in sent:
            x = datas[tenant]["test"][0][row]
            accepted, done = server.submit(tenant, x,
                                           now=time.perf_counter() - t0)
            if not accepted:
                raise AssertionError("request rejected")
            responses += done
        responses += server.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    if len(responses) != len(sent):
        raise AssertionError(f"{len(responses)} responses for {len(sent)}")
    correct = 0
    for r in responses:
        tenant, row = sent[r.rid]
        if r.snapshot_version == 0 or not math.isfinite(r.margin):
            raise AssertionError(f"bad response {r}")
        correct += r.label == datas[tenant]["test"][1][row]
    rep = server.metrics.report()
    ev = server.evaluator
    log(f"serve: {len(responses)} requests in {rep['n_batches']} batches, "
        f"accuracy={correct / len(responses):.4f} p50_ms={rep['p50_ms']:.3f} "
        f"p99_ms={rep['p99_ms']:.3f} wall_s={wall:.3f} "
        f"evaluator_launches={ev.kernel_launches} "
        f"host_hashes={ev.host_hash_calls} "
        f"fp_hits={sum(h for _, _, h in batches)} "
        f"cache_hits={server.cache.stats.hits}")
    # the same batches through the CPU plain path, with a cache of its own
    cpu = BatchEvaluator(registry, cache=ResultCache(4096),
                         policy_for=policy_for, device="cpu")
    mismatch = worst = far = 0
    fp_hits = cpu_fp_hits = 0
    for batch, out, hits in batches:
        want = cpu.evaluate(batch)
        fp_hits += hits
        cpu_fp_hits += cpu.last_eval.fp_hits
        for g, c in zip(out, want):
            worst = max(worst, abs(g.margin - c.margin))
            far += abs(g.margin - c.margin) > TOL + TOL * abs(c.margin)
            if abs(c.margin) > 1e-5 and g.label != c.label:
                mismatch += 1
    log(f"serve check: cpu plain path on the same {len(batches)} batches: "
        f"label mismatches={int(mismatch)} max |margin diff|={worst:.3g} "
        f"cpu fp_hits={cpu_fp_hits}")
    if mismatch:
        raise AssertionError(f"{int(mismatch)} labels differ from the cpu")
    if far:
        raise AssertionError(f"{far} margins differ from the cpu beyond "
                             f"rtol/atol {TOL} (max {worst})")
    if fp_hits != cpu_fp_hits or fp_hits <= 0:
        raise AssertionError(f"fp_hits cuda {fp_hits} cpu {cpu_fp_hits}")
    for name, counts in shapes.items():
        log(f"serve: {name} launch shapes (B, T, N): " + ", ".join(
            f"{shape} x{n}" for shape, n in counts.most_common()))
    return shapes


def check_stump_path_shape(shapes) -> dict:
    """Phase 3's stump measurements (:func:`check_stump_shape`) at the
    serving path's commonest launch shape over both kernels, on random
    inputs without padding rows."""
    from collections import Counter
    total = Counter()
    for counts in shapes.values():
        total.update(counts)
    (B, T, N), n = total.most_common(1)[0]
    log(f"stump votes at the path's commonest shape {(B, T, N)} "
        f"({n} of {sum(total.values())} launches)")
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = check_stump_shape(gen, "path", B, T, N, 0)
    for r in rows.values():
        r["path_launches"] = n
    return rows


# ------------------------------------------------------------ phase 6
def device_us_by_name(prof) -> dict:
    """Device time (us) of a torch.profiler trace, by kernel name."""
    by_name = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            key = evt.name.replace("(anonymous namespace)::", "")
            key = key.split("(")[0][:70]
            by_name[key] = by_name.get(key, 0.0) + evt.device_time_total
    return by_name


def profile_main_path(registry, datas, weak_learner="stump",
                      tenant="edge_vision", label="profile", rounds=25):
    """One more edge_vision enhanced training run of ``rounds`` rounds and
    a 512-request serve of ``tenant``, traced by torch.profiler (CUDA
    activity only): device time by kernel name and the share of the wall
    time the card was busy."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.paper_fedboost import FedBoostConfig
    from repro_torch.core import FederatedBoostEngine
    from repro_torch.serve import BatchConfig, EnsembleServer
    from repro_torch.sim.scenarios import DOMAINS

    dom = DOMAINS["edge_vision"]
    cfg = FedBoostConfig(n_clients=dom.n_clients, n_rounds=rounds, seed=0,
                         weak_learner=weak_learner,
                         straggler_factor=dom.straggler_factor,
                         dropout_prob=dom.dropout_prob,
                         link_mbps=dom.link_mbps)
    server = EnsembleServer(registry, BatchConfig(max_batch=64),
                            device="cuda")
    xt = datas["edge_vision"]["test"][0]
    phases = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        FederatedBoostEngine(cfg, datas["edge_vision"], "enhanced",
                             device="cuda").run()
        torch.cuda.synchronize()
        phases["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(512):
            server.submit(tenant, xt[i % len(xt)],
                          now=time.perf_counter() - t0)
        server.drain()
        torch.cuda.synchronize()
        phases["serve"] = time.perf_counter() - t0
    by_name = device_us_by_name(prof)
    busy_ms = sum(by_name.values()) / 1e3
    wall_ms = 1e3 * sum(phases.values())
    log(f"{label}: {weak_learner} {rounds} rounds wall_ms={wall_ms:.1f} "
        f"(train {1e3 * phases['train']:.1f}, serve "
        f"{1e3 * phases['serve']:.1f}) "
        f"device_busy_ms={busy_ms:.2f} idle_share={1 - busy_ms / wall_ms:.4f}")
    if not by_name:
        log(f"{label}: the trace holds no device time (not measured)")
    for key, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"{label}:   {us / 1e3:9.3f} ms  {key}")


# ------------------------------------------------------------ phase 7
CARD = "cuda"
FLEET_ROUNDS = 2                # mobile_100k's default is 4: cut to 2
FLEET_LOCKSTEP_CLIENTS = 4096   # FederatedBoostEngine.FLEET_AUTO_CLIENTS
PROFILE_SYNCS = 2000            # the enhanced run's profiled window
SCAN_TOL = 1e-7                 # both sum in f64 in one order: expect 0
LARGE_SCAN = (4096, 333, 64, 16)  # B, N, F, T: edge_vision-sized shards
INT_FIELDS = ("uplink_bytes", "downlink_bytes", "n_messages", "n_syncs",
              "learners_merged", "rounds_unavailable")
# The JAX package's run of the full-width check's configuration, on a CPU:
# repro.sim.harness.run_scenario("mobile_100k", trace="legacy", seed=0,
# n_rounds=2, serve=False).  Baseline counters and the clock do not depend
# on what is learned, so the port must give them exactly; the enhanced ones
# are printed beside the port's.
FLEET_REFERENCE = {
    "baseline": dict(uplink_bytes=56_000_000,
                     downlink_bytes=295_624_000_000, n_messages=400_000,
                     n_syncs=2, learners_merged=200_000,
                     rounds_unavailable=30_133,
                     sim_time_s=12.15086994809576,
                     final_val_error=0.2068749964237213,
                     final_test_error=0.2175000011920929),
    "enhanced": dict(uplink_bytes=30_400_000,
                     downlink_bytes=160_027_200_000, n_messages=200_000,
                     n_syncs=100_000, learners_merged=200_000,
                     rounds_unavailable=30_133,
                     sim_time_s=24.04893916706747,
                     final_val_error=0.2068749964237213,
                     final_test_error=0.21812500059604645),
}


def fleet_scenario(n_clients=None):
    """``mobile_100k``, or the same scenario, shard size and overrides at
    ``n_clients`` clients (4 samples a client, as at full size)."""
    from dataclasses import replace
    from repro_torch.sim.scenarios import get_scenario
    sc = get_scenario("mobile_100k")
    if n_clients is None:
        return sc
    return replace(sc, domain=replace(sc.domain, n_clients=n_clients,
                                      n_samples=4 * n_clients))


def host(t: torch.Tensor) -> torch.Tensor:
    """A copy on the host that later in-place updates do not reach."""
    return t.detach().to("cpu", copy=True)


def cuda_profile():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def scan_batched_bound(x, y, w, thr):
    """(bound ms, bound by) for one stump_scan_batched call: each input read
    once and the error grid written once, against two f32 compares per
    (b, n, f, t) and one f64 add per miss of these inputs."""
    B, N, F = x.shape
    T = thr.shape[2]
    nbytes = 4 * (B * N * F + 2 * B * N + 2 * B * F * T)
    misses = 0
    for n in range(N):
        pred = x[:, n, :, None] > thr
        misses += int((pred != (y[:, n] > 0)[:, None, None]).sum())
    return bound_ms(nbytes, 2.0 * B * N * F * T, misses)


def check_scan_batched():
    """Phase 7.1: the kernel against its plain version on the card, on the
    first fit wave of mobile_100k (its X, Y, D0 and threshold grids, built
    by the fleet on the card) and on a large-shard batch: bit-equal (and
    within ``SCAN_TOL``), through the wrapper and on each load route
    (16-byte and 4-byte, through the library's launcher), with each route's device
    time, the bytes bound, its share and the TB/s, and the FP64 pipe's
    floor at the SM clock under load."""
    from repro_torch.core import FederatedBoostEngine
    from repro_torch.core.fleet import FleetCore
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.build import load
    sc = fleet_scenario()
    t0 = time.perf_counter()
    data = sc.make_data(0)
    eng = FederatedBoostEngine(sc.fedboost_config(seed=0), data, "baseline",
                               fleet=True, device=CARD)
    core = FleetCore(eng)
    log(f"fleet 7.1: mobile_100k data and first-wave inputs on the card in "
        f"{time.perf_counter() - t0:.2f} s: X {tuple(core.X.shape)} "
        f"THR {tuple(core.THR.shape)}")
    gen = torch.Generator(device=CARD).manual_seed(2)
    B, N, F, T = LARGE_SCAN
    x = torch.randn((B, N, F), generator=gen, device=CARD)
    y = torch.where(torch.rand((B, N), generator=gen, device=CARD) < 0.5,
                    1.0, -1.0)
    n_valid = torch.randint(200, N + 1, (B,), generator=gen, device=CARD)
    w = torch.rand((B, N), generator=gen, device=CARD)
    w = torch.where(torch.arange(N, device=CARD)[None] < n_valid[:, None],
                    w, 0.0)                      # padding rows weigh 0
    rows = torch.randint(0, N, (B, F, T), generator=gen, device=CARD)
    thr = torch.gather(x.transpose(1, 2), 2, rows).contiguous()
    cases = {"main": (core.X, core.Y, core.D, core.THR),
             "large": (x, y, w, thr)}
    fn = load().stump_scan_batched_launch
    results = {}
    for label, args in cases.items():
        got = ops.stump_scan_batched(*args)
        want = ref.stump_scan_batched_ref(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not (err <= SCAN_TOL and torch.equal(got, want)):
            raise AssertionError(f"stump_scan_batched {label}: max err {err}, "
                                 f"not bit-equal")
        B, N, F = args[0].shape
        T = args[3].shape[2]
        b, by = scan_batched_bound(*args)
        nbytes = 4 * (B * N * F + 2 * B * N + 2 * B * F * T)
        routes = {}
        for route, vec in (("16-byte", 1), ("4-byte", 0)):
            out = torch.empty_like(want)
            ptrs = [a.data_ptr() for a in args] + [out.data_ptr()]
            stream = torch._C._cuda_getCurrentRawStream(0)

            def call(ptrs=ptrs, vec=vec, route=route):
                rc = fn(*ptrs, B, N, F, T, vec, stream)
                if rc != 0:
                    raise RuntimeError(f"{route} scan: CUDA error {rc}")
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"stump_scan_batched {label} {route} "
                                     f"route not bit-equal")
            k_ms = device_ms(call, 10, "stump_scan_batched_kernel")
            routes[route] = dict(kernel_ms=k_ms, bound_share=b / k_ms,
                                 tb_per_s=nbytes / k_ms / 1e9)
            del out
        del got, want
        ms = cuda_ms(lambda: ops.stump_scan_batched(*args), 20)
        kernel_ms = device_ms(lambda: ops.stump_scan_batched(*args), 10,
                              "stump_scan_batched_kernel")
        mhz = sm_clock_mhz()
        r = results[label] = dict(
            shape=[B, N, F, T], max_abs_err=err, bit_equal=True,
            load_route="16-byte" if ops.scan_vec(T, args[3]) else "4-byte",
            ms=ms, kernel_ms=kernel_ms,
            host_ms=ms - kernel_ms,
            plain_ms=cuda_ms(lambda: ref.stump_scan_batched_ref(*args), 3),
            bound_ms=b, bound_by=by, bound_share=b / kernel_ms,
            tb_per_s=nbytes / kernel_ms / 1e9, sm_mhz=mhz,
            fp64_floor_ms=fp64_floor_ms(B * N * F * T, mhz),
            launch_floor_ms=LAUNCH_FLOOR.get("kernel_ms"), library_ms=None,
            routes=routes)
        log(f"kernel stump_scan_batched {label} {r['shape']} "
            f"({r['load_route']} route): "
            f"max_abs_err={err:.3g} bit-equal ms={ms:.4f} "
            f"kernel_ms={kernel_ms:.4f} host_ms={r['host_ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={b:.5f} ({by}) "
            f"bound_share={r['bound_share']:.4f} TB/s={r['tb_per_s']:.3f} "
            f"fp64_floor_ms={r['fp64_floor_ms']:.5f} (SM {mhz:.0f} MHz)")
        for route, rr in routes.items():
            log(f"  stump_scan_batched {label} {route} route: "
                f"kernel_ms={rr['kernel_ms']:.4f} "
                f"bound_share={rr['bound_share']:.4f} "
                f"TB/s={rr['tb_per_s']:.3f}")
    del core, eng, cases, args
    torch.cuda.empty_cache()
    return results


class FleetRecorder:
    """Timing and logging wrappers around the fleet's methods while a run
    goes on: per-mode wall, waves, fits and launches; the wall split of the
    run into fit waves, local updates, server merges, catch-ups and the
    rest; every wave's picks and distributions on the host; and, in an
    enhanced run, a torch.profiler window (CUDA activity only) over its
    start and first ``PROFILE_SYNCS`` syncs.  The wrappers only measure:
    they call the methods unchanged."""

    PARTS = {"_fit_wave": "fit waves", "_local_update": "local updates",
             "_merge_window": "server merges",
             "_catch_up_client": "client catch-ups",
             "_catch_up_fleet": "fleet catch-ups"}

    def __init__(self, profile: bool):
        from repro_torch.core import fleet
        self.cls = fleet.FleetCore
        self.saved = {n: getattr(self.cls, n)
                      for n in (*self.PARTS, "run")}
        self.profile = profile
        self.runs = {}
        for name, fn in self.saved.items():
            setattr(self.cls, name, self._wrap(name, fn))

    def close(self):
        for name, fn in self.saved.items():
            setattr(self.cls, name, fn)

    def _wrap(self, name, fn):
        rec = self

        def wrapper(core, *args, **kwargs):
            r = rec.runs.get(core.m.mode)
            if name == "run":
                return rec._run(core, fn)
            t0 = time.perf_counter()
            out = fn(core, *args, **kwargs)
            if name in ("_fit_wave", "_local_update", "_catch_up_fleet"):
                torch.cuda.synchronize()          # a few calls a run
            r["parts"][name] += time.perf_counter() - t0
            if name == "_fit_wave":
                r["waves"].append((np.asarray(args[0]).copy(),
                                   *(host(a).numpy() for a in out),
                                   host(core.D).numpy()))
            if name == "_catch_up_client":
                r["syncs"] += 1
                if r.get("prof") is not None and r["syncs"] == PROFILE_SYNCS:
                    rec._stop_profile(r)
            return out
        return wrapper

    def _run(self, core, fn):
        from repro_torch import obs
        from repro_torch.kernels import ops
        mode = core.m.mode
        reg = obs.get_registry()
        r = self.runs[mode] = dict(parts={n: 0.0 for n in self.PARTS},
                                   waves=[], syncs=0, prof=None)
        before = (ops.LAUNCHES["stump_scan_batched"],
                  reg.counter("train.fit_batches").value,
                  reg.counter("train.fits").value)
        if self.profile and mode == "enhanced":
            r["prof"] = cuda_profile()
            r["prof"].start()
            r["prof_t0"] = time.perf_counter()
        t0 = time.perf_counter()
        out = fn(core)
        torch.cuda.synchronize()
        r["wall"] = time.perf_counter() - t0
        if r["prof"] is not None:
            self._stop_profile(r)
        r["launches"] = ops.LAUNCHES["stump_scan_batched"] - before[0]
        r["fit_batches"] = int(reg.counter("train.fit_batches").value
                               - before[1])
        r["fits"] = int(reg.counter("train.fits").value - before[2])
        return out

    @staticmethod
    def _stop_profile(r):
        torch.cuda.synchronize()
        r["prof_wall"] = time.perf_counter() - r["prof_t0"]
        r["prof_syncs"] = r["syncs"]
        prof, r["prof"] = r["prof"], None
        prof.stop()
        busy = {}
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                key = evt.name.replace("(anonymous namespace)::", "")
                key = key.split("(")[0][:60]
                busy[key] = busy.get(key, 0.0) + evt.device_time_total / 1e6
        r["prof_busy"] = busy


def _slot_errors(x, y, w, thr):
    """Both polarities' weighted errors of every stump of one slot, summed
    in f64 on the host: (2 * F * T,)."""
    x, y, w, thr = (np.asarray(a, np.float64) for a in (x, y, w, thr))
    miss = np.where(x[:, :, None] > thr[None], 1.0, -1.0) != y[:, None, None]
    e = np.einsum("n,nft->ft", w, miss).reshape(-1)
    return np.concatenate([e, 1.0 - e])


def _pick_gap(x, y, w, thr, a, b):
    """Exact error of pick ``a`` minus that of pick ``b`` on one slot's
    inputs; a pick is (feature, threshold, polarity)."""
    errs = _slot_errors(x, y, w, thr)
    F, T = thr.shape

    def at(p):
        f, th, pol = int(p[0]), np.float32(p[1]), float(p[2])
        t = int(np.nonzero(thr[f] == th)[0][0])
        return errs[f * T + t + (0 if pol > 0 else F * T)]
    return at(a) - at(b)


def _first_split(card_waves, cpu_waves, X, Y, THR):
    """The first (wave, slot) where two logged runs pick apart, with the
    exact gap of the two picks on the card's inputs; None if none does."""
    for i, (cw, pw) in enumerate(zip(card_waves, cpu_waves)):
        slots, f, thr, pol, D = cw
        if not np.array_equal(slots, pw[0]):
            return i, None, "the waves hold other slots"
        diff = np.nonzero((f != pw[1]) | (thr != pw[2]) | (pol != pw[3]))[0]
        if len(diff):
            j = int(diff[0])
            b = int(slots[j])
            gap = _pick_gap(X[b], Y[b], D[b], THR[b],
                            (f[j], thr[j], pol[j]),
                            (pw[1][j], pw[2][j], pw[3][j]))
            return i, b, gap
    return None


def fleet_full_width():
    """Phase 7.2 (and the wall split of 7.4): mobile_100k at full width
    through the harness, both modes, on the card."""
    from repro_torch.kernels import ops
    from repro_torch.sim.harness import run_scenario, summarize
    rec = FleetRecorder(profile=True)
    try:
        t0 = time.perf_counter()
        rep = run_scenario("mobile_100k", trace="legacy", seed=0,
                           n_rounds=FLEET_ROUNDS, device=CARD)
        total = time.perf_counter() - t0
    finally:
        rec.close()
    launches = dict(ops.LAUNCHES)
    log(f"fleet 7.2: run_scenario mobile_100k legacy seed 0 "
        f"{FLEET_ROUNDS} rounds on {CARD}: {total:.2f} s with data")
    for line in summarize(rep).splitlines():
        log(f"fleet 7.2: {line}")
    log(f"fleet 7.2: row {json.dumps(rep.row)}")
    for mode in ("baseline", "enhanced"):
        m, r, want = getattr(rep, mode), rec.runs[mode], FLEET_REFERENCE[mode]
        got = {k: getattr(m, k) for k in INT_FIELDS}
        log(f"fleet 7.2 {mode}: wall_s={r['wall']:.3f} waves="
            f"{r['fit_batches']} fits={r['fits']} stump_scan_batched "
            f"launches={r['launches']} {got} sim_time_s={m.sim_time_s!r} "
            f"val_err={m.final_val_error!r} test_err={m.final_test_error!r}")
        ref_line = {k: want[k] for k in INT_FIELDS}
        log(f"fleet 7.2 {mode} reference: {ref_line} sim_time_s="
            f"{want['sim_time_s']!r} val_err={want['final_val_error']!r} "
            f"test_err={want['final_test_error']!r}")
        if r["launches"] != r["fit_batches"] or r["launches"] < 1:
            raise AssertionError(f"{mode}: {r['launches']} launches for "
                                 f"{r['fit_batches']} waves")
        if r["fits"] != m.learners_merged:
            raise AssertionError(f"{mode}: {r['fits']} fits, "
                                 f"{m.learners_merged} merged")
        for v in (m.final_val_error, m.final_test_error, m.sim_time_s):
            if not math.isfinite(v):
                raise AssertionError(f"non-finite metric in {mode}")
        diff = {k: (got[k], want[k]) for k in INT_FIELDS
                if got[k] != want[k]}
        if m.sim_time_s != want["sim_time_s"]:
            diff["sim_time_s"] = (m.sim_time_s, want["sim_time_s"])
        if mode == "baseline" and diff:
            raise AssertionError(f"baseline counters differ from the "
                                 f"reference's: {diff}")
        if mode == "enhanced":
            log(f"fleet 7.2 enhanced: counters "
                + ("equal the reference's" if not diff else
                   f"differ from the reference's: {diff}"))
            if diff:
                enhanced_split(rec.runs["enhanced"]["waves"])
    if not rep.within_band:
        raise AssertionError(f"mobile_100k out of band: {rep.band_failures}")
    wall_split(rec.runs["enhanced"])
    return launches, rec.runs


def enhanced_split(card_waves):
    """Where the card's enhanced run and the CPU's own run of the same
    configuration first pick apart (as phase 4 does at the main path)."""
    from repro_torch.core import FederatedBoostEngine
    from repro_torch.core.fleet import FleetCore
    sc = fleet_scenario()
    data = sc.make_data(0)
    cfg = sc.fedboost_config(seed=0, n_rounds=FLEET_ROUNDS)
    rec = FleetRecorder(profile=False)
    try:
        eng = FederatedBoostEngine(cfg, data, "enhanced", fleet=True,
                                   device="cpu")
        eng.run()
    finally:
        rec.close()
    core = FleetCore(FederatedBoostEngine(cfg, data, "baseline", fleet=True,
                                          device="cpu"))
    split = _first_split(card_waves, rec.runs["enhanced"]["waves"],
                         core.X.numpy(), core.Y.numpy(), core.THR.numpy())
    log("fleet 7.2 enhanced: the cpu's own run "
        + ("picks as the card's at every fit" if split is None else
           f"splits from the card's at wave {split[0]}, client {split[1]}: "
           f"exact gap {split[2]} on the card's inputs"))


def wall_split(r):
    """Phase 7.4: where the enhanced full-width run's wall time went, and
    the card's busy share over the profiled window."""
    parts = {FleetRecorder.PARTS[k]: v for k, v in r["parts"].items()}
    rest = r["wall"] - sum(parts.values())
    log(f"fleet 7.4 enhanced wall split (s): wall={r['wall']:.3f} "
        + " ".join(f"{k.replace(' ', '_')}={v:.3f}" for k, v in parts.items())
        + f" rest={rest:.3f} (syncs={r['syncs']})")
    busy = sum(r["prof_busy"].values())
    log(f"fleet 7.4 profiled window: start of the run through sync "
        f"{r['prof_syncs']}: wall_s={r['prof_wall']:.3f} device_busy_s="
        f"{busy:.4f} busy_share={busy / r['prof_wall']:.4f}")
    for key, sec in sorted(r["prof_busy"].items(), key=lambda kv: -kv[1])[:8]:
        log(f"fleet 7.4   {1e3 * sec:10.3f} ms  {key}")


def fleet_lockstep():
    """Phase 7.3: mobile_100k's configuration at 4,096 clients, both modes,
    cut to 2 rounds as at full width, on the card; then on the CPU handed
    the card's pick at every wave.
    Every counter and the clock must agree, and the CPU's own pick on the
    card's inputs must be the card's or tie it to within ROUNDING.  The
    CPU's own run is set beside the card's, and where the two first pick
    apart is printed."""
    from dataclasses import replace
    from repro_torch.core import FederatedBoostEngine
    from repro_torch.models import weak
    sc = fleet_scenario(FLEET_LOCKSTEP_CLIENTS)
    data = sc.make_data(0)
    cfg = sc.fedboost_config(seed=0, n_rounds=FLEET_ROUNDS)
    base = weak.get_weak_learner("stump")
    for mode in ("baseline", "enhanced"):
        card = []

        def logged(x, y, w, thr):
            p = base.fit_batched(x, y, w, thr)
            card.append(tuple(host(a) for a in (x, y, w, thr))
                        + ({k: host(v) for k, v in p.items()},))
            return p

        def run(device, fit_batched):
            return FederatedBoostEngine(
                cfg, data, mode, behavior_for=sc.behavior_for("legacy", 0),
                fleet=True, weak=replace(base, fit_batched=fit_batched),
                device=device).run()
        m_card = run(CARD, logged)
        replay = iter(card)
        ties = [0]

        def lockstep(x, y, w, thr):
            gx, gy, gw, gthr, gp = next(replay)
            if not (torch.equal(x, gx) and torch.equal(y, gy)
                    and torch.equal(thr, gthr)):
                raise AssertionError(f"{mode}: a wave's shards or grids "
                                     f"differ from the card's")
            if not torch.allclose(w, gw, rtol=1e-4, atol=1e-9):
                raise AssertionError(f"{mode}: a wave's distributions "
                                     f"differ by {float((w - gw).abs().max())}")
            mine = base.fit_batched(gx, gy, gw, gthr)
            keys = ("feature", "threshold", "polarity")
            same = torch.ones(len(gx), dtype=torch.bool)
            for k in keys:
                same &= mine[k].to(gp[k].dtype) == gp[k]
            for j in torch.nonzero(~same)[:, 0].tolist():
                gap = _pick_gap(gx[j].numpy(), gy[j].numpy(), gw[j].numpy(),
                                gthr[j].numpy(),
                                [float(gp[k][j]) for k in keys],
                                [float(mine[k][j]) for k in keys])
                if abs(gap) > ROUNDING:
                    raise AssertionError(f"{mode}: card and cpu picks apart "
                                         f"by {gap} at slot {j}")
                ties[0] += 1
            return gp
        m_cpu = run("cpu", lockstep)
        if next(replay, None) is not None:
            raise AssertionError(f"{mode}: the cpu run made fewer waves")
        keys = INT_FIELDS + ("sim_time_s",)
        diff = {k: (getattr(m_card, k), getattr(m_cpu, k)) for k in keys
                if getattr(m_card, k) != getattr(m_cpu, k)}
        if diff:
            raise AssertionError(f"{mode}: card vs cpu counters {diff}")
        fits = sum(len(c[0]) for c in card)
        log(f"fleet 7.3 {mode} at {FLEET_LOCKSTEP_CLIENTS} clients: cpu "
            f"lockstep counters equal the card's "
            f"{ {k: getattr(m_card, k) for k in keys} }; {len(card)} waves, "
            f"{fits} fits, cpu pick == card pick at {fits - ties[0]} "
            f"(rounding ties {ties[0]}); test error card "
            f"{m_card.final_test_error:.4f} cpu {m_cpu.final_test_error:.4f}")
        own = []

        def cpu_own(x, y, w, thr):
            p = base.fit_batched(x, y, w, thr)
            own.append(p)
            return p
        run("cpu", cpu_own)
        split = None
        for i, ((gx, gy, gw, gthr, gp), o) in enumerate(zip(card, own)):
            keys = ("feature", "threshold", "polarity")
            if len(o["feature"]) != len(gx):
                split = (i, None, "all", float("nan"))   # other slots
                break
            apart = torch.zeros(len(gx), dtype=torch.bool)
            for k in keys:
                apart |= o[k].to(gp[k].dtype) != gp[k]
            if apart.any():
                j = int(torch.nonzero(apart)[0, 0])
                gap = _pick_gap(gx[j].numpy(), gy[j].numpy(), gw[j].numpy(),
                                gthr[j].numpy(),
                                [float(gp[k][j]) for k in keys],
                                [float(o[k][j]) for k in keys])
                split = (i, j, int(apart.sum()), gap)
                break
        log(f"fleet 7.3 {mode}: the cpu's own run "
            + ("picks as the card's at every wave" if split is None else
               f"first picks apart from the card's at wave {split[0]} "
               f"({split[2]} of its slots), first at slot {split[1]}: "
               f"exact gap {split[3]:.3g} on the card's inputs"))


# ------------------------------------------------------------ phase 8
GENERIC_ROUNDS = 25
GENERIC_PROFILE_ROUNDS = 5      # the profiled MLP run, cut from 25
REL = 1e-4      # a card fit against the cpu's, relative to the leaf's largest
GENERIC_TENANTS = ("edge_vision_logistic", "edge_vision_mlp")


def rel_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over a leaf, as a share of max |want|."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


class GenericFitLog:
    """The port's own logistic or MLP learner on the card, keeping each
    fit's inputs, the MLP's init (drawn again from a copy of the
    generator's state) and the fitted params where they lie, and the wall
    time of the fits and of the predicts, each closed by a synchronize so
    that the device work lands in its own share."""

    def __init__(self, name):
        from repro_torch.models.weak import WeakLearnerSpec, get_weak_learner
        self.name = name
        self.base = get_weak_learner(name)
        self.fits = []
        self.fit_s = self.predict_s = 0.0
        self.n_predicts = 0
        self.spec = WeakLearnerSpec(name, self.fit, self.predict,
                                    self.base.param_bytes)

    def fit(self, x, y, w, generator):
        from repro_torch.models.weak import init_mlp
        init = None
        if self.name == "mlp":
            copy = torch.Generator(device=generator.device)
            copy.set_state(generator.get_state())
            init = init_mlp(x.shape[1], copy)
        t0 = time.perf_counter()
        p = self.base.fit(x, y, w, generator)
        torch.cuda.synchronize()
        self.fit_s += time.perf_counter() - t0
        self.fits.append((x, y, w.clone(), init, p))
        return p

    def predict(self, p, x):
        t0 = time.perf_counter()
        out = self.base.predict(p, x)
        torch.cuda.synchronize()
        self.predict_s += time.perf_counter() - t0
        self.n_predicts += 1
        return out

    def on_cpu(self):
        shards = {}                      # one host copy per client shard
        host_ = lambda t: shards.setdefault(t.data_ptr(), t.cpu())  # noqa
        leaves = lambda p: None if p is None else {             # noqa
            k: v.cpu() for k, v in p.items()}
        return [(host_(x), host_(y), w.cpu(), leaves(init), leaves(p))
                for x, y, w, init, p in self.fits]


def generic_lockstep_on_cpu(cfg, data, mode, name, fits, label):
    """The same run on the CPU, handed the card's params at every fit.

    Each fit's inputs must be the card's (x and y equal, the distribution
    within 1e-4 relative), and the CPU's own fit on the card's inputs (the
    MLP from the card's init) must give the card's params within ``REL``,
    or the fit must be ill-conditioned: the CPU's f32 fit lies more than
    REL/10 from the same fit in f64, so that rounding alone moves it (when
    the distribution sits on a few samples, 50 or 80 steps amplify the last
    bits).  Returns the run's metrics, the largest relative difference of
    the held fits and the ill-conditioned fits."""
    from repro_torch.core import FederatedBoostEngine
    from repro_torch.models.weak import (WeakLearnerSpec, get_weak_learner,
                                         train_mlp)
    base = get_weak_learner(name)

    def own_fit(x, y, w, init, dtype=torch.float32):
        x, y, w = x.to(dtype), y.to(dtype), w.to(dtype)
        if name == "mlp":
            return train_mlp({k: v.to(dtype) for k, v in init.items()},
                             x, y, w)
        return base.fit(x, y, w, None)
    replay = iter(enumerate(fits))
    held, ill = [], []

    def fit(x, y, w, generator):
        i, (gx, gy, gw, ginit, gp) = next(replay)
        if not (torch.equal(x, gx) and torch.equal(y, gy)):
            raise AssertionError(f"{label}: fit #{i} is on another client "
                                 f"shard than the card's")
        if not torch.allclose(w, gw, rtol=1e-4, atol=1e-9):
            raise AssertionError(f"{label}: distribution at fit #{i} differs "
                                 f"by {float((w - gw).abs().max())}")
        mine = own_fit(gx, gy, gw, ginit)
        rel = max(rel_diff(mine[k], gp[k]) for k in gp)
        if rel <= REL:
            held.append(rel)
        else:
            exact = own_fit(gx, gy, gw, ginit, torch.float64)
            spread = max(rel_diff(mine[k], exact[k]) for k in mine)
            if not spread > REL / 10:
                raise AssertionError(f"{label}: fit #{i} card vs cpu {rel}, "
                                     f"cpu f32 vs f64 {spread}")
            ill.append((i, rel, spread))
        return gp
    spec = WeakLearnerSpec(name, fit, base.predict, base.param_bytes)
    m = FederatedBoostEngine(cfg, data, mode, weak=spec, device="cpu").run()
    if next(replay, None) is not None:
        raise AssertionError(f"{label}: the cpu run made fewer fits")
    return m, max(held, default=0.0), ill


def train_generic(registry, datas):
    """Phase 8.2: edge_vision at full size with the logistic and the MLP
    learner, both modes, 25 rounds each, on the card; the enhanced runs
    publish into the registry.  Each run is then repeated on the CPU in
    lockstep, handed the card's params at every fit; the CPU's own
    logistic run is set beside the card's."""
    from repro_torch.configs.paper_fedboost import FedBoostConfig
    from repro_torch.core import FederatedBoostEngine
    from repro_torch.sim.scenarios import DOMAINS
    dom = DOMAINS["edge_vision"]
    data = datas["edge_vision"]
    keys = INT_FIELDS + ("sim_time_s",)
    one = 1.0 / len(data["test"][1]) + 1e-6
    for name in ("logistic", "mlp"):
        for mode in ("baseline", "enhanced"):
            label = f"edge_vision {name} {mode}"
            cfg = FedBoostConfig(
                n_clients=dom.n_clients, n_rounds=GENERIC_ROUNDS, seed=0,
                weak_learner=name, straggler_factor=dom.straggler_factor,
                dropout_prob=dom.dropout_prob, link_mbps=dom.link_mbps)
            log_ = GenericFitLog(name)
            t0 = time.perf_counter()
            eng = FederatedBoostEngine(cfg, data, mode, weak=log_.spec,
                                       device=CARD)
            if mode == "enhanced":
                eng.attach_registry(registry, f"edge_vision_{name}")
            m = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            p = log_.fits[-1][4]
            if any(v.device.type != eng.device.type for v in p.values()):
                raise AssertionError(f"{label}: params are not on the card")
            for v in (m.final_val_error, m.final_test_error, m.sim_time_s):
                if not math.isfinite(v):
                    raise AssertionError(f"non-finite metric in {label}")
            if not m.final_val_error < 0.35:
                raise AssertionError(f"{label} did not learn")
            log(f"train {label} {GENERIC_ROUNDS} rounds on {CARD}: "
                f"bytes={m.total_bytes} msgs={m.n_messages} "
                f"syncs={m.n_syncs} merged={m.learners_merged} "
                f"published={m.snapshots_published} "
                f"sim_time_s={m.sim_time_s!r} "
                f"val_err={m.final_val_error:.4f} "
                f"test_err={m.final_test_error:.4f} wall_s={wall:.2f} "
                f"(fits {log_.fit_s:.2f} s for {len(log_.fits)}, predicts "
                f"{log_.predict_s:.2f} s for {log_.n_predicts}, rest "
                f"{wall - log_.fit_s - log_.predict_s:.2f} s)")
            t0 = time.perf_counter()
            m_cpu, worst, ill = generic_lockstep_on_cpu(
                cfg, data, mode, name, log_.on_cpu(), label)
            diff = {k: (getattr(m, k), getattr(m_cpu, k)) for k in keys
                    if getattr(m, k) != getattr(m_cpu, k)}
            if diff:
                raise AssertionError(f"{label}: cuda vs cpu counters {diff}")
            d_err = max(abs(m.final_test_error - m_cpu.final_test_error),
                        abs(m.final_val_error - m_cpu.final_val_error))
            log(f"train check {label}: cpu lockstep counters equal the "
                f"card's ({time.perf_counter() - t0:.1f} s); cpu fit on the "
                f"card's inputs within {REL} at "
                f"{len(log_.fits) - len(ill)} of {len(log_.fits)} fits "
                f"(largest {worst:.3g}); ill-conditioned {len(ill)}: "
                + (", ".join(f"#{i} {r:.3g} (cpu f32 vs f64 {s:.3g})"
                             for i, r, s in ill[:8]) or "none")
                + ("" if len(ill) <= 8 else f" and {len(ill) - 8} more")
                + f"; test error cuda {m.final_test_error:.4f} cpu "
                f"{m_cpu.final_test_error:.4f}")
            if d_err > one:
                raise AssertionError(f"{label}: cuda vs cpu errors differ by "
                                     f"{d_err}")
            if name == "logistic":
                own = FederatedBoostEngine(cfg, data, mode,
                                           device="cpu").run()
                odiff = {k: (getattr(m, k), getattr(own, k)) for k in keys
                         if getattr(m, k) != getattr(own, k)}
                log(f"train check {label}: the cpu's own run "
                    + ("gives the card's counters" if not odiff else
                       f"splits from the card's: card vs cpu {odiff}")
                    + f"; test error {own.final_test_error:.4f}")


def serve_generic(registry, datas):
    """Phase 8.3: 2048 requests (25% repeats) from the logistic and the MLP
    tenant's test set through ``EnsembleServer`` on the card, then the same
    batches through the CPU plain path.  Returns the number of generic
    batches the card's evaluator launched."""
    from repro_torch.kernels import ops
    from repro_torch.serve import (BatchConfig, BatchEvaluator,
                                   EnsembleServer, ResultCache)
    registry.rebase_clock(0.0)
    server = EnsembleServer(registry, BatchConfig(max_batch=64,
                                                  cache_capacity=4096),
                            device=CARD)
    ev = server.evaluator
    batches = []
    timed = {"eval": 0.0, "vote": 0.0}
    evaluate, eval_generic = ev.evaluate, ev._eval_generic
    vote = ops.ensemble_vote_batched

    def recording(batch):
        out = evaluate(batch)
        batches.append((list(batch), out))
        return out

    def timed_generic(group, margins):
        t0 = time.perf_counter()
        eval_generic(group, margins)
        timed["eval"] += time.perf_counter() - t0

    def timed_vote(m, a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = vote(m, a)
        torch.cuda.synchronize()
        timed["vote"] += time.perf_counter() - t0
        return out
    ev.evaluate, ev._eval_generic = recording, timed_generic
    ops.ensemble_vote_batched = timed_vote
    try:
        xt, yt = datas["edge_vision"]["test"]
        rng = np.random.RandomState(2)
        sent = []
        for i in range(2048):
            if sent and rng.rand() < 0.25:
                sent.append(sent[rng.randint(len(sent))])
            else:
                sent.append((GENERIC_TENANTS[rng.randint(2)], i % len(yt)))
        responses = []
        t0 = time.perf_counter()
        for tenant, row in sent:
            accepted, done = server.submit(tenant, xt[row],
                                           now=time.perf_counter() - t0)
            if not accepted:
                raise AssertionError("request rejected")
            responses += done
        responses += server.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ops.ensemble_vote_batched = vote
        server.close()
    if len(responses) != len(sent):
        raise AssertionError(f"{len(responses)} responses for {len(sent)}")
    correct = 0
    for r in responses:
        if r.snapshot_version == 0 or not math.isfinite(r.margin):
            raise AssertionError(f"bad response {r}")
        correct += r.label == yt[sent[r.rid][1]]
    rep = server.metrics.report()
    log(f"serve generic: {len(responses)} requests in {rep['n_batches']} "
        f"batches, accuracy={correct / len(responses):.4f} "
        f"p50_ms={rep['p50_ms']:.3f} p99_ms={rep['p99_ms']:.3f} "
        f"wall_s={wall:.3f} generic_launches={ev.kernel_launches} "
        f"host_hashes={ev.host_hash_calls} "
        f"cache_hits={server.cache.stats.hits}; generic evaluation "
        f"{timed['eval']:.3f} s of it, the vote kernel (synchronized) "
        f"{timed['vote']:.4f} s, the predicts and packing the rest")
    cpu = BatchEvaluator(registry, cache=ResultCache(4096), device="cpu")
    mismatch = far = 0
    worst = 0.0
    for batch, out in batches:
        for g, c in zip(out, cpu.evaluate(batch)):
            worst = max(worst, abs(g.margin - c.margin))
            far += abs(g.margin - c.margin) > TOL + TOL * abs(c.margin)
            mismatch += abs(c.margin) > 1e-5 and g.label != c.label
    log(f"serve generic check: cpu plain path on the same {len(batches)} "
        f"batches: label mismatches={int(mismatch)} max |margin diff|="
        f"{worst:.3g} cpu launches={cpu.kernel_launches}")
    if mismatch or far:
        raise AssertionError(f"generic serve: {int(mismatch)} labels and "
                             f"{far} margins differ from the cpu (max "
                             f"{worst})")
    if cpu.kernel_launches != ev.kernel_launches or ev.kernel_launches < 1:
        raise AssertionError(f"generic batches cuda {ev.kernel_launches} "
                             f"cpu {cpu.kernel_launches}")
    return ev.kernel_launches


# ------------------------------------------------------------ phase 9
def kernel_api_path():
    """Phase 9: ``ensemble_vote`` and ``dist_update``, which the system
    itself never calls, through ``repro_torch.kernels.ops`` as
    ``benchmarks/kernel_bench.py`` calls the JAX package's, each held to
    its plain version on the card."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=CARD).manual_seed(4)
    N = 8192
    D = torch.softmax(torch.randn((N,), generator=gen, device=CARD), 0)
    y = torch.sign(torch.randn((N,), generator=gen, device=CARD))
    h = torch.sign(torch.randn((N,), generator=gen, device=CARD))
    got, z = ops.dist_update(0.7, D, y, h)
    want, wz = ref.dist_update_ref(0.7, D, y, h)
    m = torch.sign(torch.randn((256, N), generator=gen, device=CARD))
    a = torch.randn((256,), generator=gen, device=CARD)
    hm = ops.ensemble_vote(m, a)
    torch.cuda.synchronize()
    if not (float((got - want).abs().max()) <= 1e-6
            and float((z - wz).abs() / wz) <= 1e-6
            and close(hm, ref.ensemble_vote_ref(m, a), a.abs().sum())):
        raise AssertionError("kernel API path: a kernel disagrees with its "
                             "plain version")
    log(f"kernel API path: dist_update N={N} Z={float(z)!r} and "
        f"ensemble_vote {tuple(m.shape)} match their plain versions")


# ------------------------------------------------------------ phase 10
LM_ARCH = "qwen1.5-0.5b"        # repro.launch.serve's default --arch
LM_BATCH, LM_PROMPT, LM_NEW = 4, 512, 32
# card against the CPU replay, as a share of the largest |logit|: the
# prefill differs in the order of f32 sums only (cuBLAS and the kernel
# against the CPU's), decode also where a cached key or value rounds to the
# other bf16 neighbour (tests/test_torch_lm.py holds the port to the
# reference at 2e-4 on 2 layers; 24 layers amplify it)
LM_PREFILL_REL = 1e-4
LM_DECODE_REL = 1e-3


def lm_serve():
    """Phase 10: qwen1.5-0.5b at full width through the port's
    ``generate`` on the card, counts zeroed just before and read just after;
    then prefill and generate timed, and one generate traced for the card's
    busy share; then the same params on the CPU replay the prefill and
    every decode step, fed the card's tokens.  Returns the launches of the
    counted run."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import Model
    smi = nvidia_smi()
    cfg = get_arch(LM_ARCH)
    model = Model(cfg, device=CARD)
    params = model.init(torch.Generator(CARD).manual_seed(0))
    n_params = sum(t.numel() for t in params.parameters())
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=torch.Generator(CARD).manual_seed(1),
                            device=CARD, dtype=torch.int32)
    S = LM_PROMPT + LM_NEW
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    ops.reset_launches()
    t0 = time.perf_counter()
    seqs = generate(model, params, prompts, LM_NEW, cache_len=S,
                    step_logits=steps)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"LM serve {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size} (padded {cfg.padded_vocab}), "
        f"{n_params:,} params f32; launches {launches} | {smi}")
    if launches["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times in one "
                             f"prefill of {cfg.n_layers} layers")
    if seqs.shape != (LM_BATCH, S) or not all(
            torch.isfinite(x).all() for x in steps) or \
            len(steps) != LM_NEW + 1:
        raise AssertionError("LM serve: wrong shape or non-finite logits")

    with torch.no_grad():
        prefill_ms = cuda_ms(lambda: model.prefill(
            params, {"tokens": prompts}, cache_seq=S), 5)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        generate(model, params, prompts, LM_NEW, cache_len=S)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    gen_s = statistics.median(walls)
    decode_ms = (1e3 * gen_s - prefill_ms) / LM_NEW
    log(f"LM serve {cfg.name} B={LM_BATCH} prompt={LM_PROMPT} "
        f"new={LM_NEW}: prefill_ms={prefill_ms:.3f} "
        f"decode_ms_per_token={decode_ms:.3f} generate_s={gen_s:.4f} "
        f"(first {first_s:.3f}) tokens_per_s={LM_BATCH * LM_NEW / gen_s:.1f} "
        f"peak_mem_gb={peak / 1e9:.3f} | {smi}")

    with cuda_profile() as prof:
        t0 = time.perf_counter()
        generate(model, params, prompts, LM_NEW, cache_len=S)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = device_us_by_name(prof)
    busy_ms = sum(by_name.values()) / 1e3
    n_kernels = sum(evt.device_type == torch.autograd.DeviceType.CUDA
                    for evt in prof.events())
    log(f"profile LM generate: wall_ms={wall_ms:.1f} device_busy_ms="
        f"{busy_ms:.2f} idle_share={1 - busy_ms / wall_ms:.4f} "
        f"device_ops={n_kernels} (one prefill, {LM_NEW} decode steps) "
        f"| {smi}")
    for key, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"profile LM generate:   {us / 1e3:9.3f} ms  {key}")

    # the CPU replay, in lockstep: fed the card's tokens
    t0 = time.perf_counter()
    cpu = Model(cfg, device="cpu")
    cpu_params = cpu.init()
    cpu_params.load_state_dict(params.state_dict())
    seqs = seqs.cpu()
    rels, scales, compared, skipped = [], [], 0, 0
    with torch.no_grad():
        logits, caches = cpu.prefill(cpu_params, {"tokens": prompts.cpu()},
                                     cache_seq=S)
        for i in range(LM_NEW + 1):
            card = steps[i].cpu()
            scale = float(logits.abs().max())
            rel = float((card - logits).abs().max()) / scale
            rels.append(rel)
            scales.append(scale)
            if rel > (LM_PREFILL_REL if i == 0 else LM_DECODE_REL):
                raise AssertionError(f"LM step {i}: card logits {rel:.3g} of "
                                     f"the largest |logit| from the CPU's")
            if i == LM_NEW:
                break
            tok = seqs[:, LM_PROMPT + i]
            top2 = torch.topk(logits, 2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > LM_DECODE_REL * scale
            mine = torch.clamp(logits.argmax(-1), max=cfg.vocab_size - 1)
            if not torch.equal(mine[sure], tok[sure].long()):
                raise AssertionError(f"LM step {i}: greedy tokens differ "
                                     f"where the top-two gap is clear")
            compared += int(sure.sum())
            skipped += int((~sure).sum())
            logits, caches = cpu.decode_step(cpu_params, tok[:, None],
                                             caches, LM_PROMPT + i)
    log(f"LM lockstep on the CPU ({time.perf_counter() - t0:.1f} s): "
        f"prefill logits within {rels[0]:.3g} of the largest |logit| "
        f"(tol {LM_PREFILL_REL}), decode within {max(rels[1:]):.3g} "
        f"(tol {LM_DECODE_REL}), largest |logit| {min(scales):.4g}.."
        f"{max(scales):.4g}; greedy tokens equal at {compared} of "
        f"{compared + skipped} picks ({skipped} near-ties not compared) "
        f"| {smi}")
    del params, cpu_params
    return launches


# ------------------------------------------------------------ phase 11
REPLAY_SCENARIO, REPLAY_TRACE = "iot", "gilbert"
# The JAX package's run of step 1's call (the registered iot domain, 4,000
# samples x 24 features, 24 clients, 20 rounds, 2 hosts, 1.5 s, autoscale
# on), on a CPU:
#   PYTHONPATH=src python -c "from repro.sim.harness import run_scenario;
#   print(run_scenario('iot', trace='gilbert', seed=0).serve)"
# Every field but snapshot_version and killed_host is a function of the
# behavior models (seed + 101), the request RNG (seed * 31 + 7) and the
# analytic service model alone, not of the trained stumps: the card's
# replay must give it, integers exactly and floats to REPLAY_REL (Python
# arithmetic on the same modeled times).
REPLAY_REFERENCE = {
    "offered": 784, "offline_suppressed": 120, "completed": 784,
    "rejected": 0, "p50_ms": 2.5999999999999357, "p99_ms": 4.400000000000001,
    "throughput_rps": 521.5572983944247, "mean_batch": 1.5870445344129556,
    "cache_hit_rate": 0.4489795918367347, "hosts_final": 2, "scale_outs": 0,
    "scale_ins": 0, "rerouted": 0,
    "slo": {"good": 784, "bad": 0, "budget_remaining": 1.0,
            "alerts_fired": 0, "alerts_active": 0}}
REPLAY_REL = 1e-9
CHURN_TENANTS = tuple(f"t{i}" for i in range(6))
# The JAX package's runs of churn_runs' traffic, on a CPU:
#   PYTHONPATH=src python -c "import chip_smoke, repro.serve;
#   print(chip_smoke.churn_runs(repro.serve))"
CHURN_REFERENCE = {
    "pressure": dict(
        accepted=191, completed=191, hosts=1, scale_outs=2, scale_ins=2,
        rerouted=0, events=[[0.020500000000000015, "out", "scale-0", 2],
                            [0.030500000000000024, "out", "scale-1", 3],
                            [0.19000000000000009, "in", "host-0", 2],
                            [0.21000000000000008, "in", "scale-0", 1]],
        responses="d3a2774b0e0e13aeee8f4b1d6e5105f7"),
    "churn": dict(
        accepted=505, completed=505, hosts=2, scale_outs=8, scale_ins=8,
        rerouted=0, events=[[0.020800000000000003, "out", "scale-0", 3],
                            [0.03080000000000003, "out", "scale-1", 4],
                            [0.09999999999999987, "in", "host-0", 3],
                            [0.11999999999999987, "in", "host-1", 2],
                            [1.2703999999999995, "out", "scale-2", 3],
                            [1.2807999999999984, "out", "scale-3", 4],
                            [1.359999999999994, "in", "scale-0", 3],
                            [1.3799999999999941, "in", "scale-1", 2],
                            [2.530399999999994, "out", "scale-4", 3],
                            [2.540799999999993, "out", "scale-5", 4],
                            [2.6199999999999886, "in", "scale-2", 3],
                            [2.6399999999999886, "in", "scale-3", 2],
                            [3.7903999999999884, "out", "scale-6", 3],
                            [3.8007999999999873, "out", "scale-7", 4],
                            [3.879999999999983, "in", "scale-4", 3],
                            [3.899999999999983, "in", "scale-5", 2]],
        responses="de355421542a073a4d6fe6be87c42916"),
}


def replay_equal(got: dict, want: dict, label: str) -> None:
    """``got`` holds every field of ``want`` (nested dicts too): integers
    and strings exactly, floats to ``REPLAY_REL`` relative."""
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            replay_equal(g, w, f"{label}.{k}")
        elif isinstance(w, float):
            if not math.isclose(g, w, rel_tol=REPLAY_REL, abs_tol=0.0):
                raise AssertionError(f"{label}.{k}: {g!r} != {w!r}")
        elif g != w:
            raise AssertionError(f"{label}.{k}: {g!r} != {w!r}")


def churn_cluster(serve, n_hosts: int):
    """The JAX package's ``tests/test_autoscale.py`` ``_cluster``: six
    tenants' synthetic packed stumps (4 each over 6 features), gossiped."""
    cluster = serve.ShardCluster(n_hosts, serve.GossipConfig(seed=0))
    for i, tenant in enumerate(CHURN_TENANTS):
        rng = np.random.RandomState(i)
        p = np.zeros((4, 4), np.float32)
        p[:, 0] = rng.randint(0, 6, size=4)
        p[:, 1] = rng.randn(4)
        p[:, 2] = np.where(rng.rand(4) > 0.5, 1.0, -1.0)
        a = (rng.rand(4) + 0.1).astype(np.float32)
        cluster.publish_packed(tenant, p, a, clock=0.0)
    cluster.run_until_quiescent()
    return cluster


def churn_runs(serve, **server_kw) -> dict:
    """The traffic of the JAX package's ``tests/test_autoscale.py``
    ``test_autoscaler_scales_out_under_pressure_and_back_in_when_idle``
    ("pressure") and
    ``test_two_host_autoscaled_fleet_membership_churn_is_loss_free``
    ("churn"), with their stumps and service models, through ``serve``'s
    ``ShardedEnsembleServer`` and ``FleetAutoscaler`` (``serve`` is
    ``repro_torch.serve``, ``server_kw`` its ``device=``; or the JAX
    package's serving module, to record the reference).  Returns each
    run's autoscaler counters, events, and a digest of every response's
    (rid, tenant, version) in answer order; raises if a request is lost."""
    batch = serve.BatchConfig(queue_budget=16, max_batch=4, adaptive=False,
                              fixed_window_units=1)
    out = {}
    for label, hosts, model, scale_kw, seed in (
            ("pressure", 1, 5e-3, dict(min_hosts=1, max_hosts=3), 0),
            ("churn", 2, 4e-3, dict(min_hosts=2, max_hosts=4), 7)):
        cluster = churn_cluster(serve, hosts)
        server = serve.ShardedEnsembleServer(
            cluster, batch, service_model=lambda n, s=model: s, **server_kw)
        scaler = serve.FleetAutoscaler(server, serve.AutoscaleConfig(
            target_queue=2.0, adapt_every_s=0.01, step_down=1.0,
            **scale_kw))
        rng = np.random.RandomState(seed)
        responses, accepted, t = [], 0, 0.0

        def load(n, dt, pick):
            nonlocal accepted, t
            for i in range(n):
                t += dt
                ok, done = server.submit(
                    CHURN_TENANTS[pick(i)], rng.randn(6).astype(np.float32),
                    t)
                accepted += ok
                responses.extend(done)
                responses.extend(scaler.step(t))

        def idle(n):
            nonlocal t
            for _ in range(n):
                t += 0.02
                responses.extend(server.advance(t))
                responses.extend(scaler.step(t))
        if label == "pressure":         # sustained overload, then idle
            load(300, 5e-4, lambda i: i % len(CHURN_TENANTS))
            idle(200)
        else:                           # on/off phases force churn
            for _ in range(4):
                load(150, 4e-4, lambda i: rng.randint(len(CHURN_TENANTS)))
                idle(60)
        responses.extend(server.drain())
        rids = [r.rid for r in responses]
        if len(rids) != accepted or len(set(rids)) != accepted:
            raise AssertionError(f"churn {label}: {accepted} accepted, "
                                 f"{len(rids)} answered, {len(set(rids))} "
                                 "unique")
        seq = [(r.rid, r.tenant, int(r.snapshot_version)) for r in responses]
        st = scaler.stats
        out[label] = dict(
            accepted=accepted, completed=server.report()["completed"],
            hosts=len(server.servers), scale_outs=st.scale_outs,
            scale_ins=st.scale_ins, rerouted=st.rerouted,
            events=[list(e) for e in st.events],
            responses=hashlib.blake2b(repr(seq).encode(),
                                      digest_size=16).hexdigest())
    return out


def replay_copy(windows, rng_state, cfg, **server_kw):
    """A fleet over a copy of step 1's trained cluster, prepared as
    ``replay_serve`` prepares it (gossip to quiescence, clocks rebased)."""
    from repro_torch.convert import shard_cluster_from_numpy
    from repro_torch.serve import ShardedEnsembleServer
    from repro_torch.sim import harness
    cluster = shard_cluster_from_numpy(windows, cfg, rng_state=rng_state)
    cluster.run_until_quiescent()
    cluster.rebase_clock(0.0)
    return ShardedEnsembleServer(cluster, harness.SERVE_BATCH, **server_kw)


def serve_fleet() -> dict:
    """Phase 11: serving at scale on the card.  (1) ``run_scenario`` on
    iot/gilbert at its registered size and default replay, held to the
    JAX package's report; (2) the same arrivals through two fleets over
    copies of the trained cluster, the card's and the CPU's plain path;
    (3) the arrivals again on the card under the wall clock; (4) the JAX
    package's autoscale churn traffic on the card, held to its recorded
    run; (5) the enhanced run again with tracing on and an audit attached,
    bit-equal to step 1's.  Returns step 1's launch counts."""
    from repro_torch import obs, serve
    from repro_torch.convert import cluster_windows
    from repro_torch.core import FederatedBoostEngine
    from repro_torch.kernels import ops
    from repro_torch.sim import harness
    from repro_torch.sim.scenarios import get_scenario

    sc = get_scenario(REPLAY_SCENARIO)
    seed, duration = 0, 1.5
    captured, engines = {}, []
    real_replay = harness.replay_serve

    def recording_replay(sc_, cluster, data, trace, **kw):
        captured.update(windows=cluster_windows(cluster), data=data,
                        rng_state=cluster._rng.getstate(),
                        cfg=cluster.cfg)
        return real_replay(sc_, cluster, data, trace, **kw)

    class RecordingEngine(FederatedBoostEngine):
        def run(self):
            m = super().run()
            engines.append(self)
            return m

    t0 = time.perf_counter()
    harness.replay_serve = recording_replay
    harness.FederatedBoostEngine = RecordingEngine
    try:
        rep = harness.run_scenario(REPLAY_SCENARIO, trace=REPLAY_TRACE,
                                   seed=seed, device=CARD)
    finally:
        harness.replay_serve = real_replay
        harness.FederatedBoostEngine = FederatedBoostEngine
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    s = rep.serve
    log(f"replay 11.1: run_scenario {REPLAY_SCENARIO} {REPLAY_TRACE} seed "
        f"{seed} on {CARD} ({sc.domain.n_samples}x{sc.domain.n_features}, "
        f"{sc.domain.n_clients} clients, {sc.n_rounds} rounds): "
        f"{wall:.2f} s with data; launches {launches}")
    for line in harness.summarize(rep).splitlines():
        log(f"replay 11.1: {line}")
    log(f"replay 11.1: serve {json.dumps(s)}")
    replay_equal(s, REPLAY_REFERENCE, "replay 11.1")
    if s["snapshot_version"] != rep.enhanced.snapshots_published or \
            s["snapshot_version"] < 1:
        raise AssertionError(f"served snapshot v{s['snapshot_version']}, "
                             f"{rep.enhanced.snapshots_published} published")
    for name in ("stump_scan", "stump_vote_batched"):
        if launches[name] <= 0:
            raise AssertionError(f"replay: kernel {name} never launched")
    log("replay 11.1: every field equals the JAX package's report; snapshot "
        f"v{s['snapshot_version']} = the enhanced run's publishes; zero "
        "loss held")

    # (2) the same arrivals through a card fleet and a CPU fleet
    t0 = time.perf_counter()
    arrivals, offline = harness._serve_arrivals(
        sc, captured["data"], REPLAY_TRACE, seed, duration)
    answers = {}
    for dev in (CARD, "cpu"):
        server = replay_copy(captured["windows"], captured["rng_state"],
                             captured["cfg"], device=dev,
                             service_model=harness._service_model)
        summary, responses = harness._replay(sc, server, arrivals, offline,
                                             duration, True)
        replay_equal(summary, s, f"replay 11.2 {dev}")
        answers[dev] = responses
    card, cpu = answers[CARD], answers["cpu"]
    if [(r.rid, r.tenant, r.snapshot_version) for r in card] != \
            [(r.rid, r.tenant, r.snapshot_version) for r in cpu]:
        raise AssertionError("replay 11.2: card and cpu responses differ")
    worst = max(abs(g.margin - c.margin) for g, c in zip(card, cpu))
    far = sum(abs(g.margin - c.margin) > TOL + TOL * abs(c.margin)
              for g, c in zip(card, cpu))
    log(f"replay 11.2: {len(arrivals)} arrivals through two fleets over "
        f"copies of the trained cluster: {len(card)} responses, rid/tenant/"
        f"version equal, max |margin diff| card vs cpu {worst:.3g}; both "
        f"reports equal step 1's ({time.perf_counter() - t0:.2f} s)")
    if far:
        raise AssertionError(f"replay 11.2: {far} margins differ beyond "
                             f"rtol/atol {TOL} (max {worst})")

    # (3) the card's own latency: the wall-clock service time
    server = replay_copy(captured["windows"], captured["rng_state"],
                         captured["cfg"], device=CARD)
    shapes, restore = recording_stump_shapes()
    try:
        t0 = time.perf_counter()
        summary, responses = harness._replay(sc, server, arrivals, offline,
                                             duration, True)
        torch.cuda.synchronize()
        wall_replay = time.perf_counter() - t0
    finally:
        restore()
    counts = shapes["stump_vote_batched"]
    (B, T, N), n = counts.most_common(1)[0]
    gen = torch.Generator(device=CARD).manual_seed(11)
    args = vote_inputs(gen, B, T, N, 0)
    event_ms = cuda_ms(lambda: ops.stump_vote_batched(*args), 50)
    log(f"replay 11.3: wall-clock service on {CARD}: p50_ms="
        f"{summary['p50_ms']:.4f} p99_ms={summary['p99_ms']:.4f} "
        f"throughput_rps={summary['throughput_rps']:.1f} "
        f"mean_batch={summary['mean_batch']:.4f} replay wall_s="
        f"{wall_replay:.3f} for {len(responses)} responses; "
        f"stump_vote_batched launch shapes " + ", ".join(
            f"{shape} x{k}" for shape, k in counts.most_common())
        + f"; event ms at {(B, T, N)}: {event_ms:.4f} | {nvidia_smi()}")

    # (4) membership churn on the card
    t0 = time.perf_counter()
    churn = churn_runs(serve, device=CARD)
    for label, got in churn.items():
        log(f"replay 11.4 {label}: {json.dumps(got)}")
        want = CHURN_REFERENCE[label]
        diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        if diff:
            raise AssertionError(f"churn {label} differs from the JAX "
                                 f"package's run: {diff}")
    log(f"replay 11.4: both churn runs equal the JAX package's (counters, "
        f"events, every response's rid, tenant and version) and lost "
        f"nothing ({time.perf_counter() - t0:.2f} s)")

    # (5) audits on the card: measurement only
    t0 = time.perf_counter()
    plain = engines[1]
    data = captured["data"]
    eng = FederatedBoostEngine(sc.fedboost_config(seed=seed), data,
                               "enhanced",
                               behavior_for=sc.behavior_for(REPLAY_TRACE,
                                                            seed),
                               fleet=sc.fleet, device=CARD)
    cluster = serve.ShardCluster(len(captured["windows"]),
                                 serve.GossipConfig(seed=seed))
    eng.attach_registry(cluster, sc.name, publish_every=2)
    with obs.tracing():
        audit = eng.attach_audit()
        m = eng.run()
    torch.cuda.synchronize()
    want_m = rep.enhanced
    keys = ("uplink_bytes", "downlink_bytes", "n_messages", "n_syncs",
            "learners_merged", "snapshots_published", "rounds_unavailable",
            "sim_time_s", "final_val_error", "final_test_error")
    diff = {k: (getattr(m, k), getattr(want_m, k)) for k in keys
            if getattr(m, k) != getattr(want_m, k)}
    if list(eng.ensemble.alphas) != list(plain.ensemble.alphas):
        diff["alphas"] = "differ"
    fps = {hid: [w["fingerprint"] for w in win]
           for hid, win in cluster_windows(cluster).items()}
    if fps != {hid: [w["fingerprint"] for w in win]
               for hid, win in captured["windows"].items()}:
        diff["fingerprints"] = "differ"
    if diff or audit.recorded != m.learners_merged:
        raise AssertionError(f"audited run differs from step 1's: {diff}; "
                             f"{audit.recorded} audited merges")
    log(f"replay 11.5: audited enhanced run on {CARD} bit-equal to step 1's "
        f"(counters, {len(plain.ensemble.alphas)} alphas, test error "
        f"{m.final_test_error!r}, {sum(map(len, fps.values()))} snapshot "
        f"fingerprints); {audit.recorded} merges audited, "
        f"{len(audit.flags())} flags ({time.perf_counter() - t0:.2f} s)")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    from repro_torch import obs
    from repro_torch.kernels import build, ops
    from repro_torch.serve import EnsembleRegistry

    smi = nvidia_smi()
    log(f"device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.load()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    entry = ""
    for line in build.ptxas_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "registers" in line or "spill" in line:
            spills = "spill" in line and " 0 bytes spill stores" not in line
            log(f"  ptxas: {line.strip()}"
                + (f" in {entry}" if spills else ""))

    kernel_results = check_kernels()
    kernel_results.update(check_generic_kernels())
    kernel_results["stump_scan_batched"] = check_scan_batched()
    kernel_results["flash_attention"] = check_flash_attention()

    obs.set_registry(obs.MetricsRegistry())
    registry = EnsembleRegistry()
    ops.reset_launches()
    datas, fits = train(registry)
    stump_shapes = serve(registry, datas)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    log(f"launches on the main path: {launches}; fits={fits}")
    if fits <= 0 or launches["stump_scan"] != fits:
        raise AssertionError(f"stump_scan launches {launches['stump_scan']} "
                             f"!= fits {fits}")
    for name in ("stump_scan", "stump_vote_batched", "stump_vote_fp_batched"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched")
    for name, counts in stump_shapes.items():
        if sum(counts.values()) != launches[name]:
            raise AssertionError(f"{name}: {sum(counts.values())} shapes "
                                 f"recorded for {launches[name]} launches")
    for name, r in check_stump_path_shape(stump_shapes).items():
        kernel_results[name]["path"] = r
    profile_main_path(registry, datas)

    # the fleet path: counts zeroed just before it and read just after
    ops.reset_launches()
    fleet_launches, fleet_runs = fleet_full_width()
    log(f"launches on the fleet path: {fleet_launches}")
    waves = sum(r["fit_batches"] for r in fleet_runs.values())
    if fleet_launches["stump_scan_batched"] != waves or waves < 1:
        raise AssertionError(f"stump_scan_batched launches "
                             f"{fleet_launches['stump_scan_batched']} != "
                             f"waves {waves}")
    launches["stump_scan_batched"] = fleet_launches["stump_scan_batched"]
    fleet_lockstep()

    # the generic-learner path: counts zeroed just before it, read just after
    ops.reset_launches()
    train_generic(registry, datas)
    generic_batches = serve_generic(registry, datas)
    torch.cuda.synchronize()
    generic_launches = dict(ops.LAUNCHES)
    log(f"launches on the generic path: {generic_launches}; "
        f"generic batches={generic_batches}")
    if generic_launches["ensemble_vote_batched"] != generic_batches:
        raise AssertionError(f"ensemble_vote_batched launches "
                             f"{generic_launches['ensemble_vote_batched']} "
                             f"!= generic batches {generic_batches}")
    launches["ensemble_vote_batched"] = generic_batches
    profile_main_path(registry, datas, "mlp", "edge_vision_mlp",
                      "profile generic", rounds=GENERIC_PROFILE_ROUNDS)

    # the kernel API path: counts zeroed just before it, read just after
    ops.reset_launches()
    kernel_api_path()
    torch.cuda.synchronize()
    api_launches = dict(ops.LAUNCHES)
    log(f"launches on the kernel API path: {api_launches}")
    for name in ("ensemble_vote", "dist_update"):
        if api_launches[name] != 1:
            raise AssertionError(f"kernel {name} launched "
                                 f"{api_launches[name]} times, not once")
        launches[name] = api_launches[name]

    # the LM serve path: counts zeroed just before it, read just after
    lm_launches = lm_serve()
    log(f"launches on the LM serve path: {lm_launches}")
    launches["flash_attention"] = lm_launches["flash_attention"]

    # the serving-at-scale path: counts zeroed just before phase 11, read
    # after its step 1 (the replay through run_scenario) and after it ends
    t0 = time.perf_counter()
    ops.reset_launches()
    replay_launches = serve_fleet()
    torch.cuda.synchronize()
    log(f"launches on the replay path (step 1): {replay_launches}; in all "
        f"of phase 11: {dict(ops.LAUNCHES)}; phase 11 took "
        f"{time.perf_counter() - t0:.1f} s")

    kernels = []
    MAIN_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "kernel_ms", "shape")
    for name, (source, replaces) in KERNEL_INFO.items():
        main_r = kernel_results[name]["main"]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=main_r["max_abs_err"],
            ms=main_r["ms"], plain_ms=main_r["plain_ms"],
            bound_ms=main_r["bound_ms"], bound_by=main_r["bound_by"],
            library_ms=main_r["library_ms"], kernel_ms=main_r["kernel_ms"],
            shape=main_r["shape"],
            **({"replay_launches": replay_launches[name]}
               if name in ("stump_scan", "stump_vote_batched") else {}),
            **{k: v for k, v in main_r.items() if k not in MAIN_KEYS},
            **{label: r for label, r in kernel_results[name].items()
               if label != "main"}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
