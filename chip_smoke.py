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
   to the plain version's, each launcher variant (one launch knob of
   ``stump_vote.cu``'s launchers fixed, ``STUMP_VARIANTS``) timed
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
   card, on the scenario's first fit wave, on a large-shard batch (both
   on the one-thread-a-row route) and at ``fed_mesh``'s ten covtype
   shards (the split route, also against its order's emulation), bit for
   bit on each route (the row route's 16-byte and 4-byte loads, the
   split), each timed, with the FP64 pipe's floor;
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
   audit attached, bit-equal to the first;
12. the server-less FLchain mode: blockchain_flchain/block_delay at its
   registered size (5,000 x 32, 8 clients, 20 rounds) through
   ``run_scenario`` on the card, the enhanced run committing its deltas to
   a chain of record that a 2-host chain-backed fleet folds, the replay
   (1.5 s, autoscaled) killing the committee leader at the middle
   arrival: the report equal to the JAX package's recorded run but for
   the version (the tenant's confirmed folds) and the killed host (the
   leader at the kill), held to the card's own chain, with the training
   counters and the CPU's own run's first split printed; the chain's
   guarantees (hash links, re-minting, every host folding the committer's
   fingerprint, a host added after the kill folding it from the chain
   alone, no accepted request lost); the chain carried to the CPU
   (``convert.chain_from_numpy``), re-minted from genesis and replayed on
   the plain path (rid, tenant and version equal, margins within rtol/atol
   1e-5); the enhanced run traced, clean under the port's
   ``obs_report.check_trace``, its commits stitched to ``chain.aggregate``
   on two nodes or more and its hashes the untraced run's; and
   edge_vision enhanced with eq. 1 and the two beyond-paper interval
   controllers, every interval within [i_min, i_max];
13. the policy-driven serving launcher: ``KernelPolicy.calibrate_call``
   on the card (``torch`` once, ``cuda`` over its launch grid, medians
   by backend and layout) at each tenant's first fit (edge_vision,
   iot) and at phase 5's commonest stump vote shapes, each call held cuda
   against torch (the scan bit-equal, the votes within rtol/atol 1e-5,
   the lanes bit-equal), saved and loaded back; then
   ``repro_torch.launch.serve_ensemble.main`` at its own defaults
   (edge_vision and iot, 12 rounds, 400 rps for 3 s, 3 hosts, the first
   tenant's owner killed mid-serve, autoscaled up to 5 hosts) with a
   policy table (a batch cap, a host override, iot on the fused
   fingerprint path with its own budget and cap, a pair cap), traced: the
   report equal to the JAX package's recorded run but for the snapshot
   versions (held to the card's own publishes) and staleness, every
   dispatched choice ``cuda``, the three stump kernels launched, every
   ``stump_scan`` of the run bit-equal to its plain version on its own
   inputs, the port's kernel profile and trace check over its metrics and
   trace; the
   same arrivals over copies of the trained cluster, on the CPU's plain
   path (report equal, margins within rtol/atol 1e-5) and on the card
   with iot pinned to ``torch`` (the launches split by policy); and the
   host time the dispatcher adds to a ``stump_vote_batched`` call at
   (1, 477, 1), timed in turns against the cuda backend's launch code;
14. the mesh-integrated federated boost (``core/fed_mesh.py``): the five
   paper domains and mobile_x4 at their registered sizes, K = each one's
   ``n_clients``, 80 rounds, buffer cap 8: each round's fits one
   ``stump_scan_batched`` launch, each sync two ``stump_vote_batched``
   launches, every choice ``cuda``, the summary beside the JAX package's
   (``MESH_REFERENCE``); every scan bit-equal to the plain version on its
   own inputs; each run replayed on the CPU in lockstep from the card's
   states; each final ensemble published and 256 test requests answered
   through ``BatchEvaluator`` on the card and on the CPU;
15. LM training: ``launch/train.py``'s ``train_loop`` on qwen1.5-0.5b at
   full width and depth (batch 4, seq 512, 10 steps, AdamW): the loss a
   step, ms a step, peak memory, no ``flash_attention`` launch (attention
   under autograd takes the chunked softmax); 10 steps on one batch, whose
   loss must fall, and one step traced; one step at two layers of
   full width on the card and on the CPU from the same weights (loss and
   every gradient); a checkpoint at the reduced size written at step 3,
   read back bit for bit in the JAX package's format, and resumed;
16. the MoE, SSM, hybrid and encoder-decoder LM families in f32 (TF32
   off), each through ``generate`` (batch 4, a 512-token prompt, 32
   greedy tokens; whisper a 32-token prompt over seeded frames): the
   flash launches of one prefill (8 / 0 / 1 / 12), prefill ms, decode ms
   a token, tokens/s and peak memory, and a CPU replay in lockstep
   (logits, greedy tokens, and every MoE layer handed the card's top-k
   picks, the CPU's own picks tying them): 16.1 qwen3-moe-30b-a3b at full
   width, 8 of its 48 layers, with the tokens dropped at capacity per
   layer, replayed at 2 layers of the same weights; 16.2 mamba2-1.3b at
   full size, replayed at 2 layers, and each layer's prefill(T + 1)
   against prefill(T) plus one decode step in lockstep; 16.3 Jamba at
   reduced width (8 layers, d_model 1024, 16 experts: one whole period);
   16.4 whisper-base at full size, with the encoder's full-mode
   ``flash_attention`` held against its plain version at (4, 8, 1500,
   64); 16.5 ``train_loop`` with AdamW, 5 steps each, on qwen3-moe (2
   layers, 2 x 256), mamba2-1.3b (8 layers, 4 x 512) and whisper-base (4
   x 256): ms a step, tokens/s, peak memory, the aux term in the MoE
   loss, no flash launch, and one step's gradients at 2 layers against
   the CPU's;
17. the dry run: 17.1 ``launch/dryrun.py`` traced on the card's host on
   a ``cuda`` mesh of 256 or 512 fake ranks (fake card tensors), at full
   size: qwen1.5-0.5b x train_4k x 16x16 and x decode_32k x 2x16x16,
   qwen3-moe-30b-a3b x train_4k x 16x16 x ``moe_bf16_psum``, each record
   (per-device FLOPs, argument and output bytes, peak live bytes,
   collectives by kind, forced redistributions, trace wall) beside the
   JAX package's (``DRYRUN_REFERENCE``), the MoE's expert all-reduce
   bf16; 17.2 the same ``steps.build`` run for real on a (1,1) mesh over
   a one-rank NCCL group, qwen1.5-0.5b at full depth in bf16: a prefill
   of 1 x 32,768, one decode step against its cache and one train step
   of 1 x 4,096, with their flash launches (24 / 0 / 0), logits and loss
   against the mesh-free path, counted FLOPs equal to the fake (1,1) dry
   run's, ms a step, TFLOP/s and peak memory;
18. the dispatcher's layout autotune (``dispatch.LAYOUT_GRIDS``): 18.1
   every grid member of the eight kernels at PERF.md's main and large
   shapes (flash in f32 and bf16) held to the plain version at phase 3's
   tolerances and timed by the profiler, beside the launcher's own
   choice and the fastest member (a member that cannot run a bucket must
   be refused); 18.2 ``calibrate_call`` on both backends at the slice-1
   path's buckets (edge_vision's first fit, phase 5's commonest stump
   vote shapes, ``ensemble_vote`` (256, 8192), ``dist_update`` N 8,192,
   phase 10's prefill flash shape; a winner other than ``{}`` must not
   run more than 10% slower than ``{}`` on the card), the table saved,
   loaded back and each call dispatched again: the recorded backend and
   layout launched (``cuda_layout_choices``), the result within
   tolerance; the same for a forced table of each bucket's first member
   after ``{}``; 18.3 the slice-1 path under each loaded table:
   edge_vision enhanced training with every pick and counter equal to
   phase 4's, then the 512-request serve, plain and on the fused
   fingerprint path, beside the same serve without a table (labels
   equal, margins within rtol/atol 1e-5) and every stump vote call
   launched again without it (lanes bit-equal).

Phase 3 also holds ``flash_attention`` to its plain version at the LM
path's shape, a large one, a ragged T, d 80 and 128, ``causal=False``,
bf16 at the path's shape, a large one and d 128, and the path's own
(B,T,H,d) views written into a (B,T,H,d) buffer, with
``scaled_dot_product_attention`` timed beside it; it counts the tensor-core
instructions (HGMMA, HMMA) of each flash kernel in the built library's SASS.
Launch counts are zeroed just before phase 4 and read just after phase 5,
and zeroed again just before each later path (7.2, 8, 9, 10, 11, 12, 13)
and read just after it (the main path of phases 11 and 12 is their step
1, of phase 13 its step 2, the run of ``serve_ensemble``, of phase 14
its step 1, the six training runs, of phase 15 its step 1, the
full-width ``train_loop``, of phase 16 each family's first ``generate``
and its three training runs together, of phase 17 each traced real
step of 17.2, of phase 18 its step 18.3 under the calibrated table).
The last lines are the kernels JSON, the card's ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
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


# (tile_c, deep, groups) of the stump vote launchers' own choice
OWN_VOTE_LAUNCH = (0, -1, 0)
# Launcher variants of stump_vote.cu, each one launch knob fixed (the
# others the launcher's own): "deep"/"stream" fix the loads in flight (a
# whole chunk / half a chunk), "one_stage" one stage a round, "wide" the
# 128-column tile at every shape.
STUMP_VARIANTS = {"deep": {"deep": 1}, "stream": {"deep": 0},
                  "one_stage": {"groups": 1}, "wide": {"tile_c": 4}}


def stump_variant_ms(args, want, want0, want1) -> dict:
    """Each launcher variant's device ms at these inputs, both kernels,
    each held to the shipped kernels' bits (margins and lanes); the
    variants are the launchers' knobs (``STUMP_VARIANTS``)."""
    from repro_torch.kernels import ops
    B, T, N = args[0].shape
    rows = {}
    for name, knobs in STUMP_VARIANTS.items():
        rows[name] = {}
        for kname, fn in (("stump_vote_batched",
                           ops._stump_vote_batched_cuda),
                          ("stump_vote_fp_batched",
                           ops._stump_vote_fp_batched_cuda)):
            call = lambda fn=fn, knobs=knobs: fn(*args, **knobs)  # noqa: E731
            got = call()
            torch.cuda.synchronize()
            out = got[0] if isinstance(got, tuple) else got
            if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"{kname} {(B, T, N)}: the {name} "
                                     f"variant differs from the shipped bits")
            if kname == "stump_vote_fp_batched" and not (
                    torch.equal(got[1], want0) and torch.equal(got[2], want1)):
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
            *OWN_VOTE_LAUNCH, stream)
        alloc = lambda: ops._fp_outputs(B, N, dev)          # noqa: E731
    else:
        wrapper = lambda: ops.stump_vote_batched(*args)      # noqa: E731
        launch = lambda: lib.stump_vote_launch(              # noqa: E731
            *ptrs, out.data_ptr(), B, T, N, *OWN_VOTE_LAUNCH, stream)
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
                            B, T, N, *OWN_VOTE_LAUNCH, ops._stream(xs))
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
        rel = float(((got - want).abs() / (1.0 + want.abs())).max())
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
            + (-1, torch._C._cuda_getCurrentRawStream(0)))

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
                        aa.data_ptr(), res.data_ptr(), *m.shape, -1,
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


def vote_depths(gen) -> dict:
    """Device ms of the vote kernel at each load depth, at the four phase-3
    shapes: the launcher's ``deep`` knob set to a whole chunk a round or
    half a chunk at two blocks an SM; each gives the shipped kernel's
    bits.  The launcher's own choice is the first where the column tiles
    are at most one an SM."""
    from repro_torch.kernels import ops
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for B, T, N in ((2, 300, 64), (8, 1024, 4096), (1, 256, 8192),
                    (1, 1024, 65536)):
        m = torch.rand((B, T, N), generator=gen, device="cuda") * 2 - 1
        a = torch.rand((B, T), generator=gen, device="cuda")
        want = ops.ensemble_vote_batched(m, a)
        row = {"shipped": "deep" if B * -(-N // 128) <= sms else "stream"}
        for name, deep in (("deep", 1), ("stream", 0)):
            call = lambda deep=deep: ops._ensemble_vote_batched_cuda(  # noqa
                m, a, deep=deep)
            out = call()
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
        rel = float(((got - want).abs() / (1.0 + want.abs())).max())
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
        rel = float(((got - want).abs() / (1.0 + want.abs())).max())
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
        rel = float(((got - want).abs() / (1.0 + want.abs())).max())
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


def flash_case(label, B, H, T, d, causal, dtype, gen) -> dict:
    """One case of ``flash_attention`` on the card: the kernel against its
    plain version on the same inputs, bit-equal to a second call, with
    CUDA-event and device times, the plain version's time, the bound and
    ``scaled_dot_product_attention``'s event and device times (never
    called by the port).  The bound counts q, k, v read and out written
    once, and the product work these inputs need: 2 BH T^2 d under
    causality (half of QK^T and of PV), 4 BH T^2 d without, at the bf16
    tensor-core rate for bf16 inputs and, for f32 ones, as the cheapest
    route to an f32-accurate result on this card: three TF32 products for
    each (split TF32) at the TF32 tensor-core rate."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from repro_torch.kernels import ops, ref
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
    return dict(
        shape=[B, H, T, d], causal=causal, dtype=str(dtype)[6:],
        max_abs_err=err, tol=tol, ms=cuda_ms(call, reps),
        kernel_ms=device_ms(call, min(reps, 20), "flash_attention_kernel"),
        plain_ms=cuda_ms(
            lambda: ref.flash_attention_ref(q, k, v, causal=causal),
            3 if large else 10),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(lambda: sdpa(q, k, v, is_causal=causal), reps),
        library_kernel_ms=device_ms(
            lambda: sdpa(q, k, v, is_causal=causal), min(reps, 20), None))


def flash_line(label: str, r: dict) -> str:
    return (f"kernel flash_attention {label} {r['shape']} "
            f"causal={r['causal']} {r['dtype']}: "
            f"max_abs_err={r['max_abs_err']:.3g} (tol {r['tol']}) "
            f"ms={r['ms']:.4f} kernel_ms={r['kernel_ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
            f"({r['bound_by']}) library_ms={r['library_ms']:.4f} "
            f"library_kernel_ms={r['library_kernel_ms']:.4f}")


def check_flash_attention():
    """Phase 3 for ``flash_attention``: :func:`flash_case` at the LM path's
    prefill shape and the other cases of ``FLASH_CASES``; then the SASS
    count of :func:`flash_sass`."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    results = {label: flash_case(label, *case, gen)
               for label, case in FLASH_CASES}
    for label, r in results.items():
        log(flash_line(label, r))
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
                          r"Li(\d+)ELi(\d+)E", line)
            name = None if m is None else (
                "float" if m.group(1) == "f" else "bf16", int(m.group(2)),
                int(m.group(3)))
            if name:
                counts[name] = {"HGMMA": 0, "HMMA": 0}
        elif name:
            for op in ("HGMMA", "HMMA"):
                counts[name][op] += f" {op}." in line
    if not counts:
        raise AssertionError("sass: no flash_attention_kernel in the library")
    for (dtype, D, NS), c in sorted(counts.items()):
        log(f"sass flash_attention_kernel<{dtype}, {D}, {NS} stages>: "
            f"HGMMA={c['HGMMA']} HMMA={c['HMMA']}")
        if c["HGMMA" if dtype == "bf16" else "HMMA"] == 0:
            raise AssertionError(f"sass: flash_attention_kernel<{dtype}, "
                                 f"{D}, {NS}> has no tensor-core "
                                 f"instruction")


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


def first_split(cfg, data, mode, card_fits, **engine_kw):
    """The CPU's own run beside the card's: None where every pick agrees,
    else (fit index, exact gap between the card's and the CPU's pick on
    the card's inputs, the largest relative difference of the two
    distributions there).  Both sum stump errors in f64, so the runs split
    only where the devices' exp and log, moving the distribution in its
    last bits, turn a near-tie.  ``engine_kw`` goes to the CPU's engine
    (a scenario's behaviors)."""
    from repro_torch.core import FederatedBoostEngine
    from repro_torch.models.weak import stump_thresholds
    cpu = FitLog()
    FederatedBoostEngine(cfg, data, mode, weak=cpu.spec, device="cpu",
                         **engine_kw).run()
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


# phase 4's runs, (domain, mode) -> (metrics, each fit's stump key): the
# runs phase 18.3 repeats under a calibrated table
SLICE1: dict = {}


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
        SLICE1[(domain, mode)] = (m, [_key(p) for *_, p in log_.fits])
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
        def call(xsel, *rest, **kw):
            shapes[name][tuple(xsel.shape)] += 1
            return fn(xsel, *rest, **kw)
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
MESH_SCAN = (10, 43575, 54, 16)   # fed_mesh's ten covtype shards
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
    by the fleet on the card), on a large-shard batch and at
    ``MESH_SCAN`` (the split route, held to
    ``ref.scan_batched_in_kernel_order`` too): bit-equal (and within
    ``SCAN_TOL``), through the wrapper and on each route through the
    library's launcher (the row route's 16-byte and 4-byte loads; the
    split, whose loads are 4-byte, once), with each route's device time, the bytes bound, its share and the TB/s, and the FP64 pipe's
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
    B, N, F, T = MESH_SCAN
    mx = torch.randn((B, N, F), generator=gen, device=CARD)
    my = torch.where(torch.rand((B, N), generator=gen, device=CARD) < 0.5,
                     1.0, -1.0)
    mw = torch.rand((B, N), generator=gen, device=CARD)   # exact sums
    rows = torch.randint(0, N, (B, F, T), generator=gen, device=CARD)
    mthr = torch.gather(mx.transpose(1, 2), 2, rows).contiguous()
    cases = {"main": (core.X, core.Y, core.D, core.THR),
             "large": (x, y, w, thr), "mesh": (mx, my, mw, mthr)}
    fn = load().stump_scan_batched_launch
    results = {}
    for label, args in cases.items():
        got = ops.stump_scan_batched(*args)
        want = ref.stump_scan_batched_ref(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / (1.0 + want.abs())).max())
        if not (err <= SCAN_TOL and torch.equal(got, want)):
            raise AssertionError(f"stump_scan_batched {label}: max err {err}, "
                                 f"not bit-equal")
        B, N, F = args[0].shape
        T = args[3].shape[2]
        split = ops.scan_batched_split(B, N, F, T, ops._sms(0))
        if split is not None and not torch.equal(
                got.cpu(), ref.scan_batched_in_kernel_order(
                    *[a.cpu() for a in args], split)):
            raise AssertionError(f"stump_scan_batched {label}: not its "
                                 f"order's emulation")
        b, by = scan_batched_bound(*args)
        nbytes = 4 * (B * N * F + 2 * B * N + 2 * B * F * T)
        # the split takes 4-byte loads whatever vec says: timed once
        routes = {}
        for route, vec in ((("split", 1),) if split is not None
                           else (("16-byte", 1), ("4-byte", 0))):
            out = torch.empty_like(want)
            ptrs = [a.data_ptr() for a in args] + [out.data_ptr()]
            stream = torch._C._cuda_getCurrentRawStream(0)

            def call(ptrs=ptrs, vec=vec, route=route, split=split):
                rc = fn(*ptrs, B, N, F, T, vec, 0, 0,
                        *(split or (0, 0, 0, 0)), stream)
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
            load_route=("split" if split is not None else "16-byte"
                        if ops.scan_vec(T, args[3]) else "4-byte"),
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
    del core, eng, cases, args, mx, my, mw, mthr
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

    def timed_generic(group, margins, policy):
        t0 = time.perf_counter()
        eval_generic(group, margins, policy)
        timed["eval"] += time.perf_counter() - t0

    def timed_vote(m, a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = vote(m, a, **kw)
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

# ------------------------------------------------------------ phase 12
CHAIN_SCENARIO, CHAIN_TRACE = "blockchain_flchain", "block_delay"
# The JAX package's run of step 1's call (the registered blockchain domain,
# 5,000 samples x 32 features, 8 clients, 20 rounds, 2 hosts, 1.5 s,
# autoscale on), on a CPU:
#   PYTHONPATH=src python -c "from repro.sim.harness import run_scenario;
#   r = run_scenario('blockchain_flchain', trace='block_delay', seed=0);
#   print(r.serve, vars(r.baseline), vars(r.enhanced))"
# The report's snapshot_version and killed_host follow the chain the
# enhanced run minted (the number of blocks and so the committee's epoch
# at the kill), so they are held to the card's own chain (CHAIN_MINTED
# is the JAX package's, printed beside); the other fields follow the
# behavior models (seed + 101), the request RNG (seed * 31 + 7), the
# service model and which host dies, and are held to CHAIN_REFERENCE
# wherever the card's chain kills the host the JAX package's kills.
CHAIN_REFERENCE = {
    "offered": 434, "offline_suppressed": 10, "completed": 434,
    "rejected": 0, "p50_ms": 2.6000000000000467, "p99_ms": 4.793700699278869,
    "throughput_rps": 289.39761369402913, "mean_batch": 1.3231707317073171,
    "cache_hit_rate": 0.14055299539170507, "hosts_final": 2,
    "scale_outs": 1, "scale_ins": 1, "rerouted": 0,
    "slo": {"good": 434, "bad": 0, "budget_remaining": 1.0,
            "alerts_fired": 0, "alerts_active": 0}}
CHAIN_MINTED = {"snapshot_version": 33, "killed_host": "host-0",
                "height_trained": 31, "height_served": 33,
                "tip": "098beec7cf2e94c0349d67b2"}
# the same run's training counters: the baseline's do not depend on what
# is learned and must be the card's; the enhanced ones are printed beside
CHAIN_COUNTERS = {
    "baseline": dict(uplink_bytes=44800, downlink_bytes=61440,
                     n_messages=320, n_syncs=20, learners_merged=160,
                     snapshots_published=0, rounds_unavailable=4,
                     sim_time_s=103.13430626357957),
    "enhanced": dict(uplink_bytes=12544, downlink_bytes=25440,
                     n_messages=68, n_syncs=34, learners_merged=160,
                     snapshots_published=17, rounds_unavailable=3,
                     sim_time_s=33.59398657776881,
                     final_test_error=0.2186666578054428)}
CONTROLLER_DOMAIN, CONTROLLER_ROUNDS = "edge_vision", 25


def chain_blocks(chain):
    return [(b.height, b.hash, [c.fingerprint for c in b.commits])
            for b in chain.blocks]


def chain_path() -> dict:
    """Phase 12: the server-less FLchain mode on the card.  (1)
    ``run_scenario`` on blockchain_flchain/block_delay at its registered
    size: both modes trained on the card, the enhanced run committing to
    a chain-backed fleet, the replay killing the committee leader halfway;
    held to the JAX package's report; (2) the chain's guarantees on that
    run; (3) the chain carried to the CPU, re-minted from genesis and
    replayed on the CPU's plain path; (4) the enhanced run again, traced,
    checked by the port's trace reporter; (5) the beyond-paper interval
    controllers on edge_vision.  Returns step 1's launch counts."""
    from repro_torch import obs
    from repro_torch.chain import ChainCluster
    from repro_torch.configs.paper_fedboost import FedBoostConfig
    from repro_torch.convert import chain_from_numpy, chain_to_numpy
    from repro_torch.core import FederatedBoostEngine
    from repro_torch.core.controllers import BudgetScheduler, TrendScheduler
    from repro_torch.data import make_domain_data
    from repro_torch.kernels import ops
    from repro_torch.launch import obs_report
    from repro_torch.serve import GossipConfig, ShardedEnsembleServer
    from repro_torch.sim import harness
    from repro_torch.sim.scenarios import DOMAINS, get_scenario

    sc = get_scenario(CHAIN_SCENARIO)
    seed, duration = 0, 1.5
    captured, fitlogs, kills, submits = {}, [], [], [0]
    saved = {k: getattr(harness, k) for k in (
        "replay_serve", "_replay", "FederatedBoostEngine", "ChainCluster",
        "ShardedEnsembleServer")}

    def recording_replay(sc_, cluster, data, trace, **kw):
        captured.update(cluster=cluster, data=data,
                        state=chain_to_numpy(cluster))
        return saved["replay_serve"](sc_, cluster, data, trace, **kw)

    def recording_inner(sc_, server, arrivals, offline, duration_s,
                        autoscale):
        summary, responses = saved["_replay"](sc_, server, arrivals,
                                              offline, duration_s, autoscale)
        captured.update(arrivals=arrivals, offline=offline,
                        responses=responses)
        return summary, responses

    class RecordingEngine(FederatedBoostEngine):
        def __init__(self, *a, **kw):
            fitlogs.append(FitLog())
            super().__init__(*a, weak=fitlogs[-1].spec, **kw)

    class RecordingChain(ChainCluster):
        def kill(self, host_id):
            kills.append((host_id, self.leader(), self.host_ids(),
                          self.chain.height, submits[0]))
            super().kill(host_id)

    class CountingServer(ShardedEnsembleServer):
        def submit(self, tenant, x, now):
            submits[0] += 1
            return super().submit(tenant, x, now)

    t0 = time.perf_counter()
    harness.replay_serve, harness._replay = recording_replay, recording_inner
    harness.FederatedBoostEngine = RecordingEngine
    harness.ChainCluster = RecordingChain
    harness.ShardedEnsembleServer = CountingServer
    try:
        rep = harness.run_scenario(CHAIN_SCENARIO, trace=CHAIN_TRACE,
                                   seed=seed, device=CARD)
    finally:
        for k, v in saved.items():
            setattr(harness, k, v)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    s, cluster = rep.serve, captured["cluster"]
    chain, state = cluster.chain, captured["state"]
    fits = sum(len(f.fits) for f in fitlogs)
    log(f"chain 12.1: run_scenario {CHAIN_SCENARIO} {CHAIN_TRACE} seed "
        f"{seed} on {CARD} ({sc.domain.n_samples}x{sc.domain.n_features}, "
        f"{sc.domain.n_clients} clients, {sc.n_rounds} rounds, 2 hosts, "
        f"{duration} s replay): {wall:.2f} s with data; {fits} fits; "
        f"launches stump_scan {launches['stump_scan']} stump_vote_batched "
        f"{launches['stump_vote_batched']} (all {launches})")
    for line in harness.summarize(rep).splitlines():
        log(f"chain 12.1: {line}")
    log(f"chain 12.1: serve {json.dumps(s)}")
    if launches["stump_scan"] != fits or fits <= 0:
        raise AssertionError(f"chain: stump_scan launches "
                             f"{launches['stump_scan']} != fits {fits}")
    if launches["stump_vote_batched"] <= 0:
        raise AssertionError("chain: kernel stump_vote_batched never "
                             "launched")
    # the card's own chain: the served version is the tenant's folds, the
    # killed host the leader when the kill came, at the middle arrival
    folds = sum(any(c.tenant == sc.name for c in b.commits)
                for b in chain.confirmed_blocks())
    if len(kills) != 1:
        raise AssertionError(f"chain: {len(kills)} kills, not one")
    killed, leader, up, height, at = kills[0]
    middle = len(captured["arrivals"]) // 2
    if (s["snapshot_version"] != folds or s["killed_host"] != killed
            or killed != (leader if leader in up else up[0])
            or at != middle):
        raise AssertionError(
            f"chain: served v{s['snapshot_version']} for {folds} folds; "
            f"killed {s['killed_host']!r}/{killed!r}, leader {leader!r} of "
            f"{up} at submit {at} (middle {middle})")
    log(f"chain 12.1: snapshot v{s['snapshot_version']} = the tenant's "
        f"{folds} confirmed folds; killed {killed} = the committee leader "
        f"at arrival {at} of {len(captured['arrivals'])} (chain height "
        f"{height}, up {up}); JAX package's: "
        f"v{CHAIN_MINTED['snapshot_version']}, "
        f"{CHAIN_MINTED['killed_host']}; chain height after training "
        f"{len(state['blocks']) - 1} (JAX {CHAIN_MINTED['height_trained']}),"
        f" after the replay {chain.height} (JAX "
        f"{CHAIN_MINTED['height_served']}), tip {chain.blocks[-1].hash} "
        f"(JAX {CHAIN_MINTED['tip']})")
    if killed == CHAIN_MINTED["killed_host"]:
        replay_equal(s, CHAIN_REFERENCE, "chain 12.1")
        log("chain 12.1: every other field equals the JAX package's report")
    else:
        log("chain 12.1: the card's chain killed another host than the JAX "
            "package's: the report is held to the CPU replay of the card's "
            "chain (12.3)")
    for mode, want in CHAIN_COUNTERS.items():
        m = getattr(rep, mode)
        got = {k: getattr(m, k) for k in want}
        diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        log(f"chain 12.1: {mode} counters {json.dumps(got)}; JAX package's "
            + ("equal" if not diff else f"differ at {diff}"))
        if mode == "baseline" and diff:
            raise AssertionError(f"chain: baseline counters differ from "
                                 f"the JAX package's: {diff}")
    data = captured["data"]
    for mode, flog in zip(("baseline", "enhanced"), fitlogs):
        split = first_split(sc.fedboost_config(seed=seed), data, mode,
                            flog.on_cpu(),
                            behavior_for=sc.behavior_for(CHAIN_TRACE, seed),
                            fleet=sc.fleet)
        log(f"chain 12.1: {mode}: the cpu's own run "
            + ("picks as the card's at every fit" if split is None else
               f"splits from the card's at fit #{split[0]}: exact gap "
               f"{split[1]:.3g} on the card's inputs, distributions "
               f"{split[2]:.3g} apart (relative)"))

    # (2) the chain's guarantees on the card's run
    t0 = time.perf_counter()
    if not chain.verify() or chain.replay_hashes() != \
            chain.confirmed_hashes():
        raise AssertionError("chain 12.2: hash links or replay broken")
    want_fp = cluster._committer.latest(sc.name).fingerprint
    up_hosts = cluster.host_ids()
    fps = {h: cluster.hosts[h].registry.latest(sc.name).fingerprint
           for h in up_hosts}
    if set(fps.values()) != {want_fp}:
        raise AssertionError(f"chain 12.2: host folds {fps} != the "
                             f"committer's {want_fp}")
    history = [(x.version, x.fingerprint)
               for x in cluster._committer.history(sc.name)]
    late = cluster.add_host("after-kill", now=duration)
    late_history = [(x.version, x.fingerprint)
                    for x in late.registry.history(sc.name)]
    if late_history != history:
        raise AssertionError(f"chain 12.2: a host added after the kill "
                             f"folds {late_history} != {history}")
    responses = captured["responses"]
    rids = [r.rid for r in responses]
    if (len(rids) != s["completed"] or len(set(rids)) != len(rids)
            or s["completed"] + s["rejected"] != s["offered"]):
        raise AssertionError(f"chain 12.2: {len(rids)} answers "
                             f"({len(set(rids))} unique) for "
                             f"{s['completed']} completed")
    log(f"chain 12.2: {chain.height} blocks verify and re-mint from genesis "
        f"to the confirmed hashes; up hosts {up_hosts} (the scale-out "
        f"warmed from the chain after the kill) fold the committer's "
        f"fingerprint {want_fp}; a host added after the replay folds the "
        f"same {len(history)} retained versions from the chain alone; "
        f"{len(rids)} accepted, {len(rids)} answered once, none lost "
        f"({time.perf_counter() - t0:.2f} s)")

    # (3) the card's chain on the CPU: re-minted, then replayed
    t0 = time.perf_counter()
    copy = chain_from_numpy(state, GossipConfig(seed=seed))
    want_hashes = [b["hash"] for b in state["blocks"][1:]]
    if copy.chain.replay_hashes() != want_hashes:
        raise AssertionError("chain 12.3: re-minted hashes differ")
    copy.run_until_quiescent()
    copy.rebase_clock(0.0)
    server = ShardedEnsembleServer(copy, harness.SERVE_BATCH,
                                   service_model=harness._service_model,
                                   device="cpu")
    summary, cpu_responses = harness._replay(
        sc, server, captured["arrivals"], captured["offline"], duration,
        True)
    replay_equal(summary, s, "chain 12.3 cpu")
    if [(r.rid, r.tenant, r.snapshot_version) for r in responses] != \
            [(r.rid, r.tenant, r.snapshot_version) for r in cpu_responses]:
        raise AssertionError("chain 12.3: card and cpu responses differ")
    if chain_blocks(copy.chain) != chain_blocks(chain):
        raise AssertionError("chain 12.3: the cpu replay ends on another "
                             "chain")
    worst = max(abs(g.margin - c.margin)
                for g, c in zip(responses, cpu_responses))
    far = sum(abs(g.margin - c.margin) > TOL + TOL * abs(c.margin)
              for g, c in zip(responses, cpu_responses))
    log(f"chain 12.3: the card's chain carried to the cpu "
        f"(convert.chain_from_numpy): {len(want_hashes)} block hashes "
        f"re-minted from genesis equal; {len(captured['arrivals'])} "
        f"arrivals replayed on the cpu's plain path: report equal to the "
        f"card's, killed {summary['killed_host']}, {len(cpu_responses)} "
        f"responses rid/tenant/version equal, max |margin diff| "
        f"{worst:.3g} ({time.perf_counter() - t0:.2f} s)")
    if far:
        raise AssertionError(f"chain 12.3: {far} margins differ beyond "
                             f"rtol/atol {TOL} (max {worst})")

    # (4) the enhanced run again, traced
    t0 = time.perf_counter()
    with obs.tracing() as tracer:
        traced = ChainCluster(2, GossipConfig(seed=seed))
        eng = FederatedBoostEngine(
            sc.fedboost_config(seed=seed), data, "enhanced",
            behavior_for=sc.behavior_for(CHAIN_TRACE, seed), fleet=sc.fleet,
            device=CARD)
        eng.attach_registry(traced, sc.name, publish_every=2)
        eng.run()
        torch.cuda.synchronize()
        spans, meta = tracer.finished(), tracer.meta()
    problems = obs_report.check_trace(spans, meta)
    commits = [x for x in spans if x["name"] == "chain.commit"]
    reach = []
    for c in commits:
        st = obs_report.stitch_trace(spans, c["trace"])
        reach.append(len({x["host"] for x in st["members"]
                          if x["name"] == "chain.aggregate"}))
    minted = [b.hash for b in traced.chain.blocks]
    same = minted == [b["hash"] for b in state["blocks"]]
    log(f"chain 12.4: traced enhanced run on {CARD}: {len(spans)} spans "
        f"(dropped {meta['dropped']}), check_trace problems "
        f"{len(problems)}; {len(commits)} chain.commit traces, each "
        f"stitched to chain.aggregate on {min(reach, default=0)}-"
        f"{max(reach, default=0)} nodes; {len(minted) - 1} blocks minted, "
        f"hashes {'identical to' if same else 'DIFFERENT from'} the "
        f"untraced run's ({time.perf_counter() - t0:.2f} s)")
    for line in problems[:10]:
        log(f"chain 12.4: {line}")
    if problems or not commits or min(reach) < 2 or not same:
        raise AssertionError("chain 12.4: the traced chain run failed its "
                             "checks")

    # (5) the beyond-paper interval controllers on the card
    t0 = time.perf_counter()
    dom = DOMAINS[CONTROLLER_DOMAIN]
    cdata = make_domain_data(dom, seed=0)
    cfg = FedBoostConfig(n_clients=dom.n_clients, n_rounds=CONTROLLER_ROUNDS,
                         straggler_factor=dom.straggler_factor,
                         dropout_prob=dom.dropout_prob,
                         link_mbps=dom.link_mbps,
                         balanced_init=dom.label_imbalance < 0.4)
    lo, hi = cfg.scheduler.i_min, cfg.scheduler.i_max
    for label, make in (("eq. 1", None), ("trend", TrendScheduler),
                        ("budget", BudgetScheduler)):
        eng = FederatedBoostEngine(cfg, cdata, "enhanced", device=CARD)
        if make is not None:
            eng.scheduler = make(cfg.scheduler)
        seen = []
        observe = eng.scheduler.observe

        def recorded(err, observe=observe, sched=eng.scheduler):
            out = observe(err)
            seen.append((out, sched.interval))
            return out
        eng.scheduler.observe = recorded
        m = eng.run()
        torch.cuda.synchronize()
        bad = [x for x in seen if not (lo <= x[0] <= hi and
                                       lo <= x[1] <= hi)]
        log(f"chain 12.5: {CONTROLLER_DOMAIN} enhanced {CONTROLLER_ROUNDS} "
            f"rounds on {CARD}, {label:>6}: syncs {m.n_syncs} bytes "
            f"{m.total_bytes} msgs {m.n_messages} test_err "
            f"{m.final_test_error:.4f} val_err {m.final_val_error:.4f}; "
            f"intervals {min(x[0] for x in seen)}-{max(x[0] for x in seen)}"
            f" over {len(seen)} syncs")
        if bad or len(seen) != m.n_syncs:
            raise AssertionError(f"chain 12.5 {label}: intervals outside "
                                 f"[{lo}, {hi}]: {bad[:5]}")
    log(f"chain 12.5: every interval within [{lo}, {hi}] at every sync "
        f"({time.perf_counter() - t0:.2f} s)")
    return launches


# ------------------------------------------------------------ phase 13
POLICY_DIR = ROOT / "build" / "policy"
# serve_ensemble's own defaults, the first tenant's owner killed mid-serve
# and the autoscaler on (up to 5 hosts)
POLICY_ARGV = ("--domains", "edge_vision", "iot", "--rounds", "12",
               "--rate", "400", "--duration", "3", "--hosts", "3",
               "--seed", "0", "--kill-owner", "--autoscale", "5")
# a fleet default batch cap, a host override, iot on the fused fingerprint
# path with its own budget and cap, and an edge_vision@host-0 pair cap
POLICY_TABLE = {
    "default": {"max_batch": 32},
    "hosts": {"host-1": {"batch": {"queue_budget": 512}}},
    "tenants": {"iot": {"batch": {"queue_budget": 64, "max_batch": 8},
                        "kernel": {"fused_fingerprint": True}}},
    "pairs": {"edge_vision@host-0": {"batch": {"max_batch": 16}}}}
# report fields that follow the trained snapshots, not the arrivals: an
# enhanced run may split from the JAX package's at an exact stump tie (C4)
POLICY_TRAINED = ("snapshot_version", "mean_staleness_s")
# The JAX package's run of the same command and table on a CPU, its report
# without POLICY_TRAINED (its XLA backend: the report does not depend on
# the backend, the service time being serve_ensemble's analytic model):
#   REPRO_KERNEL_BACKEND=xla PYTHONPATH=src python -c "import json,
#   chip_smoke as cs; from repro.launch import serve_ensemble as se;
#   print(json.dumps(cs.untrained(cs.run_serve_ensemble(se, cs.policy_argv(
#   'build/policy'))['report'])))"
POLICY_REFERENCE = json.loads("""
{"completed": 1765, "rejected": 0, "throughput_rps": 594.567379412382,
"p50_ms": 2.3999999999999577, "p99_ms": 4.46937436090078, "mean_batch":
1.7286973555337903, "n_batches": 1021, "queue_depth_peak": 7, "tenants":
{"edge_vision": {"completed": 853, "rejected": 0, "p50_ms":
2.392664768925634, "p99_ms": 4.199999999999999}, "iot": {"completed": 912,
"rejected": 0, "p50_ms": 2.560169122523215, "p99_ms": 4.618504786447087}},
"per_host": {"host-2": {"completed": 523, "rejected": 0, "throughput_rps":
334.53266502963794, "p50_ms": 2.5745189239847477, "p99_ms":
4.7999999999999154, "mean_batch": 1.7789115646258504, "n_batches": 294,
"queue_depth_peak": 7, "tenants": {"edge_vision": {"completed": 24,
"rejected": 0, "p50_ms": 3.2988798298179134, "p99_ms": 146.4193608601525},
"iot": {"completed": 499, "rejected": 0, "p50_ms": 2.5387744772129572,
"p99_ms": 4.7999999999999154}}, "status": "up"}, "scale-0": {"completed":
415, "rejected": 0, "throughput_rps": 294.66327365587864, "p50_ms":
2.3999999999997357, "p99_ms": 4.1999999999999815, "mean_batch":
1.7148760330578512, "n_batches": 242, "queue_depth_peak": 7, "tenants":
{"edge_vision": {"completed": 388, "rejected": 0, "p50_ms":
2.3924145674856234, "p99_ms": 4.1999999999999815}, "iot": {"completed": 27,
"rejected": 0, "p50_ms": 3.425666652120407, "p99_ms": 4.3999999999999595}},
"status": "up"}, "scale-1": {"completed": 386, "rejected": 0,
"throughput_rps": 301.59620024466295, "p50_ms": 2.5349961885892114,
"p99_ms": 4.0000000000000036, "mean_batch": 1.7079646017699115, "n_batches":
226, "queue_depth_peak": 6, "tenants": {"iot": {"completed": 386,
"rejected": 0, "p50_ms": 2.5349961885892114, "p99_ms": 4.0000000000000036}},
"status": "up"}, "host-1": {"completed": 441, "rejected": 0,
"throughput_rps": 330.1465804356089, "p50_ms": 2.3465460073186506, "p99_ms":
3.800000000000001, "mean_batch": 1.7027027027027026, "n_batches": 259,
"queue_depth_peak": 6, "tenants": {"edge_vision": {"completed": 441,
"rejected": 0, "p50_ms": 2.3465460073186506, "p99_ms": 3.800000000000001}},
"status": "retired"}, "host-0": {"completed": 0, "rejected": 0,
"throughput_rps": 0.0, "p50_ms": 0.0, "p99_ms": 0.0, "mean_batch": 0.0,
"n_batches": 0, "queue_depth_peak": 0, "tenants": {}, "status": "retired"}},
"cache": {"hits": 807, "misses": 958, "fills": 958, "invalidated": 0,
"evicted": 0, "hit_rate": 0.4572237960339943}}""")
POLICY_REL = 1e-9


def policy_argv(out_dir, table=POLICY_TABLE, name="policy_table.json"):
    """``POLICY_ARGV`` with ``table`` written into ``out_dir`` as its
    ``--policy-table``."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / name).write_text(json.dumps(table))
    return [*POLICY_ARGV, "--policy-table", str(out / name)]


def untrained(rep):
    """``rep`` without the ``POLICY_TRAINED`` fields, at every depth."""
    if isinstance(rep, dict):
        return {k: untrained(v) for k, v in rep.items()
                if k not in POLICY_TRAINED}
    return rep


def run_serve_ensemble(se, argv) -> dict:
    """Run a ``serve_ensemble`` module's ``main`` with ``argv`` as
    ``sys.argv`` (the JAX package's main reads it; so does the port's when
    it is given none).  ``se`` is ``repro_torch.launch.serve_ensemble``,
    or the JAX package's to record the reference.  Returns the fleet's
    ``report``, the ``server``, the tenants' request ``pools``, each
    tenant's published ``versions`` and a ``copy`` of the trained cluster
    taken before serving (``convert.cluster_windows``, the gossip RNG
    state, the gossip config)."""
    from repro_torch.convert import cluster_windows
    seen = {}
    train, serve_ = se.train_tenants, se.serve

    def training(cluster, domains, *a, **kw):
        pools = train(cluster, domains, *a, **kw)
        seen.update(pools=pools, versions={t: cluster.version_count(t)
                                           for t in domains},
                    copy=(cluster_windows(cluster), cluster._rng.getstate(),
                          cluster.cfg))
        return pools

    def serving(*a, **kw):
        seen["server"] = serve_(*a, **kw)
        return seen["server"]
    se.train_tenants, se.serve = training, serving
    saved, sys.argv = sys.argv, ["serve_ensemble", *argv]
    try:
        se.main()
    finally:
        se.train_tenants, se.serve = train, serve_
        sys.argv = saved
    seen["report"] = seen["server"].report()
    return seen


def recording_answers():
    """Wrap ``BatchEvaluator.evaluate`` so that every response of every
    host records (rid, tenant, version, margin) in answer order; returns
    the list and a function that restores the method."""
    from repro_torch.serve.engine import BatchEvaluator
    answers = []
    evaluate = BatchEvaluator.evaluate

    def call(self, batch):
        out = evaluate(self, batch)
        answers.extend((r.rid, r.tenant, r.snapshot_version, r.margin)
                       for r in out)
        return out
    BatchEvaluator.evaluate = call

    def restore():
        BatchEvaluator.evaluate = evaluate
    return answers, restore


def policy_equal(got, want, label: str) -> None:
    """Two reports hold the same fields at every depth: integers and
    strings exactly, floats to ``POLICY_REL`` relative."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise AssertionError(f"{label}: fields {sorted(got)} != "
                                 f"{sorted(want)}")
        for k in want:
            policy_equal(got[k], want[k], f"{label}.{k}")
    elif isinstance(want, float):
        if not math.isclose(got, want, rel_tol=POLICY_REL, abs_tol=0.0):
            raise AssertionError(f"{label}: {got!r} != {want!r}")
    elif got != want:
        raise AssertionError(f"{label}: {got!r} != {want!r}")


def answers_close(got, want, label: str) -> float:
    """Same (rid, tenant, version) in the same order, margins within
    rtol/atol ``TOL``; returns the largest margin difference."""
    if [a[:3] for a in got] != [a[:3] for a in want]:
        raise AssertionError(f"{label}: rid/tenant/version differ")
    worst = max(abs(g[3] - w[3]) for g, w in zip(got, want))
    far = sum(abs(g[3] - w[3]) > TOL + TOL * abs(w[3])
              for g, w in zip(got, want))
    if far:
        raise AssertionError(f"{label}: {far} margins differ beyond "
                             f"rtol/atol {TOL} (max {worst})")
    return worst


def recording_scans():
    """Wrap ``ops.stump_scan`` so that every call keeps a copy of its
    inputs and of the error grid it returned; returns the list and a
    function that restores the wrapper."""
    from repro_torch.kernels import ops
    calls = []
    scan = ops.stump_scan

    def call(*args, **kw):
        out = scan(*args, **kw)
        calls.append(([a.clone() for a in args], out.clone()))
        return out
    ops.stump_scan = call

    def restore():
        ops.stump_scan = scan
    return calls, restore


def hold_backends(name, args, got=None) -> float:
    """``ops.<name>`` on the card's kernel against its plain version on
    the same inputs, both through the dispatcher with a backend pinned on
    a policy of their own: the scan bit-equal (its contract), the stump
    votes within rtol/atol ``TOL`` and the fingerprint lanes bit-equal.
    ``got`` is an output the path already took from the kernel (else it is
    launched here).  Returns the largest difference."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.dispatch import KernelPolicy
    fn = getattr(ops, name)
    if got is None:
        got = fn(*args, backend="cuda", policy=KernelPolicy(env_var=None))
    want = fn(*args, backend="torch", policy=KernelPolicy(env_var=None))
    torch.cuda.synchronize()
    if name == "stump_scan":
        if not torch.equal(got, want):
            raise AssertionError(f"{name} at {tuple(args[0].shape)}: not "
                                 f"bit-equal to the plain version (max "
                                 f"{float((got - want).abs().max())})")
        return 0.0
    m, wm = (got[0], want[0]) if isinstance(got, tuple) else (got, want)
    if isinstance(got, tuple) and not all(
            torch.equal(g, w) for g, w in zip(got[1:], want[1:])):
        raise AssertionError(f"{name} at {tuple(args[0].shape)}: "
                             f"fingerprint lanes not bit-equal")
    err = float((m - wm).abs().max())
    if not close(m, wm):
        raise AssertionError(f"{name} at {tuple(args[0].shape)}: max err "
                             f"{err}")
    return err


def table_policies(table) -> list:
    """Every kernel policy a :class:`PolicyTable` holds."""
    layers = [*table._hosts.values(), *table._tenants.values(),
              *table._pairs.values()]
    return [k for k in [table.default_kernel, *(k for _, k in layers)]
            if k is not None]


def policy_path(serve_shapes, fleet_launches) -> dict:
    """Phase 13: the policy-driven serving launcher on the card.  (1)
    ``KernelPolicy.calibrate_call`` on the card at each tenant's first fit
    and at phase 5's commonest stump vote shapes, each call held cuda
    against torch (:func:`hold_backends`), saved and loaded back;
    (2) ``serve_ensemble.main`` at its own defaults with a policy
    table, traced: the report held to the JAX package's, every dispatched
    choice ``cuda``, the three stump kernels launched, every scan of the
    run bit-equal to the plain version on its own inputs, the kernel
    profile and the trace checked; (3) the same arrivals over copies of the
    trained cluster, on the CPU's plain path and on the card with iot
    pinned to ``torch``; (4) the dispatcher's host cost a call.  Returns
    step 2's launch counts."""
    import dataclasses
    import os
    from collections import Counter
    from repro_torch import obs
    from repro_torch.convert import shard_cluster_from_numpy
    from repro_torch.data import make_domain_data
    from repro_torch.kernels import dispatch, ops
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.launch import obs_report
    from repro_torch.launch import serve_ensemble as se
    from repro_torch.models.weak import stump_thresholds
    from repro_torch.serve import PolicyTable
    from repro_torch.sim.scenarios import DOMAINS

    # (1) calibrate on the card, at the first fit of each tenant (a
    # client of the domain cut as train_tenants cuts it) and at phase 5's
    # commonest stump vote shapes, each call held cuda against torch
    t0 = time.perf_counter()
    calls = []
    for tenant in ("edge_vision", "iot"):
        full = DOMAINS[tenant]
        dom = dataclasses.replace(full, n_samples=min(full.n_samples, 2000),
                                  n_clients=min(full.n_clients, 8))
        x, y = make_domain_data(dom, seed=0)["clients"][0]
        x, y = torch.from_numpy(x).to(CARD), torch.from_numpy(y).to(CARD)
        w = torch.full((x.shape[0],), 1.0 / x.shape[0], device=CARD)
        calls.append(("stump_scan", (x, y, w, stump_thresholds(x))))
    gen = torch.Generator(device=CARD).manual_seed(13)
    for name in STUMP_KERNELS:
        (B, T, N), _ = serve_shapes[name].most_common(1)[0]
        calls.append((name, vote_inputs(gen, B, T, N, 0)))
    cal = KernelPolicy()
    for name, args in calls:
        bucket, samples = cal.calibrate_call(name, *args, reps=20)
        med = {key: statistics.median(ts) * 1e3
               for key, ts in samples.items()}
        win = cal.table[(name, bucket)]
        err = hold_backends(name, args)
        log(f"policy 13.1: calibrate {name} at {tuple(args[0].shape)} "
            f"(bucket {dispatch.bucket_label(bucket)}): median ms "
            + " ".join(f"{b}[{dispatch.layout_label(lay)}]={ms:.4f}"
                       for (b, lay), ms in sorted(med.items()))
            + f" -> {win.backend} [{dispatch.layout_label(win.layout)}]"
            + ("" if win.backend == "cuda" else
               " (finding: the plain version won)")
            + ("; cuda bit-equal to torch" if name == "stump_scan" else
               f"; cuda within {TOL} of torch, max err {err:.3g}")
            + f" | {nvidia_smi()}")
        want = {("torch", ())} | {
            ("cuda", dispatch.layout_key(lay))
            for lay in dispatch.LAYOUT_GRIDS[name]
            if dispatch.layout_applies(name, bucket, lay)}
        if sorted({b for b, _ in med}) != \
                dispatch.available_backends(CARD) or set(med) != want:
            raise AssertionError(f"calibrate {name}: measured {sorted(med)}")
    path = cal.save(str(POLICY_DIR / "calibration.json"))
    back = KernelPolicy.load(path)
    if back.table != cal.table or back.measured_on != CARD:
        raise AssertionError(f"calibration table round trip: {back.table} "
                             f"measured on {back.measured_on}")
    log(f"policy 13.1: {len(back.table)} entries saved to "
        f"{Path(path).relative_to(ROOT)} and loaded back equal, measured "
        f"on {back.measured_on} ({time.perf_counter() - t0:.2f} s)")

    # (2) serve_ensemble on the card
    env = os.environ.get(dispatch.ENV_VAR)
    log(f"policy 13.2: {dispatch.ENV_VAR}={env!r}")
    if env is not None:
        raise AssertionError(f"{dispatch.ENV_VAR} is set: {env!r}")
    trace, metrics = POLICY_DIR / "trace.jsonl", POLICY_DIR / "metrics.json"
    argv = [*policy_argv(POLICY_DIR), "--trace", str(trace), "--metrics",
            str(metrics), "--device", CARD]
    old_policy = dispatch.set_default_policy(KernelPolicy())
    obs.set_registry(obs.MetricsRegistry())
    t0 = time.perf_counter()
    ops.reset_launches()
    shapes, restore_shapes = recording_stump_shapes()
    answers, restore_answers = recording_answers()
    scans, restore_scans = recording_scans()
    try:
        run = run_serve_ensemble(se, argv)
        torch.cuda.synchronize()
    finally:
        restore_shapes()
        restore_answers()
        restore_scans()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    rep = run["report"]
    log(f"policy 13.2: serve_ensemble {' '.join(argv[:-6])} on {CARD}: "
        f"{wall:.2f} s with training; launches {launches}; vote calls "
        + ", ".join(f"{k} {sum(c.values())}" for k, c in shapes.items()))
    log(f"policy 13.2: report {json.dumps(rep)}")
    policy_equal(untrained(rep), POLICY_REFERENCE, "policy 13.2")
    for tenant, v in run["versions"].items():
        served = [rep["tenants"][tenant]["snapshot_version"]] + [
            h["tenants"][tenant]["snapshot_version"]
            for h in rep["per_host"].values() if tenant in h["tenants"]]
        if served[0] != v or not all(1 <= s <= v for s in served):
            raise AssertionError(f"{tenant}: served versions {served}, "
                                 f"{v} published")
    for name in ("stump_scan", *STUMP_KERNELS):
        if launches[name] <= 0:
            raise AssertionError(f"policy 13.2: {name} never launched")
    for name in STUMP_KERNELS:
        if sum(shapes[name].values()) != launches[name]:
            raise AssertionError(f"policy 13.2: {name} called "
                                 f"{sum(shapes[name].values())} times, "
                                 f"launched {launches[name]}")
    if len(scans) != launches["stump_scan"]:
        raise AssertionError(f"policy 13.2: {len(scans)} scans recorded "
                             f"for {launches['stump_scan']} launches")
    for args, got in scans:
        hold_backends("stump_scan", args, got)
    scan_shapes = Counter(tuple(a[0].shape) + (a[3].shape[1],)
                          for a, _ in scans)
    log(f"policy 13.2: every stump_scan of the run ({len(scans)}, "
        f"(N, F, T) {dict(scan_shapes)}) bit-equal to the plain version "
        f"on its own inputs")
    policies = [dispatch.default_policy(),
                *table_policies(run["server"].policy_table)]
    choices = [sorted(set(p.choices.values())) for p in policies]
    log(f"policy 13.2: choices of the default policy and the table's "
        f"{len(policies) - 1} kernel polic(ies): {choices}; buckets "
        f"{sorted(set(k for p in policies for k in p.choices))}")
    kernel = dispatch.platform_default(CARD)
    if any(c != [kernel] for c in choices):
        raise AssertionError(f"policy 13.2: choices {choices}")
    rows, _ = obs_report.kernel_profile(json.loads(metrics.read_text()))
    for r in rows:
        log(f"policy 13.2: kernel profile {r['kernel']} {r['bucket']} "
            f"{r['backend']}: {r['launches']} launches, p50 "
            f"{r['p50_s'] * 1e3:.4f} ms, p99 {r['p99_s'] * 1e3:.4f} ms")
    profiled = {r["kernel"] for r in rows if r["backend"] == kernel}
    if not {"stump_scan", *STUMP_KERNELS} <= profiled or \
            {r["backend"] for r in rows} != {kernel}:
        raise AssertionError(f"policy 13.2: kernel profile rows {rows}")
    meta, spans = obs.load_trace(str(trace))
    errors = obs_report.check_trace(spans, meta)
    log(f"policy 13.2: trace {len(spans)} spans, check_trace "
        f"{'clean' if not errors else errors[:5]}")
    if errors:
        raise AssertionError(f"policy 13.2: trace faults {errors[:5]}")
    log(f"policy 13.2: every field but the versions and staleness equals "
        f"the JAX package's run; served versions = the card's publishes "
        f"{run['versions']}")

    # (3) the same arrivals over copies of the trained cluster
    def replay(device, table_path):
        dispatch.set_default_policy(KernelPolicy())
        table = PolicyTable.load(table_path)
        ops.reset_launches()
        got, restore_a = recording_answers()
        calls, restore_s = recording_stump_shapes()
        windows, rng_state, cfg = run["copy"]
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                server = se.serve(
                    shard_cluster_from_numpy(windows, cfg,
                                             rng_state=rng_state),
                    run["pools"], 400.0, 3.0, 0, kill_owner=True,
                    policy_table=table, autoscale_max=5, device=device)
        finally:
            restore_a()
            restore_s()
        policy_equal(server.report(), rep, f"policy 13.3 {device}")
        return got, calls, dict(ops.LAUNCHES), table
    t0 = time.perf_counter()
    cpu, _, _, _ = replay("cpu", POLICY_DIR / "policy_table.json")
    worst = answers_close(cpu, answers, "policy 13.3 cpu")
    log(f"policy 13.3: {len(cpu)} responses on a copy of the trained "
        f"cluster on the CPU's plain path: report equal to 13.2's, rid/"
        f"tenant/version equal, max |margin diff| {worst:.3g} "
        f"({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    pinned = json.loads(json.dumps(POLICY_TABLE))
    pinned["tenants"]["iot"]["kernel"]["backend"] = "torch"
    policy_argv(POLICY_DIR, pinned, "pinned_table.json")
    card, calls, pin_launches, table = replay(
        CARD, POLICY_DIR / "pinned_table.json")
    worst = answers_close(card, answers, "policy 13.3 pinned")
    iot = table.kernel_for("iot", None)
    split = {"default": sorted(set(dispatch.default_policy().choices
                                   .values())),
             "iot": sorted(set(iot.choices.values()))}
    n_calls = {k: sum(c.values()) for k, c in calls.items()}
    log(f"policy 13.3: iot pinned to torch on {CARD}: launches "
        f"{pin_launches}; vote calls {n_calls}; choices {split}; max "
        f"|margin diff| vs 13.2 {worst:.3g}; report equal to 13.2's "
        f"({time.perf_counter() - t0:.2f} s)")
    if split != {"default": [kernel], "iot": ["torch"]} or \
            pin_launches["stump_vote_fp_batched"] != 0 or \
            n_calls["stump_vote_fp_batched"] <= 0 or \
            pin_launches["stump_vote_batched"] != \
            n_calls["stump_vote_batched"] or \
            pin_launches["stump_vote_batched"] <= 0:
        raise AssertionError("policy 13.3: the launches did not split by "
                             "policy")

    # (4) the dispatcher's host cost a call
    dispatch.set_default_policy(KernelPolicy())
    args = vote_inputs(gen, 1, 477, 1, 0)
    us = host_us({"wrapper": lambda: ops.stump_vote_batched(*args),
                  "launch_code": lambda: ops._stump_vote_batched_cuda(*args)})
    added = us["wrapper"]["median"] - us["launch_code"]["median"]
    event_ms = cuda_ms(lambda: ops.stump_vote_batched(*args), 50)
    fleet = sum(fleet_launches.values())
    log(f"policy 13.4: ops.stump_vote_batched at (1, 477, 1), host us a "
        f"call in turns: wrapper {json.dumps(us['wrapper'])}, the cuda "
        f"backend's launch code {json.dumps(us['launch_code'])}: the "
        f"dispatcher adds {added:.2f} us a call, whose event time is "
        f"{event_ms:.4f} ms; phase 7.2's full-width fleet run made "
        f"{fleet} dispatched launches, so {added * fleet / 1e3:.4f} ms of "
        f"its wall | {nvidia_smi()}")
    dispatch.set_default_policy(old_policy)
    return launches


# ------------------------------------------------------------ phase 14
MESH_RUNS = ("edge_vision", "blockchain", "mobile", "iot", "healthcare",
             "mobile_x4")
MESH_CAP = 8
MESH_REQUESTS = 256
# the CPU replay of a card round against the card's: the vote's plain
# version sums in another order, so a sum carries the rounding of its
# partial sums, up to a few f32 ulps of l1, the sum of the summed terms'
# magnitudes (as ``close`` allows).  D = D0*exp(-y*s) over a sync's l1 =
# sum |alpha| of its gathered stumps: D within MESH_TOL * (1 + l1) of
# itself; val_margin within MESH_TOL * (1 + the ensemble's sum |alpha|);
# every other float within rtol/atol MESH_TOL
MESH_TOL = 1e-5
# The JAX package's runs of the same configurations, on a CPU (K
# placeholder devices, an Auto-axes mesh):
#   PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/fed_mesh_reference.py
# The port's own run may split from it at an exact stump tie (C4); its
# summary is printed beside this one.  first_nonfinite_D: the reference's
# foreign-learner update multiplies K*cap factors exp(-alpha*y*m) in f32,
# which overflows at mobile_x4's 128 clients (ROADMAP C7); the port keeps
# those semantics.
MESH_REFERENCE = json.loads("""
{"edge_vision": {"ens_count": 900, "syncs": 14, "interval_first": 2.0,
"interval_last": 8.0, "val_err": 0.36000001430511475,
"first_nonfinite_D": null}, "blockchain": {"ens_count": 608, "syncs": 13,
"interval_first": 2.0, "interval_last": 8.0, "val_err": 0.20698924362659454,
"first_nonfinite_D": null}, "mobile": {"ens_count": 2464, "syncs": 19,
"interval_first": 2.0, "interval_last": 5.0, "val_err": 0.3582589328289032,
"first_nonfinite_D": null}, "iot": {"ens_count": 1824, "syncs": 13,
"interval_first": 2.0, "interval_last": 8.0, "val_err": 0.2866666615009308,
"first_nonfinite_D": null}, "healthcare": {"ens_count": 468, "syncs": 16,
"interval_first": 2.0, "interval_last": 8.0, "val_err": 0.37555554509162903,
"first_nonfinite_D": null}, "mobile_x4": {"ens_count": 9344, "syncs": 13,
"interval_first": 2.0, "interval_last": 8.0, "val_err": 0.2843191921710968,
"first_nonfinite_D": 5}}
""")
MESH_INTS = ("buf_stamp", "buf_count", "ens_count", "counter", "last_sync",
             "sync_count")
# 14.5: one paper domain and the largest K, run again through
# ``fed_mesh._Group`` over a one-rank NCCL group on the card
MESH_NCCL_RUNS = ("edge_vision", "mobile_x4")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, a NaN matching a NaN in the same place (the kernel and
    the plain version make NaNs with other payloads)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        a[~na].view(torch.int32), b[~nb].view(torch.int32))


def mesh_data(name: str, device):
    """K and the (K, n, F)/(K, n) client shards and (K, nv, F)/(K, nv)
    validation slices of a domain at its registered size, K its
    ``n_clients``, each shard cut to the smallest client's rows (as the
    JAX package's mesh test stacks them), on ``device``; and the test
    set as numpy."""
    from repro_torch.data import make_domain_data
    from repro_torch.sim.scenarios import SCENARIOS
    dom = SCENARIOS[name].domain
    K = dom.n_clients
    data = make_domain_data(dom, seed=0)
    n = min(c[0].shape[0] for c in data["clients"])
    x = np.stack([c[0][:n] for c in data["clients"]])
    y = np.stack([c[1][:n] for c in data["clients"]])
    xv, yv = data["val"]
    nv = xv.shape[0] // K
    arrays = (x, y, xv[:K * nv].reshape(K, nv, -1), yv[:K * nv].reshape(K, nv))
    return (K, *(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays), data["test"])


def mesh_close(got: dict, want: dict, prev_count: int, label: str) -> int:
    """A CPU replay of one round (``got``, numpy under the reference's
    field names) from a state of ``prev_count`` learners against the
    card's (``want``): integer fields equal, picks (feature, threshold,
    polarity) equal, floats within MESH_TOL's rules, NaNs where the card
    has them.  The global error may differ only where validation margins
    within rounding of 0 flipped a prediction, and then the interval with
    it.  Returns the flipped predictions and D's largest relative gap
    over 1 + l1."""
    alphas = np.abs(want["ens_alpha"].astype(np.float64))
    l1_sync = float(alphas[prev_count:int(want["ens_count"])].sum())
    l1_all = float(alphas[:int(want["ens_count"])].sum())
    def close(f, rtol, atol):
        g, w = torch.from_numpy(got[f]), torch.from_numpy(want[f])
        if not torch.allclose(g, w, rtol=rtol, atol=atol, equal_nan=True):
            raise AssertionError(f"{label}: {f} off by "
                                 f"{float((g - w).abs().nan_to_num().max())}")
    for f in MESH_INTS:
        if not np.array_equal(got[f], want[f]):
            raise AssertionError(f"{label}: {f} {got[f]} != {want[f]}")
    for f in ("buf_params", "ens_params"):
        if not same_bits(torch.from_numpy(got[f][..., :3].copy()),
                         torch.from_numpy(want[f][..., :3].copy())):
            raise AssertionError(f"{label}: {f} picks differ")
    close("D", MESH_TOL * (1.0 + l1_sync), 1e-30)
    gd, wd = got["D"].astype(np.float64), want["D"].astype(np.float64)
    ok = np.isfinite(wd) & (wd > 0)
    d_gap = float(np.max(np.abs(gd[ok] - wd[ok]) / wd[ok], initial=0.0)) \
        / (1.0 + l1_sync)
    close("val_margin", MESH_TOL, MESH_TOL * (1.0 + l1_all))
    for f in ("buf_params", "ens_params", "ens_alpha"):
        close(f, MESH_TOL, MESH_TOL)
    if got["prev_err"] == want["prev_err"]:
        if got["interval"] != want["interval"]:
            raise AssertionError(f"{label}: interval {got['interval']} != "
                                 f"{want['interval']}")
        return 0, d_gap
    vg, vw = got["val_margin"], want["val_margin"]
    flips = (vg > 0) != (vw > 0)
    scale = MESH_TOL * (1.0 + l1_all)
    if not flips.any() or (np.abs(vw[flips]) > scale).any():
        raise AssertionError(f"{label}: prev_err {got['prev_err']} != "
                             f"{want['prev_err']} without a margin at 0")
    return int(flips.sum()), d_gap


def mesh_path():
    """Phase 14: the mesh-integrated federated boost on the card.  (1) The
    five paper domains and mobile_x4 at their registered sizes, K = each
    one's ``n_clients``, ``FedBoostConfig(n_clients=K)`` for its 80 rounds,
    buffer cap 8, ``ens_cap = K * n_rounds``: every round's fits one
    ``stump_scan_batched`` launch, every sync two ``stump_vote_batched``
    launches (counts zeroed by the caller just before, read here just
    after the last run), every dispatched choice ``cuda``.  (2) Every scan
    of the runs bit-equal to the plain version on its own inputs.  (3)
    Each run replayed on the CPU in lockstep: round r from the card's state
    r-1 (``convert.fed_mesh_state_to_numpy`` and back).  (4) Each final
    ensemble published into a registry and 256 requests from the domain's
    test set answered through ``BatchEvaluator`` on the card and on the
    CPU.  (5) Two of the runs again over a one-rank NCCL group
    (:func:`mesh_nccl`).  Returns the launches of (1)."""
    from repro_torch.configs.paper_fedboost import FedBoostConfig
    from repro_torch.convert import (fed_mesh_state_from_numpy,
                                     fed_mesh_state_to_numpy)
    from repro_torch.core import fed_mesh
    from repro_torch.kernels import ops
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.models.weak import stump_thresholds
    from repro_torch.serve import BatchEvaluator, EnsembleRegistry
    from repro_torch.serve.batching import Request
    smi = nvidia_smi()
    scan = ops.stump_scan_batched
    scans = []

    def recorded(*args, **kw):
        out = scan(*args, **kw)
        scans.append((args, out))
        return out
    ops.stump_scan_batched = recorded
    runs = {}
    kernels = ("stump_scan_batched", "stump_vote_batched")
    try:
        for name in MESH_RUNS:
            K, x, y, xv, yv, test = mesh_data(name, CARD)
            cfg = FedBoostConfig(n_clients=K)
            policy = KernelPolicy(env_var=None)
            thr = stump_thresholds(x.reshape(-1, x.shape[-1]))
            step = fed_mesh.make_fed_boost_step(cfg, thr, policy=policy)
            s = fed_mesh.init_state(cfg, K, x.shape[1], xv.shape[1],
                                    MESH_CAP, K * cfg.n_rounds, device=CARD)
            before, first_scan = dict(ops.LAUNCHES), len(scans)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states = [s]
            for _ in range(cfg.n_rounds):
                s = step(s, x, y, xv, yv)
                states.append(s)
            torch.cuda.synchronize()
            runs[name] = dict(
                K=K, data=(x, y, xv, yv, test), thr=thr, cfg=cfg,
                states=states, policy=policy,
                wall_s=time.perf_counter() - t0,
                scans=scans[first_scan:],
                launches={k: ops.LAUNCHES[k] - before[k] for k in kernels})
    finally:
        ops.stump_scan_batched = scan
    launches = dict(ops.LAUNCHES)

    for name, r in runs.items():
        s, L = r["states"][-1], r["launches"]
        ints = [float(st.interval) for st in r["states"][1:]]
        bad = next((i for i, st in enumerate(r["states"][1:])
                    if not bool(torch.isfinite(st.D).all())), None)
        mine = dict(ens_count=s.ens_count, syncs=s.sync_count,
                    interval_first=ints[0], interval_last=ints[-1],
                    val_err=float(s.prev_err), first_nonfinite_D=bad)
        choices = sorted(set(r["policy"].choices.values()))
        log(f"mesh 14.1 {name}: K={r['K']} n_local={r['data'][0].shape[1]} "
            f"n_val_local={r['data'][2].shape[1]} rounds={s.counter} "
            f"syncs={s.sync_count} ens_count={s.ens_count} interval "
            f"{ints[0]} -> {ints[-1]} val_err={mine['val_err']:.6f} "
            f"first_nonfinite_D={bad} wall_s={r['wall_s']:.4f} launches "
            f"{L} choices {choices} | JAX package's: "
            f"{MESH_REFERENCE[name]} | {smi}")
        if L["stump_scan_batched"] != s.counter or \
                L["stump_vote_batched"] != 2 * s.sync_count or \
                len(r["scans"]) != s.counter:
            raise AssertionError(f"mesh 14.1 {name}: launches {L} for "
                                 f"{s.counter} rounds, {s.sync_count} syncs")
        if choices != ["cuda"]:
            raise AssertionError(f"mesh 14.1 {name}: choices {choices}")
        if not math.isfinite(mine["val_err"]) or \
                bad != MESH_REFERENCE[name]["first_nonfinite_D"]:
            raise AssertionError(f"mesh 14.1 {name}: val_err "
                                 f"{mine['val_err']}, first non-finite D "
                                 f"at {bad}")

    t0 = time.perf_counter()
    n_scans = 0
    for name, r in runs.items():
        for args, got in r["scans"]:
            want = ops.stump_scan_batched(*args, backend="torch",
                                          policy=KernelPolicy(env_var=None))
            if not same_bits(got, want):
                raise AssertionError(f"mesh 14.2 {name}: a scan at "
                                     f"{tuple(args[0].shape)} is not "
                                     f"bit-equal to the plain version")
            n_scans += 1
    log(f"mesh 14.2: every scan of the six runs ({n_scans}) bit-equal to "
        f"the plain version on its own inputs "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    for name, r in runs.items():
        x, y, xv, yv, _ = (host(a) if isinstance(a, torch.Tensor) else a
                           for a in r["data"])
        step = fed_mesh.make_fed_boost_step(r["cfg"], host(r["thr"]))
        card = [fed_mesh_state_to_numpy(st) for st in r["states"]]
        flips, d_gap = 0, 0.0
        for i in range(len(card) - 1):
            got = step(fed_mesh_state_from_numpy(card[i]), x, y, xv, yv)
            f, g = mesh_close(fed_mesh_state_to_numpy(got), card[i + 1],
                              int(card[i]["ens_count"]),
                              f"mesh 14.3 {name} round {i}")
            flips, d_gap = flips + f, max(d_gap, g)
        log(f"mesh 14.3 {name}: {len(card) - 1} rounds replayed on the CPU "
            f"in lockstep from the card's states: integer fields and picks "
            f"equal, D within {d_gap:.3g} * (1 + l1) of itself (tol "
            f"{MESH_TOL}), other floats within tolerance; {flips} "
            f"validation prediction(s) flipped at a margin within rounding "
            f"of 0")
    log(f"mesh 14.3: replays took {time.perf_counter() - t0:.1f} s")

    registry = EnsembleRegistry()
    for name, r in runs.items():
        snap = fed_mesh.publish_snapshot(r["states"][-1], registry, name)
        test_x = np.asarray(r["data"][4][0], np.float32)[:MESH_REQUESTS]
        reqs = [Request(rid=i, tenant=name, x=test_x[i], t_submit=0.0)
                for i in range(len(test_x))]
        before = ops.LAUNCHES["stump_vote_batched"]
        card = BatchEvaluator(registry, device=CARD).evaluate(reqs)
        torch.cuda.synchronize()
        votes = ops.LAUNCHES["stump_vote_batched"] - before
        cpu = BatchEvaluator(registry, device="cpu").evaluate(reqs)
        got = torch.tensor([c.margin for c in card], dtype=torch.float64)
        want = torch.tensor([c.margin for c in cpu], dtype=torch.float64)
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / (1.0 + want.abs())).max())
        if [c.snapshot_version for c in card] != [snap.version] * len(reqs) \
                or not torch.allclose(got, want, rtol=MESH_TOL, atol=MESH_TOL):
            raise AssertionError(f"mesh 14.4 {name}: margins off by {err}")
        log(f"mesh 14.4 {name}: v{snap.version} of {len(snap.alphas)} "
            f"learners, {len(reqs)} requests through BatchEvaluator "
            f"({votes} vote launches), margins within {err:.3g} of the "
            f"CPU's ({rel:.3g} of 1 + |margin|; tol rtol/atol {MESH_TOL})")
    mesh_nccl(runs, smi)
    return {k: launches[k] for k in kernels}


def mesh_nccl(runs: dict, smi: str) -> None:
    """14.5: ``MESH_NCCL_RUNS`` run again for their 80 rounds with
    ``group=`` a one-rank NCCL process group on the card: every gather and
    sum goes through ``fed_mesh._Group`` (``all_gather_into_tensor`` and
    ``all_reduce`` over NCCL, on the path a group of four cards takes).
    Each run's final state, leaf for leaf, is held bit-equal to the same
    run's one-process state from 14.1, and its launches to that run's.
    The group is started here and destroyed before this returns; a group
    that does not start fails the phase (nothing falls back to gloo or the
    CPU)."""
    import socket
    import torch.distributed as dist
    from repro_torch.convert import fed_mesh_state_to_numpy
    from repro_torch.core import fed_mesh
    from repro_torch.kernels import ops
    from repro_torch.kernels.dispatch import KernelPolicy
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            device_id=torch.device(CARD, 0))
    try:
        group = dist.group.WORLD
        if dist.get_backend(group) != "nccl":
            raise AssertionError(f"mesh 14.5: backend "
                                 f"{dist.get_backend(group)}, not nccl")
        for name in MESH_NCCL_RUNS:
            r = runs[name]
            x, y, xv, yv, _ = r["data"]
            cfg, K = r["cfg"], r["K"]
            policy = KernelPolicy(env_var=None)
            step = fed_mesh.make_fed_boost_step(cfg, r["thr"], group=group,
                                                policy=policy)
            s = fed_mesh.init_state(cfg, K, x.shape[1], xv.shape[1],
                                    MESH_CAP, K * cfg.n_rounds, device=CARD)
            before = dict(ops.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(cfg.n_rounds):
                s = step(s, x, y, xv, yv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            L = {k: ops.LAUNCHES[k] - before[k] for k in r["launches"]}
            got = fed_mesh_state_to_numpy(s)
            want = fed_mesh_state_to_numpy(r["states"][-1])
            for f, w in want.items():
                g = got[f]
                if g.dtype != w.dtype or g.shape != w.shape or (
                        not same_bits(torch.from_numpy(np.ascontiguousarray(
                            g)).reshape(-1), torch.from_numpy(
                                np.ascontiguousarray(w)).reshape(-1))
                        if w.dtype == np.float32 else
                        not np.array_equal(g, w)):
                    raise AssertionError(f"mesh 14.5 {name}: {f} is not "
                                         f"bit-equal to 14.1's")
            if L != r["launches"]:
                raise AssertionError(f"mesh 14.5 {name}: launches {L}, "
                                     f"14.1's {r['launches']}")
            log(f"mesh 14.5 {name}: K={K} over a one-rank NCCL group "
                f"({dist.get_backend(group)}, world "
                f"{dist.get_world_size(group)}): {s.counter} rounds, "
                f"syncs={s.sync_count} ens_count={s.ens_count} interval "
                f"{float(s.interval)} val_err={float(s.prev_err):.6f}, "
                f"every leaf of the final state ({len(want)}) bit-equal to "
                f"14.1's one-process run; launches {L}; wall_s={wall:.4f} "
                f"(14.1's {r['wall_s']:.4f}) | {smi}")
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ phase 15
TRAIN_ARCH = "qwen1.5-0.5b"        # repro.launch.train's default --arch
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 512, 10, 3e-3
TRAIN_LOCK_LAYERS, TRAIN_LOCK_SEQ = 2, 64
# card against the CPU on one step's loss (f32 sums in other orders) and
# each gradient, as a share of its leaf's largest magnitude (the same
# rounding through the backward pass; tests/test_torch_lm.py holds a
# reduced model to it on the card)
TRAIN_LOSS_REL = 1e-4
TRAIN_GRAD_REL = 1e-4
TRAIN_CKPT_DIR = ROOT / "build" / "train_ckpt"


def lm_train() -> dict:
    """Phase 15: LM training on the card.  (1) ``train_loop`` on
    qwen1.5-0.5b at full width and depth (``--preset full``), batch 4, seq
    512, 10 steps, lr 3e-3: the loss a step (finite, near ln V), ms a
    step, peak memory, the launches (``flash_attention`` must stay at 0:
    attention under autograd takes the chunked softmax); then the same
    train step 10 times on step 0's batch from the same init, whose loss
    must fall, and one more step traced; (2) one step's loss and
    gradients at two layers of full width (seq 64) on the card and on the
    CPU from the same weights; (3) a checkpoint at the reduced size written at step 3 and
    read back bit for bit in the JAX package's format, then resumed to
    step 5.  Returns the launches of (1)."""
    import dataclasses
    import shutil
    from repro_torch import checkpoint
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.tokens import MarkovTokens
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import Model, attention
    from repro_torch.optim import adamw, cosine_schedule
    smi = nvidia_smi()
    cfg = get_arch(TRAIN_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    ops.reset_launches()
    routes = dict(attention.ROUTES)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        params, losses = train.train_loop(
            cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            lr=TRAIN_LR, log_every=1, device=CARD, step_s=step_s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    grad_calls = attention.ROUTES["chunked_grad"] - routes["chunked_grad"]
    n_params = sum(t.numel() for t in params.parameters())
    log(f"train 15.1 {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, {n_params:,} params f32, "
        f"AdamW; batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, {TRAIN_STEPS} steps "
        f"in {wall:.2f} s; launches {launches}; attention calls under "
        f"autograd {grad_calls} (flash "
        f"{attention.ROUTES['flash'] - routes['flash']}) | {smi}")
    for i, (loss, s) in enumerate(zip(losses, step_s)):
        log(f"train 15.1 step {i}: loss {loss:.6f} ms {1e3 * s:.1f}")
    sec = statistics.median(step_s[1:])
    log(f"train 15.1: median ms a step {1e3 * sec:.1f} (first "
        f"{1e3 * step_s[0]:.1f}), tokens/s {TRAIN_BATCH * TRAIN_SEQ / sec:.0f}"
        f", peak_mem_gb {peak / 1e9:.3f} | {smi}")
    if sum(line.startswith("step ") for line in
           out.getvalue().splitlines()) != TRAIN_STEPS:
        raise AssertionError(f"train 15.1: log {out.getvalue()!r}")
    if launches["flash_attention"] != 0 or grad_calls < 2 * cfg.n_layers:
        raise AssertionError(f"train 15.1: flash launched "
                             f"{launches['flash_attention']} times, "
                             f"{grad_calls} attention calls under autograd")
    # a fresh batch a step at a 151,936-token vocab: each transition of the
    # Markov stream is seen about once, so 10 steps cannot learn it and the
    # loss stays near ln V; it must stay finite and near it
    if not all(abs(v - math.log(cfg.vocab_size)) < 1.0 for v in losses):
        raise AssertionError(f"train 15.1: losses {losses}")
    # the same train step learns: 10 steps on step 0's batch from the
    # same init, with train_loop's optimizer and schedule
    del params
    model = Model(cfg, device=CARD)
    params = model.init(torch.Generator(CARD).manual_seed(0))
    params.requires_grad_(True)
    b = next(MarkovTokens(cfg.vocab_size, seed=0).batches(
        TRAIN_BATCH, TRAIN_SEQ, 1))
    b = {k: torch.from_numpy(v).to(CARD) for k, v in b.items()}
    opt = adamw(cosine_schedule(TRAIN_LR, 1, TRAIN_STEPS), b2=0.95,
                weight_decay=0.01)
    ost = opt.init(list(params.parameters()))
    step = train.make_train_step(model, params, opt)
    fixed = []
    for i in range(TRAIN_STEPS):
        loss, _, ost = step(b, i, ost)
        fixed.append(float(loss))
    log(f"train 15.1b: {TRAIN_STEPS} steps on step 0's batch from the "
        f"same init: losses "
        f"{[round(v, 4) for v in fixed]}; flash launches "
        f"{ops.LAUNCHES['flash_attention']}")
    if not fixed[-1] < fixed[0] or ops.LAUNCHES["flash_attention"]:
        raise AssertionError(f"train 15.1b: losses {fixed}")
    # one more step traced, for the card's busy share and time by kernel
    with cuda_profile() as prof:
        t0 = time.perf_counter()
        loss, _, ost = step(b, TRAIN_STEPS, ost)
        float(loss)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = device_us_by_name(prof)
    busy_ms = sum(by_name.values()) / 1e3
    n_ops = sum(evt.device_type == torch.autograd.DeviceType.CUDA
                for evt in prof.events())
    log(f"profile train step: wall_ms={wall_ms:.1f} device_busy_ms="
        f"{busy_ms:.2f} idle_share={1 - busy_ms / wall_ms:.4f} "
        f"device_ops={n_ops} | {smi}")
    for key, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"profile train step:   {us / 1e3:9.3f} ms  {key}")
    del params, ost, step

    # (2) one step, card against the CPU, at two layers of full width
    t0 = time.perf_counter()
    small = dataclasses.replace(cfg, n_layers=TRAIN_LOCK_LAYERS)
    model = Model(small, device=CARD)
    params = model.init(torch.Generator(CARD).manual_seed(0))
    cpu = Model(small, device="cpu")
    cpu_params = cpu.init()
    cpu_params.load_state_dict(params.state_dict())
    b = next(MarkovTokens(small.vocab_size, seed=0).batches(
        TRAIN_BATCH, TRAIN_LOCK_SEQ, 1))
    res = []
    for m, p in ((model, params), (cpu, cpu_params)):
        p.requires_grad_(True)
        before = ops.LAUNCHES["flash_attention"]
        loss, _ = m.loss(p, {k: torch.from_numpy(v).to(m.device)
                             for k, v in b.items()})
        grads = torch.autograd.grad(loss, list(p.parameters()))
        if ops.LAUNCHES["flash_attention"] != before:
            raise AssertionError("train 15.2: flash launched under autograd")
        res.append((float(loss.detach()), [host(g) for g in grads]))
    (loss, grads), (want_loss, want) = res
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    worst = max(float((g - w).abs().max()) / float(w.abs().max())
                for g, w in zip(grads, want))
    log(f"train 15.2 {small.name} {TRAIN_LOCK_LAYERS} layers, seq "
        f"{TRAIN_LOCK_SEQ}: loss {loss:.6f} on the card, {want_loss:.6f} on "
        f"the CPU (rel {loss_rel:.3g}, tol {TRAIN_LOSS_REL}); {len(grads)} "
        f"gradients within {worst:.3g} of each leaf's largest (tol "
        f"{TRAIN_GRAD_REL}) ({time.perf_counter() - t0:.1f} s) | {smi}")
    if loss_rel > TRAIN_LOSS_REL or worst > TRAIN_GRAD_REL:
        raise AssertionError("train 15.2: card and CPU differ")
    del params, cpu_params, grads, want

    # (3) a checkpoint at the reduced size: written at step 3, read back
    t0 = time.perf_counter()
    rcfg = reduced(cfg)
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    kw = dict(batch=TRAIN_BATCH, seq=64, lr=TRAIN_LR, device=CARD,
              ckpt_dir=str(TRAIN_CKPT_DIR))
    with contextlib.redirect_stdout(io.StringIO()):
        params, _ = train.train_loop(rcfg, steps=3, **kw)
    fresh = Model(rcfg, device=CARD).init(torch.Generator(CARD).manual_seed(9))
    opt = adamw(TRAIN_LR)
    ost = opt.init(list(fresh.parameters()))
    like = train.checkpoint_tree(fresh, ost, rcfg)
    tree, step, _ = checkpoint.restore(str(TRAIN_CKPT_DIR), like)
    ost = train.load_checkpoint_tree(tree, fresh, ost, rcfg)
    path = TRAIN_CKPT_DIR / "step_00000003"
    manifest = json.loads((path / "manifest.json").read_text())
    saved = np.load(path / "arrays.npz")
    back = checkpoint.checkpoint._flatten_with_paths(
        train.checkpoint_tree(fresh, ost, rcfg))
    if step != 3 or manifest["keys"] != sorted(back) or any(
            manifest["shapes"][k] != list(v.shape) or
            manifest["dtypes"][k] != "float32" for k, v in back.items()):
        raise AssertionError(f"train 15.3: manifest {manifest['keys'][:4]}")
    for k in ("0/embed", "0/blocks/0/attn/wq", "1/m/blocks/0/mlp/w_down",
              "1/v/final_norm"):
        if k not in back:
            raise AssertionError(f"train 15.3: no leaf {k}")
    for k, v in back.items():
        if not np.array_equal(host(v).numpy(), saved[k]):
            raise AssertionError(f"train 15.3: {k} not read back bit for "
                                 f"bit")
    for (n, p), q in zip(params.named_parameters(), fresh.parameters()):
        if not torch.equal(p, q):
            raise AssertionError(f"train 15.3: {n} differs from the trained "
                                 f"param")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        _, resumed = train.train_loop(rcfg, steps=5, **kw)
    if "resumed from step 3" not in out.getvalue() or len(resumed) != 2 \
            or checkpoint.latest_step(str(TRAIN_CKPT_DIR)) != 5:
        raise AssertionError(f"train 15.3: resume {out.getvalue()!r}")
    log(f"train 15.3 {rcfg.name}: checkpoint at step 3, {len(back)} leaves "
        f"in the JAX package's stacked layout, read back bit for bit into "
        f"params and AdamW moments; resumed to step 5 (losses "
        f"{[round(v, 4) for v in resumed]}) "
        f"({time.perf_counter() - t0:.1f} s)")
    return launches


# ------------------------------------------------------------ phase 16
FAM_BATCH, FAM_PROMPT, FAM_NEW = 4, 512, 32
FAM_MOE, FAM_MOE_LAYERS = "qwen3-moe-30b-a3b", 8     # of 48: 22.4 GB in f32
FAM_SSM = "mamba2-1.3b"
FAM_HYBRID = "jamba-1.5-large-398b"
# one MoE layer of Jamba's full width is 38.6 GB in f32: one whole 8-layer
# period at reduced width instead
FAM_HYBRID_CUT = dict(n_layers=8, d_model=1024, max_experts=16)
FAM_ENCDEC, FAM_ENCDEC_PROMPT = "whisper-base", 32
FAM_LOCK_LAYERS = 2
# a pick of the card's router that differs from the CPU's must be a
# near-tie: the CPU's probabilities of the two experts this close (f32
# rounding of the router's inputs, a few layers deep)
FAM_NEAR_TIE = 1e-5
# mamba2 on the card: a layer's last output from prefill(T + 1) against
# prefill(T) plus one decode step, fed the same input, as a share of its
# largest magnitude (the chunked scan against the recurrence in f32)
FAM_STEP_REL = 1e-4
# (arch, layers or None for the config's own, batch, seq) of 16.5
FAM_TRAIN = ((FAM_MOE, 2, 2, 256), (FAM_SSM, 8, 4, 512),
             (FAM_ENCDEC, None, 4, 256))
FAM_TRAIN_STEPS = 5


@contextlib.contextmanager
def moe_picks(record=None, replay=None, ties=None):
    """Record the top-k picks of every MoE layer call in ``record`` (the
    card's run), or replay them: each MoE call takes the next recorded
    picks (``moe_apply(expert_idx=...)``, the CPU's run in lockstep), its
    own picks compared with them and every differing pick appended to
    ``ties`` as (call, b, t, k, own expert, card expert, |p own - p card|)
    from the CPU's router probabilities."""
    from repro_torch.models import moe
    route, apply = moe.route, moe.moe_apply
    calls = [0]

    def recording(p, x, m):
        out = route(p, x, m)
        record.append(out[2])
        return out

    def replaying(p, x, cfg, act="silu", expert_idx=None):
        card = replay[calls[0]].to(x.device)
        probs, _, own = route(p, x, cfg.moe)
        for b, t, k in (own != card).nonzero().tolist():
            o, c = int(own[b, t, k]), int(card[b, t, k])
            ties.append((calls[0], b, t, k, o, c,
                         abs(float(probs[b, t, o] - probs[b, t, c]))))
        calls[0] += 1
        return apply(p, x, cfg, act, expert_idx=card)
    try:
        if record is not None:
            moe.route = recording
        if replay is not None:
            moe.moe_apply = replaying
        yield calls
    finally:
        moe.route, moe.moe_apply = route, apply


def flash_per_prefill(cfg) -> int:
    """``flash_attention`` launches in one prefill: every full causal
    attention layer without softcap (qwen3-moe 8 of 8 at the cut depth,
    Jamba 1 of 8, whisper's 6 decoder layers) and, in full mode, every
    encoder layer (whisper's 6)."""
    from repro_torch.models import transformer
    if cfg.is_encoder_decoder:
        return cfg.n_encoder_layers + cfg.n_layers
    return sum(kind == "attn" and cfg.attn_softcap == 0
               for kind, _ in transformer.layer_kinds(cfg))


def family_frames(cfg, batch, device, seed=3):
    if not cfg.is_encoder_decoder:
        return None
    return torch.randn((batch, cfg.encoder_seq, cfg.d_model), device=device,
                       generator=torch.Generator(device).manual_seed(seed))


def family_lockstep(cfg, params, prompts, frames, label: str, smi: str):
    """The card's ``generate`` over ``params`` (picks of every MoE layer
    recorded), then the same params on the CPU replaying the prefill and
    every decode step in lockstep, fed the card's tokens and, in each MoE
    layer, the card's picks (the CPU's own picks must tie them): logits as
    a share of the largest |logit| within ``LM_PREFILL_REL`` and
    ``LM_DECODE_REL``, as phase 10 holds them, greedy tokens equal where
    the top-two gap is clear.  Returns the near-ties."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import Model
    S = prompts.shape[1] + FAM_NEW
    picks, steps = [], []
    with moe_picks(record=picks):
        seqs = generate(Model(cfg, device=CARD), params, prompts, FAM_NEW,
                        cache_len=S, frames=frames, step_logits=steps)
    t0 = time.perf_counter()
    cpu = Model(cfg, device="cpu")
    cpu_params = cpu.init()
    cpu_params.load_state_dict(params.state_dict())
    T0 = prompts.shape[1]
    batch = {"tokens": prompts.cpu()}
    if frames is not None:
        batch["frames"] = frames.cpu()
    seqs = seqs.cpu()
    ties, rels, compared, skipped = [], [], 0, 0
    with torch.no_grad(), moe_picks(replay=picks, ties=ties) as calls:
        logits, caches = cpu.prefill(cpu_params, batch, cache_seq=S)
        for i in range(FAM_NEW + 1):
            card = steps[i].cpu()
            scale = float(logits.abs().max())
            rel = float((card - logits).abs().max()) / scale
            rels.append(rel)
            if rel > (LM_PREFILL_REL if i == 0 else LM_DECODE_REL):
                raise AssertionError(f"{label} step {i}: card logits "
                                     f"{rel:.3g} of the largest |logit| "
                                     f"from the CPU's")
            if i == FAM_NEW:
                break
            tok = seqs[:, T0 + i]
            top2 = torch.topk(logits, 2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > LM_DECODE_REL * scale
            mine = torch.clamp(logits.argmax(-1), max=cfg.vocab_size - 1)
            if not torch.equal(mine[sure], tok[sure].long()):
                raise AssertionError(f"{label} step {i}: greedy tokens "
                                     f"differ where the top-two gap is "
                                     f"clear")
            compared += int(sure.sum())
            skipped += int((~sure).sum())
            logits, caches = cpu.decode_step(cpu_params, tok[:, None],
                                             caches, T0 + i)
    if calls[0] != len(picks):
        raise AssertionError(f"{label}: {calls[0]} MoE calls replayed of "
                             f"{len(picks)} recorded")
    n_picks = sum(p.numel() for p in picks)
    worst = max((t[-1] for t in ties), default=0.0)
    log(f"fam {label} lockstep on the CPU "
        f"({time.perf_counter() - t0:.1f} s): prefill logits within "
        f"{rels[0]:.3g} of the largest |logit| (tol {LM_PREFILL_REL}), "
        f"decode within {max(rels[1:]):.3g} (tol {LM_DECODE_REL}); greedy "
        f"tokens equal at {compared} of {compared + skipped} picks "
        f"({skipped} near-ties not compared); MoE picks {n_picks} in "
        f"{len(picks)} layer calls, {len(ties)} differ from the CPU's own "
        f"(largest probability gap {worst:.3g}, tol {FAM_NEAR_TIE}) | {smi}")
    for call, b, t, k, o, c, gap in ties:
        log(f"fam {label} near-tie: MoE call {call} row {b} token {t} "
            f"pick {k}: CPU expert {o}, card expert {c}, probability gap "
            f"{gap:.3g}")
    if worst > FAM_NEAR_TIE:
        raise AssertionError(f"{label}: a pick differs by {worst:.3g} in "
                             f"router probability")
    return ties


def family_serve(name: str, cfg, smi: str, lock_cfg=None) -> dict:
    """One family through ``generate`` on the card: counts zeroed just
    before the first call and read just after it (one prefill: the flash
    launches must be :func:`flash_per_prefill`), then prefill and generate timed
    and peak memory; then the CPU lockstep (:func:`family_lockstep`) over
    the whole model, or over ``lock_cfg``'s first layers of the same
    weights.  Returns the record of the run."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import Model, moe, transformer
    T0 = FAM_ENCDEC_PROMPT if cfg.is_encoder_decoder else FAM_PROMPT
    S = T0 + FAM_NEW
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=CARD)
    params = model.init(torch.Generator(CARD).manual_seed(0))
    n_params = sum(t.numel() for t in params.parameters())
    prompts = torch.randint(0, cfg.vocab_size, (FAM_BATCH, T0),
                            generator=torch.Generator(CARD).manual_seed(1),
                            device=CARD, dtype=torch.int32)
    frames = family_frames(cfg, FAM_BATCH, CARD)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    picks, steps = [], []
    ops.reset_launches()
    t0 = time.perf_counter()
    with moe_picks(record=picks):
        seqs = generate(model, params, prompts, FAM_NEW, cache_len=S,
                        frames=frames, step_logits=steps)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if launches["flash_attention"] != flash_per_prefill(cfg):
        raise AssertionError(f"fam {name}: flash_attention launched "
                             f"{launches['flash_attention']} times in one "
                             f"prefill, not {flash_per_prefill(cfg)}")
    if seqs.shape != (FAM_BATCH, S) or len(steps) != FAM_NEW + 1 or not all(
            torch.isfinite(x).all() for x in steps):
        raise AssertionError(f"fam {name}: wrong shape or non-finite logits")
    dropped = []
    if cfg.moe is not None:
        cap = moe.capacity(cfg.moe, T0)
        n_moe = sum(k == "moe" for _, k in transformer.layer_kinds(cfg))
        dropped = [int((~moe._slots(p, cfg.moe, cap)[0]).sum())
                   for p in picks[:n_moe]]
    batch = {"tokens": prompts}
    if frames is not None:
        batch["frames"] = frames
    with torch.no_grad():
        prefill_ms = cuda_ms(lambda: model.prefill(params, batch,
                                                   cache_seq=S), 3)
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        generate(model, params, prompts, FAM_NEW, cache_len=S, frames=frames)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    gen_s = min(walls)
    decode_ms = (1e3 * gen_s - prefill_ms) / FAM_NEW
    peak = torch.cuda.max_memory_allocated()
    rec = dict(layers=cfg.n_layers, d_model=cfg.d_model, params=n_params,
               flash_launches=launches["flash_attention"],
               prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
               generate_s=gen_s, tokens_per_s=FAM_BATCH * FAM_NEW / gen_s,
               peak_gb=peak / 1e9, dropped_at_prefill=dropped)
    log(f"fam {name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, {n_params:,} params f32 (init {init_s:.1f} s); "
        f"B={FAM_BATCH} prompt={T0} new={FAM_NEW}: launches {launches} "
        f"| {smi}")
    log(f"fam {name}: prefill_ms={prefill_ms:.3f} decode_ms_per_token="
        f"{decode_ms:.3f} generate_s={gen_s:.4f} (first {first_s:.3f}) "
        f"tokens_per_s={rec['tokens_per_s']:.1f} peak_mem_gb="
        f"{peak / 1e9:.3f} | {smi}")
    if cfg.moe is not None:
        log(f"fam {name}: tokens x picks dropped at capacity "
            f"{moe.capacity(cfg.moe, T0)} in the prefill, per MoE layer: "
            f"{dropped} of {FAM_BATCH * T0 * cfg.moe.top_k} each")
    del picks, steps, seqs
    if lock_cfg is None:
        rec["ties"] = len(family_lockstep(cfg, params, prompts, frames, name,
                                          smi))
    else:
        small = Model(lock_cfg, device=CARD).init()
        keep = {k: v for k, v in params.state_dict().items()
                if not k.startswith("blocks.")
                or int(k.split(".")[1]) < lock_cfg.n_layers}
        small.load_state_dict(keep)
        del params
        torch.cuda.empty_cache()
        rec["ties"] = len(family_lockstep(lock_cfg, small, prompts, frames,
                                          f"{name} ({lock_cfg.n_layers} "
                                          f"layers)", smi))
        del small
    torch.cuda.empty_cache()
    return rec


def mamba_step_check(cfg, smi: str) -> dict:
    """mamba2 on the card: a prefill over T + 1 tokens against a prefill
    over the first T plus one decode step (the chunked scan against the
    recurrence), layer by layer in lockstep: every Mamba layer takes the
    T + 1 prefill's input, and its last output from ``mamba_forward``
    over T + 1 rows must equal ``mamba_decode`` after ``mamba_forward``
    over T rows within ``FAM_STEP_REL`` of its largest magnitude.  The
    whole stack's two last logits are printed beside it: through 48
    random-init layers the f32 rounding of the two forms is amplified, as
    in the JAX package's own run of the same comparison, so that gap is
    reported, not held."""
    from repro_torch.models import Model, mamba, transformer
    from repro_torch.models.layers import embed_apply, rms_norm
    model = Model(cfg, device=CARD)
    params = model.init(torch.Generator(CARD).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (FAM_BATCH, FAM_PROMPT + 1),
                         generator=torch.Generator(CARD).manual_seed(1),
                         device=CARD, dtype=torch.int32)
    t0 = time.perf_counter()
    gaps = []
    with torch.no_grad():
        x = embed_apply(params.embed, toks)
        for lp in params.blocks:
            h = rms_norm(x, lp.norm1, cfg.norm_eps)
            full, _ = mamba.mamba_forward(lp.mamba, h, cfg)
            _, st = mamba.mamba_forward(lp.mamba, h[:, :-1], cfg)
            step, _ = mamba.mamba_decode(lp.mamba, h[:, -1:], st, cfg)
            gaps.append(float((step[:, 0] - full[:, -1]).abs().max())
                        / float(full[:, -1].abs().max()))
            x, _ = transformer._mlp_half(lp, x + full, cfg)
        want = transformer._head(params, x[:, -1], cfg)
        _, caches = model.prefill(params, {"tokens": toks[:, :-1]})
        got, _ = model.decode_step(params, toks[:, -1:], caches, FAM_PROMPT)
    rel = float((got - want).abs().max()) / float(want.abs().max())
    log(f"fam {FAM_SSM}: prefill over {FAM_PROMPT + 1} tokens against "
        f"prefill over {FAM_PROMPT} plus one decode step, per layer in "
        f"lockstep: the last output within {max(gaps):.3g} of its largest "
        f"(median {statistics.median(gaps):.3g}, tol {FAM_STEP_REL}); the "
        f"whole stack's last logits within {rel:.3g} of the largest "
        f"|logit| ({cfg.n_layers} layers, not held) "
        f"({time.perf_counter() - t0:.1f} s) | {smi}")
    if not max(gaps) <= FAM_STEP_REL:
        raise AssertionError(f"fam {FAM_SSM}: a layer's prefill(T+1) and "
                             f"prefill(T) + decode differ by {max(gaps):.3g}")
    del params
    torch.cuda.empty_cache()
    return {"layer_rel": max(gaps), "stack_rel": rel}


def family_train(smi: str) -> dict:
    """16.5: ``train_loop`` with AdamW, ``FAM_TRAIN_STEPS`` steps on each
    of ``FAM_TRAIN``: ms a step, tokens/s, peak memory, every loss finite
    and, with MoE layers, above its cross-entropy by the aux term; counts
    zeroed before the first run and read after the last (no
    ``flash_attention`` launch: attention under autograd takes the chunked
    softmax).  Then one step's loss and gradients at two layers of full
    width (seq 64), card against the CPU from the same weights, MoE picks
    in lockstep, without remat."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.tokens import MarkovTokens
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import Model, attention
    out = {}
    ops.reset_launches()
    routes = dict(attention.ROUTES)
    for name, layers, batch, seq in FAM_TRAIN:
        cfg = get_arch(name)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step_s = []
        with contextlib.redirect_stdout(io.StringIO()) as text:
            params, losses = train.train_loop(
                cfg, steps=FAM_TRAIN_STEPS, batch=batch, seq=seq,
                lr=TRAIN_LR, log_every=1, device=CARD, step_s=step_s)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        lines = [f.split() for f in text.getvalue().splitlines()
                 if f.startswith("step ")]
        ces = [float(f[5]) for f in lines]
        sec = statistics.median(step_s[1:])
        n_params = sum(t.numel() for t in params.parameters())
        log(f"fam train {name}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {n_params:,} params f32, AdamW; batch {batch} x "
            f"seq {seq}, {FAM_TRAIN_STEPS} steps: losses "
            f"{[round(v, 4) for v in losses]} (ce {ces}); median ms a step "
            f"{1e3 * sec:.1f} (first {1e3 * step_s[0]:.1f}), tokens/s "
            f"{batch * seq / sec:.0f}, peak_mem_gb {peak / 1e9:.3f} | {smi}")
        if len(lines) != FAM_TRAIN_STEPS or not all(
                math.isfinite(v) for v in losses):
            raise AssertionError(f"fam train {name}: losses {losses}")
        # the logged loss carries the aux term (printed to 4 decimals)
        if (cfg.moe is not None) != all(
                float(f[3]) > c for f, c in zip(lines, ces)):
            raise AssertionError(f"fam train {name}: aux term {lines}")
        out[name] = dict(layers=cfg.n_layers, batch=batch, seq=seq,
                         losses=losses, ms_per_step=1e3 * sec,
                         tokens_per_s=batch * seq / sec, peak_gb=peak / 1e9)
        del params
    grad_calls = attention.ROUTES["chunked_grad"] - routes["chunked_grad"]
    launches = dict(ops.LAUNCHES)
    log(f"fam train: launches {launches}; attention calls under autograd "
        f"{grad_calls} (flash {attention.ROUTES['flash'] - routes['flash']})")
    if launches["flash_attention"] != 0 or grad_calls == 0:
        raise AssertionError("fam train: flash launched under autograd")
    out["flash_launches"] = launches["flash_attention"]

    for name, _, _, _ in FAM_TRAIN:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_arch(name), n_layers=FAM_LOCK_LAYERS,
                                  **({"n_encoder_layers": FAM_LOCK_LAYERS}
                                     if get_arch(name).is_encoder_decoder
                                     else {}))
        model = Model(cfg, device=CARD)
        params = model.init(torch.Generator(CARD).manual_seed(0))
        cpu = Model(cfg, device="cpu")
        cpu_params = cpu.init()
        cpu_params.load_state_dict(params.state_dict())
        b = next(MarkovTokens(cfg.vocab_size, seed=0).batches(
            2, TRAIN_LOCK_SEQ, 1))
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        frames = family_frames(cfg, 2, "cpu")
        if frames is not None:
            b["frames"] = frames
        picks, ties, res = [], [], []
        for m, p, ctx in ((model, params, moe_picks(record=picks)),
                          (cpu, cpu_params, moe_picks(replay=picks,
                                                      ties=ties))):
            p.requires_grad_(True)
            before = ops.LAUNCHES["flash_attention"]
            with ctx:
                loss, _ = m.loss(p, {k: v.to(m.device) for k, v in b.items()},
                                 remat=False)
            grads = torch.autograd.grad(loss, list(p.parameters()))
            if ops.LAUNCHES["flash_attention"] != before:
                raise AssertionError("fam train: flash under autograd")
            res.append((float(loss.detach()), [host(g) for g in grads]))
        (loss, grads), (want_loss, want) = res
        loss_rel = abs(loss - want_loss) / abs(want_loss)
        worst = max(float((g - w).abs().max()) / float(w.abs().max())
                    for g, w in zip(grads, want))
        gap = max((t[-1] for t in ties), default=0.0)
        log(f"fam train {name} {FAM_LOCK_LAYERS} layers, seq "
            f"{TRAIN_LOCK_SEQ}: loss {loss:.6f} on the card, {want_loss:.6f} "
            f"on the CPU (rel {loss_rel:.3g}, tol {TRAIN_LOSS_REL}); "
            f"{len(grads)} gradients within {worst:.3g} of each leaf's "
            f"largest (tol {TRAIN_GRAD_REL}); MoE picks differing "
            f"{len(ties)} (gap {gap:.3g}) ({time.perf_counter() - t0:.1f} s)"
            f" | {smi}")
        if loss_rel > TRAIN_LOSS_REL or worst > TRAIN_GRAD_REL \
                or gap > FAM_NEAR_TIE:
            raise AssertionError(f"fam train {name}: card and CPU differ")
        out[name]["grad_rel"] = worst
        del params, cpu_params, grads, want
    torch.cuda.empty_cache()
    return out


def lm_families() -> dict:
    """Phase 16: the MoE, SSM, hybrid and encoder-decoder LM families on
    the card in f32 (TF32 off): 16.1 qwen3-moe-30b-a3b at full width, cut
    from 48 to 8 layers; 16.2 mamba2-1.3b at full size; 16.3 Jamba at
    reduced width over one whole 8-layer period; 16.4 whisper-base at full
    size, with its encoder's full-mode ``flash_attention`` held against the
    plain version at the encoder's shape; each served through
    ``generate`` (:func:`family_serve`), counts zeroed just before its
    first call and read just after; 16.5 training
    (:func:`family_train`).  Returns the records, with the flash launches
    of each counted run."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    import dataclasses
    smi = nvidia_smi()
    out = {}
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch(FAM_MOE), n_layers=FAM_MOE_LAYERS)
    out[FAM_MOE] = family_serve(
        FAM_MOE, cfg, smi,
        lock_cfg=dataclasses.replace(cfg, n_layers=FAM_LOCK_LAYERS))
    log(f"fam 16.1 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cfg = get_arch(FAM_SSM)
    out[FAM_SSM] = family_serve(
        FAM_SSM, cfg, smi,
        lock_cfg=dataclasses.replace(cfg, n_layers=FAM_LOCK_LAYERS))
    out[FAM_SSM]["step"] = mamba_step_check(cfg, smi)
    log(f"fam 16.2 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cfg = reduced(get_arch(FAM_HYBRID), **FAM_HYBRID_CUT)
    out[FAM_HYBRID] = family_serve(FAM_HYBRID, cfg, smi)
    log(f"fam 16.3 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cfg = get_arch(FAM_ENCDEC)
    out[FAM_ENCDEC] = family_serve(FAM_ENCDEC, cfg, smi)
    r = flash_case("encoder_full", FAM_BATCH, cfg.n_heads, cfg.encoder_seq,
                   cfg.resolved_head_dim, False, torch.float32,
                   torch.Generator(device=CARD).manual_seed(7))
    log(flash_line("encoder_full", r) + f" | {smi}")
    out["encoder_full"] = r
    log(f"fam 16.4 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["train"] = family_train(smi)
    log(f"fam 16.5 took {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------------------ phase 17
DRYRUN_COMBOS = (("qwen1.5-0.5b", "train_4k", False, "baseline"),
                 ("qwen1.5-0.5b", "decode_32k", True, "baseline"),
                 ("qwen3-moe-30b-a3b", "train_4k", False, "moe_bf16_psum"),
                 ("jamba-1.5-large-398b", "long_500k", False, "baseline"),
                 ("whisper-base", "decode_32k", False, "baseline"))
DRYRUN_DIR = ROOT / "build" / "dryrun_torch"
# The JAX package's dry run of DRYRUN_COMBOS on the CPU (jax 0.9.0, 512
# placeholder devices), from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/dryrun_reference.py
DRYRUN_REFERENCE = json.loads("""
{
 "qwen1.5-0.5b/train_4k/pod16x16/baseline": {
  "status": "ok",
  "n_devices": 256,
  "flops_corrected": 19955491799040.0,
  "argument_size_in_bytes": 11724804,
  "output_size_in_bytes": 11200896,
  "output_leaves": 46,
  "collective_bytes_total": 52966709328.0,
  "collectives": {
   "all-gather": 197230592.0,
   "all-reduce": 52232345680.0,
   "all-to-all": 536870912.0,
   "collective-permute": 262144.0
  },
  "compile_s": 0.91,
  "wall_s": 4.3
 },
 "qwen1.5-0.5b/decode_32k/pod2x16x16/baseline": {
  "status": "ok",
  "n_devices": 512,
  "flops_corrected": 1037238272.0,
  "argument_size_in_bytes": 809039892,
  "output_size_in_bytes": 805458328,
  "output_leaves": 3,
  "collective_bytes_total": 116818176.0,
  "collectives": {
   "all-gather": 115998976.0,
   "all-reduce": 802816.0,
   "all-to-all": 16384.0
  },
  "compile_s": 0.27,
  "wall_s": 3.2
 },
 "qwen3-moe-30b-a3b/train_4k/pod16x16/moe_bf16_psum": {
  "status": "ok",
  "n_devices": 256,
  "flops_corrected": 169378477768704.0,
  "argument_size_in_bytes": 723304452,
  "output_size_in_bytes": 722780520,
  "output_leaves": 43,
  "collective_bytes_total": 1218638659664.0,
  "collectives": {
   "all-gather": 24794824704.0,
   "all-reduce": 1186871590992.0,
   "reduce-scatter": 452984832.0,
   "all-to-all": 3489660928.0,
   "collective-permute": 3029598208.0
  },
  "compile_s": 1.98,
  "wall_s": 20.3
 },
 "jamba-1.5-large-398b/long_500k/pod16x16/baseline": {
  "status": "ok",
  "n_devices": 256,
  "flops_corrected": 10570170240.0,
  "argument_size_in_bytes": 4356233000,
  "output_size_in_bytes": 1241399336,
  "output_leaves": 17,
  "collective_bytes_total": 2816203584.0,
  "collectives": {
   "all-gather": 1439373824.0,
   "all-reduce": 93242848.0,
   "all-to-all": 2304.0,
   "collective-permute": 1283584608.0
  },
  "compile_s": 1.42,
  "wall_s": 6.2
 },
 "whisper-base/decode_32k/pod16x16/baseline": {
  "status": "ok",
  "n_devices": 256,
  "flops_corrected": 370733056.0,
  "argument_size_in_bytes": 211199012,
  "output_size_in_bytes": 210646568,
  "output_leaves": 5,
  "collective_bytes_total": 3435485728.0,
  "collectives": {
   "all-gather": 3435084288.0,
   "all-reduce": 311296.0,
   "all-to-all": 53248.0,
   "collective-permute": 36896.0
  },
  "compile_s": 0.45,
  "wall_s": 3.1
 }
}
""")
# What the JAX package's per-device FLOPs count beyond the port's, as
# ``tools/dryrun_dot_breakdown.py`` accounts for them op by op (ROADMAP
# C8) and ``tests/test_torch_dryrun_residuals.py`` pins them on the CPU,
# worked out from the trace's own dot rows ([op, operand shapes, issuer,
# count, flops]): less the matrix-vector products XLA's CPU compiler
# leaves no ``dot`` for (:func:`matvec_flops`); plus, for Jamba
# long_500k, XLA's P.V over the whole cache on every device of the idle
# data axis where the port splits the q heads over it (15 more times the
# port's), and for whisper decode_32k XLA's Q.K^T on whole heads, each on
# 2 devices of the model axis, where the port splits the head dim (once
# more the port's).  Every other combo: nothing.
ATTN_ROWS = ("models/attention.py:_attend_row",
             "models/attention.py:_sdpa_chunked")
VEC_MATRIX = 1 << 24        # XLA rewrites a one-row product with a smaller
#                             matrix as a multiply and a reduction


def _qk(row) -> bool:
    """A product contracting fewer elements than its result row holds: an
    attention's Q.K^T (the head dim against the keys)."""
    lhs, rhs = row[1][:2]
    return lhs[-1] < rhs[-1]


def matvec_flops(rows) -> float:
    return sum(r[4] for r in rows if r[0] != "flash_attention"
               and math.prod(r[1][0][:-1]) == 1
               and math.prod(r[1][1]) < VEC_MATRIX)


DRYRUN_RESIDUAL = {
    "jamba-1.5-large-398b/long_500k/pod16x16/baseline": lambda rows: 15 * sum(
        r[4] for r in rows if r[2] == ATTN_ROWS[0] and not _qk(r)),
    "whisper-base/decode_32k/pod16x16/baseline": lambda rows: sum(
        r[4] for r in rows if r[2] in ATTN_ROWS and _qk(r)),
}
DRYRUN_RATIO_REL = 1e-9     # the counts are exact: the same ops, any host
# the JAX package's compiled output is a tuple whose table holds a
# pointer a leaf; the port's outputs carry no table
POINTER_BYTES = 8
REAL_ARCH = "qwen1.5-0.5b"
REAL_PREFILL = 32768        # prefill_32k's seq; batch cut from 32 to 1
REAL_TRAIN = 4096           # train_4k's seq; batch cut from 256 to 1
REAL_REL = 1e-4             # against the mesh-free path: prefill and decode
#   run the same ops (bit-equal expected); the train loss is the
#   vocab-parallel cross entropy (max, sum of exps, log) against logsumexp
REAL_REPS = 3


def dry_run_combos(smi: str) -> dict:
    """17.1: the dry run as the card's host runs it: each combo of
    ``DRYRUN_COMBOS`` traced at full size on a ``cuda`` mesh of 256 or 512
    fake ranks (fake card tensors; nothing is allocated on the card),
    each record printed beside the JAX package's (``DRYRUN_REFERENCE``).
    Every trace must end ``ok`` on the right device count, with its
    per-device FLOPs, less their matrix-vector products and plus the
    combo's ``DRYRUN_RESIDUAL``, the JAX package's, and its
    output bytes plus 8 B a leaf of the JAX package's output equal to the
    JAX package's; every all-reduce the MoE layer issues under
    ``moe_bf16_psum`` must move bf16.  Returns the records."""
    from repro_torch.launch import dryrun, mesh as pmesh
    out = {}
    for arch, shape, multi_pod, variant in DRYRUN_COMBOS:
        try:
            rec = dryrun.run_one(arch, shape, multi_pod=multi_pod,
                                 variant=variant, force=True, device="cuda",
                                 art_dir=str(DRYRUN_DIR))
        finally:
            pmesh.release()
        mesh = "pod2x16x16" if multi_pod else "pod16x16"
        key = f"{arch}/{shape}/{mesh}/{variant}"
        if rec["status"] != "ok":
            raise AssertionError(f"dry run {key}: {rec.get('error')}\n"
                                 f"{rec.get('traceback', '')}")
        n_dev = 512 if multi_pod else 256
        if rec["n_devices"] != n_dev:
            raise AssertionError(f"dry run {key}: {rec['n_devices']} "
                                 f"devices, not {n_dev}")
        ref = DRYRUN_REFERENCE[key]
        ma = rec["memory_analysis"]
        ratio = rec["flops_corrected"] / ref["flops_corrected"]
        vec = matvec_flops(rec["dot_rows"])
        extra = DRYRUN_RESIDUAL.get(key, lambda rows: 0.0)(rec["dot_rows"])
        want = (rec["flops_corrected"] - vec + extra) / ref["flops_corrected"]
        if abs(want - 1.0) > DRYRUN_RATIO_REL:
            raise AssertionError(f"dry run {key}: flops/dev "
                                 f"{rec['flops_corrected']:.6e} less "
                                 f"matrix-vector {vec:.6e} plus residual "
                                 f"{extra:.6e} is {want} of the JAX "
                                 f"package's")
        out_b = ma["output_size_in_bytes"] + POINTER_BYTES * ref[
            "output_leaves"]
        if out_b != ref["output_size_in_bytes"]:
            raise AssertionError(f"dry run {key}: output bytes "
                                 f"{ma['output_size_in_bytes']} + "
                                 f"{POINTER_BYTES} x {ref['output_leaves']} "
                                 f"leaves != the JAX package's "
                                 f"{ref['output_size_in_bytes']}")
        coll = {k: v["bytes"] for k, v in rec["collectives"].items()
                if v["count"]}
        log(f"dryrun 17.1 {key}: flops/dev {rec['flops_corrected']:.6e} "
            f"(JAX {ref['flops_corrected']:.6e}, ratio {ratio:.10f}; less "
            f"matrix-vector {vec:.6e}, plus residual {extra:.6e}: "
            f"{want:.12f}), args "
            f"{ma['argument_size_in_bytes']:,} B (JAX "
            f"{ref['argument_size_in_bytes']:,}), out "
            f"{ma['output_size_in_bytes']:,} B (JAX "
            f"{ref['output_size_in_bytes']:,}; + {POINTER_BYTES} B x "
            f"{ref['output_leaves']} leaves: equal), peak live "
            f"{rec['peak_live_bytes']:,} B, collectives {coll} (JAX "
            f"{ref['collectives']}), redistributions "
            f"{rec['redistributions']}, trace {rec['trace_s']} s (JAX "
            f"compile {ref['compile_s']} s) | {smi}")
        if variant == "moe_bf16_psum":
            # the expert products' all-reduce (the tensor_sm branch's);
            # the aux loss's two (E,) means stay f32
            moe = {k: v for k, v in rec["collectives_by_issuer"].items()
                   if k.startswith("all-reduce") and "models/moe.py" in k}
            expert = [k for k in moe if k.endswith(":expert_body")]
            if not expert or any(" bfloat16 " not in k for k in expert):
                raise AssertionError(f"dry run {key}: the MoE expert "
                                     f"all-reduces are {moe}, not bf16")
            log(f"dryrun 17.1 {key}: MoE all-reduces {moe}")
        out[key] = rec
    return out


def real_shapes():
    from repro_torch.configs.base import ShapeConfig
    return {"prefill": ShapeConfig("prefill_32k_b1", REAL_PREFILL, 1,
                                   "prefill"),
            "decode": ShapeConfig("decode_32k_b1", REAL_PREFILL, 1,
                                  "decode"),
            "train": ShapeConfig("train_4k_b1", REAL_TRAIN, 1, "train")}


def fake_one_device_flops() -> dict:
    """The dry run's per-device FLOPs of the 17.2 steps on a fake (1, 1)
    ``cuda`` mesh."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun, mesh as pmesh
    from repro_torch.launch import shardings as sh
    cfg = get_arch(REAL_ARCH)
    pol = sh.ShardingPolicy(batch_axes=("data",))
    out = {}
    pmesh.start_fake_group(1)
    try:
        mesh = pmesh.make_host_mesh(1, 1, device="cuda")
        for mode, shape in real_shapes().items():
            res = dryrun.trace_step(cfg, shape, mesh, pol, device="cuda")
            out[mode] = res["record"]["flops_corrected"]
    finally:
        pmesh.release()
    return out


def real_steps(smi: str, fake_flops: dict) -> dict:
    """17.2: ``steps.build`` run for real on a (1, 1) mesh over a one-rank
    NCCL group, bf16 params drawn from a seed, full depth: the prefill
    (1 x 32,768), one decode step against its cache (at position 32,768:
    the full-length cache's ring slot 0), one train step (1 x 4,096).
    Each traced run counts its FLOPs (which must equal the fake (1, 1) dry
    run's) and its flash launches (24 in the prefill, 0 in decode and
    train: counts zeroed just before each traced run and read just after);
    its logits or loss are held to the plain ``Model.prefill`` /
    ``decode_step`` / ``loss`` on the same params without a mesh; then the
    step is timed (median of ``REAL_REPS`` host-clocked, synchronized
    calls outside the cost pass) with its peak memory."""
    import socket
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, mesh as pmesh, steps
    from repro_torch.launch import shardings as sh
    cfg = get_arch(REAL_ARCH)
    pol = sh.ShardingPolicy(batch_axes=("data",))
    shapes = real_shapes()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    out = {}
    try:
        mesh = pmesh.make_host_mesh(1, 1, device=CARD)
        gen = torch.Generator(device=CARD).manual_seed(17)

        def timed(mode, res):
            fn, args = res["built"]["fn"], res["args"]
            shape = shapes[mode]

            def call():
                with dryrun.step_context(shape, mesh, pol):
                    return fn(*args)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(REAL_REPS):
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            ms = 1e3 * statistics.median(times)
            flops = res["record"]["flops_corrected"]
            r = {"ms": ms, "flops": flops,
                 "tflops_s": flops / (ms * 1e-3) / 1e12,
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                 "fake_flops": fake_flops[mode],
                 "redistributions": res["record"]["redistributions"]}
            if flops != fake_flops[mode]:
                raise AssertionError(f"real 17.2 {mode}: counted flops "
                                     f"{flops} != the fake (1,1) dry run's "
                                     f"{fake_flops[mode]}")
            return r

        def gap(got, want, label, launches, want_launches):
            g = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            r = {"bit_equal": bool(torch.equal(got, want)), "max_abs": g,
                 "rel": g / max(scale, 1e-30), "flash_launches": launches}
            if r["rel"] > REAL_REL:
                raise AssertionError(f"real 17.2 {label}: {g} against the "
                                     f"mesh-free path (largest {scale})")
            if launches != want_launches:
                raise AssertionError(f"real 17.2 {label}: {launches} flash "
                                     f"launches, not {want_launches}")
            return r

        # prefill
        ops.reset_launches()
        pre = dryrun.trace_step(cfg, shapes["prefill"], mesh, pol,
                                device=CARD, fake=False, gen=gen)
        torch.cuda.synchronize()
        launches = ops.LAUNCHES["flash_attention"]
        model = pre["built"]["model"]
        params = pre["args"][0]
        plain = steps.local_params(model, params)
        tokens = pre["args"][1]["tokens"].to_local()
        with torch.no_grad():
            want, want_caches = model.prefill(plain, {"tokens": tokens})
        out["prefill"] = gap(pre["outputs"][0].to_local(), want, "prefill",
                             launches, cfg.n_layers)
        del want
        out["prefill"].update(timed("prefill", pre))
        # one decode step against the prefill's cache
        built = steps.build(cfg, shapes["decode"], mesh, pol)
        ispec = built["in_specs"][2]
        tok = torch.randint(0, 64, (1, 1), generator=gen, device=CARD,
                            dtype=torch.int32)
        batch = {"tokens": DTensor.from_local(
                     tok, mesh, sh.to_placements(mesh, ispec["tokens"])),
                 "pos": DTensor.from_local(
                     torch.tensor(REAL_PREFILL, dtype=torch.int32,
                                  device=CARD), mesh,
                     [Replicate()] * mesh.ndim)}
        ops.reset_launches()
        dec = dryrun.trace_step(cfg, shapes["decode"], mesh, pol,
                                device=CARD, fake=False,
                                args=[params, pre["outputs"][1], batch])
        torch.cuda.synchronize()
        launches = ops.LAUNCHES["flash_attention"]
        with torch.no_grad():
            want, _ = model.decode_step(plain, tok, want_caches,
                                        REAL_PREFILL)
        out["decode"] = gap(dec["outputs"][0].to_local(), want, "decode",
                            launches, 0)
        del want, want_caches, pre
        out["decode"].update(timed("decode", dec))
        del dec
        # one train step
        ops.reset_launches()
        tr = dryrun.trace_step(cfg, shapes["train"], mesh, pol,
                               device=CARD, fake=False, gen=gen)
        torch.cuda.synchronize()
        launches = ops.LAUNCHES["flash_attention"]
        # the plain loss with its params requiring grad, as in the step:
        # attention then takes the chunked softmax there too
        tplain = steps.local_params(tr["built"]["model"], tr["args"][0],
                                    requires_grad=True)
        b = {k: v.to_local() for k, v in tr["args"][3].items()}
        want, _ = tr["built"]["model"].loss(tplain, b)
        want = want.detach()
        del tplain
        out["train"] = gap(tr["outputs"][3]["loss"].to_local(), want,
                           "train loss", launches, 0)
        out["train"]["loss"] = float(want)
        out["train"].update(timed("train", tr))
        del tr
    finally:
        dist.destroy_process_group()
    for mode, r in out.items():
        log(f"real 17.2 {REAL_ARCH} {mode} {shapes[mode].global_batch} x "
            f"{shapes[mode].seq_len}: flash launches {r['flash_launches']}"
            f", bit-equal to the mesh-free path {r['bit_equal']} (max abs "
            f"{r['max_abs']:.3e}, rel {r['rel']:.3e}), flops "
            f"{r['flops']:.6e} (fake (1,1) dry run {r['fake_flops']:.6e}), "
            f"ms {r['ms']:.3f}, TFLOP/s {r['tflops_s']:.2f}, peak_mem_gb "
            f"{r['peak_gb']:.3f}, redistributions {r['redistributions']} "
            f"| {smi}")
    return out


def dry_run() -> dict:
    """Phase 17: the dry run (17.1) and its three steps run for real on
    the card (17.2).  Returns {"dryrun", "real"}; the flash launches of
    17.2's prefill, decode and train under ``"real"``."""
    smi = nvidia_smi()
    t0 = time.perf_counter()
    recs = dry_run_combos(smi)
    log(f"dryrun 17.1 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fake = fake_one_device_flops()
    real = real_steps(smi, fake)
    log(f"real 17.2 took {time.perf_counter() - t0:.1f} s")
    return {"dryrun": recs, "real": real}


# ------------------------------------------------------------ phase 18
LAYOUT_DIR = ROOT / "build" / "layouts"
# PERF.md section 6's main and large shapes of each kernel (flash in f32
# and bf16, causal)
LAYOUT_SHAPES = {
    "stump_scan": ((333, 64, 16), (24000, 64, 16)),
    "stump_scan_batched": ((100000, 4, 48, 16), (4096, 333, 64, 16)),
    "ensemble_vote": ((256, 8192), (1024, 65536)),
    "ensemble_vote_batched": ((2, 300, 64), (8, 1024, 4096)),
    "stump_vote_batched": ((2, 300, 64), (8, 1024, 4096)),
    "stump_vote_fp_batched": ((2, 300, 64), (8, 1024, 4096)),
    "dist_update": ((8192,), (4_194_304,)),
    "flash_attention": ((4, 16, 512, 64), (2, 16, 8192, 64)),
}
LAYOUT_REPS = 10                # profiled calls a grid member
LAYOUT_REQUESTS = 512           # the slice-1 path's serve (phase 6's)


def layout_inputs(gen, kernel, shape, dtype=torch.float32):
    """Random card inputs of ``kernel`` at ``shape``: ``(args, kwargs)``
    as its ops wrapper takes them."""
    if kernel == "stump_scan":
        return scan_inputs(gen, *shape), {}
    if kernel == "stump_scan_batched":
        B, N, F, T = shape
        x = torch.randn((B, N, F), generator=gen, device=CARD)
        y = torch.where(torch.rand((B, N), generator=gen, device=CARD) < 0.5,
                        1.0, -1.0)
        w = torch.rand((B, N), generator=gen, device=CARD)
        rows = torch.randint(0, N, (B, F, T), generator=gen, device=CARD)
        thr = torch.gather(x.transpose(1, 2), 2, rows).contiguous()
        return (x, y, w, thr), {}
    if kernel.startswith("ensemble_vote"):
        m = torch.rand(shape, generator=gen, device=CARD) * 2 - 1
        return (m, torch.rand(shape[:-1], generator=gen, device=CARD)), {}
    if kernel.startswith("stump_vote"):
        return vote_inputs(gen, *shape, shape[1] // 10), {}
    if kernel == "dist_update":
        return (0.7, *dist_inputs(gen, shape[0])), {}
    return tuple(torch.randn(shape, generator=gen, device=CARD).to(dtype)
                 for _ in range(3)), {"causal": True}


def vote_l1(kernel, args, large: bool):
    """Phase 3's slack for a vote's long sums (``close``'s ``l1``, the sum
    of the summed terms' magnitudes, sum |alpha| a column): for
    ``ensemble_vote`` at every shape and for the batched votes at their
    large shape; else None (rtol/atol ``TOL``)."""
    if kernel == "ensemble_vote":
        return args[1].abs().sum()
    if large and kernel in ("ensemble_vote_batched", *STUMP_KERNELS):
        return args[-1].abs().sum(1, keepdim=True)
    return None


def layout_close(kernel, got, want, label, l1=None) -> float:
    """The largest difference of a launch from the plain version, held at
    phase 3's tolerances: the scans bit-equal, the votes within rtol/atol
    ``TOL`` (or ``TOL`` of ``l1``, :func:`vote_l1`) and the lanes
    bit-equal, ``dist_update``'s D' within 1e-6 and Z within 1e-6
    relative, flash within 2e-4 (f32) or 3e-2 (bf16)."""
    if kernel == "dist_update":
        err = float((got[0] - want[0]).abs().max())
        ok = err <= 1e-6 and float((got[1] - want[1]).abs() / want[1]) <= 1e-6
    elif isinstance(got, tuple):
        err = float((got[0] - want[0]).abs().max())
        ok = close(got[0], want[0], l1) and all(
            torch.equal(g, w) for g, w in zip(got[1:], want[1:]))
    else:
        err = float((got.float() - want.float()).abs().max())
        if kernel.startswith("stump_scan"):
            ok = torch.equal(got, want)
        elif kernel == "flash_attention":
            tol = 2e-4 if got.dtype == torch.float32 else 3e-2
            ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                     atol=tol))
        else:
            ok = close(got, want, l1)
    if not ok:
        raise AssertionError(f"layout {label}: max err {err} beyond the "
                             f"plain version's tolerance")
    return err


def member_ms(call) -> float:
    """A grid member's device ms: the median of three profiled traces of
    ``LAYOUT_REPS`` calls each, leaving out a trace that holds no kernel.
    Late in a full run one trace now and then drops a call's kernels or
    halves their time (on the H100, two identical launches measured 2.1x
    apart, one trace each)."""
    runs = [device_ms(call, LAYOUT_REPS, None) for _ in range(3)]
    good = [t for t in runs if math.isfinite(t)]
    return statistics.median(good) if good else float("nan")


def layout_grid_case(gen, kernel, shape, dtype, large, smi) -> dict:
    """18.1 at one shape: every grid member of ``kernel`` that applies to
    the shape's bucket launched, held to the plain version and timed on
    the card (``device_ms``); a member that does not apply must be
    refused.  Returns the members' device ms, the launcher's own choice's
    and the fastest."""
    from repro_torch.kernels import dispatch, ops
    from repro_torch.kernels.dispatch import KernelPolicy
    fn = getattr(ops, kernel)
    args, kw = layout_inputs(gen, kernel, shape, dtype)
    want = fn(*args, backend="torch", policy=KernelPolicy(env_var=None),
              **kw)
    bucket = dispatch.bucket_of(kernel, args, kw)
    l1 = vote_l1(kernel, args, large)
    pol = KernelPolicy(env_var=None)
    label = f"{kernel} {shape}" + (
        f" {str(dtype)[6:]}" if kernel == "flash_attention" else "")
    ms, skipped, worst = {}, [], 0.0
    for member in dispatch.LAYOUT_GRIDS[kernel]:
        name = dispatch.layout_label(member)
        call = lambda m=member: fn(*args, backend="cuda",  # noqa: E731
                                   policy=pol, **kw, **m)
        if not dispatch.layout_applies(kernel, bucket, member):
            try:
                call()
            except RuntimeError as exc:
                skipped.append(name)
                log(f"layout 18.1: {label} [{name}] does not apply to "
                    f"bucket {dispatch.bucket_label(bucket)}: refused "
                    f"({exc})")
                continue
            raise AssertionError(f"layout {label} [{name}]: launched where "
                                 f"it does not apply")
        before = ops.LAUNCHES[kernel]
        got = call()
        torch.cuda.synchronize()
        if ops.LAUNCHES[kernel] != before + 1:
            raise AssertionError(f"layout {label} [{name}]: not one launch")
        worst = max(worst, layout_close(kernel, got, want,
                                        f"{label} [{name}]", l1))
        ms[name] = member_ms(call)
    own = ms["-"]
    fastest = min((k for k in ms if math.isfinite(ms[k])), key=ms.get)
    log(f"layout 18.1: {label}: device ms "
        + " ".join(f"[{k}]={v:.4f}" for k, v in ms.items())
        + f"; own {own:.4f}, fastest [{fastest}] {ms[fastest]:.4f} "
        f"({own / ms[fastest]:.3f}x); max err {worst:.3g} | {smi}")
    return {"shape": list(shape), "dtype": str(dtype)[6:], "ms": ms,
            "own_ms": own, "fastest": fastest, "fastest_ms": ms[fastest],
            "skipped": skipped, "max_abs_err": worst}


def layout_grids(smi) -> dict:
    """18.1: every grid member of the eight kernels at PERF.md's main and
    large shapes (flash in f32 and bf16)."""
    gen = torch.Generator(device=CARD).manual_seed(18)
    out = {}
    for kernel, shapes in LAYOUT_SHAPES.items():
        dtypes = ((torch.float32, torch.bfloat16)
                  if kernel == "flash_attention" else (torch.float32,))
        out[kernel] = [layout_grid_case(gen, kernel, shape, dtype,
                                        shape == shapes[-1], smi)
                       for shape in shapes for dtype in dtypes]
        torch.cuda.empty_cache()
    return out


def layout_calls(stump_shapes) -> list:
    """18.2's calls, on the slice-1 path's buckets: edge_vision's first
    fit, phase 5's commonest shape of each stump vote, ``ensemble_vote``
    at (256, 8192), ``dist_update`` at N 8,192 and phase 10's prefill
    flash shape (f32, causal).  Each ``(kernel, args, kwargs)``."""
    from repro_torch.data import make_domain_data
    from repro_torch.models.weak import stump_thresholds
    from repro_torch.sim.scenarios import DOMAINS
    x, y = make_domain_data(DOMAINS["edge_vision"], seed=0)["clients"][0]
    x, y = torch.from_numpy(x).to(CARD), torch.from_numpy(y).to(CARD)
    w = torch.full((x.shape[0],), 1.0 / x.shape[0], device=CARD)
    calls = [("stump_scan", (x, y, w, stump_thresholds(x)), {})]
    gen = torch.Generator(device=CARD).manual_seed(182)
    for name in STUMP_KERNELS:
        (B, T, N), _ = stump_shapes[name].most_common(1)[0]
        calls.append((name, vote_inputs(gen, B, T, N, 0), {}))
    for kernel, shape in (("ensemble_vote", (256, 8192)),
                          ("dist_update", (8192,)),
                          ("flash_attention", (LM_BATCH, 16, LM_PROMPT, 64))):
        args, kw = layout_inputs(gen, kernel, shape)
        calls.append((kernel, args, kw))
    return calls


def layout_winner_on_card(name, args, kw, win, smi) -> None:
    """A recorded winner other than ``{}`` timed on the card beside ``{}``
    at the call's own inputs (device ms, as 18.1 times them): it fails the
    phase where the card runs it more than 10% slower, the band within
    which 18.1 finds two launches of one configuration."""
    from repro_torch.kernels import dispatch, ops
    from repro_torch.kernels.dispatch import KernelPolicy
    fn, pol = getattr(ops, name), KernelPolicy(env_var=None)
    own = member_ms(lambda: fn(*args, backend="cuda", policy=pol, **kw))
    ms = member_ms(lambda: fn(*args, backend="cuda", policy=pol, **kw,
                              **dict(win.layout)))
    label = dispatch.layout_label(win.layout)
    if not ms <= 1.1 * own:
        raise AssertionError(f"layout 18.2 {name}: winner [{label}] runs "
                             f"{ms:.4f} ms on the card against the "
                             f"launcher's own {own:.4f}")
    log(f"layout 18.2: {name} winner [{label}] on the card {ms:.4f} ms, "
        f"own {own:.4f} | {smi}")


def layout_dispatch_again(calls, back, what) -> None:
    """Each call dispatched under the loaded table ``back``: the backend
    and the CUDA layout launched are the entry's, the result within the
    plain version's tolerance."""
    from repro_torch.kernels import dispatch, ops
    from repro_torch.kernels.dispatch import KernelPolicy
    for name, args, kw in calls:
        fn = getattr(ops, name)
        bucket = dispatch.bucket_of(name, args, kw)
        entry = back.table[(name, bucket)]
        before = ops.LAUNCHES[name]
        got = fn(*args, policy=back, **kw)
        want = fn(*args, backend="torch", policy=KernelPolicy(env_var=None),
                  **kw)
        torch.cuda.synchronize()
        used = back.cuda_layout_choices[(name, bucket)]
        ran = ops.LAUNCHES[name] - before
        if (back.choices[(name, bucket)] != entry.backend
                or used != (dict(entry.layout) if entry.backend == "cuda"
                            else {})
                or ran != (entry.backend == "cuda")):
            raise AssertionError(f"layout 18.2 {name} ({what}): table "
                                 f"{entry}, ran "
                                 f"{back.choices[(name, bucket)]} "
                                 f"[{dispatch.layout_label(used)}], "
                                 f"{ran} launches")
        err = layout_close(name, got, want, f"18.2 {name}",
                           vote_l1(name, args, False))
        log(f"layout 18.2: {name} under the loaded {what} table: "
            f"{entry.backend} [{dispatch.layout_label(used)}] as recorded, "
            f"{ran} launch, max err {err:.3g}")


def layout_calibrate(stump_shapes, smi) -> tuple:
    """18.2: ``calibrate_call`` on both backends at :func:`layout_calls`
    (a winner other than ``{}`` also timed on the card,
    :func:`layout_winner_on_card`), the table saved and loaded back, and
    each call dispatched again under it (:func:`layout_dispatch_again`);
    then the same for a forced table, which records at each call's bucket
    the first member after ``{}`` that runs it, so that a layout reaches
    the launch whatever calibration chose.  Returns both tables' paths
    and the winners."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.dispatch import KernelPolicy
    calls = layout_calls(stump_shapes)
    cal = KernelPolicy(env_var=None)
    forced = KernelPolicy(env_var=None)
    winners = {}
    for name, args, kw in calls:
        bucket, samples = cal.calibrate_call(name, *args, reps=10, **kw)
        med = {key: statistics.median(ts) * 1e3
               for key, ts in samples.items()}
        win = cal.table[(name, bucket)]
        own = med[("cuda", ())]
        winners[name] = {"bucket": list(bucket), "backend": win.backend,
                         "layout": dict(win.layout),
                         "median_ms": {f"{b}[{dispatch.layout_label(k)}]": v
                                       for (b, k), v in med.items()}}
        shape = tuple(args[name == "dist_update"].shape)
        log(f"layout 18.2: calibrate {name} at {shape} "
            f"(bucket {dispatch.bucket_label(bucket)}): median ms "
            + " ".join(f"{b}[{dispatch.layout_label(k)}]={v:.4f}"
                       for (b, k), v in sorted(med.items()))
            + f" -> {win.backend} [{dispatch.layout_label(win.layout)}] "
            f"{med[tuple(win)]:.4f} (own {own:.4f}) | {smi}")
        if win.backend == "cuda" and win.layout:
            layout_winner_on_card(name, args, kw, win, smi)
        forced.record(name, bucket, "cuda", next(
            m for m in dispatch.LAYOUT_GRIDS[name][1:]
            if dispatch.layout_applies(name, bucket, m)))
    paths = {}
    for what, pol in (("calibrated", cal), ("forced", forced)):
        paths[what] = pol.save(str(LAYOUT_DIR / f"{what}.json"))
        back = KernelPolicy.load(paths[what])
        if back.table != pol.table or back.measured_on != CARD:
            raise AssertionError(f"layout {what} table round trip: "
                                 f"{back.table}")
        layout_dispatch_again(calls, back, what)
        log(f"layout 18.2: {len(back.table)} entries saved to "
            f"{Path(paths[what]).relative_to(ROOT)} and loaded back equal")
    return paths, winners


def recording_stump_votes():
    """Wrap the two stump vote wrappers in ``ops`` so that each call keeps
    a copy of its inputs and of its outputs; returns the list and a
    function that restores the wrappers."""
    from repro_torch.kernels import ops
    calls = []
    saved = {name: getattr(ops, name) for name in STUMP_KERNELS}

    def wrap(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            calls.append((name, [a.clone() for a in args],
                          tuple(o.clone() for o in out)
                          if isinstance(out, tuple) else out.clone()))
            return out
        return call
    for name, fn in saved.items():
        setattr(ops, name, wrap(name, fn))

    def restore():
        for name, fn in saved.items():
            setattr(ops, name, fn)
    return calls, restore


def layout_serve(registry, xt, policy_for):
    """The slice-1 path's serve: ``LAYOUT_REQUESTS`` edge_vision requests
    through ``EnsembleServer`` on the card, with phase 5's result cache
    (which the fused fingerprint path needs); returns rid -> (label,
    margin) and the stump vote calls it made."""
    from repro_torch.serve import BatchConfig, EnsembleServer
    server = EnsembleServer(registry, BatchConfig(max_batch=64,
                                                  cache_capacity=4096),
                            policy_for=policy_for, device=CARD)
    calls, restore = recording_stump_votes()
    responses = []
    try:
        t0 = time.perf_counter()
        for i in range(LAYOUT_REQUESTS):
            _, done = server.submit("edge_vision", xt[i % len(xt)],
                                    now=time.perf_counter() - t0)
            responses += done
        responses += server.drain()
        torch.cuda.synchronize()
    finally:
        restore()
    if len(responses) != LAYOUT_REQUESTS:
        raise AssertionError(f"{len(responses)} responses for "
                             f"{LAYOUT_REQUESTS} requests")
    return {r.rid: (r.label, r.margin) for r in responses}, calls


def layout_slice1(path, what, datas, smi) -> dict:
    """18.3: the slice-1 path under the loaded ``what`` table (the default
    policy, and a copy of it on the fused fingerprint path): edge_vision
    enhanced training, 25 rounds, every counter and every fit's stump
    equal to phase 4's run (under the forced table at least one launch
    must take the table's layout); then the 512-request serve, plain and
    fused, each beside the same serve without a table (margins within
    rtol/atol ``TOL``, labels equal), and every stump vote call of the
    tuned serves launched again without a table (margins within ``TOL``,
    lanes bit-equal).  Returns the launches of the path under the table
    (counts zeroed just before its training run, read just after its
    serves)."""
    from repro_torch.configs.paper_fedboost import FedBoostConfig
    from repro_torch.core import FederatedBoostEngine
    from repro_torch.kernels import dispatch, ops
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.serve import EnsembleRegistry
    from repro_torch.sim.scenarios import DOMAINS
    tuned = KernelPolicy.load(path)
    fused = KernelPolicy.load(path)
    fused.fused_fingerprint = True
    dom = DOMAINS["edge_vision"]
    cfg = FedBoostConfig(n_clients=dom.n_clients, n_rounds=25, seed=0,
                         straggler_factor=dom.straggler_factor,
                         dropout_prob=dom.dropout_prob,
                         link_mbps=dom.link_mbps)
    registry = EnsembleRegistry()
    ops.reset_launches()
    old = dispatch.set_default_policy(tuned)
    try:
        fits = FitLog()
        eng = FederatedBoostEngine(cfg, datas["edge_vision"], "enhanced",
                                   weak=fits.spec, device=CARD)
        eng.attach_registry(registry, "edge_vision")
        m = eng.run()
        torch.cuda.synchronize()
        xt = datas["edge_vision"]["test"][0]
        tuned_runs = {label: layout_serve(registry, xt, pf) for label, pf in
                      (("plain", None), ("fused", lambda t: fused))}
    finally:
        dispatch.set_default_policy(old)
    launches = dict(ops.LAUNCHES)
    for name in ("stump_scan", *STUMP_KERNELS):
        if launches[name] <= 0:
            raise AssertionError(f"layout 18.3 ({what}): {name} never "
                                 f"launched")
    m4, keys4 = SLICE1[("edge_vision", "enhanced")]
    keys = ("uplink_bytes", "downlink_bytes", "n_messages", "n_syncs",
            "learners_merged", "rounds_unavailable", "sim_time_s",
            "final_val_error", "final_test_error")
    diff = {k: (getattr(m, k), getattr(m4, k)) for k in keys
            if getattr(m, k) != getattr(m4, k)}
    picks = [_key(p) for *_, p in fits.fits]
    if diff or picks != keys4:
        raise AssertionError(f"layout 18.3: training under the {what} "
                             f"table differs from phase 4's: {diff}, picks "
                             f"equal {picks == keys4}")
    tuned_layouts = {f"{k}@{dispatch.bucket_label(b)}":
                     dispatch.layout_label(v)
                     for pol in (tuned, fused)
                     for (k, b), v in pol.cuda_layout_choices.items() if v}
    if what == "forced" and not tuned_layouts:
        raise AssertionError("layout 18.3: no launch of the path took the "
                             "forced table's layout")
    log(f"layout 18.3: edge_vision enhanced under the {what} table: "
        f"{len(picks)} fits, every pick and counter equal to phase 4's "
        f"(bytes={m.total_bytes} syncs={m.n_syncs} "
        f"test_err={m.final_test_error:.4f}); tuned launches "
        f"{tuned_layouts or 'none'}")
    worst = 0.0
    plain_fused = KernelPolicy(env_var=None, fused_fingerprint=True)
    for label, pf in (("plain", None),
                      ("fused", lambda t: plain_fused)):
        got, calls = tuned_runs[label]
        want, _ = layout_serve(registry, xt, pf)
        for rid, (lab, margin) in got.items():
            wl, wm = want[rid]
            worst = max(worst, abs(margin - wm))
            if lab != wl or abs(margin - wm) > TOL + TOL * abs(wm):
                raise AssertionError(f"layout 18.3 {what} {label} rid "
                                     f"{rid}: {lab} {margin} vs {wl} {wm}")
        for name, args, out in calls:
            again = getattr(ops, name)(*args, policy=KernelPolicy(
                env_var=None))
            layout_close(name, out, again, f"18.3 {label} {name}")
        log(f"layout 18.3: {LAYOUT_REQUESTS}-request serve ({label}) "
            f"under the {what} table: labels equal to the untuned serve's, "
            f"margins within {TOL} (max {worst:.3g}); its "
            f"{len(calls)} stump vote calls launched again without the "
            f"table: margins within {TOL}, lanes bit-equal | {smi}")
    return launches


def layout_path(stump_shapes, datas) -> dict:
    """Phase 18: the dispatcher's layout autotune on the card (18.1 the
    grids, 18.2 calibration and the loaded tables, 18.3 the slice-1 path
    under each).  Returns 18.1's results by kernel, 18.2's winners and
    18.3's launches under the calibrated table."""
    smi = nvidia_smi()
    t0 = time.perf_counter()
    grids = layout_grids(smi)
    log(f"layout 18.1: {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    paths, winners = layout_calibrate(stump_shapes, smi)
    log(f"layout 18.2: {time.perf_counter() - t1:.1f} s")
    launches = {}
    for what, path in paths.items():
        t1 = time.perf_counter()
        launches[what] = layout_slice1(path, what, datas, smi)
        log(f"layout 18.3: launches under the {what} table "
            f"{launches[what]}; {time.perf_counter() - t1:.1f} s")
    for kernel, cases in grids.items():
        for r in cases:
            if r["own_ms"] > 1.1 * r["fastest_ms"]:
                log(f"layout 18: finding: {kernel} {tuple(r['shape'])} "
                    f"{r['dtype']}: [{r['fastest']}] {r['fastest_ms']:.4f} "
                    f"ms beats the launcher's own {r['own_ms']:.4f} by "
                    f"{r['own_ms'] / r['fastest_ms']:.3f}x")
    return {"grids": grids, "winners": winners,
            "launches": launches["calibrated"]}


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

    # the chain path: counts zeroed just before phase 12, read after its
    # step 1 (the chain scenario through run_scenario) and after it ends
    t0 = time.perf_counter()
    ops.reset_launches()
    chain_launches = chain_path()
    torch.cuda.synchronize()
    log(f"launches on the chain path (step 1): {chain_launches}; in all "
        f"of phase 12: {dict(ops.LAUNCHES)}; phase 12 took "
        f"{time.perf_counter() - t0:.1f} s")

    # the policy-driven launcher: counts zeroed just before its step 2
    # (the run of serve_ensemble) and read just after it
    t0 = time.perf_counter()
    policy_launches = policy_path(stump_shapes, fleet_launches)
    torch.cuda.synchronize()
    log(f"launches on the policy path (step 2): {policy_launches}; "
        f"in all of phase 13: {dict(ops.LAUNCHES)}; phase 13 took "
        f"{time.perf_counter() - t0:.1f} s")

    # the mesh-integrated federated boost: counts zeroed just before
    # phase 14, read after its training runs (step 1)
    t0 = time.perf_counter()
    ops.reset_launches()
    mesh_launches = mesh_path()
    torch.cuda.synchronize()
    log(f"launches on the mesh path (step 1): {mesh_launches}; in all of "
        f"phase 14: {dict(ops.LAUNCHES)}; phase 14 took "
        f"{time.perf_counter() - t0:.1f} s")

    # LM training: counts zeroed just before the full-width train_loop
    # (step 1) and read just after it
    t0 = time.perf_counter()
    train_launches = lm_train()
    torch.cuda.synchronize()
    log(f"launches on the LM train path (step 1): {train_launches}; "
        f"phase 15 took {time.perf_counter() - t0:.1f} s")

    # the MoE, SSM, hybrid and encoder-decoder families: counts zeroed just
    # before each family's first generate and read just after it, and
    # before the training runs and after them
    t0 = time.perf_counter()
    fam = lm_families()
    torch.cuda.synchronize()
    fam_launches = {k: fam[k]["flash_launches"]
                    for k in (FAM_MOE, FAM_SSM, FAM_HYBRID, FAM_ENCDEC)}
    fam_launches["train"] = fam["train"]["flash_launches"]
    kernel_results["flash_attention"]["encoder_full"] = fam.pop(
        "encoder_full")
    log(f"launches of flash_attention on the LM family paths: "
        f"{fam_launches}; phase 16 took {time.perf_counter() - t0:.1f} s")

    # the dry run and its three steps for real: counts zeroed just before
    # each of 17.2's traced steps and read just after it
    t0 = time.perf_counter()
    dry = dry_run()
    real_launches = {k: r["flash_launches"] for k, r in dry["real"].items()}
    log(f"launches of flash_attention on the dry run's real steps: "
        f"{real_launches}; phase 17 took {time.perf_counter() - t0:.1f} s")

    # the layout autotune: every grid, calibration, and the slice-1 path
    # under the loaded table (its launches counted from just before 18.3
    # to just after it)
    t0 = time.perf_counter()
    layouts = layout_path(stump_shapes, datas)
    log(f"phase 18 took {time.perf_counter() - t0:.1f} s")

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
            **({"replay_launches": replay_launches[name],
                "chain_launches": chain_launches[name]}
               if name in ("stump_scan", "stump_vote_batched") else {}),
            **({"policy_launches": policy_launches[name]}
               if name in ("stump_scan", *STUMP_KERNELS) else {}),
            **({"mesh_launches": mesh_launches[name]}
               if name in mesh_launches else {}),
            **({"train_launches": train_launches[name],
                "family_launches": fam_launches,
                "dryrun_real_launches": real_launches}
               if name == "flash_attention" else {}),
            layouts=layouts["grids"][name],
            layout_path_launches=layouts["launches"][name],
            **({"calibrated": layouts["winners"][name]}
               if name in layouts["winners"] else {}),
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
