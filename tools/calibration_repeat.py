#!/usr/bin/env python3
"""How often ``KernelPolicy.calibrate_call`` records a launch other than
the launcher's own (``{}``) at ``chip_smoke.py`` phase 18.2's buckets,
and how the card runs such a winner beside ``{}``.

    python3 tools/calibration_repeat.py [--trials 15] [--reps 10]

Needs a CUDA card (the kernels are built from ``src/repro_torch/kernels/
csrc`` at first use).  For each of 18.2's six calls (edge_vision's first
fit for ``stump_scan``, the stump votes at (1, 300, 20) and (1, 240, 30),
``ensemble_vote`` (256, 8192), ``dist_update`` N 8,192, flash
(4, 16, 512, 64) f32) it calibrates ``--trials`` times and prints the
first trial's host medians of the cuda layouts, the winners' counts, the
least and the median spread of ``{}``'s reps, and the largest and the
median margin by which the fastest member's median beat ``{}``'s.  Each
winner other than ``{}`` is then timed on the card beside ``{}``
(``chip_smoke.member_ms``: the median of three profiled traces).  The
last line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import collections
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, dispatch, ops  # noqa: E402
from repro_torch.kernels.dispatch import KernelPolicy  # noqa: E402

# the serve's commonest stump vote shapes in chip_smoke.py phase 5 on an H100
VOTE_SHAPES = {"stump_vote_batched": (1, 300, 20),
               "stump_vote_fp_batched": (1, 240, 30)}


def trials(name, args, kw, n, reps) -> collections.Counter:
    """Calibrate one call ``n`` times; print what each trial recorded."""
    wins = collections.Counter()
    spreads, margins = [], []
    for i in range(n):
        cal = KernelPolicy(env_var=None)
        bucket, samples = cal.calibrate_call(name, *args, reps=reps, **kw)
        own = samples[("cuda", ())]
        med = {k: statistics.median(v) for k, v in samples.items()
               if k[0] == "cuda"}
        spreads.append((max(own) - min(own)) * 1e3)
        margins.append((med[("cuda", ())] - min(med.values())) * 1e3)
        win = cal.table[(name, bucket)]
        wins[(win.backend, dispatch.layout_key(win.layout))] += 1
        if i == 0:
            print(name, "host medians ms",
                  {dispatch.layout_label(k[1]): round(v * 1e3, 4)
                   for k, v in sorted(med.items())}, flush=True)
    print(name, "winners",
          {f"{b}[{dispatch.layout_label(k)}]": c for (b, k), c in
           wins.items()},
          f"own spread ms least {min(spreads):.4f} median "
          f"{statistics.median(spreads):.4f}; own minus fastest median ms "
          f"most {max(margins):.4f} median "
          f"{statistics.median(margins):.4f}", flush=True)
    return wins


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=15)
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args()
    build.load()
    shapes = {k: collections.Counter({v: 1}) for k, v in VOTE_SHAPES.items()}
    t0 = time.perf_counter()
    for name, args, kw in cs.layout_calls(shapes):
        wins = trials(name, args, kw, a.trials, a.reps)
        fn, pol = getattr(ops, name), KernelPolicy(env_var=None)
        for backend, key in wins:
            if backend != "cuda" or not key:
                continue
            own = cs.member_ms(lambda: fn(*args, backend="cuda", policy=pol,
                                          **kw))
            ms = cs.member_ms(lambda: fn(*args, backend="cuda", policy=pol,
                                         **kw, **dict(key)))
            print(f"  {name} [{dispatch.layout_label(key)}] device ms "
                  f"{ms:.4f}, own {own:.4f} ({ms / own:.3f}x)", flush=True)
    print(f"{time.perf_counter() - t0:.1f} s | {cs.nvidia_smi()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
