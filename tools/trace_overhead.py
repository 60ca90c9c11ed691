#!/usr/bin/env python3
"""What recording costs the mesh boost's step: client-rounds/s of a
benchmark cell's step over whole federations with the program's
recording off, under ``obs.tracing()``, and under ``torch.profiler``
(which turns the program's spans on by itself), in turns.

    PYTHONPATH=src python3 tools/trace_overhead.py \\
        [--workload covtype10p_enhanced] [--federations 2] [--turns 3] \\
        [--device cuda] [--rows N]

The data are the cell's, made by the benchmark's generator
(``perfbench/traffic/generator.py``, imported and left as it is) from
``--seed``; ``--rows`` cuts every client to N rows and its validation
slice in proportion, for a rehearsal on the CPU.  Each turn runs the
three modes in a rotated order, each over ``--federations`` federations
from a fresh ``init_state``, the card synchronized before the clock
stops; the profiler's own processing after its window is not timed.
One JSON line a mode and turn, then one with each mode's median rate,
its spans a step, and its cost a step against ``off`` in µs and in %.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODES = ("off", "tracing", "profiler")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="covtype10p_enhanced")
    p.add_argument("--federations", type=int, default=2)
    p.add_argument("--turns", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--rows", type=int, default=0)
    p.add_argument("--seed", type=int, default=2**31 + 5)
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench import harness
    from perfbench.traffic.generator import mesh_inputs, thresholds
    from repro_torch import obs
    from repro_torch.configs.paper_fedboost import (
        CompensationConfig, FedBoostConfig, SchedulerConfig)
    from repro_torch.core import fed_mesh
    from repro_torch.kernels.dispatch import KernelPolicy

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    c = harness.cell(spec, a.workload)
    conf, st = c["config"], harness.settings(c["config"], c["traffic"])
    if a.rows:
        cut = a.rows / conf["rows_per_client"]
        conf = dict(conf, n_samples=int(conf["n_samples"] * cut) + 1,
                    rows_per_client=a.rows,
                    val_rows_per_client=max(
                        1, int(conf["val_rows_per_client"] * cut)))
    dev = torch.device(a.device)
    on_card = dev.type == "cuda"
    if on_card:
        from repro_torch.kernels import build
        build.load()
    arrays = mesh_inputs(conf, a.seed)
    thr = torch.from_numpy(thresholds(arrays[0], conf["n_thresholds"]))
    x, y, xv, yv = (torch.from_numpy(t).to(dev) for t in arrays)
    K, n, _ = x.shape
    R, cap = st["n_rounds"], st["buffer_cap"]
    cfg = FedBoostConfig(n_clients=K, n_rounds=R,
                         scheduler=SchedulerConfig(**st["scheduler"]),
                         compensation=CompensationConfig(
                             **st["compensation"]))
    step = fed_mesh.make_fed_boost_step(cfg, thr.to(dev),
                                        policy=KernelPolicy(env_var=None))
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def federations() -> float:
        """Seconds of the federations, the card's work included."""
        t0 = time.perf_counter()
        for _ in range(a.federations):
            s = fed_mesh.init_state(cfg, K, n, xv.shape[1], cap, K * R,
                                    device=dev)
            for _ in range(R):
                s = step(s, x, y, xv, yv)
        sync()
        return time.perf_counter() - t0

    def run(mode: str):
        """(seconds, spans recorded) of one mode's federations."""
        if mode == "off":
            return federations(), 0
        if mode == "tracing":
            with obs.tracing() as tr:
                secs = federations()
                obs.resolve()
            return secs, tr.started
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        before = obs.profiled_tracer().started if obs.profiled_tracer() \
            else 0
        with profile(activities=acts):
            secs = federations()
        return secs, obs.profiled_tracer().started - before

    obs.disable()
    federations()                                   # warm-up
    steps = a.federations * R
    rates = {m: [] for m in MODES}
    spans = {}
    for turn in range(a.turns):
        for mode in MODES[turn % 3:] + MODES[:turn % 3]:
            secs, n_spans = run(mode)
            rates[mode].append(K * steps / secs)
            spans[mode] = n_spans / steps
            print(json.dumps({"turn": turn, "mode": mode, "seconds": secs,
                              "client_rounds_per_s": rates[mode][-1]}),
                  flush=True)
    med = {m: statistics.median(r) for m, r in rates.items()}
    per_step = {m: K / med[m] * 1e6 for m in MODES}        # µs a step
    out = {"workload": a.workload, "device": (torch.cuda.get_device_name(dev)
                                              if on_card else "cpu"),
           "K": K, "rows": n, "steps_a_mode": steps, "turns": a.turns,
           "median_client_rounds_per_s": med, "spans_a_step": spans,
           "cost_us_a_step": {m: per_step[m] - per_step["off"]
                              for m in MODES[1:]},
           "cost_pct": {m: 100.0 * (per_step[m] / per_step["off"] - 1.0)
                        for m in MODES[1:]}}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
