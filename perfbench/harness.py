"""The benchmark's run of one cell: set-up, the timed window, the traced
segment, the check against the plain reference, and the result line.

Everything a cell needs is found by name: the configuration's file is the
one ``BENCHMARK.json`` names, the traffic mix is ``traffic/<name>.json``,
the check's limits are ``limits/<workload>.json``, each end-to-end metric
is ``end_to_end/<name>.py`` and each per-layer metric ``metrics/<name>.py``,
each with a ``read(ctx)`` function (see ``Context``) that returns the
metric's value, or None where the run has nothing for it to read.  A
metric named ``<base>.<variant>`` without a file of its own is read by
``<base>.py``: the same quantity, split by the end-to-end metric it moves.
A cell's per-layer metrics are those that list it under ``workloads``, and
those without the key that move one of the cell's end-to-end metrics.

The window drives ``repro_torch.core.fed_mesh``'s step over whole
federations back to back, each from a fresh ``init_state``, with every
dispatched kernel choice left to a ``KernelPolicy`` that reads no
environment.  The states of one federation of the window (drawn from the
seed) are kept and judged by ``reference.fedboost.judge`` once the window
has closed and the program's tensors are freed.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from bisect import bisect_right
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACED_FEDERATIONS = 4       # whole federations under the profiler
CHECKED = 4                  # the judged federation is one of the first four


# --------------------------------------------------------------- discovery
def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell(spec: Dict, workload: str, bench_dir: Path = HERE) -> Dict:
    """The cell's entries and files, found by name."""
    wl = {w["name"]: w for w in spec["workloads"]}.get(workload)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in the benchmark")
    conf = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    mine = lambda ms: [m for m in ms
                       if workload in m.get("workloads", [workload])]
    end_to_end = mine(spec["end_to_end"])
    rates = {m["name"] for m in end_to_end}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in rates)]
    return {"workload": wl,
            "config": load_json(bench_dir.parent / conf["file"]),
            "traffic": load_json(bench_dir / "traffic" /
                                 f"{wl['traffic']}.json"),
            "limits": load_json(bench_dir / "limits" / f"{workload}.json"),
            "per_layer": per_layer, "end_to_end": end_to_end,
            "readers": {m["name"]: reader("metrics", m["name"], bench_dir)
                        for m in per_layer},
            "e2e_readers": {m["name"]: reader("end_to_end", m["name"],
                                              bench_dir)
                            for m in end_to_end}}


def reader(kind: str, name: str, bench_dir: Path = HERE) -> Callable:
    """``read`` of ``<kind>/<name>.py``, or of ``<kind>/<base>.py`` for a
    ``<base>.<variant>`` without a file of its own."""
    path = bench_dir / kind / f"{name}.py"
    if not path.is_file() and "." in name:
        path = bench_dir / kind / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def settings(config: Dict, traffic: Dict) -> Dict:
    """The schedule the cell runs: the configuration's, with the traffic
    mix's keys over it."""
    out = {"scheduler": {**config["scheduler"],
                         **traffic.get("scheduler", {})},
           "compensation": {**config["compensation"],
                            **traffic.get("compensation", {})},
           "buffer_cap": traffic["buffer_cap"],
           "n_rounds": traffic["n_rounds"]}
    if out["buffer_cap"] < out["scheduler"]["i_max"]:
        raise ValueError("a buffer shorter than the longest interval wraps")
    return out


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


# --------------------------------------------------------------- the record
def _host(state) -> Dict:
    return {"D": state.D.cpu(), "buf_params": state.buf_params.cpu(),
            "buf_stamp": state.buf_stamp.cpu(),
            "buf_count": state.buf_count.cpu(),
            "val_margin": state.val_margin.cpu(),
            "interval": float(state.interval),
            "prev_err": float(state.prev_err), "counter": state.counter,
            "last_sync": state.last_sync, "sync_count": state.sync_count,
            "ens_count": state.ens_count}


def record_from_states(states) -> Dict:
    """One federation's record for the judge (``reference.fedboost``), on
    the host, from the program's states: ``states[0]`` before round 0 and
    ``states[r + 1]`` after round r.  A round that synced also gives the
    rows it folded into the ensemble."""
    out = [_host(states[0])]
    for before, after in zip(states, states[1:]):
        rec = _host(after)
        if after.sync_count != before.sync_count:
            lo, hi = before.ens_count, after.ens_count
            rec.update(block=after.ens_params[lo:hi].cpu(),
                       alpha=after.ens_alpha[lo:hi].cpu())
        out.append(rec)
    return {"states": out, "ens_params": states[-1].ens_params.cpu(),
            "ens_alpha": states[-1].ens_alpha.cpu()}


# --------------------------------------------------------------- the trace
def read_trace(prof) -> Dict:
    """Device seconds and events by operation name, the busy seconds (the
    union of every device operation's interval; a user annotation's range
    on the device is no operation), and the ten largest device operations
    and idle gaps (each gap named by the innermost host operation running
    at its middle).  Reads the profiler's raw events, with the names and
    the filter that ``prof.events()`` gives them, without building its
    event tree (which takes tens of seconds for four federations)."""
    import torch
    from torch.autograd.profiler_util import _filter_name, _rewrite_name
    cuda = torch.autograd.DeviceType.CUDA
    ops: Dict[str, List[float]] = {}
    spans, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if _filter_name(name) or getattr(e, "is_hidden_event",
                                         lambda: False)():
            continue
        name = _rewrite_name(name, with_wildcard=True)
        a, b = e.start_ns(), e.end_ns()
        if e.device_type() != cuda:
            host.append((a, b, name))
        elif not e.is_user_annotation():
            o = ops.setdefault(name, [0.0, 0])
            o[0] += (b - a) * 1e-9
            o[1] += 1
            spans.append((a, b))
    spans.sort()
    busy, gaps, cur = 0.0, [], None
    for a, b in spans:
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], a))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    host.sort(key=lambda e: (e[0], -e[1]))     # an outer event first
    starts = [e[0] for e in host]
    idle: Dict[str, float] = {}
    for a, b in gaps:
        mid, name = (a + b) / 2, "python"
        i = bisect_right(starts, mid)
        for e in reversed(host[max(0, i - 16):i]):
            if e[1] >= mid:
                name = e[2]
                break
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-9
    top = lambda d: [[k, v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy * 1e-9, "device_ops": ops,
            "breakdown": {"device_ops": top({k: v[0]
                                             for k, v in ops.items()}),
                          "idle_gaps": top(idle)}}


def misses(x, y, thr) -> int:
    """Cells of the (row, feature, threshold) grid where x > threshold
    disagrees with y > 0: the scan's f64 adds."""
    n = 0
    for k in range(x.shape[0]):
        n += int(((x[k, :, :, None] > thr[None]) !=
                  (y[k, :, None, None] > 0)).sum())
    return n


# --------------------------------------------------------------- the run
class Context(dict):
    """What the metric readers read:

    ``shape``: the cell's ``K``, ``n``, ``nv`` (rows and validation rows a
    client), ``F``, ``T`` (grid columns) and ``cap`` (buffer slots);
    ``steps``: one ``(synced, n_buf)`` pair for each step of the window
    (``n_buf`` the buffered rounds a sync folded, 0 without a sync);
    ``window_s``; ``rounds``; ``setup_s``; ``peak_bytes``; in a traced run
    ``round_ms`` / ``sync_ms``: device ms of each step of the window that
    did not / did sync (CUDA events around the step call); and in a traced
    run, or one on a card whose cell has an end-to-end metric read from the
    device's trace, ``traced``: the traced segment's ``steps``, ``seconds``,
    ``busy_s``, ``misses`` (the scan's f64 adds a call) and ``device_ops``
    ({operation name: [device seconds, events]})."""


def run(spec: Dict, workload: str, seed: int, seconds: float, trace: bool,
        device: str, t_process: float, bench_dir: Path = HERE,
        fault: Optional[Callable] = None) -> Dict:
    """One run of a cell; returns the result line's object and the checks.
    ``fault`` wraps the program's step (the tests and ``calibrate.py``
    plant faults through it)."""
    import torch

    t_import = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    from perfbench.reference.fedboost import judge
    from perfbench.traffic.generator import mesh_inputs, thresholds
    from repro_torch.configs.paper_fedboost import (
        CompensationConfig, FedBoostConfig, SchedulerConfig)
    from repro_torch.core import fed_mesh
    from repro_torch.kernels.dispatch import KernelPolicy

    c = cell(spec, workload, bench_dir)
    conf, st = c["config"], settings(c["config"], c["traffic"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    t_build = time.perf_counter()
    if on_card:
        from repro_torch.kernels import build
        build.load()
    t_data = time.perf_counter()
    arrays = mesh_inputs(conf, seed)
    thr = thresholds(arrays[0], conf["n_thresholds"])
    x, y, xv, yv = (torch.from_numpy(a).to(dev) for a in arrays)
    thr_t = torch.from_numpy(thr).to(dev)
    K, n, F = x.shape
    nv, R, cap = xv.shape[1], st["n_rounds"], st["buffer_cap"]
    cfg = FedBoostConfig(n_clients=K, n_rounds=R,
                         scheduler=SchedulerConfig(**st["scheduler"]),
                         compensation=CompensationConfig(
                             **st["compensation"]))
    policy = KernelPolicy(env_var=None)
    step = fed_mesh.make_fed_boost_step(cfg, thr_t, policy=policy)
    if fault is not None:
        step = fault(step)
    fresh = lambda: fed_mesh.init_state(cfg, K, n, nv, cap, K * R,
                                        device=dev)
    inputs = (x, y, xv, yv)

    def sync_():
        if on_card:
            torch.cuda.synchronize(dev)

    def advance(s):
        """The step after ``s``, and its ``(synced, n_buf)``."""
        new = step(s, *inputs)
        synced = new.sync_count != s.sync_count
        return new, (synced, min(new.counter - s.last_sync, cap)
                     if synced else 0)

    # set-up: a local round and a sync at the cell's shapes (a sync's
    # shapes do not depend on how many slots it folds)
    t_warm = time.perf_counter()
    s = fresh()
    for _ in range(R):
        s, (synced, _) = advance(s)
        if synced:
            break
    sync_()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_process

    # the window
    ctx = Context(shape=dict(K=K, n=n, nv=nv, F=F, T=thr.shape[1], cap=cap),
                  steps=[], setup_s=setup_s)
    j = seed % CHECKED            # the federation the check judges
    judged: Optional[list] = None
    timed: List[tuple] = []
    feds = 0
    new = None
    fed_syncs: List[int] = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    done = False
    while not done:
        s = fresh()
        states = [s] if feds == j else None
        for _ in range(R):
            if time.perf_counter() >= deadline:
                done = True
                break
            if trace and on_card:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                new, took = advance(s)
                b.record()
                timed.append((took[0], a, b))
            else:
                new, took = advance(s)
            ctx["steps"].append(took)
            s = new
            if states is not None:
                states.append(s)
        if states is not None:
            judged = states
        if not done:
            fed_syncs.append(s.sync_count)
        feds += 1
    sync_()
    window_s = time.perf_counter() - t0
    ctx.update(window_s=window_s, rounds=len(ctx["steps"]))
    if trace:
        ctx.update(round_ms=[], sync_ms=[])
    for synced, a, b in timed:
        ctx["sync_ms" if synced else "round_ms"].append(a.elapsed_time(b))
    ctx["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if on_card else 0)
    del s, new
    # the judged federation, where the window closed before it ended, is
    # run to its end after the close (late, not wrong)
    while judged is None:
        late = [fresh()]
        judged = late if feds == j else None
        feds += 1
        while len(late) < R + 1:
            late.append(step(late[-1], *inputs))
    while len(judged) < R + 1:
        judged.append(step(judged[-1], *inputs))

    # the traced segment: whole federations under the profiler, after the
    # window, in a traced run, and on a card where an end-to-end metric
    # reads the device's trace
    trace_out = None
    if trace or on_card and any(m["source"] == "device_trace"
                                for m in c["end_to_end"]):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        traced_steps = []
        with profile(activities=acts) as prof:
            tt = time.perf_counter()
            for _ in range(TRACED_FEDERATIONS):
                s = fresh()
                for _ in range(R):
                    s, took = advance(s)
                    traced_steps.append(took)
            sync_()
            traced_s = time.perf_counter() - tt
        del s
        trace_out = read_trace(prof)
        ctx["traced"] = dict(trace_out, steps=traced_steps,
                             seconds=traced_s, misses=misses(x, y, thr_t))

    choices = sorted(set(policy.choices.values()))

    # the check, once the program's tensors are freed
    record = record_from_states(judged)
    del judged, inputs, x, y, xv, yv, thr_t, step
    if on_card:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    got = judge(record, (*arrays, thr), st, device=dev)
    checks = {k: {"value": v, "limit": c["limits"][k]}
              for k, v in got.items()}
    t_judge = time.perf_counter() - t_judge
    want_choice = ["cuda"] if on_card else ["torch"]
    checks["kernel_choices"] = {"value": int(choices != want_choice),
                                "limit": 0}
    # (a JAX module in the process is ``run.py``'s to refuse: it prints
    # no result then)
    correct = all(v["value"] <= v["limit"] for v in checks.values()) \
        and ctx["rounds"] > 0

    metrics = {}
    for m in (c["per_layer"] if trace else c["end_to_end"]):
        read = c["readers" if trace else "e2e_readers"][m["name"]]
        v = read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(ctx["peak_bytes"])}
    line = {"correct": bool(correct), "attempted": ctx["rounds"],
            "failed": 0 if correct else R,
            "metrics": metrics, "device": device_info}
    if trace:
        device_info.update(busy_s=trace_out["busy_s"], window_s=traced_s)
        line["breakdown"] = trace_out["breakdown"]
    line["checks"] = checks
    parts = (t_import - t_process, t_build - t_import, t_data - t_build,
             t_warm - t_data, setup_s + t_process - t_warm)
    notes = (f"perfbench: {workload} seed {seed}: setup {setup_s:.3f} s "
             "(torch import, program import, kernels' build or load, data "
             f"and state, warm-up round and sync: "
             f"{', '.join(f'{p:.3f}' for p in parts)} s), "
             f"window {window_s:.3f} s, {ctx['rounds']} rounds in {feds} "
             f"federations (syncs a whole one: {sorted(set(fed_syncs))}), "
             f"judged federation {j}, judge {t_judge:.3f} s, choices "
             f"{choices}")
    return {"line": line, "context": ctx, "notes": notes,
            "federations": feds, "fed_syncs": fed_syncs,
            "choices": choices}


def finite(v):
    """A check's value as JSON takes it."""
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    return v


def emit(result: Dict, out=sys.stdout, err=sys.stderr) -> None:
    """The checks on standard error, last, and the result's line as the
    last line of standard output."""
    line = result["line"]
    for k, v in line["checks"].items():
        line["checks"][k] = {"value": finite(v["value"]),
                             "limit": v["limit"]}
    out.flush()
    print(result["notes"], file=err)
    for k, v in line["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=err)
    err.flush()
    print(json.dumps(line, allow_nan=False), file=out)
    out.flush()
