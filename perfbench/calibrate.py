"""The readings the check's limits are set from: the program's numbers
over many seeds, the control's (the plain reference in bfloat16 in the
program's place) and each planted fault's, at a cell's own size.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--program] [--control] [--faults unchanged,half_batch,...] \\
        [--seconds 2]

One JSON line a reading on standard output.  The program's and the faults'
readings come from short runs of the harness (``--seconds`` of window);
the control needs no window.  The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from perfbench import faults, harness
    from perfbench.reference.fedboost import control, judge
    from perfbench.traffic.generator import mesh_inputs, thresholds
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    seeds = [int(s) for s in a.seeds.split(",")]
    c = harness.cell(spec, a.workload)
    st = harness.settings(c["config"], c["traffic"])

    def show(kind, seed, checks, **more):
        print(json.dumps({"kind": kind, "seed": seed, **more,
                          "checks": {k: harness.finite(v) for k, v in
                                     checks.items()}}), flush=True)

    def program(kind, seed, wrap):
        r = harness.run(spec, a.workload, seed, a.seconds, False, "cuda",
                        time.perf_counter(), fault=wrap)
        show(kind, seed, {k: v["value"] for k, v in
                          r["line"]["checks"].items()},
             correct=r["line"]["correct"], rounds=r["line"]["attempted"],
             federations=len(r["fed_syncs"]),
             fed_syncs=sorted(set(r["fed_syncs"])),
             metrics={k: v["value"] for k, v in
                      r["line"]["metrics"].items()})
    for seed in seeds:
        if a.program:
            program("program", seed, None)
        if a.control:
            arrays = mesh_inputs(c["config"], seed)
            inputs = (*arrays, thresholds(arrays[0],
                                          c["config"]["n_thresholds"]))
            t0 = time.perf_counter()
            rec = control(inputs, st, st["n_rounds"], torch.bfloat16,
                          "cuda")
            t1 = time.perf_counter()
            got = judge(rec, inputs, st, "cuda")
            show("control_bf16", seed, got,
                 syncs=rec["states"][-1]["sync_count"],
                 control_s=t1 - t0, judge_s=time.perf_counter() - t1)
        for name in filter(None, a.faults.split(",")):
            with faults.planted(name) as wrap:
                program(name, seed, wrap)
    return 0


if __name__ == "__main__":
    sys.exit(main())
