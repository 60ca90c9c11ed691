#!/usr/bin/env python3
"""Per-device dot FLOPs of the dry run, op by op, in both packages.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/dryrun_dot_breakdown.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/dryrun_dot_breakdown.py \\
        --cell jamba-1.5-large-398b/long_500k/pod16x16 --top 12

For each cell (arch/shape/mesh, the baseline variant):

* the JAX package: the combination compiled as ``repro.launch.dryrun``
  compiles it, in a process of its own (the module fixes 512 placeholder
  devices when JAX starts); its HLO text is parsed with
  ``repro.launch.hlo_analysis.parse_hlo`` and every ``dot`` counted as
  ``analyze`` counts it (2 * prod(result) * prod(contracted), times the
  product of the known trip counts of the while loops around it), grouped
  by the op's ``metadata={op_name=...}`` (XLA's text keeps the source
  line only as a stack-frame id);
* the port: ``repro_torch.launch.dryrun.trace_step`` on the fake
  production mesh (``--device cpu``), its ``CostMode.dot_rows`` grouped
  by issuing frame (a backward matmul under its forward op's frame,
  marked ``(backward)``), each row with the local operand shapes it ran
  on.

It prints, a cell at a time, both totals (which equal the two dry runs'
``flops_corrected``) and the largest groups of each, and with ``--json
OUT`` writes every group.

``--sweep`` instead reads both packages' sweep records
(``artifacts/dryrun/`` from ``python -m repro.launch.dryrun --all
[--multi-pod]``, ``artifacts/dryrun_torch/`` from ``python -m
repro_torch.launch.dryrun --all [--multi-pod] --device cpu``) and prints
every combination's per-device TFLOP in the port, its ratio to the JAX
package's ``flops_corrected`` and the ratio once the flash calls' C6 gap
(:func:`flash_gap`, from the record's ``dot_rows``) is added back,
with the trace wall::

    PYTHONPATH=src python3 tools/dryrun_dot_breakdown.py --sweep

It runs the JAX package and is not part of the port.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# the dry run's per-device gaps (ROADMAP C8), each cell arch/shape/mesh
CELLS = ("jamba-1.5-large-398b/long_500k/pod16x16",
         "jamba-1.5-large-398b/long_500k/pod2x16x16",
         "whisper-base/decode_32k/pod16x16",
         "qwen3-moe-30b-a3b/train_4k/pod16x16",
         "mamba2-1.3b/train_4k/pod16x16",
         "mamba2-1.3b/prefill_32k/pod16x16",
         "gemma2-27b/long_500k/pod16x16",
         "llama4-scout-17b-a16e/decode_32k/pod16x16")

REFERENCE = textwrap.dedent("""
    import json, re, sys
    from collections import defaultdict
    from repro.launch import dryrun, hlo_analysis as ha   # fixes 512 devices
    arch, shape, multi_pod, variant = (sys.argv[1], sys.argv[2],
                                       sys.argv[3] == "1", sys.argv[4])
    seen = []
    analyze = dryrun.hlo_analyze
    dryrun.hlo_analyze = lambda text: seen.append(text) or analyze(text)
    rec = dryrun.run_one(arch, shape, multi_pod=multi_pod, variant=variant,
                         force=True)
    assert rec["status"] == "ok", rec.get("traceback")
    text = seen[0]
    comps = ha.parse_hlo(text)
    shapes = {op.name: op.dims for ops in comps.values() for op in ops}
    entry = re.search(r"^ENTRY\\s+(%?[\\w.\\-]+)", text, re.M).group(1)
    mult = defaultdict(float)

    def visit(comp, m_in):          # analyze's walk, as it is there
        if comp not in comps or mult[comp] >= m_in:
            return
        mult[comp] = m_in
        for op in comps[comp]:
            tm = ha._TRIP_RE.search(op.rhs)
            trip = int(tm.group(1)) if tm else 1
            for cre in ha._CALLEE_RES:
                for cm in cre.finditer(op.rhs):
                    for t in re.findall(r"%[\\w.\\-]+", cm.group(1)):
                        body = "body=" + t in op.rhs and op.opcode == "while"
                        visit(t, m_in * (trip if body else 1))

    visit(entry, 1.0)
    groups = {}
    for comp, ops in comps.items():
        m_ = mult.get(comp, 0.0)
        if not m_:
            continue
        for op in ops:
            if op.opcode != "dot":
                continue
            rm = re.search(r"\\(\\s*(?:[a-z0-9]+\\[[\\d,]*\\](?:\\{[^}]*\\})?"
                           r"\\s+)?(%[\\w.\\-]+)", op.rhs)
            cm = re.search(r"lhs_contracting_dims=\\{([\\d,]*)\\}", op.rhs)
            lhs = shapes.get(rm.group(1)) if rm else None
            if not (cm and lhs is not None and op.dims is not None):
                continue
            contracted = 1
            for d in cm.group(1).split(","):
                if d:
                    contracted *= lhs[int(d)]
            n = 1
            for d in op.dims:
                n *= d
            f = 2.0 * n * contracted * m_
            name = re.search(r'op_name="([^"]*)"', op.rhs)
            key = name.group(1) if name else "(no op_name)"
            g = groups.setdefault(key, {"count": 0, "flops": 0.0,
                                        "rows": {}})
            g["count"] += m_
            g["flops"] += f
            row = g["rows"].setdefault(f"{list(lhs)} {list(op.dims)}",
                                       [list(lhs), list(op.dims), 0, 0.0])
            row[2] += m_
            row[3] += f
    for g in groups.values():
        g["rows"] = sorted(g["rows"].values(), key=lambda r: -r[3])
    print(json.dumps({"flops_corrected": rec["flops_corrected"],
                      "groups": groups}))
""")


def reference(arch: str, shape: str, multi_pod: bool,
              variant: str = "baseline") -> dict:
    """The JAX package's per-device dot FLOPs of one combination, by
    ``op_name``: {"flops_corrected", "groups": {op_name: {"count",
    "flops", "rows": [[lhs dims, result dims, count, flops]]}}}."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REFERENCE, arch, shape,
                          "1" if multi_pod else "0", variant], env=env,
                         capture_output=True, text=True, cwd=ROOT)
    if out.returncode != 0:
        raise SystemExit(f"reference {arch} {shape} failed:\n"
                         f"{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def port(arch: str, shape: str, multi_pod: bool,
         variant: str = "baseline") -> dict:
    """The port's per-device dot FLOPs of one combination on the fake
    production mesh, by issuing frame: {"flops_corrected", "groups":
    {issuer: {"count", "flops", "rows": [[op, shapes, count, flops]]}}}."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_arch, get_shape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh, release
    data, model = dryrun.mesh_split(variant)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, data=data,
                                    model=model, device="cpu")
        res = dryrun.trace_step(get_arch(arch), get_shape(shape), mesh,
                                dryrun.policy_for(variant, mesh),
                                remat=variant != "no_remat", device="cpu")
    finally:
        release()
    groups = {}
    for (op, shapes, who), (n, f) in res["mode"].dot_rows.items():
        g = groups.setdefault(who, {"count": 0, "flops": 0.0, "rows": []})
        g["count"] += n
        g["flops"] += f
        g["rows"].append([op, [list(s) for s in shapes], n, f])
    for g in groups.values():
        g["rows"].sort(key=lambda r: -r[3])
    return {"flops_corrected": res["record"]["flops_corrected"],
            "groups": groups}


def breakdown(cell: str) -> dict:
    arch, shape, mesh = cell.split("/")
    multi = mesh == "pod2x16x16"
    return {"reference": reference(arch, shape, multi),
            "port": port(arch, shape, multi)}


def show(cell: str, b: dict, top: int) -> None:
    ref, prt = b["reference"], b["port"]
    rt, pt = ref["flops_corrected"], prt["flops_corrected"]
    print(f"\n== {cell}: port {pt:.6e}, JAX {rt:.6e}, "
          f"port / JAX {pt / rt if rt else float('nan'):.4f}")
    print("  JAX by op_name (flops, count; largest rows: lhs, result "
          "dims):")
    for k, g in sorted(ref["groups"].items(), key=lambda kv: -kv[1]["flops"]
                       )[:top]:
        rows = "; ".join(f"{r[0]} -> {r[1]} x{r[2]:g}" for r in g["rows"][:2])
        print(f"    {g['flops']:.4e} x{g['count']:g} {k[-60:]}  {rows}")
    print("  port by issuing frame (flops, count; largest rows: op, "
          "local shapes):")
    for k, g in sorted(prt["groups"].items(), key=lambda kv: -kv[1]["flops"]
                       )[:top]:
        rows = "; ".join(f"{r[0]} {r[1]} x{r[2]}" for r in g["rows"][:2])
        print(f"    {g['flops']:.4e} x{g['count']} {k}  {rows}")


def flash_gap(rows) -> float:
    """What a chunked softmax computes beyond the flash calls of ``rows``
    ([op, operand shapes, issuer, count, flops] a row): both products
    over the whole (Tq, Tk) square of each call, q (B, H, Tq, d) and k
    (B, Hkv, Tk, d), less the op's formula (the causal half; the whole
    square where unmasked).  The JAX package's LM stack runs no flash kernel
    (ROADMAP C6)."""
    gap = 0.0
    for op, shapes, _, n, f in rows:
        if op == "flash_attention":
            (b, h, tq, d), (_, _, tk, _) = shapes[:2]
            gap += n * 4.0 * b * h * tq * tk * d - f
    return gap


def sweep(mesh: str) -> list:
    """(arch, shape, port TFLOP, port / JAX, (port + C6 gap) / JAX, trace
    s) for every combination both sweeps recorded on ``mesh``; a skipped
    one as (arch, shape, None, ...)."""
    rows = []
    for f in sorted((ROOT / "artifacts" / "dryrun_torch").glob(
            f"*__{mesh}__baseline.json")):
        p = json.loads(f.read_text())
        ref = ROOT / "artifacts" / "dryrun" / f.name
        if p["status"] != "ok" or not ref.exists():
            rows.append((p["arch"], p["shape"], None, p["status"]))
            continue
        r = json.loads(ref.read_text())
        pt, rt = p["flops_corrected"], r["flops_corrected"]
        gap = flash_gap(p["dot_rows"])
        rows.append((p["arch"], p["shape"], pt / 1e12, pt / rt,
                     (pt + gap) / rt, p["trace_s"]))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--cell", action="append", default=None,
                    help="arch/shape/mesh (default: every C8 cell)")
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if args.sweep:
        for mesh in ("pod16x16", "pod2x16x16"):
            print(f"== {mesh}: arch shape TFLOP/dev port/JAX "
                  f"(port+C6)/JAX trace_s")
            for row in sweep(mesh):
                if row[2] is None:
                    print(f"  {row[0]:24s} {row[1]:12s} {row[3]}")
                else:
                    print(f"  {row[0]:24s} {row[1]:12s} {row[2]:.6g} "
                          f"{row[3]:.4f} {row[4]:.4f} {row[5]}")
        return
    out = {}
    for cell in args.cell or CELLS:
        out[cell] = breakdown(cell)
        show(cell, out[cell], args.top)
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
