"""Hillclimb profiling tool: trace one (arch x shape x variant) combo on
the production mesh and print its collectives ranked by bytes x count,
and its biggest matmuls.

A port of the JAX package's ``launch/inspect_combo.py``.  The port has no
HLO ``op_name`` metadata: each collective row names the innermost frame
of the port's model or kernel code that issued it
(``cost_analysis.issuer``, e.g. ``models/attention.py:attn_apply``), and
rows with the same (kind, dtype, shape, issuer) are one row with their
count::

    PYTHONPATH=src python -m repro_torch.launch.inspect_combo \\
        --arch qwen3-moe-30b-a3b --shape train_4k [--variant baseline] \\
        [--multi-pod] [--top 15] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

from repro_torch.configs.registry import get_arch, get_shape
from repro_torch.launch.dryrun import (
    VARIANTS, mesh_split, policy_for, trace_step)


def trace_combo(arch: str, shape_name: str, variant: str = "baseline",
                multi_pod: bool = False, device: str = "cuda") -> Dict:
    """Trace the combo (``dryrun.trace_step`` on the production mesh);
    returns its result dict (``record``, ``mode`` with the rows)."""
    from repro_torch.launch.mesh import make_production_mesh
    data, model = mesh_split(variant)
    mesh = make_production_mesh(multi_pod=multi_pod, data=data, model=model,
                                device=device)
    return trace_step(get_arch(arch), get_shape(shape_name), mesh,
                      policy_for(variant, mesh),
                      remat=variant != "no_remat", device=device)


def breakdown(mode, top: int = 15) -> Tuple[List[tuple], List[tuple]]:
    """(collective rows, dot rows), each sorted by total bytes or FLOPs:
    (bytes x count, bytes once, count, kind, dtype, shape, issuer) and
    (flops, count, op, operand shapes, issuer)."""
    groups: Dict[tuple, List] = {}
    for r in mode.coll_rows:
        key = (r["kind"], r["dtype"], str(r["shape"])[:38], r["issuer"])
        g = groups.setdefault(key, [0, r["bytes"]])
        g[0] += 1
    coll = sorted(((b * n, b, n) + key for key, (n, b) in groups.items()),
                  reverse=True)[:top]
    dots = sorted(((f, n, op, str(shapes)[:38], who)
                   for (op, shapes, who), (n, f) in mode.dot_rows.items()),
                  reverse=True)[:top]
    return coll, dots


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from repro_torch.launch.mesh import release
    try:
        res = trace_combo(args.arch, args.shape, args.variant,
                          args.multi_pod, args.device)
    finally:
        release()
    rec = res["record"]
    coll, dots = breakdown(res["mode"], args.top)
    print(f"\n{args.arch} x {args.shape} x {args.variant}")
    print(f"flops/dev {rec['flops_corrected'] / 1e12:.2f} TF | "
          f"collective {rec['collective_bytes_total'] / 1e9:.1f} GB/dev | "
          f"redistributions {rec['redistributions']}")
    print(f"{'GB(w)':>8} {'MB(1)':>9} {'x':>5}  {'op':<15} {'dt':<9} "
          f"{'shape':<38} issuer")
    for w, b, n, kind, dt, shape, who in coll:
        print(f"{w / 1e9:>8.2f} {b / 1e6:>9.2f} {n:>5d}  {kind:<15} "
              f"{dt:<9} {shape:<38} {who}")
    print(f"\n{'TFLOP':>8} {'x':>5}  {'op':<16} {'operands':<38} issuer")
    for f, n, op, shapes, who in dots:
        print(f"{f / 1e12:>8.3f} {n:>5d}  {op:<16} {shapes:<38} {who}")


if __name__ == "__main__":
    main()
