"""Trace reporter: where did the time go, from an exported obs trace.

    PYTHONPATH=src python -m repro_torch.launch.obs_report TRACE.jsonl
    PYTHONPATH=src python -m repro_torch.launch.obs_report TRACE.jsonl \
        --metrics METRICS.json --top 20 --folded out.folded --check

Reads the JSON Lines trace written by ``Tracer.export_jsonl`` (the JAX
package's schema, ``src/repro/obs/README.md``) and prints:

* **top spans** aggregated by name — count, total/self wall time, p50/p99
  span duration (self time excludes child spans, so a phase that merely
  *contains* the work doesn't dominate its own children);
* a **per-phase breakdown** by namespace prefix (``train.`` / ``serve.`` /
  ``kernel.`` / ``gossip.`` / ...) of self wall time;
* with ``--metrics``, the **kernel profile** table from the registry
  snapshot's ``kernel.wall_s{...}`` histograms, cross-checked against the
  persisted backend-calibration table (a calibrated winner that the live
  timings contradict is flagged for recalibration);
* with ``--folded``, flamegraph-style folded stacks (``a;b;c <usec>`` of
  self time per unique stack — feed to any FlameGraph renderer).

``--check`` validates the trace instead of decorating it: every line must
parse, every parent must exist and wall-contain its children (missing
parents/links are tolerated only when the export header records ring
drops, with a warning), trace ids must be consistent (a span whose stack
parent sits in another trace must link into its own), and every
``serve.request`` must decompose (queue_s + batch_s + kernel_s ==
latency_s == sim_t1 - sim_t0) within tolerance.  Exits non-zero on any
violation.

``--stitch KEY`` assembles the cross-host causal tree for one trace —
KEY is a trace id, ``rid:N``, or ``auto`` (the slowest serve.request) —
and prints its members plus every span linking into it, with hosts and
sim-clock bounds, then reconciles the stitched end-to-end latency
against the queue+batch+kernel decomposition.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.obs import load_trace, percentile

TOL = 1e-6      # seconds of slack for float accumulation in checks


# ------------------------------------------------------------------ analysis
def self_times(spans: List[Dict]) -> Dict[int, float]:
    """Wall self time per span id: own duration minus direct children."""
    dur = {s["span"]: (s["t1"] or s["t0"]) - s["t0"] for s in spans}
    child_sum: Dict[int, float] = defaultdict(float)
    for s in spans:
        if s["parent"] is not None:
            child_sum[s["parent"]] += dur[s["span"]]
    return {sid: max(0.0, d - child_sum.get(sid, 0.0))
            for sid, d in dur.items()}

def aggregate(spans: List[Dict]) -> List[Dict]:
    """Per-name aggregate rows, sorted by total wall time descending."""
    self_t = self_times(spans)
    rows: Dict[str, Dict] = {}
    for s in spans:
        r = rows.setdefault(s["name"], {"name": s["name"], "count": 0,
                                        "total_s": 0.0, "self_s": 0.0,
                                        "durs": []})
        d = (s["t1"] or s["t0"]) - s["t0"]
        r["count"] += 1
        r["total_s"] += d
        r["self_s"] += self_t[s["span"]]
        r["durs"].append(d)
    out = []
    for r in rows.values():
        out.append({"name": r["name"], "count": r["count"],
                    "total_s": r["total_s"], "self_s": r["self_s"],
                    "p50_s": percentile(r["durs"], 50.0),
                    "p99_s": percentile(r["durs"], 99.0)})
    return sorted(out, key=lambda r: -r["total_s"])

def phase_breakdown(spans: List[Dict]) -> List[Tuple[str, float, int]]:
    """(namespace, self wall seconds, span count), biggest first."""
    self_t = self_times(spans)
    agg: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for s in spans:
        ns = s["name"].split(".", 1)[0]
        agg[ns][0] += self_t[s["span"]]
        agg[ns][1] += 1
    return sorted(((ns, v[0], int(v[1])) for ns, v in agg.items()),
                  key=lambda r: -r[1])

def folded_stacks(spans: List[Dict]) -> Dict[str, int]:
    """Flamegraph folded stacks: 'root;child;leaf' -> self usec."""
    by_id = {s["span"]: s for s in spans}
    self_t = self_times(spans)

    def stack(s: Dict) -> str:
        names = [s["name"]]
        seen = {s["span"]}
        p = s["parent"]
        while p is not None and p in by_id and p not in seen:
            seen.add(p)
            names.append(by_id[p]["name"])
            p = by_id[p]["parent"]
        return ";".join(reversed(names))

    out: Dict[str, int] = defaultdict(int)
    for s in spans:
        usec = int(round(1e6 * self_t[s["span"]]))
        if usec > 0:
            out[stack(s)] += usec
    return dict(out)


# --------------------------------------------------------------- validation
def check_trace(spans: List[Dict],
                meta: Optional[Dict] = None) -> List[str]:
    """Structural violations in a trace (empty list = valid).

    ``meta`` is the export header (``load_trace``).  A bounded ring may
    legitimately have dropped the parent of a retained child — missing
    parents are only violations when the header proves nothing was dropped
    (or for legacy headerless traces, which predate drop accounting and
    were always checked strictly)."""
    errors: List[str] = []
    dropped = int(meta.get("dropped", 0)) if meta else 0
    tolerate_missing = meta is not None and dropped > 0
    by_id: Dict[int, Dict] = {}
    for s in spans:
        if s["span"] in by_id:
            errors.append(f"duplicate span id {s['span']}")
        by_id[s["span"]] = s
    for s in spans:
        if s["t1"] is None:
            errors.append(f"span {s['span']} ({s['name']}) never ended")
            continue
        if s["t1"] < s["t0"]:
            errors.append(f"span {s['span']} ({s['name']}) ends before "
                          f"it starts")
        p = by_id.get(s["parent"]) if s["parent"] is not None else None
        if s["parent"] is not None and p is None:
            if not tolerate_missing:
                errors.append(f"span {s['span']} ({s['name']}) references "
                              f"missing parent {s['parent']}")
        elif p is not None and p["t1"] is not None:
            if s["t0"] < p["t0"] - TOL or s["t1"] > p["t1"] + TOL:
                errors.append(
                    f"span {s['span']} ({s['name']}) escapes parent "
                    f"{p['span']} ({p['name']}) wall window")
        # trace-id consistency (schema 2 spans only): the stack parent may
        # belong to a different trace (a serve.batch wall-contains requests
        # of many traces) — but then the span must carry an explicit link
        # into its *own* trace, or its causal history is unreachable
        tid = s.get("trace")
        if tid:
            links = s.get("links", [])
            if (p is not None and p.get("trace")
                    and p["trace"] != tid
                    and not any(lt == tid for lt, _ in links)):
                errors.append(
                    f"span {s['span']} ({s['name']}) in trace {tid} has "
                    f"stack parent in trace {p['trace']} but no link "
                    f"into its own trace")
            for lt, lsid in links:
                target = by_id.get(lsid)
                if target is None:
                    if not tolerate_missing:
                        errors.append(
                            f"span {s['span']} ({s['name']}) links to "
                            f"missing span {lsid}")
                elif target.get("trace") and target["trace"] != lt:
                    errors.append(
                        f"span {s['span']} ({s['name']}) link claims span "
                        f"{lsid} is in trace {lt} but it is in "
                        f"{target['trace']}")
        if s["name"] == "serve.request":
            a = s["attrs"]
            parts = a.get("queue_s", 0) + a.get("batch_s", 0) + \
                a.get("kernel_s", 0)
            if abs(parts - a.get("latency_s", 0)) > TOL:
                errors.append(
                    f"serve.request {s['span']}: queue+batch+kernel = "
                    f"{parts:.6f}s != latency {a.get('latency_s'):.6f}s")
            if (s["sim_t0"] is not None and s["sim_t1"] is not None and
                    abs((s["sim_t1"] - s["sim_t0"])
                        - a.get("latency_s", 0)) > TOL):
                errors.append(
                    f"serve.request {s['span']}: sim interval != latency")
    return errors


# ----------------------------------------------------------------- stitching
def resolve_trace_key(spans: List[Dict], key: str) -> Optional[str]:
    """Resolve a ``--stitch`` key to a trace id.  Accepts a literal trace
    id, ``rid:N`` (the trace of request N), or ``auto`` (the trace of the
    slowest ``serve.request`` — the most interesting one to stitch)."""
    if key == "auto":
        reqs = [s for s in spans
                if s["name"] == "serve.request" and s.get("trace")]
        if not reqs:
            return next((s["trace"] for s in spans if s.get("trace")), None)
        return max(reqs, key=lambda s: s["attrs"].get("latency_s", 0.0)
                   )["trace"]
    if key.startswith("rid:"):
        rid = int(key[4:])
        for s in spans:
            if s.get("trace") and s["attrs"].get("rid") == rid:
                return s["trace"]
        return None
    return key


def stitch_trace(spans: List[Dict], trace_id: str) -> Dict:
    """Assemble the stitched causal tree for one trace: every span *in*
    the trace plus every span that links *into* it (a chain.mint /
    chain.aggregate on another node, a serve.batch host's completion).

    Returns ``{trace, members, hosts, sim_t0, sim_t1, e2e_s, parts_s}``:
    ``e2e_s`` is the trace's simulated-clock extent, ``parts_s`` the sum
    of the serve.request decomposition (queue + batch + kernel) — for a
    request trace the two agree within TOL (the acceptance check)."""
    members: List[Dict] = []
    for s in spans:
        if s.get("trace") == trace_id:
            members.append(dict(s, _edge="member"))
        elif any(lt == trace_id for lt, _ in s.get("links", [])):
            members.append(dict(s, _edge="linked"))
    members.sort(key=lambda s: (s["sim_t0"] if s["sim_t0"] is not None
                                else s["t0"], s["span"]))
    sims0 = [s["sim_t0"] for s in members
             if s["_edge"] == "member" and s["sim_t0"] is not None]
    sims1 = [s["sim_t1"] for s in members
             if s["_edge"] == "member" and s["sim_t1"] is not None]
    parts = sum(s["attrs"].get("queue_s", 0.0)
                + s["attrs"].get("batch_s", 0.0)
                + s["attrs"].get("kernel_s", 0.0)
                for s in members if s["name"] == "serve.request")
    t0 = min(sims0) if sims0 else None
    t1 = max(sims1) if sims1 else None
    return {
        "trace": trace_id,
        "members": members,
        "hosts": sorted({s.get("host", "") for s in members
                         if s.get("host")}),
        "sim_t0": t0, "sim_t1": t1,
        "e2e_s": (t1 - t0) if (t0 is not None and t1 is not None) else None,
        "parts_s": parts if parts > 0 else None,
    }


def print_stitch(st: Dict) -> None:
    print(f"\n-- stitched trace {st['trace']} "
          f"({len(st['members'])} spans, hosts: "
          f"{', '.join(st['hosts']) or '-'}) --")
    print(f"{'sim_t0':>10}{'sim_t1':>10}  {'host':<10}{'edge':<8}"
          f"{'name':<18}detail")
    for s in st["members"]:
        sim0 = f"{s['sim_t0']:.6f}" if s["sim_t0"] is not None else "-"
        sim1 = f"{s['sim_t1']:.6f}" if s["sim_t1"] is not None else "-"
        a = s["attrs"]
        detail = " ".join(f"{k}={a[k]}" for k in
                          ("rid", "tenant", "cid", "seq", "height",
                           "queue_s", "batch_s", "kernel_s", "latency_s")
                          if k in a)
        print(f"{sim0:>10}{sim1:>10}  {s.get('host', '') or '-':<10}"
              f"{s['_edge']:<8}{s['name']:<18}{detail}")
    if st["e2e_s"] is not None:
        line = f"stitched e2e: {st['e2e_s'] * 1e3:.3f} ms (sim extent)"
        if st["parts_s"] is not None:
            delta = abs(st["e2e_s"] - st["parts_s"])
            line += (f" · queue+batch+kernel = {st['parts_s'] * 1e3:.3f} ms"
                     f" · |delta| = {delta * 1e3:.6f} ms")
        print(line)


# ------------------------------------------------------------ kernel profile
_LABELED = re.compile(r"^kernel\.wall_s\{(.*)\}$")

def kernel_profile(metrics_snapshot: Dict,
                   calibration_path: Optional[str] = None
                   ) -> Tuple[List[Dict], List[str]]:
    """(profile rows, calibration warnings) from a registry snapshot.

    Rows come from ``kernel.wall_s{backend=...,bucket=...,kernel=...}``
    histograms.  When a calibration table exists, each (kernel, bucket)
    observed on 2+ backends is checked: if the calibrated winner's p50 is
    not the fastest observed, a recalibration warning is emitted."""
    rows: List[Dict] = []
    launches = metrics_snapshot.get("counters", {})
    for key, h in sorted(metrics_snapshot.get("histograms", {}).items()):
        m = _LABELED.match(key)
        if not m:
            continue
        labels = dict(kv.split("=", 1) for kv in m.group(1).split(","))
        n = launches.get(key.replace("kernel.wall_s", "kernel.launches"),
                         h.get("count", 0))
        rows.append({"kernel": labels.get("kernel", "?"),
                     "bucket": labels.get("bucket", "?"),
                     "backend": labels.get("backend", "?"),
                     "launches": int(n), "p50_s": h["p50"],
                     "p99_s": h["p99"]})
    warnings: List[str] = []
    table: Dict[Tuple[str, str], str] = {}
    if calibration_path and Path(calibration_path).exists():
        data = json.loads(Path(calibration_path).read_text())
        for e in data.get("table", []):
            blabel = "x".join(str(int(d)) for d in e["bucket"])
            table[(e["kernel"], blabel)] = e["backend"]
    if table:
        grouped: Dict[Tuple[str, str], Dict[str, float]] = defaultdict(dict)
        for r in rows:
            grouped[(r["kernel"], r["bucket"])][r["backend"]] = r["p50_s"]
        for (kern, bucket), by_backend in sorted(grouped.items()):
            winner = table.get((kern, bucket))
            if winner is None or winner not in by_backend \
                    or len(by_backend) < 2:
                continue
            best = min(by_backend, key=by_backend.get)
            if best != winner:
                warnings.append(
                    f"calibration stale: {kern}@{bucket} calibrated to "
                    f"'{winner}' (observed p50 {by_backend[winner]*1e3:.3f} "
                    f"ms) but '{best}' measured faster "
                    f"({by_backend[best]*1e3:.3f} ms) — recalibrate")
    return rows, warnings


# ----------------------------------------------------------------- printing
def _fmt_s(s: float) -> str:
    return f"{1e3 * s:10.3f}ms"

def print_report(spans: List[Dict], top: int,
                 metrics_snapshot: Optional[Dict],
                 calibration_path: Optional[str],
                 dropped: int = 0) -> None:
    total_self = sum(self_times(spans).values())
    drop_note = f" · {dropped} dropped by ring" if dropped else ""
    print(f"{len(spans)} spans · {total_self * 1e3:.1f} ms traced self "
          f"time{drop_note}")
    print(f"\n-- top {top} span names (by total wall time) --")
    print(f"{'name':<24}{'count':>7}{'total':>13}{'self':>13}"
          f"{'p50':>13}{'p99':>13}")
    for r in aggregate(spans)[:top]:
        print(f"{r['name']:<24}{r['count']:>7}{_fmt_s(r['total_s']):>13}"
              f"{_fmt_s(r['self_s']):>13}{_fmt_s(r['p50_s']):>13}"
              f"{_fmt_s(r['p99_s']):>13}")
    print("\n-- per-phase self time --")
    for ns, sec, n in phase_breakdown(spans):
        pct = 100.0 * sec / total_self if total_self else 0.0
        print(f"{ns:<12}{_fmt_s(sec):>13}  {pct:5.1f}%  ({n} spans)")
    if metrics_snapshot is not None:
        rows, warns = kernel_profile(metrics_snapshot, calibration_path)
        if rows:
            print("\n-- kernel profile --")
            print(f"{'kernel':<22}{'bucket':<16}{'backend':<11}"
                  f"{'launches':>9}{'p50':>13}{'p99':>13}")
            for r in rows:
                print(f"{r['kernel']:<22}{r['bucket']:<16}"
                      f"{r['backend']:<11}{r['launches']:>9}"
                      f"{_fmt_s(r['p50_s']):>13}{_fmt_s(r['p99_s']):>13}")
        for w in warns:
            print(f"WARNING: {w}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="per-phase time breakdown from an obs JSONL trace")
    ap.add_argument("trace", help="JSONL trace (Tracer.export_jsonl output)")
    ap.add_argument("--metrics", default=None,
                    help="registry snapshot JSON (MetricsRegistry.save)")
    ap.add_argument("--calibration",
                    default="artifacts/backend_calibration.json",
                    help="backend calibration table to sanity-check "
                         "against observed kernel timings")
    ap.add_argument("--top", type=int, default=15,
                    help="span names to show (default 15)")
    ap.add_argument("--folded", default=None, metavar="OUT",
                    help="write flamegraph folded stacks here")
    ap.add_argument("--check", action="store_true",
                    help="validate structure (parse, nesting, trace ids, "
                         "links, request decomposition); non-zero exit "
                         "on violation")
    ap.add_argument("--stitch", default=None, metavar="KEY",
                    help="print the stitched cross-host tree for one "
                         "trace: a trace id, 'rid:N', or 'auto' (slowest "
                         "serve.request)")
    args = ap.parse_args(argv)

    try:
        meta, spans = load_trace(args.trace)
    except (OSError, json.JSONDecodeError) as e:
        print(f"unreadable trace {args.trace!r}: {e}", file=sys.stderr)
        return 2
    if not spans:
        print(f"empty trace {args.trace!r}", file=sys.stderr)
        return 2
    dropped = int(meta.get("dropped", 0)) if meta else 0

    snapshot = None
    if args.metrics:
        snapshot = json.loads(Path(args.metrics).read_text())

    if args.check:
        errors = check_trace(spans, meta)
        if errors:
            for e in errors[:50]:
                print(f"CHECK FAILED: {e}", file=sys.stderr)
            print(f"{len(errors)} violation(s) in {len(spans)} spans",
                  file=sys.stderr)
            return 1
        if dropped:
            print(f"WARNING: ring dropped {dropped} span(s) — trace is "
                  f"incomplete; missing-parent/link checks relaxed")
        print(f"trace OK: {len(spans)} spans parse, nest, and decompose")

    print_report(spans, args.top, snapshot, args.calibration,
                 dropped=dropped)

    if args.stitch:
        tid = resolve_trace_key(spans, args.stitch)
        if tid is None:
            print(f"no trace matches stitch key {args.stitch!r}",
                  file=sys.stderr)
            return 2
        print_stitch(stitch_trace(spans, tid))

    if args.folded:
        stacks = folded_stacks(spans)
        with Path(args.folded).open("w") as f:
            for stack, usec in sorted(stacks.items()):
                f.write(f"{stack} {usec}\n")
        print(f"\nwrote {len(stacks)} folded stacks -> {args.folded}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
