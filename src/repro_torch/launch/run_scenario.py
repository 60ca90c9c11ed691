"""Scenario launcher: run one registered deployment scenario end to end —
train baseline + enhanced through a behavior trace on the card, check the
paper band, then replay the publish/request trace into the autoscaled
serving fleet on the card.

    PYTHONPATH=src python -m repro_torch.launch.run_scenario --list
    PYTHONPATH=src python -m repro_torch.launch.run_scenario mobile_100k \\
        --trace legacy --rounds 2 --fleet
    PYTHONPATH=src python -m repro_torch.launch.run_scenario iot \\
        --trace gilbert --hosts 3 --serve-duration 2.0
    PYTHONPATH=src python -m repro_torch.launch.run_scenario healthcare \\
        --trace maintenance --no-serve --device cpu

``--list`` prints the registry (domains, variants, traces, bands); a run
prints the train metrics against the paper band and the serving-replay
report, and exits nonzero when the run falls out of the band.  The chain
scenario serves from a chain of record and kills its committee leader
mid-replay:

    PYTHONPATH=src python -m repro_torch.launch.run_scenario \\
        blockchain_flchain --trace block_delay
"""
from __future__ import annotations

import argparse
import sys

from repro_torch import obs
from repro_torch.sim.harness import run_scenario, summarize
from repro_torch.sim.scenarios import (SCENARIOS, base_scenarios,
                                       get_scenario, variant_scenarios)


def list_registry() -> None:
    print(f"{len(base_scenarios())} base scenario(s) + "
          f"{len(variant_scenarios())} variant(s):\n")
    for name, sc in SCENARIOS.items():
        kind = (f"variant of {sc.variant_of}" if sc.variant_of
                else "paper domain")
        b = sc.band
        print(f"{name:<18} [{kind}] {sc.domain.n_clients} clients, "
              f"{sc.domain.n_samples} samples, {sc.partitioner} partition")
        print(f"{'':<18} traces: legacy, {', '.join(sc.nontrivial_traces)}")
        print(f"{'':<18} band: time ~{b.time_down[0]:.0f}-"
              f"{b.time_down[1]:.0f}%  comm ~{b.comm_down[0]:.0f}-"
              f"{b.comm_down[1]:.0f}%  acc {b.acc_delta_pp[0]:+.1f}.."
              f"{b.acc_delta_pp[1]:+.1f}pp")
        if sc.notes:
            print(f"{'':<18} {sc.notes}")
        print()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="train -> serve one registered scenario on the card")
    ap.add_argument("scenario", nargs="?", default=None,
                    help="registered scenario name (see --list)")
    ap.add_argument("--list", action="store_true", dest="list_",
                    help="list the scenario registry and exit")
    ap.add_argument("--trace", default="legacy",
                    help="behavior trace name (default: legacy)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="boosting rounds (default: scenario's n_rounds)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train and serve on "
                         "(default: cuda)")
    ap.add_argument("--hosts", type=int, default=2,
                    help="initial serving hosts")
    ap.add_argument("--serve-duration", type=float, default=1.5,
                    help="serving replay window (simulated seconds)")
    ap.add_argument("--no-serve", action="store_true",
                    help="train + band check only")
    ap.add_argument("--no-autoscale", action="store_true",
                    help="fixed fleet during the serve replay")
    ap.add_argument("--engine", choices=("events", "loop"),
                    default="events",
                    help="execution core: the event-queue virtual clock "
                         "(default) or the legacy client-at-a-time loop "
                         "kept as the bit-for-bit parity oracle")
    ap.add_argument("--fleet", action="store_true",
                    help="force the vectorized fleet profile (auto-"
                         "enabled at 4096+ clients; implies the event "
                         "core)")
    ap.add_argument("--trace-out", default=None, metavar="OUT.jsonl",
                    help="export the obs span timeline here")
    ap.add_argument("--metrics-out", default=None, metavar="OUT.json",
                    help="export the obs metrics-registry snapshot here")
    args = ap.parse_args(argv)

    if args.list_ or args.scenario is None:
        list_registry()
        return 0

    sc = get_scenario(args.scenario)
    if args.trace not in sc.traces:
        ap.error(f"scenario {sc.name!r} has no trace {args.trace!r}; "
                 f"choose from: legacy, {', '.join(sc.nontrivial_traces)}")
    if args.fleet:
        from dataclasses import replace
        sc = replace(sc, fleet=True)
    tracer = None
    if args.trace_out or args.metrics_out:
        tracer = obs.configure(trace=True)
    rep = run_scenario(sc, trace=args.trace, seed=args.seed,
                       n_rounds=args.rounds, serve=not args.no_serve,
                       serve_duration_s=args.serve_duration,
                       hosts=args.hosts, autoscale=not args.no_autoscale,
                       engine=args.engine, device=args.device)
    print(summarize(rep))
    if tracer is not None:
        if args.trace_out:
            print(f"trace: {len(tracer)} spans -> "
                  f"{tracer.export_jsonl(args.trace_out)}")
        if args.metrics_out:
            print(f"metrics: -> {obs.get_registry().save(args.metrics_out)}")
        obs.disable()
    return 0 if rep.within_band else 1


if __name__ == "__main__":
    sys.exit(main())
