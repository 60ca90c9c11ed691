"""Ensemble serving launcher: train federated boosted ensembles on paper
domains, publish snapshots into a sharded registry cluster mid-training,
gossip them across hosts, then serve a bursty closed-loop workload through
the adaptive micro-batcher with per-snapshot result caching — on the card
unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve_ensemble \\
        --domains edge_vision iot --rounds 12 --rate 400 --duration 3 \\
        --hosts 3 --cache 4096 --kill-owner

Prints per-tenant published versions and gossip convergence, then the
serving report: throughput, p50/p99 latency, batch-size mix, snapshot
staleness, per-host traffic, and cache hit rate.  ``--fixed-window N``
disables window adaptation for an A/B against a fixed window of N
milliseconds; ``--kill-owner`` marks the first tenant's owning host down
halfway through to exercise rendezvous failover onto a gossiped replica;
``--backend``/``--calibration`` pin or table-drive the kernel backend
(``cuda`` or ``torch``; see :mod:`repro_torch.kernels.dispatch`);
``--autoscale MAX`` lets the eq.-(1) fleet autoscaler grow/shrink the host
count between ``--hosts`` and MAX on queue-depth/p99 pressure;
``--policy-table JSON`` loads per-(tenant, host) batching/kernel policies
(:mod:`repro_torch.serve.policy`).  Service time is the analytic model
``1.2 ms + 0.2 ms`` per kernel request, so the report is a function of the
arrivals, the policies and the trained snapshots, as in the JAX package's
launcher, whose command line and printed lines this one keeps.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch import obs
from repro_torch.configs.paper_fedboost import FedBoostConfig
from repro_torch.core import FederatedBoostEngine
from repro_torch.data import make_domain_data
from repro_torch.kernels.dispatch import KernelPolicy
from repro_torch.serve import (AutoscaleConfig, BatchConfig, FleetAutoscaler,
                               GossipConfig, PolicyTable, ServeMetrics,
                               ShardCluster, ShardedEnsembleServer)
from repro_torch.sim.scenarios import DOMAINS


def train_tenants(cluster: ShardCluster, domains, rounds: int, seed: int,
                  policy=None, device="cuda"):
    """Train one enhanced-mode engine per domain (cut to at most 2,000
    samples and 8 clients), publishing into ``cluster``; gossip to
    quiescence and rebase the clock.  Returns each tenant's request pool
    (its test features)."""
    pools = {}
    for name in domains:
        dom = dataclasses.replace(DOMAINS[name],
                                  n_samples=min(DOMAINS[name].n_samples, 2000),
                                  n_clients=min(DOMAINS[name].n_clients, 8))
        data = make_domain_data(dom, seed=seed)
        cfg = FedBoostConfig(n_clients=dom.n_clients, n_rounds=rounds,
                             straggler_factor=dom.straggler_factor,
                             dropout_prob=dom.dropout_prob, seed=seed,
                             balanced_init=dom.label_imbalance < 0.4)
        eng = FederatedBoostEngine(cfg, data, "enhanced",
                                   kernel_policy=policy, device=device)
        eng.attach_registry(cluster, name)    # publishes route to the owner
        metrics = eng.run()
        pools[name] = np.asarray(data["test"][0], np.float32)
        snap = cluster.latest(name)
        print(f"trained {name:<12} val_err={metrics.final_val_error:.3f} "
              f"-> {cluster.version_count(name)} snapshots published "
              f"(latest v{snap.version}, {snap.n_learners} learners, "
              f"owner {cluster.owner(name)})")
    rounds_taken = cluster.run_until_quiescent(now=0.0)
    print(f"gossip converged in {rounds_taken} anti-entropy round(s): "
          f"{cluster.stats.pulled} snapshots pulled, "
          f"{cluster.stats.reconciled} conflicts reconciled")
    cluster.rebase_clock(0.0)
    return pools


def serve(cluster: ShardCluster, pools, rate: float, duration: float,
          seed: int, fixed_window_ms: float = 0.0, cache_capacity: int = 4096,
          kill_owner: bool = False, policy=None, policy_table=None,
          autoscale_max: int = 0, budget_per_host: float = None,
          budget_per_hour: float = None, device="cuda"):
    """Serve the bursty closed-loop workload over ``cluster``'s hosts on
    ``device``; returns the :class:`ShardedEnsembleServer`."""
    # the flag-built config composes with a policy table: it becomes the
    # fleet default the table's host/tenant/pair overrides layer onto
    cfg = (BatchConfig(adaptive=False,
                       fixed_window_units=max(1, int(fixed_window_ms)),
                       cache_capacity=cache_capacity)
           if fixed_window_ms > 0
           else BatchConfig(cache_capacity=cache_capacity))
    server = ShardedEnsembleServer(
        cluster, cfg, service_model=lambda n: 1.2e-3 + 2.0e-4 * n,
        policy=policy, policy_table=policy_table, device=device)
    scaler = None
    if autoscale_max > 0:
        scaler = FleetAutoscaler(server, AutoscaleConfig(
            min_hosts=len(cluster.hosts),
            max_hosts=max(autoscale_max, len(cluster.hosts))),
            budget_per_host=budget_per_host,
            budget_per_hour=budget_per_hour)
    elif budget_per_host is not None or budget_per_hour is not None:
        print("  WARNING: --budget-per-host/--budget-per-hour only apply "
              "to an autoscaled fleet; pass --autoscale MAX to enable "
              "the cost cap (budget flags ignored)")
    tenants = sorted(pools)
    victim = cluster.owner(tenants[0]) if kill_owner else None
    rng = np.random.RandomState(seed)
    t, killed = 0.0, False
    while t < duration:
        # bursty arrivals: 3x rate on-phase, 0.1x off-phase, 0.5 s period
        lam = rate * (3.0 if (t % 0.5) < 0.25 else 0.1)
        t += rng.exponential(1.0 / max(lam, 1e-9))
        if t >= duration:
            break
        if victim is not None and not killed and t >= 0.5 * duration:
            cluster.mark_down(victim)
            killed = True
            print(f"  t={t:.2f}s marked {victim} down -> "
                  f"{tenants[0]} now served by "
                  f"{cluster.route(tenants[0]).host_id} (gossiped replica)")
        tenant = tenants[rng.randint(len(tenants))]
        pool = pools[tenant]
        server.submit(tenant, pool[rng.randint(pool.shape[0])], t)
        if scaler is not None:
            scaler.step(t)
    server.drain()
    if scaler is not None:
        st = scaler.stats
        print(f"  autoscaler: {st.scale_outs} scale-out(s), "
              f"{st.scale_ins} scale-in(s), {st.rerouted} request(s) "
              f"rerouted, peak pressure {st.pressure_peak:.2f}, "
              f"final fleet {len(server.servers)} host(s)")
        if st.budget_capped:
            print(f"  budget: {st.budget_capped} scale-out(s) refused at "
                  f"{scaler.projected_cost():.2f} $/h projected "
                  f"(cap {scaler.budget_per_hour:.2f} $/h, "
                  f"{scaler.cost_per_host_hour:.2f} $/h per host)")
        for when, action, hid, size in st.events:
            print(f"    t={when:.2f}s scale-{action:<3} {hid:<10} "
                  f"-> {size} hosts")
    return server


def main(argv=None) -> dict:
    """Run the launcher on ``argv``; prints the report and returns it (the
    fleet's :meth:`ShardedEnsembleServer.report` dict)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--domains", nargs="+",
                    default=["edge_vision", "iot"], choices=sorted(DOMAINS))
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--rate", type=float, default=400.0)
    ap.add_argument("--duration", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hosts", type=int, default=3,
                    help="serving hosts in the sharded cluster")
    ap.add_argument("--cache", type=int, default=4096,
                    help="result-cache entries per host (0 disables)")
    ap.add_argument("--kill-owner", action="store_true",
                    help="mark the first tenant's owner down mid-serve "
                         "(failover demo)")
    ap.add_argument("--fixed-window", type=float, default=0.0,
                    help="fixed batch window in ms (0 = adaptive)")
    ap.add_argument("--autoscale", type=int, default=0, metavar="MAX",
                    help="autoscale the fleet between --hosts and MAX "
                         "hosts on queue-depth/p99 pressure (0 = fixed "
                         "fleet)")
    ap.add_argument("--budget-per-host", type=float, default=None,
                    metavar="$/H", help="projected cost of one serving "
                    "host in $/hour (cost-aware autoscaling)")
    ap.add_argument("--budget-per-hour", type=float, default=None,
                    metavar="$/H", help="fleet budget in $/hour: "
                    "scale-outs that would exceed it are refused")
    ap.add_argument("--policy-table", default=None, metavar="JSON",
                    help="per-(tenant, host) batching/kernel policy table "
                         "(see repro_torch.serve.policy for the JSON "
                         "shape); the CLI batching flags form the fleet "
                         "default its host/tenant/pair overrides layer "
                         "onto")
    ap.add_argument("--backend", default=None, choices=["torch", "cuda"],
                    help="force one kernel backend fleet-wide (default: "
                         "per-call resolution — REPRO_TORCH_KERNEL_BACKEND "
                         "env var > calibration > the kernel on the card, "
                         "the plain version on the CPU)")
    ap.add_argument("--calibration", default=None, metavar="JSON",
                    help="backend-calibration table written by "
                         "KernelPolicy.save; per-bucket winners drive "
                         "kernel dispatch")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train and serve on "
                         "(default: cuda)")
    ap.add_argument("--trace", default=None, metavar="OUT.jsonl",
                    help="export the obs span timeline here (enables "
                         "tracing + kernel profiling for the whole run)")
    ap.add_argument("--metrics", default=None, metavar="OUT.json",
                    help="export the obs metrics-registry snapshot here")
    args = ap.parse_args(argv)

    tracer = None
    if args.trace or args.metrics:
        tracer = obs.configure(trace=True)

    policy = None
    if args.backend:
        policy = KernelPolicy(backend=args.backend)
    elif args.calibration:
        policy = KernelPolicy.load(args.calibration)
        print(f"loaded calibration table ({len(policy.table)} buckets) "
              f"from {args.calibration}")

    policy_table = None
    if args.policy_table:
        policy_table = PolicyTable.load(args.policy_table)
        print(f"loaded policy table from {args.policy_table}")

    cluster = ShardCluster(args.hosts, GossipConfig(seed=args.seed))
    pools = train_tenants(cluster, args.domains, args.rounds, args.seed,
                          policy=policy, device=args.device)
    server = serve(cluster, pools, args.rate, args.duration, args.seed,
                   fixed_window_ms=args.fixed_window,
                   cache_capacity=args.cache, kill_owner=args.kill_owner,
                   policy=policy, policy_table=policy_table,
                   autoscale_max=args.autoscale,
                   budget_per_host=args.budget_per_host,
                   budget_per_hour=args.budget_per_hour, device=args.device)

    rep = server.report()
    mode = ("adaptive" if args.fixed_window <= 0
            else f"fixed {args.fixed_window:.0f}ms")
    mode += " window"
    if args.autoscale > 0:
        mode += f", autoscaled <= {args.autoscale} hosts"
    print(f"\nserving [{mode}, {args.hosts} hosts] nominal "
          f"{args.rate:.0f} rps, {args.duration:.1f}s bursty closed loop")
    print(f"  completed {rep['completed']}  rejected {rep['rejected']}  "
          f"throughput {rep['throughput_rps']:.0f} rps")
    print(f"  latency p50 {rep['p50_ms']:.2f} ms  p99 {rep['p99_ms']:.2f} ms  "
          f"mean batch {rep['mean_batch']:.1f}  "
          f"peak queue {rep['queue_depth_peak']}")
    cache = rep["cache"]
    print(f"  cache hit rate {cache['hit_rate']:.1%} "
          f"({cache['hits']} hits, {cache['fills']} fills, "
          f"{cache['invalidated']} invalidated)")
    for hid, h in rep["per_host"].items():
        print(f"  host {hid:<8} [{h['status']:>7}] served "
              f"{h['completed']:>6} p99 {h['p99_ms']:>6.2f} ms  "
              f"batches {h['n_batches']}")
    for name, t in rep["tenants"].items():
        print(f"  tenant {name:<12} served {t['completed']:>5} "
              f"p99 {t['p99_ms']:>6.2f} ms  snapshot v{t['snapshot_version']} "
              f"staleness {t['mean_staleness_s']:.2f}s")

    if tracer is not None:
        if args.trace:
            print(f"  trace: {len(tracer)} spans -> "
                  f"{tracer.export_jsonl(args.trace)}")
        if args.metrics:
            # fold the fleet's per-host serving counters into the global
            # registry snapshot so one file carries train + serve + kernel
            fleet_view = ServeMetrics(obs.get_registry())
            for _hid, _status, m in server._all_metrics():
                ShardedEnsembleServer._merge_into(fleet_view, m)
            ShardedEnsembleServer._merge_into(fleet_view, server.metrics)
            print(f"  metrics: -> "
                  f"{obs.get_registry().save(args.metrics)}")
        obs.disable()
    return rep


if __name__ == "__main__":
    main()
