"""Scenario harness: one registered scenario end to end — train both
engine modes through a behavior trace on the engine's device, then replay
the resulting publish/request trace into the serving fleet.

Training drives :class:`~repro_torch.core.async_engine.FederatedBoostEngine`
(baseline and enhanced) with the scenario's ``behavior_for`` hook; the
scenario's ``fleet`` field picks the engine profile, so ``mobile_100k``
runs the vectorized fleet profile.  The enhanced run publishes snapshots
mid-training into a :class:`~repro_torch.serve.shard.ShardCluster`
(stamped with the simulated clock).  The serve phase gossip-converges the
cluster, rebases the publisher clocks, and replays a request trace
*derived from the same behavior models* — each client emits Poisson
requests thinned by its availability and delayed by its link latency (an
offline phone sends nothing; a congested chain peer's requests arrive
late) — through a :class:`~repro_torch.serve.service.ShardedEnsembleServer`
voting on the same device, under the eq.-(1)
:class:`~repro_torch.serve.autoscale.FleetAutoscaler`.  One
:class:`ScenarioReport` per (scenario, trace, seed) carries both halves.

A chain-of-record scenario (``chain=True``, ``blockchain_flchain``)
publishes into a :class:`~repro_torch.chain.ChainCluster` instead: the
enhanced run's deltas commit to the shared chain, every host folds the
confirmed blocks, and the replay kills the committee leader halfway
through.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.chain import ChainCluster
from repro_torch.core import FederatedBoostEngine
from repro_torch.core.async_engine import RunMetrics
from repro_torch.core.metrics import (
    common_target, pct_reduction, time_to_error)
from repro_torch.obs.slo import SLObjective, SLOMonitor
from repro_torch.serve import (AutoscaleConfig, BatchConfig, FleetAutoscaler,
                               GossipConfig, ShardCluster,
                               ShardedEnsembleServer)
from repro_torch.serve.engine import Response
from repro_torch.sim.scenarios import Scenario, get_scenario

# serve-replay fleet defaults: small fleet, autoscalable, analytic service
# model (the JAX package's c0 + c1*n regime)
SERVE_BATCH = BatchConfig(queue_budget=64, max_batch=16, cache_capacity=1024)


def _autoscale_config(n_hosts: int) -> AutoscaleConfig:
    # the caller's fleet size is the floor — the autoscaler may grow the
    # fleet, never drain below what was asked for
    return AutoscaleConfig(min_hosts=n_hosts, max_hosts=max(6, n_hosts),
                           target_queue=16.0, target_p99_s=0.10,
                           adapt_every_s=0.02, step_down=0.1)


def _service_model(n_kernel: int) -> float:
    return 1.2e-3 + 4.0e-4 * n_kernel


@dataclass
class ScenarioReport:
    """Train->serve results for one (scenario, trace, seed)."""
    scenario: str
    trace: str
    seed: int
    baseline: RunMetrics
    enhanced: RunMetrics
    row: Dict[str, float]            # Table-1-style relative improvements
    band_failures: List[str]         # empty = within paper band
    serve: Optional[Dict] = None     # serving-replay summary (None = skipped)

    @property
    def within_band(self) -> bool:
        return not self.band_failures


def train_pair(sc: Scenario, trace: str, seed: int = 0,
               n_rounds: Optional[int] = None,
               cluster: Optional[ShardCluster] = None,
               publish_every: int = 2, engine: str = "events",
               device="cuda") -> Tuple[Dict, Dict[str, RunMetrics]]:
    """Run baseline + enhanced through one behavior trace on one dataset.
    The enhanced engine publishes into ``cluster`` (when given) so the
    serve phase replays real mid-training snapshots.  ``engine`` selects
    the execution core (``events``, the default, or the legacy ``loop``
    parity oracle); the scenario's ``fleet`` field picks the engine
    profile (None = auto by fleet size)."""
    data = sc.make_data(seed)
    cfg = sc.fedboost_config(seed=seed, n_rounds=n_rounds)
    runs: Dict[str, RunMetrics] = {}
    for mode in ("baseline", "enhanced"):
        # a fresh behavior set per engine: stateful models (Gilbert
        # chains, outage processes) must not leak state across runs
        eng = FederatedBoostEngine(cfg, data, mode,
                                   behavior_for=sc.behavior_for(trace, seed),
                                   engine=engine, fleet=sc.fleet,
                                   device=device)
        if mode == "enhanced" and cluster is not None:
            eng.attach_registry(cluster, sc.name, publish_every=publish_every)
        # traced runs carry contribution audits (pure measurement, merges
        # unchanged); the fleet profile has no per-entry merge to audit
        audit = (eng.attach_audit()
                 if obs.enabled() and not eng.fleet_profile else None)
        with obs.span("scenario.train", sim_t=0.0, scenario=sc.name,
                      trace=trace, seed=seed, mode=mode) as sp:
            runs[mode] = eng.run()
            sp.end_sim(runs[mode].sim_time_s)
        if audit is not None:
            for fl in audit.flags():
                obs.point("audit.flag", scenario=sc.name, mode=mode,
                          cid=fl.cid, metric=fl.metric, z=fl.z)
    return data, runs


def result_row(runs: Dict[str, RunMetrics]) -> Dict[str, float]:
    """The Table-1 relative-improvement row for one baseline/enhanced pair
    (the JAX package's metric definitions)."""
    b, e = runs["baseline"], runs["enhanced"]
    tgt = common_target([b.val_error_curve, e.val_error_curve])
    tb = time_to_error(b.val_error_curve, tgt)
    te = time_to_error(e.val_error_curve, tgt)
    return {
        "time_down": pct_reduction(tb[0], te[0]) if tb and te else 0.0,
        "comm_down": pct_reduction(b.total_bytes, e.total_bytes),
        "msgs_down": pct_reduction(b.n_messages, e.n_messages),
        "conv_down": pct_reduction(tb[1], te[1]) if tb and te else 0.0,
        "acc_delta_pp": 100.0 * (b.final_test_error - e.final_test_error),
        "base_err": b.final_test_error,
        "enh_err": e.final_test_error,
        "base_bytes": float(b.total_bytes),
        "enh_bytes": float(e.total_bytes),
        "unavailable_rounds": float(e.rounds_unavailable),
    }


def _serve_arrivals(sc: Scenario, data: Dict, trace: str, seed: int,
                    duration_s: float
                    ) -> Tuple[List[Tuple[float, np.ndarray]], int]:
    """The replay's request trace: ``([(t, x), ...], offline)``, sorted by
    arrival time, and the count of requests an offline client never sent.

    Each client emits Poisson requests at ``serve_rate / n_clients``; the
    *same behavior models* that shaped training gate them — a request is
    dropped while the client is unavailable and delayed by its link
    latency.  Serving time runs ``time_warp`` times slower than behavior
    time, so diurnal cycles and outage windows project onto the replay
    window.  Each request's features are a test row drawn in arrival
    order from the same RNG, after the emission times."""
    # fresh behavior instances: the serve epoch is a different day than
    # training.  Candidate emission times are gated in *global* time order
    # so stateful behaviors — including processes shared across clients,
    # like a site-outage window or the blockchain ledger — see
    # non-decreasing timestamps.
    behavior_for = sc.behavior_for(trace, seed + 101)
    xs = np.asarray(data["test"][0], np.float32)
    rng = np.random.RandomState(seed * 31 + 7)
    per_client = sc.serve_rate / sc.domain.n_clients
    candidates: List[Tuple[float, int]] = []
    for cid in range(sc.domain.n_clients):
        t = 0.0
        while True:
            t += rng.exponential(1.0 / per_client)
            if t >= duration_s:
                break
            candidates.append((t, cid))
    candidates.sort()

    behaviors = ([behavior_for(c) for c in range(sc.domain.n_clients)]
                 if behavior_for is not None else None)
    times: List[float] = []
    offline = 0
    for t, cid in candidates:
        if behaviors is None:
            times.append(t)
            continue
        beh = behaviors[cid]
        bt = t * sc.time_warp            # serve-s -> behavior-s
        if not beh.availability(bt):
            offline += 1                 # device offline: nothing sent
            continue
        # query delay is measured in behavior-seconds; project it back
        # onto the serving clock (reads never pay training-commit costs)
        times.append(t + beh.query_delay(bt) / sc.time_warp)
    times.sort()
    return [(t, xs[rng.randint(xs.shape[0])]) for t in times], offline


def _replay(sc: Scenario, server: ShardedEnsembleServer,
            arrivals: List[Tuple[float, np.ndarray]], offline: int,
            duration_s: float, autoscale: bool
            ) -> Tuple[Dict, List[Response]]:
    """Drive ``arrivals`` through ``server`` (under the autoscaler when
    ``autoscale``) with an SLO ledger attached; returns the replay summary
    and every response in the order the fleet answered.  Asserts the
    fleet's zero-loss invariant (every accepted request answered exactly
    once across membership churn).

    Over a chain cluster under the autoscaler, the committee leader is
    killed just before the middle arrival: an abrupt death, not a drain.
    The autoscaler sheds the dead replica (accepted requests reroute), a
    replacement warms from chain history alone, and the zero-loss
    assertion must still hold."""
    # SLO ledger over the replay: measurement only (the autoscaler keeps
    # its queue/p99 signal), so scenario bands are unchanged
    monitor = SLOMonitor([SLObjective(tenant=sc.name,
                                      latency_threshold_s=0.05,
                                      target=0.95,
                                      window_s=max(0.25, duration_s / 3.0))])
    server.attach_slo(monitor)
    scaler = (FleetAutoscaler(server,
                              _autoscale_config(len(server.cluster.hosts)))
              if autoscale else None)
    cluster = server.cluster
    kill_at = (len(arrivals) // 2
               if isinstance(cluster, ChainCluster) and scaler is not None
               else None)
    killed = None
    accepted, responses = 0, []
    for i, (t, x) in enumerate(arrivals):
        if i == kill_at:
            up = cluster.host_ids()
            if len(up) > 1:
                leader = cluster.leader()
                killed = leader if leader in up else up[0]
                cluster.kill(killed)
        ok, out = server.submit(sc.name, x, t)
        accepted += ok
        responses.extend(out)
        if scaler is not None:
            responses.extend(scaler.step(t))
        monitor.check(t)
    responses.extend(server.drain())
    rids = [r.rid for r in responses]
    if len(rids) != accepted or len(set(rids)) != len(rids):
        raise AssertionError(
            f"request loss under churn: accepted={accepted} "
            f"answered={len(rids)} unique={len(set(rids))}")

    rep = server.report()
    tenant = rep["tenants"].get(sc.name, {})
    # settle the alert state past the drain tail before summarizing
    t_end = duration_s + monitor.objectives[sc.name].window_s
    monitor.check(t_end)
    slo_rep = monitor.report(t_end)["tenants"].get(sc.name, {})
    return {
        "offered": len(arrivals), "offline_suppressed": offline,
        "completed": rep["completed"], "rejected": rep["rejected"],
        "p50_ms": rep["p50_ms"], "p99_ms": rep["p99_ms"],
        "throughput_rps": rep["throughput_rps"],
        "mean_batch": rep["mean_batch"],
        "cache_hit_rate": rep["cache"]["hit_rate"],
        "snapshot_version": tenant.get("snapshot_version", 0),
        "hosts_final": len(server.servers),
        "scale_outs": scaler.stats.scale_outs if scaler else 0,
        "scale_ins": scaler.stats.scale_ins if scaler else 0,
        "rerouted": scaler.stats.rerouted if scaler else 0,
        "killed_host": killed,
        "slo": {
            "good": slo_rep.get("good", 0),
            "bad": slo_rep.get("bad", 0),
            "budget_remaining": slo_rep.get("budget_remaining", 1.0),
            "alerts_fired": sum(1 for e in monitor.alerts.events
                                if e.kind == "fire"),
            "alerts_active": len(monitor.alerts.active()),
        },
    }, responses


def replay_serve(sc: Scenario, cluster: ShardCluster, data: Dict,
                 trace: str, seed: int = 0, duration_s: float = 1.5,
                 autoscale: bool = True, device="cuda") -> Dict:
    """Replay the scenario's request trace (:func:`_serve_arrivals`) into
    a serving fleet over ``cluster`` that votes on ``device``, under the
    analytic service model; returns the replay summary."""
    sp = obs.span("scenario.serve_replay", sim_t=0.0, scenario=sc.name,
                  trace=trace, seed=seed)
    cluster.run_until_quiescent()
    cluster.rebase_clock(0.0)
    server = ShardedEnsembleServer(cluster, SERVE_BATCH,
                                   service_model=_service_model,
                                   device=device)
    arrivals, offline = _serve_arrivals(sc, data, trace, seed, duration_s)
    summary, _ = _replay(sc, server, arrivals, offline, duration_s,
                         autoscale)
    sp.set(completed=summary["completed"], hosts_final=summary["hosts_final"])
    sp.end(sim_t=duration_s)
    return summary


def run_scenario(name_or_scenario, trace: str = "legacy", seed: int = 0,
                 n_rounds: Optional[int] = None, serve: bool = True,
                 serve_duration_s: float = 1.5, hosts: int = 2,
                 autoscale: bool = True, publish_every: int = 2,
                 engine: str = "events", device="cuda") -> ScenarioReport:
    """One scenario end to end on ``device``: train both modes through
    ``trace``, check the paper band, then (optionally) replay the
    publish/request trace into an autoscaled serving fleet.  Scenarios
    with ``serve_replay=False`` (the fleet-scale smokes) always skip the
    serve phase.  A chain scenario's fleet is a
    :class:`~repro_torch.chain.ChainCluster` (no central registry)."""
    sc = (name_or_scenario if isinstance(name_or_scenario, Scenario)
          else get_scenario(name_or_scenario))
    serve = serve and sc.serve_replay
    with obs.span("scenario.run", scenario=sc.name, trace=trace, seed=seed):
        if not serve:
            cluster = None
        elif sc.chain:
            # decentralized chain-of-record mode: publishes commit to the
            # shared chain; hosts (and any replacement the autoscaler
            # warms later) fold confirmed blocks
            cluster = ChainCluster(hosts, GossipConfig(seed=seed))
        else:
            cluster = ShardCluster(hosts, GossipConfig(seed=seed))
        data, runs = train_pair(sc, trace, seed=seed, n_rounds=n_rounds,
                                cluster=cluster, publish_every=publish_every,
                                engine=engine, device=device)
        row = result_row(runs)
        report = ScenarioReport(
            scenario=sc.name, trace=trace, seed=seed,
            baseline=runs["baseline"], enhanced=runs["enhanced"],
            row=row, band_failures=sc.band.check(row))
        if serve:
            report.serve = replay_serve(sc, cluster, data, trace, seed=seed,
                                        duration_s=serve_duration_s,
                                        autoscale=autoscale, device=device)
    return report


def summarize(rep: ScenarioReport) -> str:
    """Human-readable one-scenario summary (the run_scenario CLI output)."""
    sc = get_scenario(rep.scenario)
    lines = [
        f"scenario {rep.scenario} · trace {rep.trace} · seed {rep.seed}",
        f"  train: time_down {rep.row['time_down']:+.1f}%  "
        f"comm_down {rep.row['comm_down']:+.1f}%  "
        f"msgs_down {rep.row['msgs_down']:+.1f}%  "
        f"acc_delta {rep.row['acc_delta_pp']:+.1f}pp  "
        f"(unavailable rounds: {rep.row['unavailable_rounds']:.0f})",
        f"  band:  time ~{sc.band.time_down[0]:.0f}-"
        f"{sc.band.time_down[1]:.0f}%  comm ~{sc.band.comm_down[0]:.0f}-"
        f"{sc.band.comm_down[1]:.0f}%  acc {sc.band.acc_delta_pp[0]:+.1f}.."
        f"{sc.band.acc_delta_pp[1]:+.1f}pp  -> "
        + ("WITHIN BAND" if rep.within_band
           else "OUT OF BAND: " + "; ".join(rep.band_failures)),
    ]
    if rep.serve is not None:
        s = rep.serve
        lines.append(
            f"  serve: {s['completed']} done / {s['rejected']} shed "
            f"(+{s['offline_suppressed']} never sent)  "
            f"p50 {s['p50_ms']:.2f} ms  p99 {s['p99_ms']:.2f} ms  "
            f"cache {s['cache_hit_rate']:.0%}  "
            f"snapshot v{s['snapshot_version']}  "
            f"hosts {s['hosts_final']} "
            f"({s['scale_outs']} out / {s['scale_ins']} in, "
            f"{s['rerouted']} rerouted)")
    return "\n".join(lines)
