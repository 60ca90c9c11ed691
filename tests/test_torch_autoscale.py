"""The port's fleet autoscaler and elastic membership against the JAX
package's, on the CPU.

Each criterion of the JAX package's ``tests/test_autoscale.py`` outside
the policy table runs on both packages with the same request stream,
synthetic packed stumps and service model.  The port must meet the
criterion, and its responses (rids, tenants, versions, submit times),
``AutoscaleStats`` (events included) and ``report()`` — p50/p99 included —
must equal the reference's exactly; margins within rtol/atol 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serve as J  # noqa: E402
import repro_torch.serve as T  # noqa: E402

TOL = 1e-5
TENANTS = [f"t{i}" for i in range(6)]


def _publish(target, tenant, T_=4, F=6, seed=0, clock=0.0):
    rng = np.random.RandomState(seed)
    p = np.zeros((T_, 4), np.float32)
    p[:, 0] = rng.randint(0, F, size=T_)
    p[:, 1] = rng.randn(T_)
    p[:, 2] = np.where(rng.rand(T_) > 0.5, 1.0, -1.0)
    a = (rng.rand(T_) + 0.1).astype(np.float32)
    return target.publish_packed(tenant, p, a, clock=clock)


def _cluster(P, n_hosts, tenants, seed=0):
    cluster = P.ShardCluster(n_hosts, P.GossipConfig(seed=seed))
    for i, t in enumerate(tenants):
        _publish(cluster, t, seed=i)
    cluster.run_until_quiescent()
    return cluster


def both(fn):
    """``fn(serve_module, server_kw)`` on the JAX package, then the port."""
    return fn(J, {}), fn(T, {"device": "cpu"})


def assert_responses_equal(ref, port):
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        assert (a.rid, a.tenant, a.snapshot_version, a.t_submit) == (
            b.rid, b.tenant, b.snapshot_version, b.t_submit)
        assert abs(a.margin - b.margin) <= TOL + TOL * abs(a.margin)


def assert_stats_equal(ref, port):
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


# ------------------------------------------------------------- membership
def test_scale_out_warms_replica_before_joining():
    def run(P, _kw):
        cluster = _cluster(P, 2, TENANTS)
        digests = cluster.digests()
        new = cluster.add_host("h-new")
        with pytest.raises(ValueError):
            cluster.add_host("h-new")
        return (new.up, new.registry.digest(), next(iter(digests.values())),
                cluster.host_ids(), dataclasses.asdict(cluster.stats))
    j, t = both(run)
    assert t == j
    assert t[0] and t[1] == t[2] and "h-new" in t[3]


def test_add_host_warms_from_down_replicas_under_total_outage():
    def run(P, _kw):
        cluster = _cluster(P, 2, TENANTS)
        want = {t: cluster.latest(t).fingerprint for t in TENANTS}
        for hid in list(cluster.hosts):
            cluster.mark_down(hid)
        new = cluster.add_host("replacement")
        return (want, new.up,
                {t: new.registry.latest(t).fingerprint for t in TENANTS},
                cluster.route(TENANTS[0]).host_id)
    j, t = both(run)
    assert t == j
    assert t[1] and t[2] == t[0] and t[3] == "replacement"


def test_remove_host_hands_unpublished_window_to_survivor():
    def run(P, _kw):
        cluster = _cluster(P, 3, TENANTS)
        owner = cluster.owner("t0")
        v2 = _publish(cluster, "t0", T_=5, seed=9)
        cluster.remove_host(owner)
        held = [hid for hid, h in cluster.hosts.items()
                if h.registry.get("t0", 2) is not None]
        rounds = cluster.run_until_quiescent()
        return (owner, v2.version, v2.fingerprint, held, rounds,
                cluster.converged(), cluster.digests())
    j, t = both(run)
    assert t == j
    owner, version, fp, held, _, converged, digests = t
    assert version == 2 and held and converged
    assert all(d["t0"] == (2, fp) for d in digests.values())


def test_cluster_remove_host_hands_window_to_down_survivor_or_refuses():
    def run(P, _kw):
        cluster = _cluster(P, 2, ["t0"])
        owner = cluster.owner("t0")
        other = [h for h in cluster.hosts if h != owner][0]
        v2 = _publish(cluster, "t0", T_=5, seed=9)
        cluster.mark_down(other)
        cluster.remove_host(owner)
        with pytest.raises(ValueError):
            cluster.remove_host(other)
        return (cluster.hosts[other].registry.latest("t0").fingerprint,
                v2.fingerprint)
    j, t = both(run)
    assert t == j and t[0] == t[1]


def test_scale_in_drains_without_losing_accepted_requests():
    def run(P, kw):
        cluster = _cluster(P, 3, TENANTS)
        server = P.ShardedEnsembleServer(
            cluster, P.BatchConfig(adaptive=False, fixed_window_units=10_000,
                                   max_batch=64, queue_budget=64),
            service_model=lambda n: 1e-4, **kw)
        rng = np.random.RandomState(0)
        for i in range(30):
            ok, out = server.submit(TENANTS[i % len(TENANTS)],
                                    rng.randn(6).astype(np.float32),
                                    now=1e-4 * i)
            assert ok and out == []
        victim = [hid for hid, s in server.servers.items()
                  if s.queue.depth][0]
        depth = server.servers[victim].queue.depth
        responses, rerouted = server.remove_host(victim, now=0.01)
        assert victim not in server.servers
        assert victim not in cluster.hosts
        drained = server.drain()
        return (victim, depth, rerouted, responses, drained,
                server.report())
    j, t = both(run)
    victim, depth, rerouted, responses, drained, rep = t
    assert (victim, depth, rerouted) == j[:3]
    assert_responses_equal(j[3] + j[4], responses + drained)
    assert rep == j[5]
    assert rerouted == depth and responses == []
    assert sorted(r.rid for r in drained) == list(range(30))
    assert rep["completed"] == 30
    assert rep["per_host"][victim]["status"] == "retired"
    assert all(r.t_submit <= 1e-4 * 30 for r in drained)


def test_remove_last_up_host_with_queued_requests_refuses():
    def run(P, kw):
        cluster = _cluster(P, 2, TENANTS[:2])
        server = P.ShardedEnsembleServer(
            cluster, P.BatchConfig(adaptive=False, fixed_window_units=10_000),
            service_model=lambda n: 1e-4, **kw)
        hid0, hid1 = list(server.servers)
        server.remove_host(hid0)
        assert server.submit(TENANTS[0], np.zeros(6, np.float32), 0.0)[0]
        depth = server.servers[hid1].queue.depth
        with pytest.raises(ValueError):
            server.remove_host(hid1)
        return hid1, depth, hid1 in server.servers, server.drain()
    j, t = both(run)
    assert t[:3] == j[:3] == (t[0], 1, True)
    assert_responses_equal(j[3], t[3])
    assert len(t[3]) == 1


def test_retired_host_id_cannot_be_reused():
    def run(P, kw):
        cluster = _cluster(P, 3, TENANTS)
        server = P.ShardedEnsembleServer(cluster, P.BatchConfig(),
                                         service_model=lambda n: 1e-4, **kw)
        victim = next(iter(server.servers))
        server.remove_host(victim)
        assert server.host_id_taken(victim)
        with pytest.raises(ValueError):
            server.add_host(victim)
        server.add_host("fresh-0")
        return victim, sorted(server.servers), cluster.digests()
    j, t = both(run)
    assert t == j and "fresh-0" in t[1]


# -------------------------------------------------------------- controller
def test_autoscaler_sheds_downed_host_first_and_reroutes_its_queue():
    def run(P, kw):
        cluster = _cluster(P, 3, TENANTS)
        server = P.ShardedEnsembleServer(
            cluster, P.BatchConfig(adaptive=False, fixed_window_units=10_000,
                                   queue_budget=64),
            service_model=lambda n: 1e-4, **kw)
        scaler = P.FleetAutoscaler(server, P.AutoscaleConfig(
            min_hosts=1, max_hosts=3, target_queue=64.0, adapt_every_s=0.01,
            step_down=1.0))
        rng = np.random.RandomState(0)
        accepted = 0
        for i in range(18):
            accepted += server.submit(TENANTS[i % len(TENANTS)],
                                      rng.randn(6).astype(np.float32),
                                      now=1e-4 * i)[0]
        dead = max(server.servers,
                   key=lambda hid: server.servers[hid].queue.depth)
        stuck = server.servers[dead].queue.depth
        cluster.mark_down(dead)
        responses, t = [], 0.0
        while scaler.stats.scale_ins == 0 and t < 2.0:
            t += 0.02
            responses += server.advance(t)
            responses += scaler.step(t)
        responses += server.drain()
        return (accepted, dead, stuck, scaler.stats, responses,
                server.report())
    j, t = both(run)
    accepted, dead, stuck, stats, responses, rep = t
    assert (accepted, dead, stuck) == j[:3]
    assert_stats_equal(j[3], stats)
    assert_responses_equal(j[4], responses)
    assert rep == j[5]
    assert stuck > 0 and stats.scale_ins >= 1
    ins = [e for e in stats.events if e[1] == "in"]
    assert ins[0][2] == dead
    assert stats.rerouted == stuck
    rids = [r.rid for r in responses]
    assert len(rids) == accepted and len(set(rids)) == accepted


def _pressure_then_idle(P, kw):
    cluster = _cluster(P, 1, TENANTS)
    server = P.ShardedEnsembleServer(
        cluster, P.BatchConfig(queue_budget=16, max_batch=4, adaptive=False,
                               fixed_window_units=1),
        service_model=lambda n: 5e-3, **kw)
    scaler = P.FleetAutoscaler(server, P.AutoscaleConfig(
        min_hosts=1, max_hosts=3, target_queue=2.0, adapt_every_s=0.01,
        step_down=1.0))
    rng = np.random.RandomState(0)
    responses, accepted, t = [], 0, 0.0
    for i in range(300):                          # sustained overload
        t += 5e-4
        ok, out = server.submit(TENANTS[i % len(TENANTS)],
                                rng.randn(6).astype(np.float32), t)
        accepted += ok
        responses += out
        responses += scaler.step(t)
    grown = len(server.servers)
    for _ in range(200):                          # idle: pressure ~ 0
        t += 0.02
        responses += server.advance(t)
        responses += scaler.step(t)
    final = len(server.servers)
    responses += server.drain()
    return dict(accepted=accepted, grown=grown, final=final,
                stats=scaler.stats, responses=responses,
                report=server.report())


def test_autoscaler_scales_out_under_pressure_and_back_in_when_idle():
    j, t = both(_pressure_then_idle)
    assert (t["accepted"], t["grown"], t["final"]) == (
        j["accepted"], j["grown"], j["final"])
    assert_stats_equal(j["stats"], t["stats"])
    assert_responses_equal(j["responses"], t["responses"])
    assert t["report"] == j["report"]
    assert t["report"]["p50_ms"] == j["report"]["p50_ms"]
    assert t["report"]["p99_ms"] == j["report"]["p99_ms"]
    assert t["stats"].scale_outs >= 1
    assert 1 < t["grown"] <= 3
    assert t["stats"].scale_ins >= 1 and 1 <= t["final"] < t["grown"]
    rids = [r.rid for r in t["responses"]]
    assert len(rids) == t["accepted"] and len(set(rids)) == t["accepted"]
    assert t["report"]["completed"] == t["accepted"]


def test_rebuilt_autoscaler_skips_retired_ids():
    def run(P, kw):
        cluster = _cluster(P, 1, TENANTS)
        server = P.ShardedEnsembleServer(
            cluster, P.BatchConfig(queue_budget=16, max_batch=4,
                                   adaptive=False, fixed_window_units=1),
            service_model=lambda n: 5e-3, **kw)
        cfg = P.AutoscaleConfig(min_hosts=1, max_hosts=3, target_queue=2.0,
                                adapt_every_s=0.01, step_down=1.0)
        responses = []

        def overload(scaler, t0):
            rng, t = np.random.RandomState(0), t0
            for i in range(200):
                t += 5e-4
                responses.extend(server.submit(
                    TENANTS[i % len(TENANTS)],
                    rng.randn(6).astype(np.float32), t)[1])
                responses.extend(scaler.step(t))
            return t

        first = P.FleetAutoscaler(server, cfg)
        t = overload(first, 0.0)
        for _ in range(200):
            t += 0.02
            responses.extend(server.advance(t))
            responses.extend(first.step(t))
        second = P.FleetAutoscaler(server, cfg)
        overload(second, t)
        responses.extend(server.drain())
        return first.stats, second.stats, responses, server.report()
    j, t = both(run)
    assert_stats_equal(j[0], t[0])
    assert_stats_equal(j[1], t[1])
    assert_responses_equal(j[2], t[2])
    assert t[3] == j[3]
    assert t[0].scale_ins >= 1 and t[1].scale_outs >= 1


def _churn(P, kw):
    cluster = _cluster(P, 2, TENANTS)
    server = P.ShardedEnsembleServer(
        cluster, P.BatchConfig(queue_budget=16, max_batch=4, adaptive=False,
                               fixed_window_units=1),
        service_model=lambda n: 4e-3, **kw)
    scaler = P.FleetAutoscaler(server, P.AutoscaleConfig(
        min_hosts=2, max_hosts=4, target_queue=2.0, adapt_every_s=0.01,
        step_down=1.0))
    rng = np.random.RandomState(7)
    responses, accepted, t = [], 0, 0.0
    for burst in range(4):                        # on/off phases force churn
        for i in range(150):
            t += 4e-4
            ok, out = server.submit(TENANTS[rng.randint(len(TENANTS))],
                                    rng.randn(6).astype(np.float32), t)
            accepted += ok
            responses += out
            responses += scaler.step(t)
        for _ in range(60):
            t += 0.02
            responses += server.advance(t)
            responses += scaler.step(t)
    responses += server.drain()
    return dict(accepted=accepted, stats=scaler.stats, responses=responses,
                report=server.report(), hosts=len(server.servers),
                cache=server.cache_stats())


def test_two_host_autoscaled_fleet_membership_churn_is_loss_free():
    j, t = both(_churn)
    assert t["accepted"] == j["accepted"] and t["hosts"] == j["hosts"]
    assert_stats_equal(j["stats"], t["stats"])
    assert_responses_equal(j["responses"], t["responses"])
    assert t["report"] == j["report"] and t["cache"] == j["cache"]
    assert t["stats"].scale_outs >= 1 and t["stats"].scale_ins >= 1
    rids = [r.rid for r in t["responses"]]
    assert len(rids) == t["accepted"] and len(set(rids)) == t["accepted"]
    assert t["report"]["completed"] == t["accepted"]
    assert 2 <= t["hosts"] <= 4
    statuses = {h["status"] for h in t["report"]["per_host"].values()}
    assert "retired" in statuses and "up" in statuses


# ----------------------------------------------------- cost-aware budget
def _bursty(P, kw, budget_kw):
    cfg = P.AutoscaleConfig(min_hosts=2, max_hosts=8, target_queue=16.0,
                            target_p99_s=0.10, adapt_every_s=0.02,
                            step_down=0.1)
    cluster = _cluster(P, 2, TENANTS)
    server = P.ShardedEnsembleServer(
        cluster, P.BatchConfig(queue_budget=64, max_batch=16),
        service_model=lambda n: 1.2e-3 + 8.0e-4 * n, **kw)
    scaler = P.FleetAutoscaler(server, cfg, **budget_kw)
    rng = np.random.RandomState(0)
    accepted, responses, max_hosts, t = 0, [], len(server.servers), 0.0
    while t < 1.5:
        lam = 1800.0 * (3.0 if (t % 0.5) < 0.25 else 0.1)
        t += rng.exponential(1.0 / max(lam, 1e-9))
        if t >= 1.5:
            break
        ok, out = server.submit(TENANTS[rng.randint(len(TENANTS))],
                                rng.randn(6).astype(np.float32), t)
        accepted += ok
        responses.extend(out)
        responses.extend(scaler.step(t))
        max_hosts = max(max_hosts, len(server.servers))
    responses.extend(server.drain())
    return dict(accepted=accepted, responses=responses, max_hosts=max_hosts,
                scaler=scaler, report=server.report())


@pytest.mark.parametrize("label,budget_kw", [
    ("uncapped", {}),
    ("capped", {"budget_per_host": 0.5, "budget_per_hour": 1.5})])
def test_budget_caps_scale_out_under_1800rps_burst(label, budget_kw):
    j, t = both(lambda P, kw: _bursty(P, kw, budget_kw))
    assert (t["accepted"], t["max_hosts"]) == (j["accepted"],
                                               j["max_hosts"])
    assert_stats_equal(j["scaler"].stats, t["scaler"].stats)
    assert_responses_equal(j["responses"], t["responses"])
    assert t["report"] == j["report"]
    rids = [r.rid for r in t["responses"]]
    assert len(rids) == t["accepted"] and len(set(rids)) == t["accepted"]
    sc = t["scaler"]
    if label == "uncapped":
        assert t["max_hosts"] > 3 and sc.stats.budget_capped == 0
    else:
        assert t["max_hosts"] <= 3 and sc.stats.budget_capped > 0
        assert sc.max_affordable() == 3
        assert sc.projected_cost(3) == pytest.approx(1.5)


def test_budget_never_forces_below_min_hosts():
    def run(P, kw):
        cluster = _cluster(P, 2, TENANTS)
        server = P.ShardedEnsembleServer(cluster,
                                         P.BatchConfig(queue_budget=32), **kw)
        scaler = P.FleetAutoscaler(server,
                                   P.AutoscaleConfig(min_hosts=2,
                                                     max_hosts=8),
                                   budget_per_host=1.0, budget_per_hour=0.5)
        affordable = scaler.max_affordable()
        for i in range(50):
            scaler.step(i * 0.1)
        return affordable, len(server.servers), scaler.stats
    j, t = both(run)
    assert t[:2] == j[:2] == (2, 2)
    assert_stats_equal(j[2], t[2])
